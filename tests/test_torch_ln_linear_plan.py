"""The launch plan of the fused LayerNorm -> linear kernel
(csrc/ln_linear.cu, K8), on the CPU: the tile (rows x outputs a CTA), the
stages of the shared W ring and the CTAs a row tile's outputs are split
over, at the shapes the train steps, the classifier build and the GPU tests
give it, on a card of 132 SMs (an H100 SXM). The kernel itself runs only on
the card (tests/test_torch_kernels_gpu.py)."""
import pytest

from latteclip_torch.kernels import fused_ln_linear as FL

SMS = 132

# (M = B * L rows, D, O): the padded ViT-B/32 step's eight LN -> projection
# pairs and the classifier build's (chip_smoke.py), ViT-B/16 vision at its
# train and eval batches, and the GPU tests' shapes
SITES = [
    (25600, 768, 2304), (25600, 768, 3072),      # vision pairs [256, 100] in_proj, c_fc
    (78848, 512, 1536), (78848, 512, 2048),      # captions [1024, 77]
    (3619, 512, 1536), (3619, 512, 2048),        # templates [47, 77]
    (77000, 512, 1536), (77000, 512, 2048),      # classifier build [1000, 77]
    (100864, 768, 2304), (50432, 768, 3072),     # ViT-B/16 vision [512, 197], [256, 197]
    (231, 512, 1536), (200, 768, 2304), (50, 768, 3072), (65, 64, 200), (7, 128, 64),
    (80, 1024, 256), (63, 768, 2304), (100, 1664, 64), (30, 1664, 72),
]


@pytest.mark.parametrize("M,D,O", SITES)
def test_ln_linear_plan_is_one_the_kernel_takes(M, D, O):
    """Every plan fits a CTA's shared memory with at least two W stages,
    takes a tile the kernel is built for, and splits a row tile's outputs
    over no more CTAs than it has output tiles."""
    plan = FL.ln_linear_plan(M, D, O, SMS)
    assert (plan.bm, plan.bn) in FL.LN_TILES
    assert FL.LN_MIN_STAGES <= plan.stages <= FL.LN_MAX_STAGES
    assert plan.smem_bytes == FL.ln_linear_smem_bytes(plan.bm, plan.bn, D, plan.stages)
    assert plan.smem_bytes <= FL.MAX_SMEM
    assert FL.ln_linear_smem_bytes(plan.bm, plan.bn, D, plan.stages + 1) > FL.MAX_SMEM \
        or plan.stages == FL.LN_MAX_STAGES
    assert 1 <= plan.n_splits <= -(-O // plan.bn)


@pytest.mark.parametrize("M,D,O,tile,stages,splits", [
    (25600, 768, 3072, (128, 128), 2, 3),   # 200 row tiles: 3 splits, 5 waves, not 2 of 25 tiles
    (25600, 768, 2304, (128, 128), 2, 3),
    (78848, 512, 2048, (128, 128), 6, 1),   # 616 row tiles fill the card alone
    (3619, 512, 1536, (128, 128), 6, 4),    # 29 row tiles: 4 splits fill 116 SMs once
    (3619, 512, 2048, (128, 128), 6, 4),
    (80, 1024, 256, (64, 128), 6, 2),       # past D = 768 a CTA takes 64 rows
    (100, 1536, 64, (64, 128), 2, 1),
    (100, 1664, 64, (64, 64), 2, 1),        # the widest row: two stages are the most that fit
])
def test_ln_linear_plan_at_the_main_sites(M, D, O, tile, stages, splits):
    plan = FL.ln_linear_plan(M, D, O, SMS)
    assert ((plan.bm, plan.bn), plan.stages, plan.n_splits) == (tile, stages, splits)


def test_ln_linear_smem_holds_the_rows_and_the_ring():
    """xn [128, 768] bf16 and two 16 KB W stages: 196,608 + 32,768 B, plus
    1 KB of alignment slack and five 8-byte mbarriers; [128, 512] leaves
    room for six stages."""
    assert FL.ln_linear_smem_bytes(128, 128, 768, 2) == 1024 + 196608 + 32768 + 40
    assert FL.ln_linear_smem_bytes(128, 128, 512, 6) == 1024 + 131072 + 6 * 16384 + 104
    assert FL.ln_linear_smem_bytes(128, 128, 512, 7) > FL.MAX_SMEM


@pytest.mark.parametrize("M,D,O", [(100, 96, 64), (100, 128, 60), (100, 1728, 64), (0, 128, 64)])
def test_ln_linear_plan_refuses_what_the_kernel_does_not_take(M, D, O):
    """D not a multiple of 64, O not of 8, a row too wide for two W stages
    beside 64 normalised rows (D > 1664), or no rows."""
    with pytest.raises(ValueError, match="fused LayerNorm -> linear"):
        FL.ln_linear_plan(M, D, O, SMS)


def test_plan_sweep_tool_checks_every_plan_and_needs_the_card():
    """tools/ln_linear_plans.py holds each plan's output to the plain version
    with chip_smoke.py's bounds, and refuses to time anything without CUDA."""
    import torch

    from latteclip_torch.tools import ln_linear_plans as T

    ref = torch.randn(1, 300, 256).to(torch.bfloat16)
    assert T.agrees(ref, ref)
    dropped = ref.clone()
    dropped[..., 128:144] = 0
    assert not T.agrees(dropped, ref)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.run()
