"""The launch plans of rows of more than 128 tokens, on the CPU: the
forward's long-row kernel (csrc/flash_fwd.cu::flash_fwd_long_kernel: K and V
resident in shared memory or streamed through a ring, the warps of a CTA and
the CTAs per (row, head)) and the backward's (csrc/flash_bwd.cu: the row
resident in shared memory or the tiled pair, the warps of a CTA), at the
shapes the towers and the GPU tests give them, on a card of 132 SMs (an H100
SXM). The kernels themselves run only on the card
(tests/test_torch_kernels_gpu.py)."""
import pytest

from latteclip_torch.kernels import attention as A

SMS = 132


@pytest.mark.parametrize("B,L,H,D,segmented,form,warps,splits", [
    (64, 197, 12, 64, False, "resident", 8, 1),     # ViT-B/16 vision: two CTAs an SM
    (256, 197, 12, 64, False, "resident", 8, 1),    # the ViT-B/16 eval batch
    (64, 197, 12, 64, True, "resident", 8, 1),      # segment ids beside K and V
    (64, 197, 6, 128, False, "resident", 13, 1),    # head_dim 128: one CTA an SM
    (8, 577, 16, 64, False, "resident", 16, 1),     # 336 px: 128 pairs, not split
    (1, 384, 1, 128, False, "resident", 4, 6),      # the resident form's edge at D=128
    (1, 385, 1, 128, False, "streamed", 4, 6),
    (2, 577, 1, 128, False, "streamed", 4, 9),
    (1, 1024, 2, 64, False, "streamed", 4, 16),
])
def test_long_row_plan_at_the_main_shapes(B, L, H, D, segmented, form, warps, splits):
    plan = A.long_row_plan(B, L, H, D, segmented, SMS)
    assert (plan.form, plan.warps, plan.splits) == (form, warps, splits)
    assert plan.smem_bytes == A.long_row_smem_bytes(L, D, warps, segmented, form == "resident")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [129, 144, 197, 255, 256, 257, 384, 385, 577, 800, 1024, 4096])
@pytest.mark.parametrize("pairs", [(1, 1), (1, 2), (8, 16), (64, 12), (256, 12)])
def test_long_row_plan_is_one_the_kernel_takes(pairs, L, D):
    """Every plan fits a CTA's shared memory and the kernel's launch bounds,
    gives every warp a query block in its first round, keeps K and V resident
    whenever they fit beside the fewest warps, and splits only where the
    (row, head) pairs leave at least half the SMs idle."""
    B, H = pairs
    rows = -(-L // 16) * 16
    for segmented in (False, True):
        plan = A.long_row_plan(B, L, H, D, segmented, SMS)
        assert plan.smem_bytes <= A.MAX_SMEM
        assert 1 <= plan.warps <= A.LONG_MAX_WARPS
        assert 1 <= plan.warps <= (rows // 16) // plan.splits
        fits = A.long_row_smem_bytes(L, D, A.LONG_MIN_WARPS, segmented, True) <= A.MAX_SMEM
        assert (plan.form == "resident") == fits
        if 2 * B * H > SMS:
            assert plan.splits == 1
        else:
            assert B * H * plan.splits <= SMS


def test_long_row_smem_holds_the_row():
    """K plus V of the whole row, rows padded to D + 8 values: 59,904 B at
    D=64, L=197; 113,152 B at D=128, L=197; 170,496 B at D=64, L=577; D=128
    at L=577 (322,048 B) does not fit a CTA and streams."""
    def kv(L, D):
        return A.long_row_smem_bytes(L, D, 0, False, True)
    assert (kv(197, 64), kv(197, 128), kv(577, 64), kv(577, 128)) == (59904, 113152, 170496, 322048)
    assert A.long_row_smem_bytes(197, 64, 7, True, True) == 59904 + 208 * 4 + 7 * 16 * 72 * 2
    assert A.long_row_smem_bytes(577, 128, 4, False, False) == (2 * 2 * 64 + 4 * 16) * 136 * 2


@pytest.mark.parametrize("D", [64, 128])
def test_long_row_plan_takes_any_length(D):
    """A row of any length runs: past the resident form's reach the streamed
    form keeps the seg ids of its ring's slots only, so its shared memory
    does not grow with L."""
    most = A.long_row_smem_bytes(4096, D, A.LONG_MAX_WARPS, True, False)
    assert most <= A.MAX_SMEM
    for L in (4096, 40_000, 1 << 20):
        plan = A.long_row_plan(1, L, 1, D, True, SMS)
        assert plan.form == "streamed" and plan.smem_bytes <= most
        assert A.long_row_smem_bytes(L, D, A.LONG_MAX_WARPS, True, False) == most


@pytest.mark.parametrize("L,D", [(128, 64), (77, 64), (197, 32)])
def test_long_row_plan_refuses_what_the_long_kernel_does_not_take(L, D):
    with pytest.raises(ValueError, match="long-row plan"):
        A.long_row_plan(8, L, 2, D, False, SMS)


def test_plan_sweep_tool_checks_every_plan_and_needs_the_card():
    """tools/long_row_plans.py holds each plan's output (the forward's out
    and lse2, the backward's dq, dk and dv) to the plain version with
    chip_smoke.py's bounds, and refuses to time anything without CUDA."""
    import torch

    from latteclip_torch.tools import long_row_plans as T

    ref_out = torch.randn(2, 197, 128).to(torch.bfloat16)
    ref_lse2 = torch.randn(2, 2, 197)
    assert T.agrees(ref_out, ref_lse2, ref_out, ref_lse2)
    assert not T.agrees(ref_out, ref_lse2 + 2e-3, ref_out, ref_lse2)
    dropped = ref_out.clone()
    dropped[:, 90:106] = 0
    assert not T.agrees(dropped, ref_lse2, ref_out, ref_lse2)
    ref_grad = torch.randn(2, 197, 3 * 128)
    assert T.grads_agree(ref_grad, ref_grad, 2, 64)
    wrong = ref_grad.clone()
    wrong[:, :, 128:144] = 0  # 16 columns of dk
    assert not T.grads_agree(wrong, ref_grad, 2, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.run()


# (B, L, H, D): ViT-B/16 vision at its GPU-test, train and eval batches, the
# 336 px row, head_dim 128, and the GPU tests' edges of the resident form
BWD_SHAPES = [
    (64, 197, 12, 64), (512, 197, 12, 64), (256, 197, 12, 64), (8, 577, 16, 64),
    (64, 197, 6, 128), (2, 129, 2, 64), (2, 256, 2, 128), (1, 208, 1, 128), (1, 209, 1, 128),
    (1, 208, 1, 64), (1, 209, 1, 64), (1, 384, 1, 64), (1, 385, 1, 64), (1, 1024, 2, 64),
]


@pytest.mark.parametrize("B,L,H,D", BWD_SHAPES)
@pytest.mark.parametrize("segmented", [False, True])
def test_bwd_long_row_plan_is_one_the_kernel_takes(B, L, H, D, segmented):
    """At D=64 the row takes the pair form (two CTAs an SM) exactly where its
    unpadded rows fit half an SM; at D=128 it stays resident in padded rows
    exactly where Q, K, V and dO of the whole row (with lse2, delta and
    segment ids) fit a CTA's shared memory, one warp per 16-token block up
    to 8; the tiled pair takes the rest, in 64-token tiles that always fit."""
    plan = A.bwd_long_row_plan(B, L, H, D, segmented, SMS)
    rows = -(-L // 16) * 16
    pair = D == 64 and A.bwd_row_smem_bytes(L, D, segmented, padded=False) <= A.BWD_PAIR_SMEM
    fits = D == 128 and A.bwd_row_smem_bytes(L, D, segmented) <= A.MAX_SMEM
    assert plan.smem_bytes <= A.MAX_SMEM
    assert plan.form == ("resident_pair" if pair else "resident" if fits else "tiled")
    if pair:
        assert plan.warps == A.BWD_ROW_WARPS and 2 * (plan.smem_bytes + 1024) <= A.SM_SMEM
        assert plan.smem_bytes == A.bwd_row_smem_bytes(L, D, segmented, padded=False)
    elif fits:
        assert plan.warps == min(rows // 16, A.BWD_ROW_WARPS)
        assert plan.smem_bytes == A.bwd_row_smem_bytes(L, D, segmented)
    else:
        assert plan.smem_bytes == A.bwd_tiled_smem_bytes(D, segmented)


@pytest.mark.parametrize("B,L,H,D,form,warps", [
    (64, 197, 12, 64, "resident_pair", 8),   # ViT-B/16 vision: two CTAs of 8 warps an SM
    (512, 197, 12, 64, "resident_pair", 8),  # its train batch
    (2, 256, 2, 64, "tiled", 4),             # past 208 tokens the D=64 row takes the tiled pair
    (64, 197, 6, 128, "resident", 8),     # head_dim 128: 8 warps walk 13 blocks
    (8, 577, 16, 64, "tiled", 4),         # 336 px: the row does not fit a CTA
    (1, 208, 1, 64, "resident_pair", 8),  # the forms' edges
    (1, 209, 1, 64, "tiled", 4),
    (1, 208, 1, 128, "resident", 8),
    (1, 209, 1, 128, "tiled", 4),
])
def test_bwd_long_row_plan_at_the_main_shapes(B, L, H, D, form, warps):
    plan = A.bwd_long_row_plan(B, L, H, D, True, SMS)
    assert (plan.form, plan.warps) == (form, warps)


def test_bwd_row_smem_holds_the_row():
    """Q, dO, K and V of 208 padded rows of D + 8 values, lse2 and delta, and
    the segment ids when segmented: 119,808 + 1,664 (+ 1,664) B at D=64;
    226,304 + 1,664 + 1,664 = 229,632 B at D=128, the most that fits."""
    assert A.bwd_row_smem_bytes(197, 64, False) == 4 * 208 * 72 * 2 + 208 * 8
    assert A.bwd_row_smem_bytes(197, 64, True) == 4 * 208 * 72 * 2 + 208 * 16
    assert A.bwd_row_smem_bytes(197, 128, True) == 229632
    assert A.bwd_tiled_smem_bytes(64, False) == 4 * 64 * 72 * 2 + 64 * 8
    assert A.bwd_row_smem_bytes(197, 64, True, padded=False) == 4 * 208 * 64 * 2 + 208 * 16
    assert 2 * (A.bwd_row_smem_bytes(208, 64, True, padded=False) + 1024) <= A.SM_SMEM
    assert 2 * (A.bwd_row_smem_bytes(209, 64, False, padded=False) + 1024) > A.SM_SMEM


@pytest.mark.parametrize("L,D", [(128, 64), (77, 64), (197, 32)])
def test_bwd_long_row_plan_refuses_what_the_long_rows_do_not_take(L, D):
    with pytest.raises(ValueError, match="backward long-row plan"):
        A.bwd_long_row_plan(8, L, 2, D, False, SMS)
