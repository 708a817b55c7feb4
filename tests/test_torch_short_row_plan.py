"""The launch plans of rows of at most 128 tokens, on the CPU: the forward's
and the backward's short-row ring (csrc/flash_fwd.cu::flash_fwd_ring_kernel,
csrc/flash_bwd.cu::flash_bwd_ring_kernel: persistent CTAs, consumer
warpgroups of 64 query rows, a TMA ring of stages) or the one-CTA-per-(row,
head) form, at the shapes the towers and the GPU tests give them, on a card
of 132 SMs (an H100 SXM). The kernels themselves run only on the card
(tests/test_torch_kernels_gpu.py)."""
import pytest

from latteclip_torch.kernels import attention as A

SMS = 132
LENGTHS = [1, 2, 16, 50, 64, 65, 77, 80, 81, 96, 97, 100, 128]


def _ring_fits(plan, smem_of):
    """The plan's CTA fits a CTA's shared memory, ctas_per_sm of them fit an
    SM's, and its stages are the most that do (at most RING_MAX_STAGES)."""
    per_cta = plan.smem_bytes + A.CTA_RESERVED_SMEM
    assert plan.smem_bytes == smem_of(plan.stages)
    assert plan.smem_bytes <= A.MAX_SMEM
    assert plan.ctas_per_sm * per_cta <= A.SM_SMEM
    assert 1 <= plan.stages <= A.RING_MAX_STAGES


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("pairs", [(1, 1), (2, 3), (8, 8), (255, 12), (1000, 8)])
def test_short_row_plans_are_ones_the_kernels_take(pairs, L, D):
    B, H = pairs
    for segmented in (False, True):
        for plan_of, smem_of in ((A.short_row_plan, A.short_row_smem_bytes),
                                 (A.bwd_short_row_plan, A.bwd_short_row_smem_bytes)):
            plan = plan_of(B, L, H, D, segmented, SMS)
            assert plan.form in ("ring", "cta")
            if plan.form == "cta":
                assert plan.c_args() == (0, 0)
                continue
            _ring_fits(plan, lambda s: smem_of(L, D, s, segmented))
            assert plan.warpgroups == (1 if L <= 64 else 2)
            assert plan.grid == min(B * H, SMS * plan.ctas_per_sm)
            assert plan.c_args() == (plan.grid, plan.stages)
            if plan.ctas_per_sm > 1 and plan_of is A.short_row_plan:
                assert plan.stages == 1  # several CTAs an SM overlap each other's copy-in


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", LENGTHS)
def test_the_one_cta_form_holds_its_lengths_and_few_backward_items(L, D):
    """The ring everywhere but at 65..96 tokens in the forward and 65..80 in
    the backward, whose second warpgroup would hold 32 (16) tokens at most;
    the backward also where B * H items leave each SM at most one, and, at
    D=64 beyond 64 tokens (two passes over the queries), at most four."""
    assert (A.short_row_plan(64, L, 8, D, False, SMS).form == "cta") == (
        A.CTA_FORM_MIN <= L <= A.CTA_FORM_MAX)
    cta = A.CTA_FORM_MIN <= L <= A.BWD_CTA_FORM_MAX
    two_passes = D == 64 and L > 64
    assert (A.bwd_short_row_plan(128, L, 8, D, False, SMS).form == "cta") == cta  # 1024 items
    assert A.bwd_short_row_plan(16, L, 8, D, False, SMS).form == "cta"  # 128 items, 132 SMs
    assert A.bwd_short_row_plan(17, L, 8, D, False, SMS).form == ("cta" if cta or two_passes else "ring")
    assert A.bwd_short_row_plan(66, L, 8, D, False, SMS).form == ("cta" if cta or two_passes else "ring")
    assert A.bwd_short_row_plan(67, L, 8, D, False, SMS).form == ("cta" if cta else "ring")  # 536 items


@pytest.mark.parametrize("B,L,H,D,segmented,fwd,bwd", [
    # (form, warpgroups, ctas_per_sm, stages, grid) of the forward and the backward
    (256, 100, 12, 64, True, ("ring", 2, 2, 1, 264), ("ring", 2, 2, 1, 264)),   # ViT-B/32 vision pairs
    (128, 100, 12, 64, True, ("ring", 2, 2, 1, 264), ("ring", 2, 2, 1, 264)),   # the eval's pairs
    (255, 50, 12, 64, False, ("ring", 1, 4, 1, 528), ("ring", 1, 2, 2, 264)),   # odd eval batch
    (336, 128, 8, 64, True, ("ring", 2, 2, 1, 264), ("ring", 2, 2, 1, 264)),    # packed captions
    (8, 128, 8, 64, True, ("ring", 2, 2, 1, 64), ("cta", 0, 0, 0, 0)),          # packed templates
    (1000, 77, 8, 64, False, ("cta", 0, 0, 0, 0), ("cta", 0, 0, 0, 0)),         # classifier build
    (1024, 77, 8, 64, False, ("cta", 0, 0, 0, 0), ("cta", 0, 0, 0, 0)),         # padded captions
    (64, 100, 6, 128, True, ("ring", 2, 1, 2, 132), ("ring", 2, 1, 1, 132)),    # head_dim 128
    (64, 50, 6, 128, False, ("ring", 1, 2, 1, 264), ("ring", 1, 2, 1, 264)),
])
def test_short_row_plan_at_the_main_shapes(B, L, H, D, segmented, fwd, bwd):
    for plan_of, want in ((A.short_row_plan, fwd), (A.bwd_short_row_plan, bwd)):
        p = plan_of(B, L, H, D, segmented, SMS)
        assert (p.form, p.warpgroups, p.ctas_per_sm, p.stages, p.grid) == want


def test_short_row_smem_holds_the_stages():
    """Per stage, the forward holds Q, K and V of one (row, head) in boxes of
    64 token rows a warpgroup (16,384 B a tile at D=64 and two warpgroups),
    the backward those and dO and out; plus the seg ids (and, backward, lse2
    and delta) of the box's tokens, 16 B of mbarriers, and 1 KB to align."""
    assert A.short_row_smem_bytes(100, 64, 1, False) == 1024 + 3 * 16384 + 16
    assert A.short_row_smem_bytes(100, 64, 1, True) == 1024 + 3 * 16384 + 512 + 16
    assert A.short_row_smem_bytes(50, 128, 2, False) == 1024 + 2 * 3 * 16384 + 32
    assert A.bwd_short_row_smem_bytes(100, 64, 2, False) == 1024 + 2 * (5 * 16384 + 1024) + 32
    assert A.bwd_short_row_smem_bytes(100, 128, 1, True) == 1024 + 5 * 32768 + 1536 + 16
    # two backward stages of 128 tokens do not fit a CTA at D=128
    assert A.bwd_short_row_smem_bytes(128, 128, 2, False) > A.MAX_SMEM


@pytest.mark.parametrize("L,D", [(0, 64), (129, 64), (100, 96), (197, 128)])
def test_short_row_plans_refuse_what_they_do_not_cover(L, D):
    for plan_of in (A.short_row_plan, A.bwd_short_row_plan):
        with pytest.raises(ValueError, match="short-row"):
            plan_of(4, L, 2, D, False, SMS)
