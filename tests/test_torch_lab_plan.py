"""The lab kernels' launch plans, on the CPU: the lab forward's ring
(csrc/lab.cu::lab_fwd_ring_kernel) or its one-CTA-per-(b, h) form, the lab
backward's ring (lab_bwd_ring_kernel) or its one-CTA form, and the
head-summed Q K^T's and P V's rings (lab_qk_ring_kernel, lab_pv_ring_kernel)
or their one-CTA-per-row forms, at the lab tools' shapes and at the edges of
each form, on a card of 132 SMs (an H100 SXM). The plans read the shape
only, so the two entry points of each kernel (packed and BHLD, natural and
pret) launch with the same plan, and each wrapper launches with its plan:
the wrappers' launch arguments are captured to show it. The kernels
themselves run only on the card (tests/test_torch_kernels_gpu.py)."""
import pytest
import torch

from latteclip_torch.kernels import lab as LB
from latteclip_torch.tools import lab_plans

SMS = 132


def _fits(plan, smem_of, min_stages, max_stages, max_ctas):
    """A ring plan's CTA fits a CTA's shared memory, ctas_per_sm of them fit
    an SM's, one more would not (or the registers allow no more), and its
    stages are the most that fit."""
    assert plan.form == "ring"
    assert plan.smem_bytes == smem_of(plan.stages) <= LB.MAX_SMEM
    assert plan.ctas_per_sm * (plan.smem_bytes + LB.CTA_RESERVED_SMEM) <= LB.SM_SMEM
    more = plan.ctas_per_sm + 1
    assert more > max_ctas or more * (smem_of(min_stages) + LB.CTA_RESERVED_SMEM) > LB.SM_SMEM
    assert min_stages <= plan.stages <= max_stages
    budget = min(LB.MAX_SMEM, LB.SM_SMEM // plan.ctas_per_sm - LB.CTA_RESERVED_SMEM)
    assert plan.stages == max_stages or smem_of(plan.stages + 1) > budget
    assert plan.c_args() == (plan.grid, plan.stages)


@pytest.mark.parametrize("L", [1, 16, 50, 64, 65, 77, 127, 128])
@pytest.mark.parametrize("B,HD", [(1, 64), (3, 128), (300, 512), (1024, 512), (64, 256)])
def test_qk_plans_are_ones_the_ring_takes(B, HD, L):
    plan = LB.lab_qk_plan(B, L, HD, SMS)
    _fits(plan, lambda s: LB.lab_qk_smem_bytes(L, s), LB.QK_MIN_STAGES, LB.QK_MAX_STAGES, 2)
    assert plan.warpgroups == (1 if L <= 64 else 2)
    assert plan.grid == min(B, SMS * plan.ctas_per_sm) <= B


@pytest.mark.parametrize("L,want", [
    # (form, warpgroups, ctas_per_sm, stages) at the tool's [1024, L, 8 x 64]
    (1, ("ring", 1, 2, 6)),
    (16, ("ring", 1, 2, 6)),
    (77, ("ring", 2, 2, 2)),
    (128, ("ring", 2, 1, 3)),
])
def test_qk_plan_at_its_form_boundaries(L, want):
    p = LB.lab_qk_plan(1024, L, 512, SMS)
    assert (p.form, p.warpgroups, p.ctas_per_sm, p.stages) == want
    assert p.grid == SMS * p.ctas_per_sm


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 16, 50, 64, 65, 77, 128, 129, 197, 256, 257])
@pytest.mark.parametrize("B,H", [(1, 1), (3, 2), (512, 12), (64, 6)])
def test_fwd_plans_are_ones_the_kernels_take(B, H, L, D):
    plan = LB.lab_fwd_plan(B, L, H, D, SMS)
    if L > LB.FWD_RING_MAX_LEN:
        assert plan == LB.CTA_PLAN and plan.c_args() == (0, 0)
        return
    _fits(plan, lambda s: LB.lab_fwd_smem_bytes(L, D, s), 1, LB.RING_MAX_STAGES, LB.fwd_max_ctas(L, D))
    kb = -(-L // 64)
    assert plan.warpgroups == (1 if kb % 2 else 2)
    assert plan.ctas_per_sm <= LB.fwd_max_ctas(L, D)
    assert plan.grid == min(B * H, SMS * plan.ctas_per_sm) <= B * H


@pytest.mark.parametrize("L,D,want", [
    # (form, warpgroups, ctas_per_sm, stages) at [512, L, H x D]
    (1, 64, ("ring", 1, 4, 1)),
    (50, 64, ("ring", 1, 4, 1)),
    (77, 64, ("ring", 2, 2, 1)),
    (129, 64, ("ring", 1, 2, 1)),    # two CTAs of one stage beat one of three
    (197, 64, ("ring", 2, 1, 2)),    # the lab tool's shape
    (256, 64, ("ring", 2, 1, 2)),
    (257, 64, ("cta", 0, 0, 0)),     # beyond the registers' row
    (50, 128, ("ring", 1, 2, 1)),
    (77, 128, ("ring", 2, 1, 2)),
    (197, 128, ("ring", 2, 1, 1)),
    (256, 128, ("ring", 2, 1, 1)),
    (257, 128, ("cta", 0, 0, 0)),
])
def test_fwd_plan_at_its_form_boundaries(L, D, want):
    p = LB.lab_fwd_plan(512, L, 768 // D, D, SMS)
    assert (p.form, p.warpgroups, p.ctas_per_sm, p.stages) == want


def test_ring_smem_holds_the_stages():
    """Forward: per stage Q, K and V of one (b, h) in boxes of 64 rows a
    64-key block (16 KB a tile at D=64 and 128 tokens) and 16 B of mbarrier
    and count; a 64 x D output tile a warpgroup; 1 KB to align. Q K^T: per
    stage a q and a k tile of 64 rows a warpgroup and a flat 64 x L chunk of
    kT; S of one batch row (L x L f32 + 16 B)."""
    assert LB.lab_fwd_smem_bytes(128, 64, 2) == 1024 + 2 * 3 * 16384 + 2 * 8192 + 32
    assert LB.lab_fwd_smem_bytes(197, 64, 2) == 1024 + 2 * 3 * 32768 + 2 * 8192 + 32
    assert LB.lab_fwd_smem_bytes(50, 128, 1) == 1024 + 3 * 16384 + 16384 + 16
    assert LB.lab_qk_smem_bytes(77, 2) == 1024 + 2 * (2 * 16384 + 128 * 77) + 23728 + 16 + 32
    assert LB.lab_qk_smem_bytes(50, 1) == 1024 + 2 * 8192 + 6400 + 10000 + 16 + 16
    # two stages of 256 tokens do not fit a CTA at D=128
    assert LB.lab_fwd_smem_bytes(256, 128, 2) > LB.MAX_SMEM


@pytest.mark.parametrize("L,HD", [(0, 512), (129, 512), (77, 96), (77, 0)])
def test_qk_plan_refuses_what_the_kernels_do_not_take(L, HD):
    with pytest.raises(ValueError, match="Q K"):
        LB.lab_qk_plan(4, L, HD, SMS)


@pytest.mark.parametrize("L,D", [(0, 64), (50, 96), (197, 32)])
def test_fwd_plan_refuses_what_the_kernels_do_not_take(L, D):
    with pytest.raises(ValueError, match="head_dim|L >= 1"):
        LB.lab_fwd_plan(4, L, 2, D, SMS)


def _captured_launches(monkeypatch):
    """Run the wrappers' CUDA route on CPU tensors up to the launch, with
    the tensor check passed and the launch recorded instead of made."""
    calls = []
    monkeypatch.setattr(LB, "_check", lambda *a, **k: None)
    monkeypatch.setattr(LB, "sm_count", lambda index: SMS)
    monkeypatch.setattr(LB, "_launch", lambda name, counter, tensors, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("B,L,H,D", [(512, 197, 12, 64), (4, 50, 2, 64), (3, 257, 2, 128), (2, 77, 2, 128)])
def test_packed_and_bhld_launch_with_one_plan(monkeypatch, B, L, H, D):
    calls = _captured_launches(monkeypatch)
    x = torch.empty(0)
    LB._fwd("latteclip_lab_fwd_packed", x, x, x, B, L, H, D, (0,), (0,))
    LB._fwd("latteclip_lab_fwd_bhld", x, x, x, B, L, H, D, (0,), (0,))
    (n1, a1), (n2, a2) = calls
    assert (n1, n2) == ("latteclip_lab_fwd_packed", "latteclip_lab_fwd_bhld")
    assert a1 == a2 == (B, L, H, D, D ** -0.5, *LB.lab_fwd_plan(B, L, H, D, SMS).c_args())


@pytest.mark.parametrize("B,L,H,D", [(1024, 77, 8, 64), (4, 77, 2, 64), (3, 1, 2, 128), (5, 128, 2, 64)])
def test_natural_and_pret_launch_with_one_plan(monkeypatch, B, L, H, D):
    calls = _captured_launches(monkeypatch)
    q = torch.empty(B, L, H * D)
    LB._qk("latteclip_lab_qk_natural", q, q, lambda *s: s, H)
    LB._qk("latteclip_lab_qk_pret", q, q, lambda *s: s, H)
    (n1, a1), (n2, a2) = calls
    assert (n1, n2) == ("latteclip_lab_qk_natural", "latteclip_lab_qk_pret")
    assert a1 == a2 == (B, L, H * D, *LB.lab_qk_plan(B, L, H * D, SMS).c_args())


@pytest.mark.parametrize("shape", list(lab_plans.FWD_SHAPES) + [(3, 1, 2, 64), (2, 300, 2, 128)])
def test_the_fwd_sweep_takes_the_plans_own_form(shape):
    """latteclip_torch.tools.lab_plans times every form the lab forward's
    entry point takes at a shape; the plan's own form is always among them."""
    B, L, H, D = shape
    plan = LB.lab_fwd_plan(B, L, H, D, SMS)
    forms = {"cta": (0, 0)}
    if L <= LB.FWD_RING_MAX_LEN:
        forms.update(lab_plans.ring_forms(B * H, SMS, LB.fwd_max_ctas(L, D), 1, LB.RING_MAX_STAGES,
                                          lambda s: LB.lab_fwd_smem_bytes(L, D, s)))
    assert forms[lab_plans.label(plan)] == plan.c_args()


@pytest.mark.parametrize("shape", lab_plans.QK_SHAPES)
def test_the_qk_sweep_takes_the_plans_own_form(shape):
    B, L, H, D = shape
    plan = LB.lab_qk_plan(B, L, H * D, SMS)
    forms = lab_plans.ring_forms(B, SMS, 2, LB.QK_MIN_STAGES, LB.QK_MAX_STAGES,
                                 lambda s: LB.lab_qk_smem_bytes(L, s))
    assert forms[lab_plans.label(plan)] == plan.c_args()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [16, 50, 77, 129, 197, 256])
@pytest.mark.parametrize("B,H", [(1, 1), (3, 2), (512, 12), (64, 6)])
def test_bwd_plans_are_ones_the_kernels_take(B, H, L, D):
    """The backward ring takes head_dim 64 up to 208 tokens, one CTA an SM,
    the most resident items that fit (at most two) and a grid of
    min(B * H, SMs); everything else takes the one-CTA form, whose row must
    fit a CTA's shared memory (the wrapper refuses a row that does not: 256
    tokens at head_dim 128)."""
    plan = LB.lab_bwd_plan(B, L, H, D, SMS)
    if D != 64 or L > LB.BWD_RING_MAX_LEN:
        assert plan == LB.CTA_PLAN and plan.c_args() == (0, 0)
        rows = (L + 15) // 16 * 16
        if 4 * rows * (D + 8) * 2 + 8 * rows <= LB.MAX_SMEM:
            LB._check_row_fits(L, D, 4, extra=8)
        else:
            assert (L, D) == (256, 128)
            with pytest.raises(ValueError, match="shared memory"):
                LB._check_row_fits(L, D, 4, extra=8)
        return
    assert (plan.form, plan.warpgroups, plan.ctas_per_sm) == ("ring", 2, 1)
    assert plan.smem_bytes == LB.lab_bwd_smem_bytes(L, plan.stages) <= LB.MAX_SMEM
    assert 1 <= plan.stages <= LB.BWD_RING_MAX_STAGES
    assert plan.stages == LB.BWD_RING_MAX_STAGES or LB.lab_bwd_smem_bytes(L, plan.stages + 1) > LB.MAX_SMEM
    assert plan.grid == min(B * H, SMS) <= B * H
    assert plan.c_args() == (plan.grid, plan.stages)


@pytest.mark.parametrize("L,D,want", [
    # (form, warpgroups, ctas_per_sm, stages) at [512, L, H x D]
    (16, 64, ("ring", 2, 1, 2)),
    (64, 64, ("ring", 2, 1, 2)),      # one 64-row block: tiles of 64 rows
    (65, 64, ("ring", 2, 1, 2)),
    (144, 64, ("ring", 2, 1, 2)),     # the longest row of which two items fit
    (145, 64, ("ring", 2, 1, 1)),
    (197, 64, ("ring", 2, 1, 1)),     # the lab tool's shape
    (208, 64, ("ring", 2, 1, 1)),     # the longest row whose item and ds fit
    (209, 64, ("cta", 0, 0, 0)),
    (50, 128, ("cta", 0, 0, 0)),      # head_dim 128: the ring takes 64 only
    (197, 128, ("cta", 0, 0, 0)),
])
def test_bwd_plan_at_its_form_boundaries(L, D, want):
    p = LB.lab_bwd_plan(512, L, 768 // D, D, SMS)
    assert (p.form, p.warpgroups, p.ctas_per_sm, p.stages) == want


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 16, 50, 77, 127, 128])
@pytest.mark.parametrize("B,H", [(1, 1), (3, 2), (1024, 8), (64, 4)])
def test_pv_plans_are_ones_the_ring_takes(B, H, L, D):
    """The P V ring: one warpgroup up to 64 tokens, two beyond; two CTAs an
    SM at head_dim 64 where two stages fit each (one at 128); the fewest
    stages that keep PV_INFLIGHT_BYTES of v in flight an SM, as many as fit
    up to that; a grid of min(B, SMs * CTAs an SM)."""
    plan = LB.lab_pv_plan(B, L, H, D, SMS)
    smem_of = lambda s: LB.lab_pv_smem_bytes(L, H * D, s)  # noqa: E731
    assert plan.form == "ring" and plan.warpgroups == (1 if L <= 64 else 2)
    assert plan.smem_bytes == smem_of(plan.stages) <= LB.MAX_SMEM
    assert plan.ctas_per_sm * (plan.smem_bytes + LB.CTA_RESERVED_SMEM) <= LB.SM_SMEM
    assert plan.ctas_per_sm == (2 if D == 64 and 2 * (smem_of(2) + LB.CTA_RESERVED_SMEM) <= LB.SM_SMEM else 1)
    assert LB.PV_MIN_STAGES <= plan.stages <= LB.PV_MAX_STAGES
    in_flight = plan.ctas_per_sm * plan.stages * 32 * H * D
    fewer = plan.ctas_per_sm * (plan.stages - 1) * 32 * H * D
    assert plan.stages == LB.PV_MIN_STAGES or fewer < LB.PV_INFLIGHT_BYTES
    budget = min(LB.MAX_SMEM, LB.SM_SMEM // plan.ctas_per_sm - LB.CTA_RESERVED_SMEM)
    assert (in_flight >= LB.PV_INFLIGHT_BYTES or plan.stages == LB.PV_MAX_STAGES
            or smem_of(plan.stages + 1) > budget)
    assert plan.grid == min(B, SMS * plan.ctas_per_sm) <= B
    assert plan.c_args() == (plan.grid, plan.stages)


@pytest.mark.parametrize("L,H,D,want", [
    # (form, warpgroups, ctas_per_sm, stages) at [1024, L, H x D]
    (1, 8, 64, ("ring", 1, 2, 2)),      # one token: one partial 16-key step
    (16, 8, 64, ("ring", 1, 2, 2)),     # one whole 16-key step
    (64, 8, 64, ("ring", 1, 2, 2)),
    (65, 8, 64, ("ring", 2, 2, 2)),
    (77, 8, 64, ("ring", 2, 2, 2)),     # the probe's shape: 64 KB of v in flight an SM
    (128, 8, 64, ("ring", 2, 1, 4)),    # three p slots of 32 KB: one CTA an SM
    (77, 4, 128, ("ring", 2, 1, 4)),    # head_dim 128: one CTA an SM
    (77, 2, 64, ("ring", 2, 2, 8)),     # a narrow row: the most stages
])
def test_pv_plan_at_its_form_boundaries(L, H, D, want):
    p = LB.lab_pv_plan(1024, L, H, D, SMS)
    assert (p.form, p.warpgroups, p.ctas_per_sm, p.stages) == want
    assert p.grid == SMS * p.ctas_per_sm


def test_bwd_and_pv_ring_smem_holds_their_stages():
    """Backward: per resident item Q, dO, V and K, and ds, a panel a 64-key
    block, each round16(L) rows (64 up to 64 tokens) x 128 B; two 64 x 64
    bf16 output tiles; lse2 and delta (8 B a row); 16 B of mbarrier and
    count an item; 1 KB to align. P V: per stage 16 token rows of every head
    (32 HD bytes), three p slots of 2 L^2 + 28 bytes rounded to 16, 16 B of
    mbarriers a stage and a p slot."""
    assert LB.lab_bwd_smem_bytes(197, 1) == 1024 + 8 * 208 * 128 + 16384 + 8 * 208 + 16 == 232080
    assert LB.lab_bwd_smem_bytes(77, 2) == 1024 + 10 * 80 * 128 + 16384 + 8 * 80 + 32
    assert LB.lab_bwd_smem_bytes(50, 1) == 1024 + 5 * 64 * 128 + 16384 + 8 * 64 + 16
    assert LB.lab_bwd_smem_bytes(208, 1) <= LB.MAX_SMEM < LB.lab_bwd_smem_bytes(209, 1)
    assert LB.lab_bwd_smem_bytes(144, 2) <= LB.MAX_SMEM < LB.lab_bwd_smem_bytes(145, 2)
    assert LB.pv_p_bytes(77) == 11888
    assert LB.lab_pv_smem_bytes(77, 512, 2) == 1024 + 2 * 16384 + 3 * 11888 + 16 * 5
    assert LB.lab_pv_smem_bytes(1, 128, 8) == 1024 + 8 * 4096 + 3 * 32 + 16 * 11


@pytest.mark.parametrize("L,D", [(0, 64), (50, 96), (197, 32)])
def test_bwd_plan_refuses_what_the_kernels_do_not_take(L, D):
    with pytest.raises(ValueError, match="head_dim|L >= 1"):
        LB.lab_bwd_plan(4, L, 2, D, SMS)


@pytest.mark.parametrize("L,H,D", [(0, 8, 64), (129, 8, 64), (77, 0, 64), (77, 8, 96)])
def test_pv_plan_refuses_what_the_kernels_do_not_take(L, H, D):
    with pytest.raises(ValueError, match="P V|head_dim"):
        LB.lab_pv_plan(4, L, H, D, SMS)


def test_pv_plan_keeps_the_one_cta_form_where_two_stages_do_not_fit():
    """128 heads of 64: a 16-key step of v is 256 KB, more than a CTA holds."""
    assert LB.lab_pv_plan(4, 77, 128, 64, SMS) == LB.CTA_PLAN


@pytest.mark.parametrize("B,L,H,D", [(512, 197, 12, 64), (4, 50, 2, 64), (3, 77, 2, 128), (2, 300, 2, 64)])
def test_the_bwd_wrapper_launches_with_its_plan(monkeypatch, B, L, H, D):
    calls = _captured_launches(monkeypatch)
    xb = torch.empty((B, H, L, D), device="meta")
    LB.lab_bwd_bhld(xb, xb, xb, xb, torch.empty((H, B, L), device="meta"))
    ((name, args),) = calls
    assert name == "latteclip_lab_bwd_bhld"
    assert args == (B, L, H, D, D ** -0.5, *LB.lab_bwd_plan(B, L, H, D, SMS).c_args())


@pytest.mark.parametrize("B,L,H,D", [(1024, 77, 8, 64), (4, 77, 2, 64), (9, 1, 2, 128), (3, 127, 8, 64)])
def test_the_pv_wrapper_launches_with_its_plan(monkeypatch, B, L, H, D):
    calls = _captured_launches(monkeypatch)
    LB.pv_heads(torch.empty((B, L, L), device="meta"), torch.empty((B, L, H * D), device="meta"), H)
    ((name, args),) = calls
    assert name == "latteclip_lab_pv"
    assert args == (B, L, H, D, *LB.lab_pv_plan(B, L, H, D, SMS).c_args())


@pytest.mark.parametrize("shape", list(lab_plans.BWD_SHAPES) + [(3, 16, 2, 64), (2, 256, 2, 64)])
def test_the_bwd_sweep_takes_the_plans_own_form(shape):
    plan = LB.lab_bwd_plan(*shape, SMS)
    assert lab_plans.bwd_forms(*shape, SMS)[lab_plans.label(plan)] == plan.c_args()


@pytest.mark.parametrize("shape", list(lab_plans.PV_SHAPES) + [(3, 128, 2, 128), (9, 1, 1, 64)])
def test_the_pv_sweep_takes_the_plans_own_form(shape):
    plan = LB.lab_pv_plan(*shape, SMS)
    assert lab_plans.pv_forms(*shape, SMS)[lab_plans.label(plan)] == plan.c_args()
