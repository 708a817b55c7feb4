"""The launch plans of rows of at most 128 tokens, on the CPU: the forward's
and the backward's short-row ring (csrc/flash_fwd.cu::flash_fwd_ring_kernel,
csrc/flash_bwd.cu::flash_bwd_ring_kernel: persistent CTAs, consumer
warpgroups of 64 query rows, a TMA ring of stages), their warp rings
(flash_fwd_warp_ring_kernel, flash_bwd_warp_ring_kernel: persistent CTAs,
one consumer warp per 16 rows, a TMA ring of stages; head_dim 64) or the
one-CTA-per-(row, head) form, at the shapes the towers and the GPU tests give
them, on a card of 132 SMs (an H100 SXM), and the warp rings'
producer/consumer protocols in a simulation. The kernels themselves run only
on the card (tests/test_torch_kernels_gpu.py)."""
import numpy as np
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
        for bwd, plan_of, smem_of in ((False, A.short_row_plan, A.short_row_smem_bytes),
                                      (True, A.bwd_short_row_plan, A.bwd_short_row_smem_bytes)):
            plan = plan_of(B, L, H, D, segmented, SMS)
            assert plan.form in ("ring", "warp_ring", "cta")
            if plan.form == "cta":
                assert plan.c_args(bwd) == ((0, 0) if bwd else (0, 0, 0))
                continue
            assert plan.grid == min(B * H, SMS * plan.ctas_per_sm)
            if plan.form == "warp_ring":
                assert D == 64 and (bwd or A.WARP_RING_MIN <= L <= A.WARP_RING_MAX)
                assert plan.stages <= A.WARP_RING_STAGES
                wr_smem = A.bwd_warp_ring_smem_bytes if bwd else A.warp_ring_smem_bytes
                _ring_fits(plan, lambda s: wr_smem(L, s, segmented))
                assert plan.warpgroups == 0 and plan.ctas_per_sm == A.warp_ring_ctas(L, bwd)
                assert plan.c_args(bwd) == ((plan.grid, A.BWD_WARP_RING_CODE + plan.stages) if bwd
                                            else (plan.grid, plan.stages, A.WARP_RING_CODE))
                continue
            _ring_fits(plan, lambda s: smem_of(L, D, s, segmented))
            assert plan.warpgroups == (1 if L <= 64 else 2)
            assert plan.c_args(bwd) == ((plan.grid, plan.stages) if bwd else (plan.grid, plan.stages, 0))
            if plan.ctas_per_sm > 1 and not bwd:
                assert plan.stages == 1  # several CTAs an SM overlap each other's copy-in


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", LENGTHS)
def test_the_one_cta_form_holds_its_lengths_and_few_backward_items(L, D):
    """The band of 65..96 tokens, forward and backward, where the warpgroup
    ring's second warpgroup would hold 32 tokens at most, and the backward's
    few-item cases (B * H items leave each SM at most one, and, at D=64
    beyond 64 tokens, at most four) leave the warpgroup ring: at head_dim 64
    for the warp ring, at 128 for the one-CTA form. Everywhere else the
    warpgroup ring."""
    band = A.WARP_RING_MIN <= L <= A.WARP_RING_MAX
    off_ring = "warp_ring" if D == 64 else "cta"
    assert A.short_row_plan(64, L, 8, D, False, SMS).form == (off_ring if band else "ring")
    bwd_band = band
    two_passes = D == 64 and L > 64
    assert A.bwd_short_row_plan(128, L, 8, D, False, SMS).form == (off_ring if bwd_band else "ring")  # 1024 items
    assert A.bwd_short_row_plan(16, L, 8, D, False, SMS).form == off_ring  # 128 items, 132 SMs
    assert A.bwd_short_row_plan(17, L, 8, D, False, SMS).form == (off_ring if bwd_band or two_passes else "ring")
    assert A.bwd_short_row_plan(66, L, 8, D, False, SMS).form == (off_ring if bwd_band or two_passes else "ring")
    assert A.bwd_short_row_plan(67, L, 8, D, False, SMS).form == (off_ring if bwd_band else "ring")  # 536 items


@pytest.mark.parametrize("B,L,H,D,segmented,fwd,bwd", [
    # (form, warpgroups, ctas_per_sm, stages, grid) of the forward and the backward
    (256, 100, 12, 64, True, ("ring", 2, 2, 1, 264), ("ring", 2, 2, 1, 264)),   # ViT-B/32 vision pairs
    (128, 100, 12, 64, True, ("ring", 2, 2, 1, 264), ("ring", 2, 2, 1, 264)),   # the eval's pairs
    (255, 50, 12, 64, False, ("ring", 1, 4, 1, 528), ("ring", 1, 2, 2, 264)),   # odd eval batch
    (336, 128, 8, 64, True, ("ring", 2, 2, 1, 264), ("ring", 2, 2, 1, 264)),    # packed captions
    (8, 128, 8, 64, True, ("ring", 2, 2, 1, 64), ("warp_ring", 0, 1, 2, 64)),   # packed templates
    (1000, 77, 8, 64, False, ("warp_ring", 0, 2, 2, 264), ("warp_ring", 0, 2, 2, 264)),  # classifier build
    (1024, 77, 8, 64, False, ("warp_ring", 0, 2, 2, 264), ("warp_ring", 0, 2, 2, 264)),  # padded captions
    (47, 77, 8, 64, False, ("warp_ring", 0, 2, 2, 264), ("warp_ring", 0, 2, 2, 264)),    # templates, FLYP
    (1000, 77, 10, 64, False, ("warp_ring", 0, 2, 2, 264), ("warp_ring", 0, 2, 2, 264)),  # 640-wide text
    (64, 128, 8, 64, True, ("ring", 2, 2, 1, 264), ("warp_ring", 0, 1, 2, 132)),  # few items an SM
    (512, 96, 8, 64, False, ("warp_ring", 0, 2, 2, 264), ("warp_ring", 0, 1, 2, 132)),  # the band's edge
    (512, 97, 8, 64, False, ("ring", 2, 2, 1, 264), ("ring", 2, 2, 1, 264)),
    (1000, 77, 8, 128, False, ("cta", 0, 0, 0, 0), ("cta", 0, 0, 0, 0)),       # head_dim 128 keeps one CTA
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


def test_warp_ring_smem_mirrors_the_kernels():
    """The forward warp ring's CTA: 1 KB to align, per stage Q, K and V of
    round16(L) rows of 128 B (30,720 B at 80 rows), the 16-row output tiles
    of its warps, the seg ids of each stage, two mbarriers a stage; two CTAs
    of two stages fit an SM at 96 rows (three would at 80: their registers
    were the limit there). The backward's: per stage
    Q, K, V, dO and out (51,200 B at 80 rows), lse2, delta and the seg ids,
    one 16-row staging tile a warp, three mbarriers a stage; two CTAs of two
    stages fit an SM at 80 rows (with seg ids 115,632 B of a 115,712 B
    share)."""
    assert A.warp_ring_smem_bytes(77, 2, False) == 1024 + 2 * 3 * 80 * 128 + 80 * 128 + 32
    assert A.warp_ring_smem_bytes(77, 2, True) == 1024 + 2 * 3 * 80 * 128 + 80 * 128 + 2 * 80 * 4 + 32
    assert A.warp_ring_smem_bytes(96, 1, False) == 1024 + 3 * 96 * 128 + 96 * 128 + 16
    assert A.bwd_warp_ring_smem_bytes(77, 2, False) == 1024 + 2 * 5 * 80 * 128 + 80 * 128 + 2 * 80 * 8 + 48
    assert A.bwd_warp_ring_smem_bytes(77, 2, True) == 115632
    share = A.SM_SMEM // 2 - A.CTA_RESERVED_SMEM
    assert share == 115712 and A.bwd_warp_ring_smem_bytes(80, 3, False) > share
    assert 2 * (A.warp_ring_smem_bytes(96, 2, True) + A.CTA_RESERVED_SMEM) <= A.SM_SMEM
    assert 3 * (A.warp_ring_smem_bytes(80, 2, True) + A.CTA_RESERVED_SMEM) <= A.SM_SMEM
    assert A.bwd_warp_ring_smem_bytes(128, 2, True) <= A.MAX_SMEM < A.bwd_warp_ring_smem_bytes(128, 3, True)


@pytest.mark.parametrize("B,H,L", [(1, 1, 77), (2, 3, 80), (1000, 8, 77), (7, 5, 96), (1, 200, 65)])
def test_warp_ring_grid_never_exceeds_the_items(B, H, L):
    """A warp ring launches one CTA per (row, head) item up to its CTAs an SM
    times the SMs, so small cases start no idle CTA; each CTA walks the items
    x, x + grid, ..., which wraps where the items exceed the grid."""
    for bwd in (False, True):
        plan = A.warp_ring_plan(B, L, H, False, SMS, bwd)
        assert plan.grid == min(B * H, SMS * plan.ctas_per_sm)
        walks = [list(range(x, B * H, plan.grid)) for x in range(plan.grid)]
        assert sorted(i for w in walks for i in w) == list(range(B * H)) and all(walks)


@pytest.mark.parametrize("L,D", [(0, 64), (129, 64), (100, 96), (197, 128)])
def test_short_row_plans_refuse_what_they_do_not_cover(L, D):
    for plan_of in (A.short_row_plan, A.bwd_short_row_plan):
        with pytest.raises(ValueError, match="short-row"):
            plan_of(4, L, 2, D, False, SMS)


# -- the warp rings' producer/consumer protocols, simulated ------------------
# Models of csrc/flash_fwd.cu's and csrc/flash_bwd.cu's warp rings, statement
# for statement, with the barrier, slot and scheduler models of
# tests/test_torch_long_row_plan.py: random interleavings, TMA copies landing
# at random later steps, and a failure on a deadlock, on a wait that
# succeeds for another phase than its agent means, on a copy into a slot not
# yet released by every consumer warp, and on a read of a slot that does not
# hold what its reader expects.

from test_torch_long_row_plan import _Barrier, _run, _slot_order_ok, _Slots, _wait  # noqa: E402


def _fwd_warp_ring(mine, stages, warps, rng):
    """One CTA of flash_fwd_warp_ring_kernel over its items `mine`: the
    producer waits for a slot's release from the item `stages` back, fills it
    (full: one arrival and the copy's bytes); each consumer warp waits for
    full, reads, and releases (empty: one arrival a warp)."""
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(warps) for _ in range(stages)]
    slots, copies = _Slots(stages, warps), []

    def producer():
        for n, item in enumerate(mine):
            s = n % stages
            if n >= stages:
                yield _wait(empty[s], (n // stages - 1) & 1, n // stages - 1)
            slots.fill(s, item)
            full[s].expect_tx(3 * 80 * 128)
            copies.append((full[s], 3 * 80 * 128, slots, s))

    def consumer(w):
        for n, item in enumerate(mine):
            s = n % stages
            yield _wait(full[s], (n // stages) & 1, n // stages)
            slots.read(s, item)
            slots.release(s, item)
            empty[s].arrive()

    _run([producer()] + [consumer(w) for w in range(warps)], rng, copies)
    return slots.log


def _bwd_warp_ring(mine, stages, warps, rng, finish_first=False):
    """One CTA of flash_bwd_warp_ring_kernel over its items `mine`: the
    producer's issue(n) waits for the slot's release from item n - stages,
    fills it and expects its bytes on `loaded`; finish(n) waits for `loaded`,
    reads the landed tiles (delta) and arrives on `full`; the producer issues
    the first `stages` items, finishes item 0, then per item n finishes n + 1
    and issues n + stages (with one stage: issues n + 1, then finishes it).
    Each consumer warp waits for full, reads and releases. With
    `finish_first` the producer takes the two-stage order at any stage count,
    the fault the simulation must find at one stage."""
    loaded = [_Barrier(1) for _ in range(stages)]
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(warps) for _ in range(stages)]
    slots, copies = _Slots(stages, warps), []
    count = len(mine)

    def issue(n):
        s = n % stages
        if n >= stages:
            yield _wait(empty[s], (n // stages - 1) & 1, n // stages - 1)
        slots.fill(s, mine[n])
        loaded[s].expect_tx(5 * 80 * 128)
        copies.append((loaded[s], 5 * 80 * 128, slots, s))

    def finish(n):
        s = n % stages
        yield _wait(loaded[s], (n // stages) & 1, n // stages)
        assert slots.tag[s] == mine[n] and slots.landed[s], f"delta of {mine[n]} from slot {s}"
        full[s].arrive()

    def producer():
        for n in range(min(stages, count)):
            yield from issue(n)
        if count:
            yield from finish(0)
        for n in range(count - 1):
            if stages > 1 or finish_first:
                yield from finish(n + 1)
                if n + stages < count:
                    yield from issue(n + stages)
            else:
                yield from issue(n + 1)
                yield from finish(n + 1)

    def consumer(w):
        for n, item in enumerate(mine):
            s = n % stages
            yield _wait(full[s], (n // stages) & 1, n // stages)
            slots.read(s, item)
            slots.release(s, item)
            empty[s].arrive()

    _run([producer()] + [consumer(w) for w in range(warps)], rng, copies)
    return slots.log


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("items,grid", [(1, 1), (5, 2), (7, 3), (12, 4), (3, 5), (9, 9)])
def test_warp_ring_protocol_never_deadlocks(bwd, stages, items, grid):
    """Each CTA of a grid that wraps the items, does not divide them or
    exceeds them, at 1-4 stages and five consumer warps: every wait is for
    the phase its agent means, each fill is read and released by every
    consumer warp before the next, no agent waits forever, and the CTAs
    together visit each item once."""
    rng = np.random.default_rng(1000 * stages + 10 * items + grid + bwd)
    ring = _bwd_warp_ring if bwd else _fwd_warp_ring
    seen = []
    for cta in range(grid):
        mine = list(range(cta, items, grid))
        for _ in range(5):
            log = ring(mine, stages, 5, rng)
            for slot in log:
                _slot_order_ok(slot, 5, 5)
            assert sorted(tag for slot in log for what, tag in slot if what == "fill") == mine
        seen += mine
    assert sorted(seen) == list(range(items))


def test_warp_ring_simulation_finds_a_producer_that_finishes_before_issuing():
    """The control: a backward producer with one stage that waits for item
    n + 1's copy (to take its delta) before issuing it deadlocks, and the
    simulation says so; in the kernel's order the same run completes."""
    rng = np.random.default_rng(0)
    _bwd_warp_ring(list(range(3)), 1, 5, rng)
    with pytest.raises(AssertionError, match="deadlock"):
        _bwd_warp_ring(list(range(3)), 1, 5, rng, finish_first=True)
