"""The launch plans of rows of more than 128 tokens, on the CPU: the
forward's rings at head_dim 64 (csrc/flash_fwd.cu: the row ring up to 272
tokens, the stream ring beyond; their grids, slots and shared memory) and
its long-row kernel at head_dim 128 (flash_fwd_long_kernel: K and V
resident in shared memory or streamed through a ring, the warps of a CTA
and the CTAs per (row, head)), the backward's (csrc/flash_bwd.cu: the row
resident in shared memory, the streamed pair or the tiled pair, the warps of
a CTA, the streamed pair's grid), and the rings' producer/consumer
protocols in a simulation, at the shapes the towers and the GPU tests give
them, on a card of 132 SMs (an H100 SXM). The kernels themselves run only on
the card (tests/test_torch_kernels_gpu.py)."""
import numpy as np
import pytest

from latteclip_torch.kernels import attention as A

SMS = 132


@pytest.mark.parametrize("B,L,H,D,segmented,form,warps,splits", [
    (64, 197, 12, 64, False, "row_ring", 132, 2),    # ViT-B/16 vision: (grid, slots) of the row ring
    (256, 197, 12, 64, False, "row_ring", 132, 2),   # the ViT-B/16 eval batch
    (64, 197, 12, 64, True, "row_ring", 132, 2),     # segment ids read from device memory
    (64, 197, 6, 128, False, "resident", 13, 1),     # head_dim 128: the long-row kernel, one CTA an SM
    (8, 577, 16, 64, False, "stream_ring", 132, 5),  # 336 px: five slots of 128 keys
    (1, 384, 1, 128, False, "resident", 4, 6),       # the resident form's edge at D=128
    (1, 385, 1, 128, False, "streamed", 4, 6),
    (2, 577, 1, 128, False, "streamed", 4, 9),
    (1, 1024, 2, 64, False, "stream_ring", 16, 5),   # 16 items: one CTA each
    (64, 257, 16, 64, False, "row_ring", 132, 2),    # ViT-L/14 vision, 272 keys
    (256, 257, 16, 64, True, "row_ring", 132, 2),    # the ViT-L/14 eval batch
    (64, 256, 8, 64, False, "row_ring", 132, 2),     # ViT-medium, no class token
    (16, 1024, 12, 64, False, "stream_ring", 132, 5),  # ViT-B-16-SigLIP-512
    (64, 577, 16, 64, True, "stream_ring", 132, 5),  # L-14-336, segment ids beside the slots
])
def test_long_row_plan_at_the_main_shapes(B, L, H, D, segmented, form, warps, splits):
    """The plan's form and its first two integers: (grid, slots) of a ring,
    (warps, splits) of the long-row kernel; its shared memory mirrors the
    kernel's."""
    plan = A.long_row_plan(B, L, H, D, segmented, SMS)
    assert plan.form == form and plan.c_args()[:2] == (warps, splits)
    if form == "row_ring":
        assert plan.smem_bytes == A.row_ring_smem_bytes(plan.chunk, plan.stages)
        assert plan.chunk == (208 if L <= 208 else 272) and plan.c_args()[2] == 2
    elif form == "stream_ring":
        assert plan.smem_bytes == A.stream_ring_smem_bytes(128, plan.stages, segmented)
        assert plan.chunk == 128 and plan.c_args()[2] == 4
    else:
        assert (plan.warps, plan.splits) == (warps, splits)
        assert plan.smem_bytes == A.long_row_smem_bytes(L, D, warps, segmented, form == "resident")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [129, 144, 197, 255, 256, 257, 384, 385, 577, 800, 1024, 4096])
@pytest.mark.parametrize("pairs", [(1, 1), (1, 2), (8, 16), (64, 12), (256, 12)])
def test_long_row_plan_is_one_the_kernel_takes(pairs, L, D):
    """Every plan fits a CTA's shared memory and the kernel's launch bounds.
    At head_dim 64: the row ring exactly where the row fits its key
    capacities (up to 272 tokens), else the stream ring, each on a grid of
    at most one CTA an SM and never more than its items. At head_dim 128:
    the long-row kernel, which gives every warp a query block in its first
    round, keeps K and V resident whenever they fit beside the fewest warps,
    and splits only where the (row, head) pairs leave at least half the SMs
    idle."""
    B, H = pairs
    rows = -(-L // 16) * 16
    for segmented in (False, True):
        for causal in (False, True):
            plan = A.long_row_plan(B, L, H, D, segmented, SMS, causal)
            assert plan.smem_bytes <= A.MAX_SMEM
            if D == 64:
                blocks = -(-L // 64)
                if L <= 272:
                    items = B * H
                    assert plan.form == "row_ring" and plan.warps == A.ROW_RING_WARPS
                    assert plan.chunk >= L and plan.stages == 2
                else:
                    items = B * H * -(-blocks // 2)
                    assert plan.form == "stream_ring" and plan.warps == A.STREAM_RING_WARPS
                    assert plan.chunk == (64 if causal else 128) and 1 <= plan.stages <= A.RING_MAX_SLOTS
                assert plan.grid == min(items, SMS)
                continue
            assert 1 <= plan.warps <= A.LONG_MAX_WARPS
            assert 1 <= plan.warps <= (rows // 16) // plan.splits
            fits = A.long_row_smem_bytes(L, D, A.LONG_MIN_WARPS, segmented, True) <= A.MAX_SMEM
            assert (plan.form == "resident") == fits
            if 2 * B * H > SMS:
                assert plan.splits == 1
            else:
                assert B * H * plan.splits <= SMS


@pytest.mark.parametrize("L", [129, 197, 256, 257, 577, 1024])
def test_long_row_plan_takes_a_ring_at_head_dim_64(L):
    """The rings take every length past 128 tokens at head_dim 64 (the row
    ring to 272, the stream ring beyond), with their entry-point codes, at
    every batch, head count and mask; the long-row kernel's plan stays what
    it was, for head_dim 128 and for timing beside the rings."""
    for B, H in ((1, 1), (64, 12), (256, 16)):
        for segmented in (False, True):
            for causal in (False, True):
                plan = A.long_row_plan(B, L, H, 64, segmented, SMS, causal)
                code = plan.c_args()[2]
                if L <= 272:
                    assert plan.form == "row_ring" and code == A.FWD_FORMS["row_ring"]
                else:
                    assert plan.form == "stream_ring"
                    assert code == A.FWD_FORMS["stream_ring"] + (not causal)
                old = A.long_kernel_plan(B, L, H, 64, segmented, SMS)
                assert old.form in ("resident", "streamed") and old.c_args()[2] == int(old.form == "resident")
    assert A.long_row_plan(8, L, 2, 128, False, SMS).form in ("resident", "streamed")


def test_long_ring_smem_mirrors_the_kernels():
    """The row ring's CTA: 1 KB to align, two slots of Q, K and V of 208 or
    272 token rows of 128 B, two 64-row output tiles, 16 B a slot for its
    mbarrier and release count: 177,184 B at 208 keys and 226,336 B at 272,
    one CTA an SM. The stream ring's: 1 KB, two item slots of two Q boxes,
    its ring slots of K and V, two output tiles, the seg ids and two
    mbarriers a slot; five slots of 128 keys fit, six do not."""
    assert A.row_ring_smem_bytes(208, 2) == 1024 + 2 * 3 * 208 * 128 + 2 * 8192 + 32 == 177184
    assert A.row_ring_smem_bytes(272, 2) == 226336 <= A.MAX_SMEM < A.row_ring_smem_bytes(208, 3)
    for seg in (False, True):
        ids = (2 * 128 + 5 * 128) * 4 if seg else 0
        assert A.stream_ring_smem_bytes(128, 5, seg) == 1024 + 4 * 8192 + 5 * 32768 + 2 * 8192 + ids + 16 * 7
        assert A.stream_ring_smem_bytes(128, 5, seg) <= A.MAX_SMEM < A.stream_ring_smem_bytes(128, 6, seg)


@pytest.mark.parametrize("B,L,H", [(1, 129, 1), (2, 257, 2), (3, 1024, 1), (512, 257, 16), (1, 577, 3)])
def test_long_ring_grid_never_exceeds_the_items(B, L, H):
    """A ring's grid is one persistent CTA an SM, never more than its items:
    (row, head)s for the row ring, (row, head, pair of 64-row query
    blocks)s for the stream ring, so small cases launch no idle CTA."""
    for segmented in (False, True):
        plan = A.long_row_plan(B, L, H, 64, segmented, SMS)
        items = B * H if L <= 272 else B * H * -(-(-(-L // 64)) // 2)
        assert plan.grid == min(items, SMS)
        for chunk in A.STREAM_RING_CHUNKS:
            assert A.stream_ring_plan(B, L, H, segmented, SMS, chunk).grid == min(B * H * -(-(-(-L // 64)) // 2), SMS)


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
    form keeps the seg ids of its ring's slots only, and the stream ring
    those of its item and ring slots, so neither's shared memory grows with L."""
    most = A.long_row_smem_bytes(4096, D, A.LONG_MAX_WARPS, True, False)
    assert most <= A.MAX_SMEM
    for L in (4096, 40_000, 1 << 20):
        plan = A.long_row_plan(1, L, 1, D, True, SMS)
        if D == 64:
            assert plan.form == "stream_ring"
            assert plan.smem_bytes == A.stream_ring_smem_bytes(128, plan.stages, True) <= A.MAX_SMEM
        else:
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
    """At D=64 the row takes the streamed pair at every length (three CTAs
    an SM, both kernels within a third of an SM's shared memory, one CTA per
    item at most); at D=128 it stays resident in padded rows exactly where Q, K, V
    and dO of the whole row (with lse2, delta and segment ids) fit a CTA's
    shared memory, one warp per 16-token block up to 8, and the tiled pair
    takes the rest, in 64-token tiles that always fit."""
    plan = A.bwd_long_row_plan(B, L, H, D, segmented, SMS)
    rows = -(-L // 16) * 16
    fits = D == 128 and A.bwd_row_smem_bytes(L, D, segmented) <= A.MAX_SMEM
    assert plan.smem_bytes <= A.MAX_SMEM
    assert plan.form == ("streamed" if D == 64 else "resident" if fits else "tiled")
    if plan.form == "streamed":
        items = B * H * -(-L // 64)
        assert plan.warps == 5 and plan.grid == min(items, 3 * SMS)
        assert 3 * (max(A.bwd_stream_smem_bytes(segmented)) + 1024) <= A.SM_SMEM
        assert plan.smem_bytes == max(A.bwd_stream_smem_bytes(segmented))
        assert plan.c_args() == (plan.grid, 3)
    elif fits:
        assert plan.warps == min(rows // 16, A.BWD_ROW_WARPS)
        assert plan.smem_bytes == A.bwd_row_smem_bytes(L, D, segmented)
        assert plan.c_args() == (plan.warps, 1)
    else:
        assert plan.smem_bytes == A.bwd_tiled_smem_bytes(D, segmented)
        assert plan.c_args() == (4, 0)


@pytest.mark.parametrize("B,L,H,D,form,warps", [
    (64, 197, 12, 64, "streamed", 5),     # ViT-B/16 vision: the streamed pair beat resident_pair
    (512, 197, 12, 64, "streamed", 5),    # its train batch
    (2, 256, 2, 64, "streamed", 5),
    (64, 197, 6, 128, "resident", 8),     # head_dim 128: 8 warps walk 13 blocks
    (8, 577, 16, 64, "streamed", 5),      # 336 px
    (1, 208, 1, 64, "streamed", 5),       # the forms' edges
    (1, 209, 1, 64, "streamed", 5),
    (1, 208, 1, 128, "resident", 8),
    (1, 209, 1, 128, "tiled", 4),
    (512, 257, 16, 64, "streamed", 5),    # ViT-L/14 training
    (64, 257, 16, 64, "streamed", 5),     # ViT-L/14 serving
    (16, 1024, 12, 64, "streamed", 5),    # ViT-B-16-SigLIP-512
    (2, 257, 2, 128, "tiled", 4),         # head_dim 128 keeps the tiled pair
])
def test_bwd_long_row_plan_at_the_main_shapes(B, L, H, D, form, warps):
    plan = A.bwd_long_row_plan(B, L, H, D, True, SMS)
    assert (plan.form, plan.warps) == (form, warps)


@pytest.mark.parametrize("L", [129, 144, 176, 197, 208])
def test_bwd_long_row_plan_streams_from_129_tokens_at_head_dim_64(L):
    """At 129-208 tokens, where an earlier form held the whole row in
    shared memory two CTAs an SM, the plan takes the streamed pair, which
    beat that form at [64, 197, 12 x 64] and [512, 197, 12 x 64], at every
    batch and head count."""
    for B, H in ((64, 12), (512, 12), (1, 1)):
        for segmented in (False, True):
            plan = A.bwd_long_row_plan(B, L, H, 64, segmented, SMS)
            assert (plan.form, plan.c_args()) == ("streamed", (plan.grid, A.BWD_FORMS["streamed"]))


@pytest.mark.parametrize("L", [209, 257, 577, 1024])
@pytest.mark.parametrize("segmented", [False, True])
def test_bwd_long_row_plan_streams_past_208_tokens_at_head_dim_64(L, segmented):
    """ViT-L/14's 257 tokens, 336 px at 577 and SigLIP-512 at 1024 take the
    streamed pair on 396 CTAs (three an SM) with three ring slots: a fourth
    (a 32-row K and V tile each, two mbarriers) would not leave the dq
    kernel's CTA in a third of an SM."""
    plan = A.bwd_long_row_plan(512, L, 16, 64, segmented, SMS)
    assert (plan.form, plan.grid) == ("streamed", 3 * SMS)
    assert plan.c_args() == (3 * SMS, 3)
    assert A.BWD_STREAM_STAGES == 3
    assert A.bwd_stream_smem_bytes(segmented)[0] + 2 * 32 * 128 + 16 > A.BWD_STREAM_SMEM


def test_bwd_stream_smem_mirrors_the_kernels():
    """The dq kernel's CTA: 1 KB to align, two item slots of Q, dO and out
    (64 rows of 128 B each), three ring slots of K and V (32 rows each),
    lse2 and delta of the item slots, the seg ids of the item and ring slots
    when segmented, 12 mbarriers; the dk/dv kernel's: two item slots of K
    and V, three ring slots of Q, dO and Qs with their lse2 and delta, the
    seg ids, 13 mbarriers. Three CTAs share an SM."""
    block, chunk = 64 * 128, 32 * 128
    for seg in (False, True):
        ids = (2 * 64 + 3 * 32) * 4 if seg else 0
        dq, dkdv = A.bwd_stream_smem_bytes(seg)
        assert dq == 1024 + 6 * block + 6 * chunk + 2 * 2 * 64 * 4 + ids + 8 * 12
        assert dkdv == 1024 + 4 * block + 9 * chunk + 3 * 32 * 8 + ids + 8 * 13
    assert A.bwd_stream_smem_bytes(False) == (75872, 71528)
    assert A.BWD_STREAM_SMEM == 233472 // 3 - 1024 == 76800
    assert max(A.bwd_stream_smem_bytes(True)) <= A.BWD_STREAM_SMEM


@pytest.mark.parametrize("B,L,H", [(1, 209, 1), (2, 257, 2), (3, 1024, 1), (512, 257, 16)])
def test_bwd_stream_plan_grid_never_exceeds_the_items(B, L, H):
    """The grid is one CTA per (row, head, 64-token block) item up to three
    an SM, so small cases launch no idle CTA."""
    for segmented in (False, True):
        plan = A.bwd_stream_plan(B, L, H, segmented, SMS)
        assert plan.grid == min(B * H * -(-L // 64), 3 * SMS)


def test_bwd_long_row_plan_keeps_the_tiled_pair_at_head_dim_128():
    """The streamed pair has no head_dim 128 form: past 208 tokens the D=128
    row keeps the tiled pair at every length and batch."""
    for L in (209, 257, 385, 577, 1024, 4096):
        for B, H in ((1, 1), (512, 8)):
            assert A.bwd_long_row_plan(B, L, H, 128, False, SMS).form == "tiled"


def test_bwd_row_smem_holds_the_row():
    """Q, dO, K and V of 208 padded rows of D + 8 values, lse2 and delta, and
    the segment ids when segmented: 119,808 + 1,664 (+ 1,664) B at D=64;
    226,304 + 1,664 + 1,664 = 229,632 B at D=128, the most that fits."""
    assert A.bwd_row_smem_bytes(197, 64, False) == 4 * 208 * 72 * 2 + 208 * 8
    assert A.bwd_row_smem_bytes(197, 64, True) == 4 * 208 * 72 * 2 + 208 * 16
    assert A.bwd_row_smem_bytes(197, 128, True) == 229632
    assert A.bwd_tiled_smem_bytes(64, False) == 4 * 64 * 72 * 2 + 64 * 8


@pytest.mark.parametrize("L,D", [(128, 64), (77, 64), (197, 32)])
def test_bwd_long_row_plan_refuses_what_the_long_rows_do_not_take(L, D):
    with pytest.raises(ValueError, match="backward long-row plan"):
        A.bwd_long_row_plan(8, L, 2, D, False, SMS)


# -- the forward rings' producer/consumer protocols, simulated ----------------
# Models of the mbarrier protocols of csrc/flash_fwd.cu's row ring (no
# producer warp: thread 0 fills the slots first, then the warpgroup that
# releases a slot last refills it) and stream ring (a producer warp, two
# item slots of Q, `stages` ring slots, one release a consumer warp),
# statement for statement: each agent is a generator that yields the waits
# its loop issues (same slots, phases and parities as the kernel) and
# arrives where the kernel arrives; TMA copies land at random later steps.
# A scheduler runs them in random interleavings and fails on a deadlock (no
# agent can move while one has not finished), on a wait that succeeds for a
# phase other than the one its agent means (parity aliasing), on a copy into
# a slot that a consumer has not released, and on a read of a slot that
# does not hold what the reader expects.

class _Barrier:
    def __init__(self, count):
        self.count, self.pending, self.tx, self.completed = count, count, 0, 0

    def _maybe_complete(self):
        if self.pending == 0 and self.tx == 0:
            self.completed += 1
            self.pending = self.count

    def arrive(self):
        assert self.pending > 0
        self.pending -= 1
        self._maybe_complete()

    def expect_tx(self, nbytes):
        self.tx += nbytes
        self.arrive()

    def land(self, nbytes):
        self.tx -= nbytes
        assert self.tx >= 0
        self._maybe_complete()


class _Slots:
    """What each slot holds: the tag of its last fill, whether its copy has
    landed, and how many consumer warps have released it."""

    def __init__(self, n, readers):
        self.tag, self.landed, self.released, self.readers = [None] * n, [True] * n, [readers] * n, readers
        self.log = [[] for _ in range(n)]

    def fill(self, s, tag):
        assert self.released[s] == self.readers, f"slot {s} refilled with {tag} before its release"
        self.tag[s], self.landed[s], self.released[s] = tag, False, 0
        self.log[s].append(("fill", tag))

    def read(self, s, tag):
        assert self.tag[s] == tag and self.landed[s], f"slot {s} read for {tag}, holds {self.tag[s]}"
        self.log[s].append(("read", tag))

    def release(self, s, tag):
        assert self.tag[s] == tag
        self.released[s] += 1
        self.log[s].append(("release", tag))


def _wait(bar, parity, phase):
    """A parity wait for the completion of phase `phase` of `bar`."""
    assert parity == phase & 1
    return ("wait", bar, parity, phase)


def _run(agents, rng, copies):
    """Run the agents to their end in a random interleaving; `copies` holds
    the TMA copies in flight as (barrier, bytes, slots, slot) entries. An
    agent yields ("wait", barrier, parity, phase)."""
    state = {a: next(a, None) for a in agents}
    while True:
        live = [a for a, op in state.items() if op is not None]
        if not live and not copies:
            return
        ready = []
        for a in live:
            _, bar, parity, phase = state[a]
            if (bar.completed & 1) != parity:  # the hardware's parity test
                assert bar.completed == phase + 1, f"phase {phase} waited, {bar.completed} completed"
                ready.append(a)
        choices = ready + [None] * len(copies)
        assert choices, "deadlock: every agent waits on a phase that never completes"
        pick = choices[int(rng.integers(len(choices)))]
        if pick is None:
            bar, nbytes, slots, s = copies.pop(int(rng.integers(len(copies))))
            slots.landed[s] = True
            bar.land(nbytes)
        else:
            state[pick] = next(pick, None)


def _slot_order_ok(log, readers, releases):
    """Each fill of a slot is read by `readers` consumers and released
    `releases` times, no release before a read, before the next fill."""
    fills = [i for i, (what, _) in enumerate(log) if what == "fill"]
    for i, start in enumerate(fills):
        end = fills[i + 1] if i + 1 < len(fills) else len(log)
        tag, events = log[start][1], log[start + 1:end]
        assert all(t == tag for _, t in events), (tag, events)
        kinds = [what for what, _ in events]
        assert kinds.count("read") == readers and kinds.count("release") == releases, (tag, events)
        assert kinds[0] == "read", (tag, events)


def _row_ring(n_items, nqb, stages, rng):
    """One CTA of flash_fwd_row_ring_kernel over `n_items` items (CTA-local
    indices): thread 0 fills the first `stages` slots; warpgroup w takes the
    blocks w, w + 2, ... of the CTA's (item, block) sequence, waits for an
    item's slot at its first block of it and, at its last, counts its
    release; the warpgroup
    whose release completes the count refills the slot with the item
    `stages` on. Returns the slots' log."""
    wgs = A.RING_WARPGROUPS
    full = [_Barrier(1) for _ in range(stages)]
    released = [0] * stages
    slots, copies = _Slots(stages, wgs), []

    def fill(s, n):
        slots.fill(s, n)
        full[s].expect_tx(8192)
        copies.append((full[s], 8192, slots, s))

    for s in range(min(stages, n_items)):
        fill(s, s)

    def warpgroup(w):
        waited = -1
        for k in range(w, n_items * nqb, wgs):
            n, s = k // nqb, (k // nqb) % stages
            if n != waited:
                yield _wait(full[s], (n // stages) & 1, n // stages)
                slots.read(s, n)
                waited = n
            if k + wgs >= (n + 1) * nqb:
                slots.release(s, n)
                released[s] += 1
                if released[s] == wgs:
                    released[s] = 0
                    if n + stages < n_items:
                        fill(s, n + stages)

    _run([warpgroup(w) for w in range(wgs)], rng, copies)
    return slots.log


def _stream_ring(items, fills_of, stages, rng, late_warp=None):
    """One CTA of flash_fwd_stream_ring_kernel over its `items`: the producer
    warp loads each item's Q into two item slots and streams fills_of(item)
    ring-slot fills (its chunks, twice); each of the eight consumer warps
    (two warpgroups, both reading every chunk) releases an item slot once it
    holds its Q and a ring slot after its products on it. With `late_warp`,
    that warp releases each ring slot only after waiting for the next fill,
    the fault the simulation must find. Returns both logs."""
    warps = 4 * A.RING_WARPGROUPS
    q_full, q_empty = [_Barrier(1) for _ in range(2)], [_Barrier(warps) for _ in range(2)]
    full, empty = [_Barrier(1) for _ in range(stages)], [_Barrier(warps) for _ in range(stages)]
    qslots, ring, copies = _Slots(2, warps), _Slots(stages, warps), []

    def producer():
        c = 0
        for n, item in enumerate(items):
            qs = n % 2
            if n >= 2:
                yield _wait(q_empty[qs], (n // 2 - 1) & 1, n // 2 - 1)
            qslots.fill(qs, item)
            q_full[qs].expect_tx(16384)
            copies.append((q_full[qs], 16384, qslots, qs))
            for k in range(fills_of(item)):
                s = c % stages
                if c >= stages:
                    yield _wait(empty[s], (c // stages - 1) & 1, c // stages - 1)
                ring.fill(s, (item, k))
                full[s].expect_tx(8192)
                copies.append((full[s], 8192, ring, s))
                c += 1

    def consumer_warp(w):
        c, owed = 0, []
        for n, item in enumerate(items):
            qs = n % 2
            yield _wait(q_full[qs], (n // 2) & 1, n // 2)
            qslots.read(qs, item)
            qslots.release(qs, item)
            q_empty[qs].arrive()
            for k in range(fills_of(item)):
                s = c % stages
                yield _wait(full[s], (c // stages) & 1, c // stages)
                ring.read(s, (item, k))
                owed.append((s, (item, k)))
                while owed and (w != late_warp or len(owed) > 1):
                    slot, tag = owed.pop(0)
                    ring.release(slot, tag)
                    empty[slot].arrive()
                c += 1
        for slot, tag in owed:
            ring.release(slot, tag)
            empty[slot].arrive()

    _run([producer()] + [consumer_warp(w) for w in range(warps)], rng, copies)
    return qslots.log, ring.log


@pytest.mark.parametrize("L", [129, 197, 208, 209, 257, 272])
@pytest.mark.parametrize("items", [1, 2, 3, 7, 10])
def test_row_ring_protocol_never_deadlocks(L, items):
    """The row ring's slots over several items a CTA (odd and even query
    blocks a row: 5 at 257 tokens, so the warpgroups' blocks alternate
    between items), with the plan's slot count and with one, in random
    interleavings: every wait is for the phase its warpgroup means, every
    fill is read and released by both warpgroups before the next, and no
    warpgroup waits forever."""
    nqb = -(-L // 64)
    rng = np.random.default_rng(L * 100 + items)
    for stages in sorted({A.row_ring_plan(2, L, 2, SMS).stages, 1, 3}):
        for _ in range(10):
            log = _row_ring(items, nqb, stages, rng)
            for slot in log:
                _slot_order_ok(slot, A.RING_WARPGROUPS, A.RING_WARPGROUPS)
            assert sum(e[0] == "fill" for slot in log for e in slot) == items


@pytest.mark.parametrize("L,causal", [(129, False), (257, False), (577, False), (577, True), (1024, True),
                                      (385, False)])
@pytest.mark.parametrize("chunk", A.STREAM_RING_CHUNKS)
def test_stream_ring_protocol_never_deadlocks(L, causal, chunk):
    """The stream ring over both passes and several items a CTA, causal
    items streaming fewer chunks, with the plan's slot count and others:
    the same checks, for the item slots and the ring slots, each read and
    released by all eight consumer warps."""
    plan = A.stream_ring_plan(2, L, 2, False, SMS, chunk)
    nqb, nkc = -(-L // 64), -(-L // chunk)
    npair = -(-nqb // A.RING_WARPGROUPS)

    def fills_of(item):
        pr = item % npair
        return 2 * (min(nkc, -(-min(L, (pr + 1) * 128) // chunk)) if causal else nkc)

    items = 2 * npair + 1
    warps = 4 * A.RING_WARPGROUPS
    rng = np.random.default_rng(L + chunk)
    for stages in sorted({plan.stages, 1, 2, 5}):
        for grid in (1, 2):
            for cta in range(grid):
                mine = list(range(cta, items, grid))
                qlog, rlog = _stream_ring(mine, fills_of, stages, rng)
                for slot in qlog + rlog:
                    _slot_order_ok(slot, warps, warps)
                assert sum(e[0] == "fill" for slot in rlog for e in slot) == sum(map(fills_of, mine))


def test_ring_protocol_simulation_finds_a_late_release():
    """The simulation's control: a stream ring whose consumer warp releases
    each slot only after waiting for the next fill deadlocks once the
    producer needs that slot again, and the simulation says so; released on
    time, the same run completes."""
    rng = np.random.default_rng(0)
    _stream_ring(list(range(4)), lambda item: 4, 1, rng)
    with pytest.raises(AssertionError, match="deadlock"):
        _stream_ring(list(range(4)), lambda item: 4, 1, rng, late_warp=2)

