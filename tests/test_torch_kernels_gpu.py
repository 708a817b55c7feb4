"""latteclip_torch CUDA kernels against their plain PyTorch versions, on the card.

The kernels are CUDA C++ for sm_90a with no CPU mode, so every test that
launches them is marked ``gpu`` and skips without a CUDA device; the test of
the out check itself runs on the CPU. The file imports neither JAX nor
latteclip_tpu, so it runs on a machine that has only PyTorch; there, skip the
JAX-side conftest:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q -m gpu

Lengths cover both sides of each dispatch edge of the kernels (rows of at
most 128 tokens on the short-row ring, one warpgroup up to L=64 and two up
to 128, or in the one-CTA-per-(row, head) form, with one 64-key tile up to
L=64 and one 128-key tile up to 128; the long-row kernel beyond, in its
resident and streamed forms) and a ragged edge in each; the ring also runs
on explicit grids that it wraps many times, that do not divide the items,
and that have one CTA per item. q and k are
drawn from N(0, 0.3^2), v and the cotangent from N(0, 1).
Tolerances as in tests/test_torch_attention.py: bf16 out elementwise
atol = rtol = 2e-2 and, relative to the reference's own size,
||out - ref|| / ||ref|| <= 1e-2 (bf16 rounding of out gives < 2^-8; the
elementwise bound alone is near the size of out itself at long rows); lse2
atol 1e-3. The backward kernels are held on dq, dk and dv separately:
||d - ref|| / ||ref|| <= 1e-2 and, elementwise, |d - ref| <= 2e-2 * max|ref|
(each gradient is rounded to bf16 once, < 2^-8 relative, and a flip in the
bf16 rounding of one p or ds moves a sum of L terms by far less).

The head-split kernels run the whole-row kernels' arithmetic and differ only
in where lse2 is stored (the gradient comes in the layout of qkv from both),
so they are held to the whole-row kernels bit for bit as well as to their
plain versions. Segment runs of 2 tokens let one flip of the bf16 rounding of
p (2^-8 at most, p <= 1) move lse2 by up to 2^-8 / ln 2 = 5.6e-3, since
l >= 1: where such runs occur lse2 is held to that bound. The fused
LayerNorm -> linear kernel is held as bf16 out is: elementwise
atol = rtol = 2e-2 and ||y - ref|| / ||ref|| <= 1e-2 (both sides multiply
the same bf16 operands in f32 and round once; they differ where the f32
summation order flips one bf16 rounding of xn or y); its control zeroes one
16-output block of W, which leaves those outputs at the bias alone.
"""
import numpy as np
import pytest
import torch

from latteclip_torch.kernels import attention as A
from latteclip_torch.kernels import fused_ln_linear as FL
from latteclip_torch.kernels import lab as LB

torch.set_num_threads(1)

OUT_TOL = 2e-2
OUT_REL_TOL = 1e-2
LSE_TOL = 1e-3
GRAD_REL_TOL = 1e-2
GRAD_MAX_TOL = 2e-2


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")


def _qkv(rng, B, L, H, D):
    """q, k ~ N(0, 0.3^2) and v ~ N(0, 1), packed as [B, L, 3*H*D] float32."""
    std = np.repeat(np.array([0.3, 0.3, 1.0], np.float32), H * D)
    return torch.from_numpy(rng.standard_normal((B, L, 3 * H * D)).astype(np.float32) * std)


def _assert_out_close(out, ref):
    out, ref = out.float(), ref.float()
    torch.testing.assert_close(out, ref, atol=OUT_TOL, rtol=OUT_TOL)
    rel = float((out - ref).norm() / ref.norm())
    assert rel <= OUT_REL_TOL, f"||out - ref|| / ||ref|| = {rel:.4g} > {OUT_REL_TOL}"


def _segments(rng, B, L):
    """Runs of 1..L/3 tokens numbered 1, 2, ..., then a seg-0 padding tail."""
    seg = np.zeros((B, L), np.int32)
    for r in range(B):
        pos, sid = 0, 1
        while pos < L - L // 8:
            n = int(rng.integers(1, max(2, L // 3 + 1)))
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


def _long_segments(rng, B, L, shortest=6):
    """Runs of ``shortest``..L/3 tokens numbered 1, 2, ..., then a seg-0
    padding tail of at least L/8 tokens. Every row then sees at least
    ``shortest`` keys with p near 1 (q, k ~ N(0, 0.3^2) keep the scores
    flat), so l >= ~6 and the flip of one bf16 rounding of p (2^-8 of p,
    which the f32 summation order of the scores can cause) moves lse2 by
    under 2^-8 / (6 ln 2) = 9.4e-4, inside LSE_TOL; a run of 2 tokens could
    move it by 2.8e-3, which over the 10^5 rows of the large grids happens."""
    seg = np.zeros((B, L), np.int32)
    end = L - L // 8
    for r in range(B):
        pos, sid = 0, 1
        while pos + shortest <= end:
            n = min(int(rng.integers(shortest, max(shortest + 1, L // 3 + 1))), end - pos)
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 16, 50, 64, 65, 77, 100, 128, 129, 197])
def test_cuda_kernels_match_plain_versions(L, D):
    _need_cuda()
    rng = np.random.default_rng(L * 1000 + D)
    H = 2
    x = _qkv(rng, 3, L, H, D).to("cuda", torch.bfloat16)
    seg = torch.from_numpy(_segments(rng, 3, L)).cuda()
    for causal in (False, True):
        for ours, ref in (
            (A.flash_attention_qkv(x, H, causal), A.flash_fwd_plain(x, H, causal)),
            (A.flash_attention_qkv_segmented(x, H, seg, causal),
             A.flash_fwd_seg_plain(x, seg, H, causal)),
        ):
            torch.cuda.synchronize()
            _assert_out_close(ours[0], ref[0])
            torch.testing.assert_close(ours[1], ref[1], atol=LSE_TOL, rtol=0)


# Rows of more than 128 tokens take the long-row kernel: (B, L, H, D) on both
# sides of its edges (16-row blocks, 64-key stages, the resident form's edge
# at D=128 between 384 and 385 tokens, the streamed form beyond), with grids
# from one (row, head) pair, split across CTAs, up to several waves.
LONG_ROW_CASES = [
    *[(2, L, 2, 64) for L in (129, 144, 197, 255, 256, 257, 577)],
    *[(2, L, 1, 128) for L in (129, 144, 197, 255, 256, 257, 577)],
    (1, 197, 1, 128), (1, 384, 1, 128), (1, 385, 1, 128), (1, 1024, 2, 64),
    (8, 577, 16, 64), (64, 197, 12, 64), (64, 197, 6, 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,D", LONG_ROW_CASES)
def test_cuda_long_rows_match_plain_versions(B, L, H, D):
    """K1, K2 (segments) and K5 on long rows against their plain versions,
    causal and not, each in the form its plan gives; K5 bit for bit K1."""
    _need_cuda()
    rng = np.random.default_rng(B * 100000 + L * 1000 + H * 10 + D)
    x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
    seg = torch.from_numpy(_long_segments(rng, B, L)).cuda()
    for causal in (False, True):
        out, lse2 = A.flash_attention_qkv(x, H, causal)
        ref_out, ref_lse2 = A.flash_fwd_plain(x, H, causal)
        torch.cuda.synchronize()
        _assert_out_close(out, ref_out)
        torch.testing.assert_close(lse2, ref_lse2, atol=LSE_TOL, rtol=0)
        seg_out, seg_lse2 = A.flash_attention_qkv_segmented(x, H, seg, causal)
        ref_out, ref_lse2 = A.flash_fwd_seg_plain(x, seg, H, causal)
        torch.cuda.synchronize()
        _assert_out_close(seg_out, ref_out)
        torch.testing.assert_close(seg_lse2, ref_lse2, atol=LSE_TOL, rtol=0)
        if A.head_split(H, D):
            hs_out, hs_lse2 = A.flash_attention_qkv_hs(x, H, causal)
            torch.cuda.synchronize()
            assert torch.equal(hs_out, out)
            assert torch.equal(hs_lse2.reshape(H, B, L).transpose(0, 1), lse2)
    # control: the check sees one 16-key block of values dropped
    dropped = x.clone()
    dropped[:, L // 2:L // 2 + 16, 2 * H * D:] = 0
    with pytest.raises(AssertionError):
        _assert_out_close(A.flash_fwd_plain(dropped, H, False)[0], A.flash_fwd_plain(x, H, False)[0])


@pytest.mark.gpu
def test_cuda_long_row_kernel_refuses_a_plan_it_cannot_take():
    """The entry point returns an error for a plan whose shared memory,
    warps or splits it cannot take, and the wrapper raises on such an error:
    no fallback."""
    _need_cuda()
    B, L, H, D = 1, 577, 1, 128
    x = torch.zeros(B, L, 3 * H * D, device="cuda", dtype=torch.bfloat16)
    out = torch.empty(B, L, H * D, device="cuda", dtype=torch.bfloat16)
    lse2 = torch.empty(B, H, L, device="cuda")
    kernel = A._kernel("latteclip_flash_fwd")
    stream = torch.cuda.current_stream().cuda_stream
    for warps, splits, resident in ((4, 1, 1), (17, 1, 0), (4, 37, 0), (0, 1, 0)):
        err = kernel(x.data_ptr(), out.data_ptr(), lse2.data_ptr(), B, L, H, D, 0,
                     (D ** -0.5) * A.LOG2E, warps, splits, resident, stream)
        assert err != 0, (warps, splits, resident)
    A.flash_attention_qkv(x, H)  # the plan's own launch
    torch.cuda.synchronize()


ONE_P_FLIP_LSE = 2 ** -8 / np.log(2)  # lse2 moved by one flip of a bf16 p, l >= 1


def _pair_segments(rng, B, L):
    """Runs of 2 tokens and of 2..L/3 tokens, alternating, numbered 1, 2,
    ..., then a seg-0 padding tail of at least L/8 tokens."""
    seg = np.zeros((B, L), np.int32)
    end = L - L // 8
    for r in range(B):
        pos, sid = 0, 1
        while pos + 2 <= end:
            n = 2 if sid % 2 else int(rng.integers(2, max(3, L // 3 + 1)))
            n = min(n, end - pos)
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


# The backward's rows of more than 128 tokens: the row kernel where the row
# fits (D=64 up to 208 tokens in unpadded rows, two CTAs an SM; D=128 up to
# 208 in padded rows) and the tiled pair beyond.
BWD_LONG_ROW_CASES = [
    *[(2, L, 2, D) for L in (129, 197, 256, 577) for D in (64, 128)],
    (1, 208, 1, 128), (1, 209, 1, 128), (1, 208, 1, 64), (1, 209, 1, 64),
    (64, 197, 12, 64), (64, 197, 6, 128), (8, 577, 16, 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,D", BWD_LONG_ROW_CASES)
def test_cuda_long_row_backward_matches_plain_versions(B, L, H, D):
    """K3, K4 (segments, with runs of 2 tokens) and K6 on long rows against
    their plain versions, causal and not, in the form their plan gives; K6
    bit for bit K3; the segmented forward's lse2 within one flip of p."""
    _need_cuda()
    rng = np.random.default_rng(B * 100000 + L * 1000 + H * 10 + D + 3)
    x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((B, L, H * D)).astype(np.float32)).to("cuda", torch.bfloat16)
    seg = torch.from_numpy(_pair_segments(rng, B, L)).cuda()
    for causal in (False, True):
        out, lse2 = A.flash_attention_qkv(x, H, causal)
        ours = A.flash_attention_qkv_bwd(x, out, dout, lse2, H, causal)
        ref = A.flash_bwd_plain(x, out, dout, lse2, H, causal)
        torch.cuda.synchronize()
        _assert_grads_close(ours, ref, H, D)
        seg_out, seg_lse2 = A.flash_attention_qkv_segmented(x, H, seg, causal)
        ref_out, ref_lse2 = A.flash_fwd_seg_plain(x, seg, H, causal)
        seg_ours = A.flash_attention_qkv_segmented_bwd(x, seg, seg_out, dout, seg_lse2, H, causal)
        seg_ref = A.flash_bwd_seg_plain(x, seg, seg_out, dout, seg_lse2, H, causal)
        torch.cuda.synchronize()
        _assert_out_close(seg_out, ref_out)
        torch.testing.assert_close(seg_lse2, ref_lse2, atol=ONE_P_FLIP_LSE, rtol=0)
        _assert_grads_close(seg_ours, seg_ref, H, D)
        if A.head_split(H, D):
            hs_out, hs_lse2 = A.flash_attention_qkv_hs(x, H, causal)
            dqkv = A.flash_attention_qkv_hs_bwd(x, hs_out, dout, hs_lse2, H, causal)
            torch.cuda.synchronize()
            _assert_grads_close(dqkv, A.merge_dqkv(A.flash_bwd_hs_plain(x, hs_out, dout, hs_lse2, H, causal)), H, D)
            assert torch.equal(dqkv, ours)


def _bwd_entry(x, seg, out, dout, lse2, H, causal, warps, resident):
    """The backward entry point called with an explicit plan: (error, dqkv)."""
    B, L, _ = x.shape
    D = x.shape[-1] // (3 * H)
    name = "latteclip_flash_bwd" if seg is None else "latteclip_flash_bwd_seg"
    dqkv = torch.empty_like(x)
    delta = torch.empty(B, H, L, device="cuda")
    tensors = [x, *([] if seg is None else [seg]), out, dout, lse2, delta, dqkv]
    err = A._kernel(name)(*(t.data_ptr() for t in tensors), B, L, H, D, int(causal),
                          (D ** -0.5) * A.LOG2E, D ** -0.5, warps, resident,
                          torch.cuda.current_stream().cuda_stream)
    return err, dqkv


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,D", [(2, 197, 2, 64), (2, 197, 1, 128), (3, 256, 2, 64)])
def test_cuda_backward_forms_agree(B, L, H, D):
    """Where the row fits, the row kernel at several warp counts, in padded
    rows and (D=64, up to 208 tokens) in unpadded swizzled rows, and the
    tiled pair each match the plain version: the plan picks between forms
    that compute the same gradient (padded rows at D=64 are no plan's form,
    but the entry point runs them)."""
    _need_cuda()
    rng = np.random.default_rng(L + D + 29)
    x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((B, L, H * D)).astype(np.float32)).to("cuda", torch.bfloat16)
    for causal in (False, True):
        out, lse2 = A.flash_attention_qkv(x, H, causal)
        ref = A.flash_bwd_plain(x, out, dout, lse2, H, causal)
        most = min(A.BWD_ROW_WARPS, -(-L // 16))
        forms = [(most, 1), (4, 1), (1, 1), (0, 0)]
        if D == 64 and L <= 208:  # unpadded swizzled rows, two CTAs an SM
            forms += [(8, 2), (3, 2)]
        for warps, resident in forms:
            err, dqkv = _bwd_entry(x, None, out, dout, lse2, H, causal, warps, resident)
            torch.cuda.synchronize()
            assert err == 0, (warps, resident)
            _assert_grads_close(dqkv, ref, H, D)


@pytest.mark.gpu
def test_cuda_long_row_backward_refuses_a_plan_it_cannot_take():
    """The backward entry point returns an error for a resident plan whose
    shared memory or warps it cannot take, and launches nothing for it."""
    _need_cuda()
    for L, D, warps, resident in ((577, 64, 8, 1), (385, 64, 8, 1), (209, 128, 8, 1),
                                  (197, 128, 9, 1), (197, 64, 9, 1), (197, 64, 0, 1),
                                  (129, 64, 10, 1), (197, 64, 9, 2), (209, 64, 8, 2),
                                  (197, 128, 8, 2), (197, 64, 8, 3)):
        H = 1
        x = torch.zeros(1, L, 3 * H * D, device="cuda", dtype=torch.bfloat16)
        out = torch.zeros(1, L, H * D, device="cuda", dtype=torch.bfloat16)
        err, _ = _bwd_entry(x, None, out, out, torch.zeros(1, H, L, device="cuda"), H, False,
                            warps, resident)
        assert err != 0, (L, D, warps, resident)
    torch.cuda.synchronize()


def _ring_fwd(name, x, seg, H, causal, grid, stages, lse_shape=None):
    """A forward entry point called with an explicit short-row ring plan:
    (error, out, lse2)."""
    B, L, _ = x.shape
    D = x.shape[-1] // (3 * H)
    out = torch.empty(B, L, H * D, device="cuda", dtype=torch.bfloat16)
    lse2 = torch.empty(lse_shape or (B, H, L), device="cuda")
    tensors = [x, *([] if seg is None else [seg]), out, lse2]
    err = A._kernel(name)(*(t.data_ptr() for t in tensors), B, L, H, D, int(causal),
                          (D ** -0.5) * A.LOG2E, grid, stages, 0, torch.cuda.current_stream().cuda_stream)
    return err, out, lse2


def _ring_bwd(name, x, seg, out, dout, lse2, H, causal, grid, stages):
    """A backward entry point called with an explicit short-row ring plan:
    (error, dqkv)."""
    B, L, _ = x.shape
    D = x.shape[-1] // (3 * H)
    dqkv = torch.empty_like(x)
    delta = torch.empty(B, H, L, device="cuda")
    tensors = [x, *([] if seg is None else [seg]), out, dout, lse2, delta, dqkv]
    err = A._kernel(name)(*(t.data_ptr() for t in tensors), B, L, H, D, int(causal),
                          (D ** -0.5) * A.LOG2E, D ** -0.5, grid, stages,
                          torch.cuda.current_stream().cuda_stream)
    return err, dqkv


# The short-row ring on explicit grids: (B, grid) with H = 256 / D heads (two
# head-split groups), so that B * H items wrap the ring many times, are no
# multiple of the grid, or are fewer than the SMs (the grid then has one CTA
# per item).
RING_GRIDS = {"wraps": (15, 4), "ragged": (7, 5), "fewer_than_sms": (2, None)}


@pytest.mark.gpu
@pytest.mark.parametrize("grids", list(RING_GRIDS))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [16, 50, 77, 100, 128])
def test_cuda_short_row_ring_matches_plain_versions(L, D, grids):
    """The ring forward and backward (whatever the plan picks at this length)
    against their plain versions, causal and segmented; the head-split
    forward and backward on the same ring equal K1 and K3 bit for bit.
    Causal rows near their row's or segment's start see few keys (from 1),
    and one flip of a bf16 p, which the f32 summation order of the scores
    can cause, moves their lse2 by up to 2^-8 / (l ln 2): causal lse2 is
    held to ONE_P_FLIP_LSE (l >= 1), the rest to LSE_TOL."""
    _need_cuda()
    B, grid = RING_GRIDS[grids]
    H = 256 // D
    grid = grid or B * H
    rng = np.random.default_rng(L * 1000 + D + 41 + B)
    x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((B, L, H * D)).astype(np.float32)).to("cuda", torch.bfloat16)
    seg = torch.from_numpy(_long_segments(rng, B, L, shortest=min(6, L))).cuda()
    fwd_stages = 2  # the ring's parity flips on every other wrap
    bwd_stages = 2 if A.bwd_short_row_smem_bytes(L, D, 2, True) <= A.MAX_SMEM else 1
    for causal in (False, True):
        for sg in (None, seg):
            suffix = "" if sg is None else "_seg"
            err, out, lse2 = _ring_fwd("latteclip_flash_fwd" + suffix, x, sg, H, causal, grid, fwd_stages)
            ref_out, ref_lse2 = (A.flash_fwd_plain(x, H, causal) if sg is None
                                 else A.flash_fwd_seg_plain(x, sg, H, causal))
            torch.cuda.synchronize()
            assert err == 0
            _assert_out_close(out, ref_out)
            torch.testing.assert_close(lse2, ref_lse2, atol=ONE_P_FLIP_LSE if causal else LSE_TOL, rtol=0)
            err, dqkv = _ring_bwd("latteclip_flash_bwd" + suffix, x, sg, out, dout, lse2, H, causal,
                                  grid, bwd_stages)
            ref = (A.flash_bwd_plain(x, out, dout, lse2, H, causal) if sg is None
                   else A.flash_bwd_seg_plain(x, sg, out, dout, lse2, H, causal))
            torch.cuda.synchronize()
            assert err == 0
            _assert_grads_close(dqkv, ref, H, D)
        hp = 128 // D
        err, out_hs, lse_hs = _ring_fwd("latteclip_flash_fwd_hs", x, None, H, causal, grid, fwd_stages,
                                        (H // hp, hp, B, L))
        err1, out1, lse1 = _ring_fwd("latteclip_flash_fwd", x, None, H, causal, grid, fwd_stages)
        torch.cuda.synchronize()
        assert err == 0 and err1 == 0
        assert torch.equal(out_hs, out1)
        assert torch.equal(lse_hs.reshape(H, B, L).transpose(0, 1), lse1)
        err, d_hs = _ring_bwd("latteclip_flash_bwd_hs", x, None, out1, dout, lse_hs, H, causal, grid,
                              bwd_stages)
        err1, d1 = _ring_bwd("latteclip_flash_bwd", x, None, out1, dout, lse1, H, causal, grid, bwd_stages)
        torch.cuda.synchronize()
        assert err == 0 and err1 == 0
        assert torch.equal(d_hs, d1)


@pytest.mark.gpu
def test_cuda_short_row_ring_refuses_a_plan_it_cannot_take():
    """The short-row entry points return an error for ring stages they
    cannot hold (none, more than RING_MAX_STAGES, or past a CTA's shared
    memory), and launch nothing for them; a grid of 0 is the one-CTA form."""
    _need_cuda()
    H = 1
    for L, D, bwd, stages in ((100, 64, False, 0), (100, 64, False, 5), (100, 128, False, 3),
                              (100, 64, True, 0), (100, 64, True, 3), (100, 128, True, 2),
                              (50, 64, True, 5)):
        x = torch.zeros(1, L, 3 * H * D, device="cuda", dtype=torch.bfloat16)
        if bwd:
            out = torch.zeros(1, L, H * D, device="cuda", dtype=torch.bfloat16)
            err, _ = _ring_bwd("latteclip_flash_bwd", x, None, out, out, torch.zeros(1, H, L, device="cuda"),
                               H, False, 1, stages)
        else:
            err, _, _ = _ring_fwd("latteclip_flash_fwd", x, None, H, False, 1, stages)
        assert err != 0, (L, D, bwd, stages)
    err, out, lse2 = _ring_fwd("latteclip_flash_fwd", torch.zeros(1, 50, 3 * 64, device="cuda",
                                                                  dtype=torch.bfloat16), None, 1, False, 0, 0)
    torch.cuda.synchronize()
    assert err == 0 and torch.isfinite(lse2).all()


@pytest.mark.gpu
def test_cuda_short_row_plan_forms_count_their_launch():
    """Each form of the short-row plans (the ring; the one-CTA form at 65..96
    tokens, 65..80 in the backward, and there where the items are few an SM),
    run through the wrappers, adds one to its kernel's count and matches the
    plain version."""
    _need_cuda()
    rng = np.random.default_rng(43)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (B, L, H, D), forms in (((160, 100, 4, 64), ("ring", "ring")), ((64, 77, 4, 64), ("cta", "cta")),
                                ((2, 100, 2, 64), ("ring", "cta")), ((128, 50, 2, 128), ("ring", "ring"))):
        assert (A.short_row_plan(B, L, H, D, False, sms).form,
                A.bwd_short_row_plan(B, L, H, D, False, sms).form) == forms
        x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
        dout = torch.from_numpy(rng.standard_normal((B, L, H * D)).astype(np.float32)).to("cuda", torch.bfloat16)
        A.reset_launch_counts()
        out, lse2 = A.flash_attention_qkv(x, H, True)
        ours = A.flash_attention_qkv_bwd(x, out, dout, lse2, H, True)
        assert A.launch_counts["flash_fwd"] == 1 and A.launch_counts["flash_bwd"] == 1
        assert sum(A.launch_counts.values()) == 2
        ref_out, ref_lse2 = A.flash_fwd_plain(x, H, True)
        torch.cuda.synchronize()
        _assert_out_close(out, ref_out)
        # causal rows near the start see few keys: one flipped bf16 p moves lse2 by <= ONE_P_FLIP_LSE
        torch.testing.assert_close(lse2, ref_lse2, atol=ONE_P_FLIP_LSE, rtol=0)
        _assert_grads_close(ours, A.flash_bwd_plain(x, out, dout, lse2, H, True), H, D)


def _grad_errors(ours, ref, H, D):
    """[(name, ||d - ref|| / ||ref||, max|d - ref| / max|ref|)] for dq, dk, dv."""
    ours, ref = ours.float(), ref.float()
    errs = []
    for i, name in enumerate(("dq", "dk", "dv")):
        a, r = ours[..., i * H * D:(i + 1) * H * D], ref[..., i * H * D:(i + 1) * H * D]
        errs.append((name, float((a - r).norm() / r.norm()),
                     float((a - r).abs().max() / r.abs().max())))
    return errs


def _assert_grads_close(ours, ref, H, D):
    for name, rel, worst in _grad_errors(ours, ref, H, D):
        assert rel <= GRAD_REL_TOL and worst <= GRAD_MAX_TOL, \
            f"{name}: ||d - ref|| / ||ref|| = {rel:.4g}, max|d - ref| / max|ref| = {worst:.4g}"


def _assert_single_token_grads(ours, ref, H, D):
    """At L = 1, p = 1 and dp = delta in exact arithmetic, so dq and dk are
    0 and both sides hold only f32 summation noise; dv = dout exactly."""
    HD = H * D
    assert float(ours[..., :2 * HD].float().abs().max()) <= 1e-5
    torch.testing.assert_close(ours[..., 2 * HD:], ref[..., 2 * HD:], atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 16, 50, 64, 65, 77, 100, 128, 129, 197])
def test_cuda_backward_kernels_match_plain_versions(L, D):
    _need_cuda()
    rng = np.random.default_rng(L * 1000 + D + 7)
    H, B = 2, 3
    x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((B, L, H * D)).astype(np.float32)).to("cuda", torch.bfloat16)
    seg = torch.from_numpy(_segments(rng, B, L)).cuda()
    for causal in (False, True):
        out, lse2 = A.flash_attention_qkv(x, H, causal)
        check = _assert_single_token_grads if L == 1 else _assert_grads_close
        ours = A.flash_attention_qkv_bwd(x, out, dout, lse2, H, causal)
        ref = A.flash_bwd_plain(x, out, dout, lse2, H, causal)
        torch.cuda.synchronize()
        check(ours, ref, H, D)
        out, lse2 = A.flash_attention_qkv_segmented(x, H, seg, causal)
        ours = A.flash_attention_qkv_segmented_bwd(x, seg, out, dout, lse2, H, causal)
        ref = A.flash_bwd_seg_plain(x, seg, out, dout, lse2, H, causal)
        torch.cuda.synchronize()
        check(ours, ref, H, D)


@pytest.mark.gpu
@pytest.mark.parametrize("segmented", [False, True])
def test_cuda_autograd_functions_match_autograd_through_plain_forward(segmented):
    """On the card, the Functions' gradient (forward and backward kernels)
    against autograd through the plain forward, in bf16."""
    _need_cuda()
    rng = np.random.default_rng(5)
    H, D, B, L = 2, 64, 4, 77
    x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((B, L, H * D)).astype(np.float32)).to("cuda", torch.bfloat16)
    seg = torch.from_numpy(_segments(rng, B, L)).cuda()
    grads = []
    for fn in ("kernel", "plain"):
        xi = x.clone().requires_grad_(True)
        if segmented:
            out = (A.FlashAttentionSegmented.apply(xi, seg, H, True)[0] if fn == "kernel"
                   else A.flash_fwd_seg_plain(xi, seg, H, True)[0])
        else:
            out = (A.FlashAttention.apply(xi, H, True)[0] if fn == "kernel"
                   else A.flash_fwd_plain(xi, H, True)[0])
        grads.append(torch.autograd.grad(out, xi, dout)[0])
    torch.cuda.synchronize()
    for name, rel, _ in _grad_errors(grads[0], grads[1], H, D):
        assert rel <= 2e-2, f"{name}: {rel:.4g}"


@pytest.mark.parametrize("L,causal", [(197, False), (577, False), (77, True)])
def test_backward_check_sees_one_dropped_value_block(L, causal):
    """The plain backward run with the values of one 16-key block zeroed
    fails the gradient check, by a wide margin on dk."""
    H, D = 2, 64
    rng = np.random.default_rng(L + 1)
    x = _qkv(rng, 2, L, H, D).to(torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((2, L, H * D)).astype(np.float32)).to(torch.bfloat16)
    out, lse2 = A.flash_fwd_plain(x, H, causal)
    ref = A.flash_bwd_plain(x, out, dout, lse2, H, causal)
    dropped = x.clone()
    dropped[:, L // 2:L // 2 + 16, 2 * H * D:] = 0
    wrong = A.flash_bwd_plain(dropped, out, dout, lse2, H, causal)
    _assert_grads_close(ref, ref, H, D)
    with pytest.raises(AssertionError):
        _assert_grads_close(wrong, ref, H, D)
    errs = dict((name, rel) for name, rel, _ in _grad_errors(wrong, ref, H, D))
    assert errs["dk"] > 5 * GRAD_REL_TOL


@pytest.mark.parametrize("L,causal", [(197, False), (577, False), (77, True)])
def test_out_check_sees_one_dropped_value_block(L, causal):
    """A kernel that loses the values of one 16-key block, as a wrong V tile
    would, fails the out check, and the relative-norm bound alone rejects it
    by a wide margin."""
    H, D = 2, 64
    x = _qkv(np.random.default_rng(L), 2, L, H, D).to(torch.bfloat16)
    ref = A.flash_fwd_plain(x, H, causal)[0]
    dropped = x.clone()
    dropped[:, L // 2:L // 2 + 16, 2 * H * D:] = 0
    wrong = A.flash_fwd_plain(dropped, H, causal)[0]
    _assert_out_close(ref, ref)
    with pytest.raises(AssertionError):
        _assert_out_close(wrong, ref)
    rel = float((wrong.float() - ref.float()).norm() / ref.float().norm())
    assert rel > 5 * OUT_REL_TOL


@pytest.mark.gpu
def test_cuda_wrappers_count_each_launch():
    _need_cuda()
    x = torch.zeros(2, 50, 3 * 2 * 64, device="cuda", dtype=torch.bfloat16)
    seg = torch.ones(2, 50, device="cuda", dtype=torch.int32)
    A.reset_launch_counts()
    out, lse2 = A.flash_attention_qkv(x, 2)
    A.flash_attention_qkv_segmented(x, 2, seg)
    A.flash_attention_qkv_segmented(x, 2, seg)
    A.flash_attention_qkv_bwd(x, out, out, lse2, 2)
    A.flash_attention_qkv_segmented_bwd(x, seg, out, out, lse2, 2)
    out_hs, lse2_hs = A.flash_attention_qkv_hs(x, 2)
    A.flash_attention_qkv_hs_bwd(x, out_hs, out_hs, lse2_hs, 2)
    A.flash_attention_qkv_bd(x, 2)
    A.flash_attention_qkv_bd(x, 2)
    assert A.launch_counts == {"flash_fwd": 1, "flash_fwd_seg": 2, "flash_bwd": 1, "flash_bwd_seg": 1,
                               "flash_fwd_hs": 1, "flash_bwd_hs": 1, "flash_fwd_bd": 2}
    FL.reset_launch_counts()
    w = torch.zeros(256, 128, device="cuda")
    FL.fused_ln_linear(torch.zeros(2, 50, 128, device="cuda", dtype=torch.bfloat16),
                       w[0], w[1], w, w[:, 0].contiguous())
    assert FL.launch_counts == {"ln_linear": 1}


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take():
    _need_cuda()
    x = torch.zeros(2, 50, 3 * 4 * 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_attention_qkv(x, 4)
    with pytest.raises(ValueError, match="bfloat16"):
        A.flash_attention_qkv(torch.zeros(2, 50, 384, device="cuda"), 2)
    wide = torch.zeros(2, 50, 768, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention_qkv(wide[:, :, :384], 2)
    with pytest.raises(ValueError, match="seg_ids"):
        A.flash_attention_qkv_segmented(wide[:, :, :384].contiguous(), 2,
                                        torch.ones(2, 50, device="cuda", dtype=torch.int64))
    x = torch.zeros(2, 50, 384, device="cuda", dtype=torch.bfloat16)
    out, lse2 = A.flash_attention_qkv(x, 2)
    with pytest.raises(ValueError, match="dout"):
        A.flash_attention_qkv_bwd(x, out, out.float(), lse2, 2)
    with pytest.raises(ValueError, match="lse2"):
        A.flash_attention_qkv_bwd(x, out, out, lse2[:, :, :49], 2)
    with pytest.raises(ValueError, match="lse2"):  # the head-split backward reads [H/HP, HP, B, L]
        A.flash_attention_qkv_hs_bwd(x, out, out, lse2, 2)
    with pytest.raises(ValueError, match="head-split"):  # 3 heads of 64 are no group of 2
        A.flash_attention_qkv_hs(torch.zeros(2, 50, 3 * 3 * 64, device="cuda", dtype=torch.bfloat16), 3)
    with pytest.raises(ValueError, match="block-diagonal"):
        A.flash_attention_qkv_bd(torch.zeros(2, 129, 384, device="cuda", dtype=torch.bfloat16), 2)
    xs = torch.zeros(2, 50, 96, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(64, 96, device="cuda")
    with pytest.raises(ValueError, match="multiple of 64"):
        FL.fused_ln_linear(xs, w[0], w[1], w, w[:, 0].contiguous())
    w = torch.zeros(64, 128, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        FL.fused_ln_linear(torch.zeros(2, 50, 128, device="cuda"), w[0], w[1], w, w[:, 0].contiguous())
    with pytest.raises(ValueError, match="wb"):
        FL.fused_ln_linear(torch.zeros(2, 50, 128, device="cuda", dtype=torch.bfloat16), w[0], w[1],
                           w, w[:2, 0].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 16, 50, 77, 100, 128, 129, 197])
def test_cuda_head_split_kernels_match_plain_versions_and_whole_row_kernels(L, D):
    _need_cuda()
    rng = np.random.default_rng(L * 1000 + D + 11)
    H, B = 256 // D, 3  # two head groups of 128 / D heads
    x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((B, L, H * D)).astype(np.float32)).to("cuda", torch.bfloat16)
    for causal in (False, True):
        out, lse2 = A.flash_attention_qkv_hs(x, H, causal)
        ref_out, ref_lse2 = A.flash_fwd_hs_plain(x, H, causal)
        torch.cuda.synchronize()
        assert lse2.shape == (H // (128 // D), 128 // D, B, L)
        _assert_out_close(out, ref_out)
        torch.testing.assert_close(lse2, ref_lse2, atol=LSE_TOL, rtol=0)
        out1, lse1 = A.flash_attention_qkv(x, H, causal)
        assert torch.equal(out, out1)
        assert torch.equal(lse2.reshape(H, B, L).transpose(0, 1), lse1)

        dqkv = A.flash_attention_qkv_hs_bwd(x, out, dout, lse2, H, causal)
        ref3 = A.flash_bwd_hs_plain(x, out, dout, lse2, H, causal)
        torch.cuda.synchronize()
        assert dqkv.shape == x.shape  # stored in the layout of qkv: no re-merge
        check = _assert_single_token_grads if L == 1 else _assert_grads_close
        check(dqkv, A.merge_dqkv(ref3), H, D)
        assert torch.equal(dqkv, A.flash_attention_qkv_bwd(x, out, dout, lse1, H, causal))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 16, 50, 64, 65, 77, 100, 128])
def test_cuda_block_diagonal_forward_matches_plain_version(L, D):
    _need_cuda()
    rng = np.random.default_rng(L * 1000 + D + 13)
    H, B = 2, 3
    x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
    for causal in (False, True):
        out, lse2 = A.flash_attention_qkv_bd(x, H, causal)
        ref_out, ref_lse2 = A.flash_fwd_bd_plain(x, H, causal)
        torch.cuda.synchronize()
        _assert_out_close(out, ref_out)
        torch.testing.assert_close(lse2, ref_lse2, atol=LSE_TOL, rtol=0)
        if L >= 32:  # control: the check sees one 16-key block of values dropped
            dropped = x.clone()
            dropped[:, L // 2:L // 2 + 16, 2 * H * D:] = 0
            with pytest.raises(AssertionError):
                _assert_out_close(A.flash_fwd_bd_plain(dropped, H, causal)[0], ref_out)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["headsplit", "blockdiag"])
def test_cuda_route_functions_match_autograd_through_plain_forward(route):
    """The head-split Function (K5, K6 and the re-merge) and the
    block-diagonal one (K7, K3) against autograd through their plain
    forwards, in bf16."""
    _need_cuda()
    rng = np.random.default_rng(6)
    H, D, B, L = 4, 64, 4, 77
    x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((B, L, H * D)).astype(np.float32)).to("cuda", torch.bfloat16)
    fn, plain = ((A.FlashAttentionHeadSplit, A.flash_fwd_hs_plain) if route == "headsplit"
                 else (A.FlashAttentionBlockDiag, A.flash_fwd_bd_plain))
    grads = []
    for forward in (lambda xi: fn.apply(xi, H, True)[0], lambda xi: plain(xi, H, True)[0]):
        xi = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(forward(xi), xi, dout)[0])
    torch.cuda.synchronize()
    for name, rel, _ in _grad_errors(grads[0], grads[1], H, D):
        assert rel <= 2e-2, f"{name}: {rel:.4g}"


def _ln_inputs(rng, B, L, D, O, device="cuda"):
    x = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32) * 2 + 0.5)
    ln_w = torch.from_numpy(1 + 0.1 * rng.standard_normal(D).astype(np.float32))
    ln_b = torch.from_numpy(0.1 * rng.standard_normal(D).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((O, D)).astype(np.float32) * D ** -0.5)
    wb = torch.from_numpy(0.1 * rng.standard_normal(O).astype(np.float32))
    return x.to(device, torch.bfloat16), ln_w.to(device), ln_b.to(device), w.to(device), wb.to(device)


# The eight LN -> projection sites of chip_smoke.py (vision 768 -> 2304 and
# 3072; text 512 -> 1536 and 2048 for captions, templates and the classifier
# build) at ragged row counts (not a multiple of 128, under 64), the template
# site's own 3619 rows (split over the outputs), the vision site's 25600, and
# each tile of the plan: (128, 128) up to D=768, (64, 128) past it, (64, 64)
# at D=1664.
@pytest.mark.gpu
@pytest.mark.parametrize("B,L,D,O", [
    (3, 77, 512, 1536), (2, 100, 768, 2304), (1, 50, 768, 3072), (5, 13, 64, 200),
    (7, 1, 128, 64), (2, 40, 1024, 256),
    (2, 77, 512, 2048), (47, 77, 512, 1536), (47, 77, 512, 2048), (256, 100, 768, 3072),
    (1, 63, 768, 2304), (3, 50, 768, 3072), (1, 100, 1664, 64), (1, 30, 1664, 72),
])
def test_cuda_ln_linear_matches_plain_version(B, L, D, O):
    _need_cuda()
    rng = np.random.default_rng(B * L + D + O)
    x, ln_w, ln_b, w, wb = _ln_inputs(rng, B, L, D, O)
    y = FL.fused_ln_linear(x, ln_w, ln_b, w, wb)
    ref = FL.fused_ln_linear_plain(x, ln_w, ln_b, w, wb)
    torch.cuda.synchronize()
    assert y.shape == (B, L, O) and y.dtype == torch.bfloat16
    _assert_out_close(y, ref)
    if O >= 64:  # control: one 16-output block of W zeroed
        dropped = w.clone()
        dropped[O // 2:O // 2 + 16] = 0
        with pytest.raises(AssertionError):
            _assert_out_close(FL.fused_ln_linear_plain(x, ln_w, ln_b, dropped, wb), ref)


@pytest.mark.gpu
def test_cuda_ln_linear_refuses_a_plan_it_cannot_take():
    """The entry point returns an error for a plan whose tile, stages,
    splits or shared memory it cannot take; the wrapper raises on one."""
    _need_cuda()
    x, ln_w, ln_b, w, wb = _ln_inputs(np.random.default_rng(3), 1, 100, 1664, 128)
    w16 = w.to(torch.bfloat16)
    y = torch.empty(1, 100, 128, device="cuda", dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    for bm, bn, n_splits, stages in ((128, 128, 1, 2), (128, 64, 1, 2), (64, 64, 1, 1),
                                     (64, 64, 1, 9), (32, 64, 1, 2), (64, 32, 1, 2),
                                     (64, 64, 3, 2), (64, 64, 0, 2)):
        err = FL._kernel()(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w16.data_ptr(),
                           wb.data_ptr(), y.data_ptr(), 100, 1664, 128, FL.LN_EPS, bm, bn,
                           n_splits, stages, stream)
        assert err != 0, (bm, bn, n_splits, stages)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_every_plan_form_counts_its_launch():
    """Each form of each launch plan, run through its wrapper, adds one to
    its kernel's count and matches the plain version: the backward's short
    rows and its three long-row forms; K8's three tiles."""
    _need_cuda()
    rng = np.random.default_rng(31)
    for (B, L, H, D), form in (((2, 77, 2, 64), None), ((2, 197, 2, 64), "resident_pair"),
                               ((2, 197, 1, 128), "resident"), ((2, 256, 2, 64), "tiled"),
                               ((1, 257, 1, 128), "tiled")):
        if form:
            assert A.bwd_long_row_plan(B, L, H, D, False, 132).form == form
        x = _qkv(rng, B, L, H, D).to("cuda", torch.bfloat16)
        dout = torch.from_numpy(rng.standard_normal((B, L, H * D)).astype(np.float32)).to("cuda", torch.bfloat16)
        out, lse2 = A.flash_attention_qkv(x, H)
        A.reset_launch_counts()
        ours = A.flash_attention_qkv_bwd(x, out, dout, lse2, H)
        assert A.launch_counts["flash_bwd"] == 1 and sum(A.launch_counts.values()) == 1
        torch.cuda.synchronize()
        _assert_grads_close(ours, A.flash_bwd_plain(x, out, dout, lse2, H, False), H, D)
    for (B, L, D, O), tile in (((2, 77, 512, 1536), (128, 128)), ((1, 50, 768, 3072), (128, 128)),
                               ((2, 40, 1024, 256), (64, 128)), ((1, 100, 1664, 64), (64, 64))):
        plan = FL.ln_linear_plan(B * L, D, O, 132)
        assert (plan.bm, plan.bn) == tile
        x, ln_w, ln_b, w, wb = _ln_inputs(rng, B, L, D, O)
        FL.reset_launch_counts()
        y = FL.fused_ln_linear(x, ln_w, ln_b, w, wb)
        assert FL.launch_counts == {"ln_linear": 1}
        torch.cuda.synchronize()
        _assert_out_close(y, FL.fused_ln_linear_plain(x, ln_w, ln_b, w, wb))


@pytest.mark.gpu
def test_cuda_fused_ln_linear_function_matches_autograd_through_unfused():
    """FusedLnLinear's gradient is that of dense(layer_norm(x)): every input's
    gradient against autograd through the unfused composition, in bf16
    (the same products, taken by other calls: ||d - ref|| / ||ref|| <= 1e-2)."""
    _need_cuda()
    rng = np.random.default_rng(8)
    inputs = _ln_inputs(rng, 4, 77, 512, 1536)
    dy = torch.from_numpy(rng.standard_normal((4, 77, 1536)).astype(np.float32)).to("cuda", torch.bfloat16)
    grads = []
    for fused in (True, False):
        args = [t.clone().requires_grad_(True) for t in inputs]
        y = (FL.FusedLnLinear.apply(*args, FL.LN_EPS) if fused
             else FL.dense(FL.layer_norm(*args[:3]), args[3], args[4], torch.bfloat16))
        grads.append(torch.autograd.grad(y, args, dy))
    torch.cuda.synchronize()
    for name, a, r in zip(("x", "ln_w", "ln_b", "w", "wb"), *grads):
        assert a.dtype == r.dtype and a.shape == r.shape
        rel = float((a.float() - r.float()).norm() / r.float().norm())
        assert rel <= 1e-2, f"d{name}: {rel:.4g}"


# -- the attention lab's kernels (csrc/lab.cu) --------------------------------
# Forward o and the gradients are held as above; lse (natural log) atol 1e-3.
# The head-summed products are f32: ||S - ref|| / ||ref|| <= 1e-4 and
# max|S - ref| <= 1e-4 * max|ref| (both sides multiply the same bf16
# operands exactly in f32 and differ only in the order of the f32 sums).

F32_REL_TOL = 1e-4


def _lab_qkv(rng, B, H, L, D, layout):
    """q, k ~ N(0, 0.3^2), v ~ N(0, 1), bf16 on the card, [B, L, H*D] or [B, H, L, D]."""
    shape = (B, L, H * D) if layout == "packed" else (B, H, L, D)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std).to("cuda", torch.bfloat16)
            for std in (0.3, 0.3, 1.0)]


def _assert_lab_grads_close(ours, ref):
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        a, r = a.float(), r.float()
        rel = float((a - r).norm() / r.norm())
        worst = float((a - r).abs().max() / r.abs().max())
        assert rel <= GRAD_REL_TOL and worst <= GRAD_MAX_TOL, f"{name}: {rel:.4g}, {worst:.4g}"


def _assert_f32_close(out, ref):
    d = out - ref
    assert float(d.norm() / ref.norm()) <= F32_REL_TOL
    assert float(d.abs().max() / ref.abs().max()) <= F32_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 16, 50, 64, 65, 77, 128, 129, 197, 256, 257])
def test_cuda_lab_forward_matches_plain_versions(L, D):
    """Packed, BHLD and BHLD between permutes against their plain versions;
    the packed and BHLD entry points run one kernel and agree bit for bit."""
    _need_cuda()
    rng = np.random.default_rng(L * 1000 + D + 17)
    B, H = 3, 2
    q, k, v = _lab_qkv(rng, B, H, L, D, "packed")
    o, lse = LB.lab_fwd_packed(q, k, v, H)
    ref_o, ref_lse = LB.lab_fwd_packed_plain(q, k, v, H)
    o3, lse3 = LB.lab_fwd_v3_packed(q, k, v, H)
    qb, kb, vb = (LB.to_bhld(x, H).contiguous() for x in (q, k, v))
    ob, lseb = LB.lab_fwd_bhld(qb, kb, vb)
    ref_ob, ref_lseb = LB.lab_fwd_bhld_plain(qb, kb, vb)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, L) and lseb.shape == (H, B, L)
    _assert_out_close(o, ref_o)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
    _assert_out_close(ob, ref_ob)
    torch.testing.assert_close(lseb, ref_lseb, atol=LSE_TOL, rtol=0)
    assert torch.equal(o3, o) and torch.equal(lse3.transpose(0, 1), lse)
    assert torch.equal(LB.from_bhld(ob), o)
    if L >= 32:  # control: the check sees one 16-key block of values dropped
        dropped = v.clone()
        dropped[:, L // 2:L // 2 + 16] = 0
        with pytest.raises(AssertionError):
            _assert_out_close(LB.lab_fwd_packed_plain(q, k, dropped, H)[0], ref_o)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [16, 50, 77, 129, 197])
def test_cuda_lab_backward_matches_plain_version(L, D):
    _need_cuda()
    rng = np.random.default_rng(L * 1000 + D + 19)
    B, H = 3, 2
    qb, kb, vb = _lab_qkv(rng, B, H, L, D, "bhld")
    dob = torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32)).to("cuda", torch.bfloat16)
    _, lse = LB.lab_fwd_bhld(qb, kb, vb)
    ours = LB.lab_bwd_bhld(qb, kb, vb, dob, lse)
    ref = LB.lab_bwd_bhld_plain(qb, kb, vb, dob, lse)
    torch.cuda.synchronize()
    _assert_lab_grads_close(ours, ref)
    if L >= 32:  # control: dq and dk see one 16-key block of values dropped
        dropped = vb.clone()
        dropped[:, :, L // 2:L // 2 + 16] = 0
        with pytest.raises(AssertionError):
            _assert_lab_grads_close(LB.lab_bwd_bhld_plain(qb, kb, dropped, dob, lse), ref)


@pytest.mark.gpu
def test_cuda_lab_function_matches_autograd_through_plain_forward():
    """LabAttentionBHLD's gradient (both lab kernels) against autograd
    through the plain lab forward, in bf16."""
    _need_cuda()
    rng = np.random.default_rng(21)
    B, H, L, D = 4, 2, 77, 64
    qb, kb, vb = _lab_qkv(rng, B, H, L, D, "bhld")
    dob = torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32)).to("cuda", torch.bfloat16)
    grads = []
    for forward in (lambda *x: LB.LabAttentionBHLD.apply(*x)[0], lambda *x: LB.lab_fwd_bhld_plain(*x)[0]):
        leaves = [x.clone().requires_grad_(True) for x in (qb, kb, vb)]
        grads.append(torch.autograd.grad(forward(*leaves), leaves, dob))
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), *grads):
        rel = float((a.float() - r.float()).norm() / r.float().norm())
        assert rel <= 2e-2, f"{name}: {rel:.4g}"


@pytest.mark.gpu
@pytest.mark.parametrize("H,D", [(2, 64), (8, 64), (2, 128)])
@pytest.mark.parametrize("L", [1, 16, 50, 77, 127, 128])
def test_cuda_lab_head_summed_products_match_plain_versions(L, H, D):
    """Q K^T (natural and pret, which agree bit for bit) and P V against
    their plain versions, N(0, 1) bf16 operands."""
    _need_cuda()
    rng = np.random.default_rng(L * 100 + H * 10 + D)
    B, HD = 3, H * D
    q, k, p, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", torch.bfloat16)
                  for s in ((B, L, HD), (B, L, HD), (B, L, L), (B, L, HD)))
    kt = k.transpose(1, 2).contiguous()
    s = LB.qk_heads_natural(q, k, H)
    s_pret = LB.qk_heads_pret(q, kt, H)
    o = LB.pv_heads(p, v, H)
    ref_s, ref_o = LB.qk_heads_natural_plain(q, k, H), LB.pv_heads_plain(p, v, H)
    torch.cuda.synchronize()
    assert s.shape == (B, L, L) and o.shape == (B, L, D) and s.dtype == o.dtype == torch.float32
    _assert_f32_close(s, ref_s)
    assert torch.equal(s_pret, s)
    _assert_f32_close(o, ref_o)
    torch.testing.assert_close(LB.qk_heads_pret_plain(q, kt, H), ref_s, atol=0, rtol=F32_REL_TOL)
    if HD >= 32:  # controls: one 16-column block of k or of v zeroed
        dk, dv = k.clone(), v.clone()
        dk[:, :, HD // 2:HD // 2 + 16] = 0
        dv[:, :, HD // 2:HD // 2 + 16] = 0
        with pytest.raises(AssertionError):
            _assert_f32_close(LB.qk_heads_natural_plain(q, dk, H), ref_s)
        with pytest.raises(AssertionError):
            _assert_f32_close(LB.pv_heads_plain(p, dv, H), ref_o)


def _lab_fwd_entry(entry, q, k, v, H, plan_args):
    """A lab forward entry point called with an explicit plan (grid,
    stages; (0, 0) is the one-CTA form): (error, o, lse)."""
    if entry == "packed":
        B, L, HD = q.shape
        D, lse_shape = HD // H, (B, H, L)
    else:
        B, H, L, D = q.shape
        lse_shape = (H, B, L)
    o = torch.empty_like(q)
    lse = torch.empty(lse_shape, device="cuda")
    err = LB._kernel(f"latteclip_lab_fwd_{entry}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, L, H, D, D ** -0.5,
        *plan_args, torch.cuda.current_stream().cuda_stream)
    return err, o, lse


def _lab_qk_entry(entry, q, k, plan_args):
    """A Q K^T entry point called with an explicit plan: (error, S)."""
    B, L, HD = q.shape
    s = torch.empty(B, L, L, device="cuda")
    err = LB._kernel(f"latteclip_lab_qk_{entry}")(q.data_ptr(), k.data_ptr(), s.data_ptr(), B, L, HD,
                                                   *plan_args, torch.cuda.current_stream().cuda_stream)
    return err, s


# The lab rings on explicit grids: (B, grid) so that the items (B * H for the
# forward at H = 2, B for Q K^T) wrap the grid many times, are no multiple of
# it, or are fewer than the CTAs (the grid then has one CTA per item); and
# the one-CTA form, grid 0.
LAB_GRIDS = {"wraps": (15, 4), "ragged": (7, 5), "fewer_than_ctas": (2, 300), "cta": (3, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("grids", list(LAB_GRIDS))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 16, 50, 64, 65, 77, 128, 129, 197, 256, 257])
def test_cuda_lab_forward_forms_match_plain_versions(L, D, grids):
    """Each form of the lab forward (the ring, with the plan's stages, and
    the one-CTA form) against the plain version on explicit grids; packed and
    BHLD agree bit for bit on each. Rows beyond the ring's 256 tokens take
    the one-CTA form only: the ring's entry refuses them."""
    _need_cuda()
    B, grid = LAB_GRIDS[grids]
    H = 2
    rng = np.random.default_rng(L * 1000 + D + 29 + B)
    q, k, v = _lab_qkv(rng, B, H, L, D, "packed")
    qb, kb, vb = (LB.to_bhld(x, H).contiguous() for x in (q, k, v))
    stages = LB.lab_fwd_plan(B, L, H, D, 132).stages or 1
    if L > LB.FWD_RING_MAX_LEN and grid:
        err, _, _ = _lab_fwd_entry("packed", q, k, v, H, (grid, 1))
        assert err != 0
        return
    err, o, lse = _lab_fwd_entry("packed", q, k, v, H, (grid, stages))
    errb, ob, lseb = _lab_fwd_entry("bhld", qb, kb, vb, H, (grid, stages))
    ref_o, ref_lse = LB.lab_fwd_packed_plain(q, k, v, H)
    torch.cuda.synchronize()
    assert err == 0 and errb == 0
    _assert_out_close(o, ref_o)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
    assert torch.equal(LB.from_bhld(ob), o) and torch.equal(lseb.transpose(0, 1), lse)


@pytest.mark.gpu
@pytest.mark.parametrize("grids", list(LAB_GRIDS))
@pytest.mark.parametrize("H,D", [(2, 64), (8, 64), (2, 128)])
@pytest.mark.parametrize("L", [1, 16, 50, 77, 127, 128])
def test_cuda_lab_qk_forms_match_plain_versions(L, H, D, grids):
    """Each form of the head-summed Q K^T (the ring, with the plan's stages,
    and the one-CTA form) against the plain version on explicit grids;
    natural and pret agree bit for bit on each."""
    _need_cuda()
    B, grid = LAB_GRIDS[grids]
    rng = np.random.default_rng(L * 100 + H * 10 + D + 31 + B)
    HD = H * D
    q, k = (torch.from_numpy(rng.standard_normal((B, L, HD)).astype(np.float32)).to("cuda", torch.bfloat16)
            for _ in range(2))
    kt = k.transpose(1, 2).contiguous()
    stages = LB.lab_qk_plan(B, L, HD, 132).stages
    err, s = _lab_qk_entry("natural", q, k, (grid, stages))
    errp, sp = _lab_qk_entry("pret", q, kt, (grid, stages))
    ref = LB.qk_heads_natural_plain(q, k, H)
    torch.cuda.synchronize()
    assert err == 0 and errp == 0
    _assert_f32_close(s, ref)
    assert torch.equal(sp, s)


@pytest.mark.gpu
def test_cuda_lab_rings_refuse_a_plan_they_cannot_take():
    """The ring entry points return an error for stages they cannot hold
    (none, more than the ring's most, or past a CTA's shared memory; Q K^T
    also one, since its slot is released only once the next chunk's
    products are issued) and
    for rows the ring does not take, and launch nothing for them."""
    _need_cuda()
    H = 2
    for L, D, stages in ((50, 64, 0), (50, 64, LB.RING_MAX_STAGES + 1), (197, 128, 2), (257, 64, 1)):
        x = torch.zeros(1, L, H * D, device="cuda", dtype=torch.bfloat16)
        err, _, _ = _lab_fwd_entry("packed", x, x, x, H, (1, stages))
        assert err != 0, (L, D, stages)
    for L, stages in ((77, 0), (77, 1), (77, LB.QK_MAX_STAGES + 1), (128, 4)):
        x = torch.zeros(1, L, 128, device="cuda", dtype=torch.bfloat16)
        for entry in ("natural", "pret"):
            err, _ = _lab_qk_entry(entry, x, x, (1, stages))
            assert err != 0, (entry, L, stages)
    torch.cuda.synchronize()


def _lab_bwd_entry(qb, kb, vb, dob, lse, plan_args):
    """The lab backward's entry point called with an explicit plan (grid,
    stages; (0, 0) is the one-CTA form): (error, [dq, dk, dv])."""
    B, H, L, D = qb.shape
    grads = [torch.empty_like(qb) for _ in range(3)]
    err = LB._kernel("latteclip_lab_bwd_bhld")(
        *(x.data_ptr() for x in (qb, kb, vb, dob, lse, *grads)), B, L, H, D, D ** -0.5, *plan_args,
        torch.cuda.current_stream().cuda_stream)
    return err, grads


def _lab_pv_entry(p, v, H, plan_args):
    """The P V entry point called with an explicit plan: (error, O)."""
    B, L, HD = v.shape
    o = torch.empty(B, L, HD // H, device="cuda")
    err = LB._kernel("latteclip_lab_pv")(p.data_ptr(), v.data_ptr(), o.data_ptr(), B, L, H, HD // H, *plan_args,
                                          torch.cuda.current_stream().cuda_stream)
    return err, o


@pytest.mark.gpu
@pytest.mark.parametrize("grids", list(LAB_GRIDS))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [16, 50, 77, 129, 197])
def test_cuda_lab_bwd_forms_match_plain_versions(L, D, grids):
    """Each form of the lab backward (the ring with one and, where two fit,
    two resident items, and the one-CTA form) against the plain version and
    against each other on explicit grids. At head_dim 128 the ring's entry
    refuses the row: the plan keeps the one-CTA form there."""
    _need_cuda()
    B, grid = LAB_GRIDS[grids]
    H = 2
    rng = np.random.default_rng(L * 1000 + D + 41 + B)
    qb, kb, vb = _lab_qkv(rng, B, H, L, D, "bhld")
    dob = torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32)).to("cuda", torch.bfloat16)
    _, lse = LB.lab_fwd_bhld(qb, kb, vb)
    ref = LB.lab_bwd_bhld_plain(qb, kb, vb, dob, lse)
    err, cta = _lab_bwd_entry(qb, kb, vb, dob, lse, (0, 0))
    rings = []
    if grid and D == 128:
        assert _lab_bwd_entry(qb, kb, vb, dob, lse, (grid, 1))[0] != 0
    elif grid:
        rings = [_lab_bwd_entry(qb, kb, vb, dob, lse, (grid, stages)) for stages in (1, 2)
                 if LB.lab_bwd_smem_bytes(L, stages) <= LB.MAX_SMEM]
        assert len(rings) == (2 if L <= 144 else 1)
    torch.cuda.synchronize()
    assert err == 0
    _assert_lab_grads_close(cta, ref)
    for err_ring, grads in rings:
        assert err_ring == 0
        _assert_lab_grads_close(grads, ref)
        _assert_lab_grads_close(grads, cta)


# P V on explicit grids: one CTA for every row, fewer CTAs than rows, more
# CTAs than rows, and the one-CTA-per-row form (grid 0)
PV_GRIDS = {"one_cta": 1, "ragged": 2, "more_than_rows": 300, "cta": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("grids", list(PV_GRIDS))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 77, 127])
@pytest.mark.parametrize("B", [3, 9])
def test_cuda_lab_pv_forms_match_plain_versions(B, L, D, grids):
    """Each form of the head-summed P V (the ring with the plan's stages and
    with the fewest, and the one-CTA form) against the plain version and
    against each other, at batch sizes and odd rows where most batch rows of
    p start off a 16-byte boundary (the ring copies the aligned span around
    each and reads the last batch row's tail from device memory)."""
    _need_cuda()
    grid, H = PV_GRIDS[grids], 3
    rng = np.random.default_rng(L * 100 + B * 10 + D + 43)
    p, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", torch.bfloat16)
            for shape in ((B, L, L), (B, L, H * D)))
    ref = LB.pv_heads_plain(p, v, H)
    err, cta = _lab_pv_entry(p, v, H, (0, 0))
    stages = {LB.lab_pv_plan(B, L, H, D, 132).stages, LB.PV_MIN_STAGES}
    rings = [_lab_pv_entry(p, v, H, (grid, st)) for st in sorted(stages)] if grid else []
    torch.cuda.synchronize()
    assert err == 0
    _assert_f32_close(cta, ref)
    for err_ring, o in rings:
        assert err_ring == 0
        _assert_f32_close(o, ref)
        _assert_f32_close(o, cta)


@pytest.mark.gpu
def test_cuda_lab_bwd_and_pv_rings_refuse_a_plan_they_cannot_take():
    """The backward ring refuses no resident item or more than two, two items
    of rows past 144 tokens, rows past 208 and head_dim 128; the P V ring one
    stage (no copy would be in flight while a step is multiplied), more than
    PV_MAX_STAGES, rows past 128 and stages that do not fit a CTA."""
    _need_cuda()
    H = 2
    for L, D, stages in ((50, 64, 0), (50, 64, LB.BWD_RING_MAX_STAGES + 1), (197, 64, 2), (209, 64, 1),
                         (77, 128, 1)):
        xb = torch.zeros(1, H, L, D, device="cuda", dtype=torch.bfloat16)
        lse = torch.zeros(H, 1, L, device="cuda")
        assert _lab_bwd_entry(xb, xb, xb, xb, lse, (1, stages))[0] != 0, (L, D, stages)
    for L, HD, stages in ((77, 128, 1), (77, 128, LB.PV_MAX_STAGES + 1), (129, 128, 2), (77, 8192, 2)):
        p = torch.zeros(1, L, L, device="cuda", dtype=torch.bfloat16)
        v = torch.zeros(1, L, HD, device="cuda", dtype=torch.bfloat16)
        assert _lab_pv_entry(p, v, HD // 64, (1, stages))[0] != 0, (L, HD, stages)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_lab_bwd_and_pv_plan_forms_count_their_launch():
    """Each form the backward and P V plans pick, through the wrappers, adds
    one to its kernel's count and matches the plain version."""
    _need_cuda()
    rng = np.random.default_rng(47)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, L, H, D, want in ((4, 197, 2, 64, ("ring", 1)), (4, 77, 2, 64, ("ring", 2)), (3, 50, 2, 128, ("cta", 0))):
        qb, kb, vb = _lab_qkv(rng, B, H, L, D, "bhld")
        _, lse = LB.lab_fwd_bhld(qb, kb, vb)
        plan = LB.lab_bwd_plan(B, L, H, D, sms)
        assert (plan.form, plan.stages) == want
        LB.reset_launch_counts()
        grads = LB.lab_bwd_bhld(qb, kb, vb, vb, lse)
        assert LB.launch_counts == {"lab_fwd": 0, "lab_bwd": 1, "lab_qk": 0, "lab_pv": 0}
        ref = LB.lab_bwd_bhld_plain(qb, kb, vb, vb, lse)
        torch.cuda.synchronize()
        _assert_lab_grads_close(grads, ref)
    for B, L, H, D in ((3, 77, 3, 64), (9, 1, 2, 128)):
        p, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", torch.bfloat16)
                for shape in ((B, L, L), (B, L, H * D)))
        assert LB.lab_pv_plan(B, L, H, D, sms).form == "ring"
        LB.reset_launch_counts()
        o = LB.pv_heads(p, v, H)
        assert LB.launch_counts == {"lab_fwd": 0, "lab_bwd": 0, "lab_qk": 0, "lab_pv": 1}
        torch.cuda.synchronize()
        _assert_f32_close(o, LB.pv_heads_plain(p, v, H))


@pytest.mark.gpu
def test_cuda_lab_plan_forms_count_their_launch():
    """Each form the lab plans pick, through the wrappers, adds one to its
    kernel's count and matches the plain version."""
    _need_cuda()
    rng = np.random.default_rng(37)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, L, H, D in ((4, 197, 2, 64), (2, 300, 2, 64), (5, 50, 2, 128)):
        q, k, v = _lab_qkv(rng, B, H, L, D, "packed")
        LB.reset_launch_counts()
        o, lse = LB.lab_fwd_packed(q, k, v, H)
        assert LB.launch_counts == {"lab_fwd": 1, "lab_bwd": 0, "lab_qk": 0, "lab_pv": 0}
        assert LB.lab_fwd_plan(B, L, H, D, sms).form == ("cta" if L > LB.FWD_RING_MAX_LEN else "ring")
        ref_o, ref_lse = LB.lab_fwd_packed_plain(q, k, v, H)
        torch.cuda.synchronize()
        _assert_out_close(o, ref_o)
        torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)


@pytest.mark.gpu
def test_cuda_lab_wrappers_count_each_launch():
    _need_cuda()
    B, L, H, D = 2, 50, 2, 64
    x = torch.zeros(B, L, H * D, device="cuda", dtype=torch.bfloat16)
    xb = torch.zeros(B, H, L, D, device="cuda", dtype=torch.bfloat16)
    LB.reset_launch_counts()
    LB.lab_fwd_packed(x, x, x, H)
    _, lse = LB.lab_fwd_bhld(xb, xb, xb)
    LB.lab_fwd_v3_packed(x, x, x, H)
    LB.lab_bwd_bhld(xb, xb, xb, xb, lse)
    LB.qk_heads_natural(x, x, H)
    LB.qk_heads_pret(x, x.transpose(1, 2).contiguous(), H)
    LB.pv_heads(torch.zeros(B, L, L, device="cuda", dtype=torch.bfloat16), x, H)
    assert LB.launch_counts == {"lab_fwd": 3, "lab_bwd": 1, "lab_qk": 2, "lab_pv": 1}


@pytest.mark.gpu
def test_cuda_lab_wrappers_raise_on_what_the_kernels_do_not_take():
    _need_cuda()
    x = torch.zeros(2, 50, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        LB.lab_fwd_packed(x, x, x, 4)                   # D = 32
    with pytest.raises(ValueError, match="bfloat16"):
        LB.lab_fwd_packed(x.float(), x.float(), x.float(), 2)
    wide = torch.zeros(2, 50, 256, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        LB.lab_fwd_packed(wide[:, :, :128], x, x, 2)
    with pytest.raises(ValueError, match="shared memory"):  # a row too long for one CTA
        xl = torch.zeros(1, 1024, 128, device="cuda", dtype=torch.bfloat16)
        LB.lab_fwd_packed(xl, xl, xl, 2)
    xb = torch.zeros(2, 2, 50, 64, device="cuda", dtype=torch.bfloat16)
    _, lse = LB.lab_fwd_bhld(xb, xb, xb)
    with pytest.raises(ValueError, match="lse"):  # [B, H, L] where [H, B, L] is taken
        LB.lab_bwd_bhld(xb, xb, xb, xb, torch.zeros(2, 2, 49, device="cuda"))
    long_row = torch.zeros(2, 129, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="L <= 128"):
        LB.qk_heads_natural(long_row, long_row, 2)
    with pytest.raises(ValueError, match="multiple of 64"):
        LB.qk_heads_natural(torch.zeros(2, 50, 96, device="cuda", dtype=torch.bfloat16),
                            torch.zeros(2, 50, 96, device="cuda", dtype=torch.bfloat16), 3)
    with pytest.raises(ValueError, match="kT|k must"):
        LB.qk_heads_pret(x, x, 2)  # k given [B, L, HD] where [B, HD, L] is taken
    with pytest.raises(ValueError, match="p must"):
        LB.pv_heads(torch.zeros(2, 50, 49, device="cuda", dtype=torch.bfloat16), x, 2)


@pytest.mark.parametrize("kind", ["fwd", "bwd", "qk", "pv"])
def test_lab_checks_see_one_zeroed_block(kind):
    """On the CPU: each lab check rejects its plain version with one 16-key
    block of v (attention) or one 16-column block of k or v (products)
    zeroed, by a wide margin, at the lab tools' row lengths."""
    rng = np.random.default_rng(23)
    B, H, D = 2, 2, 64
    if kind in ("fwd", "bwd"):
        L = 197
        qb, kb, vb = (torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32) * s).to(torch.bfloat16)
                      for s in (0.3, 0.3, 1.0))
        dropped = vb.clone()
        dropped[:, :, L // 2:L // 2 + 16] = 0
        if kind == "fwd":
            ref = LB.lab_fwd_bhld_plain(qb, kb, vb)[0]
            _assert_out_close(ref, ref)
            wrong = LB.lab_fwd_bhld_plain(qb, kb, dropped)[0]
            with pytest.raises(AssertionError):
                _assert_out_close(wrong, ref)
            assert float((wrong.float() - ref.float()).norm() / ref.float().norm()) > 5 * OUT_REL_TOL
        else:
            lse = LB.lab_fwd_bhld_plain(qb, kb, vb)[1]
            ref = LB.lab_bwd_bhld_plain(qb, kb, vb, vb, lse)
            _assert_lab_grads_close(ref, ref)
            wrong = LB.lab_bwd_bhld_plain(qb, kb, dropped, vb, lse)
            with pytest.raises(AssertionError):
                _assert_lab_grads_close(wrong, ref)
            assert float((wrong[1].float() - ref[1].float()).norm() / ref[1].float().norm()) > 5 * GRAD_REL_TOL
        return
    L, HD = 77, H * D
    a = torch.from_numpy(rng.standard_normal((B, L, HD if kind == "qk" else L)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((B, L, HD)).astype(np.float32)).to(torch.bfloat16)
    plain = LB.qk_heads_natural_plain if kind == "qk" else LB.pv_heads_plain
    ref = plain(a, b, H)
    _assert_f32_close(ref, ref)
    dropped = b.clone()
    dropped[:, :, HD // 2:HD // 2 + 16] = 0
    wrong = plain(a, dropped, H)
    with pytest.raises(AssertionError):
        _assert_f32_close(wrong, ref)
    assert float((wrong - ref).norm() / ref.norm()) > 100 * F32_REL_TOL
