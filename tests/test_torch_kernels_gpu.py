"""latteclip_torch CUDA kernels against their plain PyTorch versions, on the card.

The kernels are CUDA C++ for sm_90a with no CPU mode, so every test that
launches them is marked ``gpu`` and skips without a CUDA device; the test of
the out check itself runs on the CPU. The file imports neither JAX nor
latteclip_tpu, so it runs on a machine that has only PyTorch; there, skip the
JAX-side conftest:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q -m gpu

Lengths cover both sides of each dispatch edge of the kernels (one 64-key
tile up to L=64, one 128-key tile up to L=128, 64 x 64 tiles beyond) and a
ragged edge in each. q and k are drawn from N(0, 0.3^2), v and the
cotangent from N(0, 1).
Tolerances as in tests/test_torch_attention.py: bf16 out elementwise
atol = rtol = 2e-2 and, relative to the reference's own size,
||out - ref|| / ||ref|| <= 1e-2 (bf16 rounding of out gives < 2^-8; the
elementwise bound alone is near the size of out itself at long rows); lse2
atol 1e-3. The backward kernels are held on dq, dk and dv separately:
||d - ref|| / ||ref|| <= 1e-2 and, elementwise, |d - ref| <= 2e-2 * max|ref|
(each gradient is rounded to bf16 once, < 2^-8 relative, and a flip in the
bf16 rounding of one p or ds moves a sum of L terms by far less).

The head-split kernels run the whole-row kernels' arithmetic and differ only
in where lse2 and the gradient are stored, so they are held to the
whole-row kernels bit for bit as well as to their plain versions. The fused
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

        dqkv3 = A.flash_attention_qkv_hs_bwd(x, out, dout, lse2, H, causal)
        ref3 = A.flash_bwd_hs_plain(x, out, dout, lse2, H, causal)
        torch.cuda.synchronize()
        assert dqkv3.shape == (3, B, L, H * D)
        check = _assert_single_token_grads if L == 1 else _assert_grads_close
        check(A.merge_dqkv(dqkv3), A.merge_dqkv(ref3), H, D)
        assert torch.equal(A.merge_dqkv(dqkv3), A.flash_attention_qkv_bwd(x, out, dout, lse1, H, causal))


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


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,D,O", [
    (3, 77, 512, 1536), (2, 100, 768, 2304), (1, 50, 768, 3072), (5, 13, 64, 200),
    (7, 1, 128, 64), (2, 40, 1024, 256),
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
@pytest.mark.parametrize("L", [1, 16, 50, 77, 129, 197])
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
@pytest.mark.parametrize("L", [1, 16, 50, 77, 128])
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
