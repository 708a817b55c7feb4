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
"""
import numpy as np
import pytest
import torch

from latteclip_torch.kernels import attention as A

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
    assert A.launch_counts == {"flash_fwd": 1, "flash_fwd_seg": 2, "flash_bwd": 1, "flash_bwd_seg": 1}


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
