"""latteclip_torch attention backward: the plain versions of the two backward
kernels against the Pallas kernels they port, the autograd Functions on the
CPU, and the plain backward against autograd.

The JAX side is ``jax.vjp`` of ``flash_attention_qkv`` /
``flash_attention_qkv_segmented``, whose custom VJP runs ``_bwd_kernel`` /
``_bwd_kernel_seg`` in interpret mode off-TPU. The port's plain backward is
fed the residuals of the JAX forward (``_flash_fwd_impl`` /
``_flash_fwd_seg_impl``) and the same bf16 cotangent, so the comparison is of
the backward alone. q and k are N(0, 0.3^2) as in the JAX kernel tests, v
and the cotangent N(0, 1).

Tolerances: both sides repeat the same bf16 roundings (pb, ds and each
gradient once) and differ only in f32 summation order, which can flip the
rounding of a single p or ds. dq, dk and dv are each held to
||d - ref|| / ||ref|| <= 1e-2 and, elementwise, |d - ref| <= 2e-2 * max|ref|,
the bounds chip_smoke.py holds the CUDA kernels to. In float32 the plain
backward and autograd through the plain forward are the same function up to
f32 rounding: atol 1e-5 on gradients of size ~1.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from latteclip_tpu.kernels.attention import (
    _flash_fwd_impl,
    _flash_fwd_seg_impl,
    flash_attention_qkv,
    flash_attention_qkv_segmented,
)
from latteclip_torch.kernels import attention as A

torch.set_num_threads(1)

GRAD_REL_TOL = 1e-2
GRAD_MAX_TOL = 2e-2
F32_TOL = 1e-5


def _inputs(B, L, H, D, seed):
    rng = np.random.default_rng(seed)
    std = np.repeat(np.array([0.3, 0.3, 1.0], np.float32), H * D)
    qkv = (rng.standard_normal((B, L, 3 * H * D)) * std).astype(np.float32)
    dout = rng.standard_normal((B, L, H * D)).astype(np.float32)
    return qkv, dout


def _packed_text_segments(R, P):
    seg = np.zeros((R, P), np.int32)
    for r in range(R):  # three segments, then a seg-0 padding tail
        a, b, c = 30 + r, 41, 37 - r
        seg[r, :a] = 1
        seg[r, a:a + b] = 2
        seg[r, a + b:a + b + c] = 3
    return seg


def _assert_grads_close(ours, ref, H, D):
    ours, ref = ours.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert ours.shape == ref.shape
    for i, name in enumerate(("dq", "dk", "dv")):
        a, r = ours[..., i * H * D:(i + 1) * H * D], ref[..., i * H * D:(i + 1) * H * D]
        rel = np.linalg.norm(a - r) / np.linalg.norm(r)
        worst = np.abs(a - r).max() / np.abs(r).max()
        assert rel <= GRAD_REL_TOL and worst <= GRAD_MAX_TOL, f"{name}: rel {rel:.3g}, max {worst:.3g}"


@pytest.mark.parametrize("L,causal,D", [(50, False, 64), (77, True, 64), (77, True, 128)])
def test_flash_bwd_plain_matches_pallas(L, causal, D):
    H, B = 2, 3  # B=3 is odd: JAX pads rows to its group
    x, g = _inputs(B, L, H, D, seed=L + D)
    xj, gj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a: flash_attention_qkv(a, H, causal), xj)
    ref = vjp(gj)[0]
    out, lse2 = _flash_fwd_impl(xj, causal, H)
    ours = A.flash_bwd_plain(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(np.array(out.astype(jnp.float32))),
        torch.from_numpy(g).to(torch.bfloat16), torch.from_numpy(np.array(lse2)), H, causal)
    assert ours.dtype == torch.bfloat16
    _assert_grads_close(ours, ref, H, D)


@pytest.mark.parametrize("layout", ["vision_pairs", "packed_text"])
def test_flash_bwd_seg_plain_matches_pallas(layout):
    if layout == "vision_pairs":  # two 50-token images per row, non-causal
        R, P, causal = 3, 100, False
        seg = np.tile(np.repeat(np.array([1, 2], np.int32), 50), (R, 1))
    else:
        R, P, causal = 2, 128, True
        seg = _packed_text_segments(R, P)
    H, D = 2, 64
    x, g = _inputs(R, P, H, D, seed=P)
    xj, gj, sj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), jnp.asarray(seg)
    _, vjp = jax.vjp(lambda a: flash_attention_qkv_segmented(a, H, sj, causal), xj)
    ref = vjp(gj)[0]
    out, lse2 = _flash_fwd_seg_impl(xj, sj, causal, H)
    ours = A.flash_bwd_seg_plain(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(seg),
        torch.from_numpy(np.array(out.astype(jnp.float32))),
        torch.from_numpy(g).to(torch.bfloat16), torch.from_numpy(np.array(lse2)), H, causal)
    _assert_grads_close(ours, ref, H, D)


def _segments():
    return torch.tensor([[1] * 10 + [2] * 20 + [0] * 7, [1] * 37], dtype=torch.int32)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_functions_on_cpu_equal_the_plain_backward(segmented, causal):
    H, D = 2, 64
    x, g = _inputs(2, 37, H, D, seed=11)
    x = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    g = torch.from_numpy(g).to(torch.bfloat16)
    seg = _segments()
    if segmented:
        out, lse2 = A.FlashAttentionSegmented.apply(x, seg, H, causal)
        ref_out, ref_lse2 = A.flash_fwd_seg_plain(x.detach(), seg, H, causal)
        ref = A.flash_bwd_seg_plain(x.detach(), seg, ref_out, g, ref_lse2, H, causal)
    else:
        out, lse2 = A.FlashAttention.apply(x, H, causal)
        ref_out, ref_lse2 = A.flash_fwd_plain(x.detach(), H, causal)
        ref = A.flash_bwd_plain(x.detach(), ref_out, g, ref_lse2, H, causal)
    assert not lse2.requires_grad
    assert torch.equal(out, ref_out) and torch.equal(lse2, ref_lse2)
    (dx,) = torch.autograd.grad(out, x, g)
    assert torch.equal(dx, ref)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_is_the_gradient_of_the_plain_forward_in_f32(segmented, causal):
    H, D = 3, 16
    x, _ = _inputs(2, 37, H, D, seed=12)
    x = torch.from_numpy(x * 2).requires_grad_(True)  # f32, sharper rows than the kernel tests
    seg = _segments()
    if segmented:
        out, lse2 = A.flash_fwd_seg_plain(x, seg, H, causal)
    else:
        out, lse2 = A.flash_fwd_plain(x, H, causal)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (ref,) = torch.autograd.grad(out, x, g)
    args = (x.detach(), out.detach(), g, lse2.detach(), H, causal)
    ours = (A.flash_bwd_seg_plain(x.detach(), seg, *args[1:]) if segmented
            else A.flash_bwd_plain(*args))
    assert ours.dtype == torch.float32
    torch.testing.assert_close(ours, ref, atol=F32_TOL, rtol=0)


def test_dispatch_differentiates_the_plain_route_on_cpu():
    """Off the kernel route, autograd differentiates the plain forward."""
    from latteclip_torch.kernels import attention_core_qkv, attention_core_qkv_segmented

    x, _ = _inputs(2, 37, 2, 64, seed=13)
    x = torch.from_numpy(x).requires_grad_(True)
    seg = _segments()
    for out in (attention_core_qkv(x, 2, causal=True),
                attention_core_qkv_segmented(x, 2, seg, causal=True)):
        (dx,) = torch.autograd.grad(out.sum(), x)
        assert torch.isfinite(dx).all() and dx.abs().sum() > 0
