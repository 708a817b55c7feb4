"""latteclip_torch attention: the plain versions of the two forward kernels
against the Pallas kernels they port, and the dispatch around them.

The JAX side calls ``_flash_fwd_impl`` / ``_flash_fwd_seg_impl``, which run
the Pallas kernels in interpret mode off-TPU. Inputs are made with numpy and
rounded to bf16 identically on both sides.

Tolerances: out atol = rtol = 2e-2, as for the bf16 kernel tests of the JAX
package (tests/test_kernels.py), and ||out - ref|| / ||ref|| <= 1e-2, which
holds out to its own size (bf16 rounding gives < 2^-8). lse2 atol 1e-3:
both sides round the same
p = exp2(s - rowmax) to bf16 and sum those values in f32, so they differ only
where the f32 summation order of a score flips the bf16 rounding of one p;
such a flip moves lse2 by up to log2(1 + 2^-8) * p / l. q and k are
N(0, 0.3^2), the scale of the JAX package's kernel tests, where rows are
flat enough for 1e-3 to hold (observed <= 5e-7); v, which does not enter
lse2, is N(0, 1). With q and k at unit variance a peaked row can exceed it
through one flip (1.6e-3 measured for the CUDA kernel on
an NVIDIA H100 80GB HBM3 at a 700 W power limit, see PERF.md).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from latteclip_tpu.kernels.attention import _flash_fwd_impl, _flash_fwd_seg_impl
from latteclip_torch.kernels import (
    attention_core_qkv,
    attention_core_qkv_segmented,
    kernel_route,
)
from latteclip_torch.kernels import attention as A

torch.set_num_threads(1)

OUT_TOL = 2e-2
OUT_REL_TOL = 1e-2
LSE_TOL = 1e-3
ONE_P_FLIP_LSE = 2 ** -8 / np.log(2)  # lse2 moved by one flip of a bf16 p, l >= 1


def _qkv(B, L, H, D, seed):
    # q, k ~ N(0, 0.3^2), the scale of the JAX package's kernel tests; v ~ N(0, 1)
    std = np.repeat(np.array([0.3, 0.3, 1.0], np.float32), H * D)
    return (np.random.default_rng(seed).standard_normal((B, L, 3 * H * D)) * std).astype(np.float32)


def _compare(ours, ref):
    out, lse2 = ours
    ref_out, ref_lse2 = ref
    ref_out = np.asarray(ref_out.astype(jnp.float32))
    assert out.shape == ref_out.shape and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref_out, atol=OUT_TOL, rtol=OUT_TOL)
    assert np.linalg.norm(out.float().numpy() - ref_out) <= OUT_REL_TOL * np.linalg.norm(ref_out)
    np.testing.assert_allclose(lse2.numpy(), np.asarray(ref_lse2), atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("L,causal,H,D", [
    (50, False, 2, 64), (77, True, 2, 64), (77, False, 2, 64), (77, True, 2, 128),
])
def test_flash_fwd_plain_matches_pallas(L, causal, H, D):
    x = _qkv(3, L, H, D, seed=L + D)  # B=3 is odd: JAX pads rows to its group
    ref = _flash_fwd_impl(jnp.asarray(x, jnp.bfloat16), causal, H)
    ours = A.flash_fwd_plain(torch.from_numpy(x).to(torch.bfloat16), H, causal)
    _compare(ours, ref)


def _packed_text_segments(R, P):
    seg = np.zeros((R, P), np.int32)
    for r in range(R):  # three segments, then a seg-0 padding tail
        a, b, c = 30 + r, 41, 37 - r
        seg[r, :a] = 1
        seg[r, a:a + b] = 2
        seg[r, a + b:a + b + c] = 3
    return seg


@pytest.mark.parametrize("layout", ["vision_pairs", "packed_text"])
def test_flash_fwd_seg_plain_matches_pallas(layout):
    if layout == "vision_pairs":  # two 50-token images per row, non-causal
        R, P, causal = 3, 100, False
        seg = np.tile(np.repeat(np.array([1, 2], np.int32), 50), (R, 1))
    else:
        R, P, causal = 2, 128, True
        seg = _packed_text_segments(R, P)
    H, D = 2, 64
    x = _qkv(R, P, H, D, seed=P)
    ref = _flash_fwd_seg_impl(jnp.asarray(x, jnp.bfloat16), jnp.asarray(seg), causal, H)
    ours = A.flash_fwd_seg_plain(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(seg), H, causal)
    _compare(ours, ref)


def _pair_segments(rng, R, P):
    """Runs of 2 tokens and of 2..P/3 tokens, alternating, then a seg-0 tail."""
    seg = np.zeros((R, P), np.int32)
    end = P - P // 8
    for r in range(R):
        pos, sid = 0, 1
        while pos + 2 <= end:
            n = min(2 if sid % 2 else int(rng.integers(2, P // 3 + 1)), end - pos)
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


@pytest.mark.parametrize("P,causal", [(128, True), (128, False), (197, False)])
def test_two_token_segments_plain_matches_pallas(P, causal):
    """Segments of 2 tokens, where one flip of the bf16 rounding of p moves
    lse2 by up to 2^-8 / ln 2 = 5.6e-3 (l >= 1): lse2 is held to that bound.
    The Pallas body in interpret mode flips such roundings against the plain
    version too, since the two sum the scores in other orders: at P=197, 2
    of 3152 rows moved by 1.1e-4; every other row agrees to 1e-6. The GPU
    tests hold the CUDA kernel to the same bound."""
    H, D = 2, 64
    rng = np.random.default_rng(P + int(causal))
    x = _qkv(8, P, H, D, seed=P + 7)
    seg = _pair_segments(rng, 8, P)
    ref_out, ref_lse2 = _flash_fwd_seg_impl(jnp.asarray(x, jnp.bfloat16), jnp.asarray(seg), causal, H)
    out, lse2 = A.flash_fwd_seg_plain(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(seg), H, causal)
    ref_out = np.asarray(ref_out.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref_out, atol=OUT_TOL, rtol=OUT_TOL)
    assert np.linalg.norm(out.float().numpy() - ref_out) <= OUT_REL_TOL * np.linalg.norm(ref_out)
    np.testing.assert_allclose(lse2.numpy(), np.asarray(ref_lse2), atol=ONE_P_FLIP_LSE, rtol=0)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    x = torch.from_numpy(_qkv(2, 50, 2, 64, seed=0)).to(torch.bfloat16)
    seg = torch.ones(2, 50, dtype=torch.int32)
    A.reset_launch_counts()
    out, lse2 = A.flash_attention_qkv(x, 2, causal=False)
    ref_out, ref_lse2 = A.flash_fwd_plain(x, 2, causal=False)
    assert torch.equal(out, ref_out) and torch.equal(lse2, ref_lse2)
    out_s, _ = A.flash_attention_qkv_segmented(x, 2, seg, causal=False)
    # one segment per row is plain whole-row attention
    assert torch.equal(out_s, ref_out)
    dqkv = A.flash_attention_qkv_bwd(x, out, out, lse2, 2, causal=False)
    assert torch.equal(dqkv, A.flash_bwd_plain(x, out, out, lse2, 2, causal=False))
    assert torch.equal(A.flash_attention_qkv_segmented_bwd(x, seg, out, out, lse2, 2, causal=False),
                       dqkv)
    assert A.launch_counts == {"flash_fwd": 0, "flash_fwd_seg": 0, "flash_bwd": 0, "flash_bwd_seg": 0,
                               "flash_fwd_hs": 0, "flash_bwd_hs": 0, "flash_fwd_bd": 0}


def test_kernel_route_follows_jax_dispatch_rule():
    cuda = torch.device("cuda")
    assert kernel_route(3 * 768, 12, torch.bfloat16, cuda)          # D=64
    assert kernel_route(3 * 768, 6, torch.bfloat16, cuda)           # D=128
    assert not kernel_route(3 * 64, 4, torch.bfloat16, cuda)        # D=16: plain
    assert not kernel_route(3 * 768, 12, torch.float32, cuda)       # f32: plain
    assert not kernel_route(3 * 768, 12, torch.bfloat16, torch.device("cpu"))
    assert not kernel_route(3 * 768, 12, torch.bfloat16, cuda, attention="plain")
    with pytest.raises(ValueError):
        kernel_route(3 * 768, 12, torch.bfloat16, cuda, attention="xla")


def test_dispatch_on_cpu_is_the_plain_version_at_any_head_width():
    x = torch.from_numpy(_qkv(2, 17, 4, 16, seed=1))      # f32, head_dim 16
    seg = torch.from_numpy(np.repeat(np.array([[1] * 9 + [2] * 8], np.int32), 2, axis=0))
    assert torch.equal(attention_core_qkv(x, 4, causal=True), A.flash_fwd_plain(x, 4, True)[0])
    assert torch.equal(attention_core_qkv_segmented(x, 4, seg, causal=False),
                       A.flash_fwd_seg_plain(x, seg, 4, False)[0])
