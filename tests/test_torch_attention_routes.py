"""latteclip_torch's other attention routes against latteclip_tpu: the plain
versions of the head-split kernels (K5 forward, K6 backward) and of the
block-diagonal forward (K7) against the Pallas kernels they port, the route
rule of the dispatch, and both towers with each route against the JAX towers
with the matching switch on.

The JAX side runs its Pallas kernels in interpret mode off-TPU, with
``LATTECLIP_ATTN_HEADSPLIT=1`` or ``LATTECLIP_ATTN_BLOCKDIAG=1`` set and, for
the towers, ``latteclip_tpu.kernels._pallas_enabled`` patched true. Inputs are
made with numpy and rounded to bf16 identically on both sides; q and k are
N(0, 0.3^2) and v and the cotangent N(0, 1), as in
tests/test_torch_attention.py, except for the block-diagonal comparison,
which draws every entry from N(0, 1) as the JAX package's own test does
(tests/test_kernels.py::test_blockdiag_fold_matches_wholerow).

Tolerances:
* head-split forward and backward: the whole-row kernels' arithmetic, so the
  whole-row tolerances of tests/test_torch_attention.py and
  tests/test_torch_attention_bwd.py (out atol = rtol = 2e-2 and
  ||out - ref|| / ||ref|| <= 1e-2, lse2 atol 1e-3; dq, dk, dv each
  ||d - ref|| / ||ref|| <= 1e-2 and |d - ref| <= 2e-2 * max|ref|);
* block-diagonal forward: both sides now round at the same points (p / l in
  f32, then bf16), so a difference needs an f32 summation-order flip of one
  rounding of p / l, which moves out by one bf16 ulp of p times |v|: out
  atol 4e-3 (2^-8) and ||out - ref|| / ||ref|| <= 1e-3 (observed 1.95e-3
  and 3.5e-5), lse2 atol 1e-5 (l sums unrounded p; observed 9.5e-7). The
  JAX package holds the fold to the whole-row forward at 2e-2 and 5e-3;
* towers in bf16: the two packages round attention identically on these
  routes but take the GEMMs through different libraries, whose f32
  summation orders flip bf16 roundings that compound over the layers:
  L2-normalised features to 1e-2, as tests/test_torch_model.py holds bf16
  towers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latteclip_tpu import kernels as jax_kernels
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.kernels import attention as JA
from latteclip_tpu.models import clip as jax_clip
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.kernels import (
    ATTENTION_CHOICES,
    attention_core_qkv,
    attention_core_qkv_segmented,
    kernel_route,
    whole_row_route,
)
from latteclip_torch.kernels import attention as A
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.models.vit import pack_pairs_auto

torch.set_num_threads(1)

OUT_TOL = 2e-2
OUT_REL_TOL = 1e-2
LSE_TOL = 1e-3
GRAD_REL_TOL = 1e-2
GRAD_MAX_TOL = 2e-2
BD_OUT_TOL = 4e-3
BD_OUT_REL_TOL = 1e-3
BD_LSE_TOL = 1e-5
TOWER_TOL = 1e-2
SWITCHES = {"headsplit": "LATTECLIP_ATTN_HEADSPLIT", "blockdiag": "LATTECLIP_ATTN_BLOCKDIAG"}

# a tiny config whose heads are 64 wide in both towers (tests/test_torch_model.py)
HD64_RAW = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 64, "layers": 2, "width": 128, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 2},
}


def _qkv(B, L, H, D, seed, qk_std=0.3):
    std = np.repeat(np.array([qk_std, qk_std, 1.0], np.float32), H * D)
    return (np.random.default_rng(seed).standard_normal((B, L, 3 * H * D)) * std).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("B,L,H,D,causal", [
    (3, 77, 4, 64, True), (5, 13, 2, 64, False), (3, 50, 2, 128, False), (9, 77, 8, 64, True),
])
def test_head_split_forward_plain_matches_pallas(B, L, H, D, causal, monkeypatch):
    monkeypatch.setenv(SWITCHES["headsplit"], "1")
    x = _qkv(B, L, H, D, seed=B * L + D)
    ref_out, ref_lse2 = JA._flash_fwd_impl(jnp.asarray(x, jnp.bfloat16), causal, H)
    hp = 128 // D
    assert ref_lse2.shape == (H // hp, hp, B, L)  # the head-split kernel ran
    out, lse2 = A.flash_fwd_hs_plain(_bf16(x), H, causal)
    assert lse2.shape == ref_lse2.shape and out.dtype == torch.bfloat16
    ref_out = _f32(ref_out)
    np.testing.assert_allclose(out.float().numpy(), ref_out, atol=OUT_TOL, rtol=OUT_TOL)
    assert np.linalg.norm(out.float().numpy() - ref_out) <= OUT_REL_TOL * np.linalg.norm(ref_out)
    np.testing.assert_allclose(lse2.numpy(), np.asarray(ref_lse2), atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("B,L,H,D,causal", [(3, 77, 4, 64, True), (5, 50, 2, 128, False)])
def test_head_split_backward_plain_matches_pallas_vjp(B, L, H, D, causal, monkeypatch):
    """The port's plain K6 from the JAX forward's residuals (lse2 in the
    head-split layout) against ``jax.vjp`` of ``_make_fa``, which runs
    ``_bwd_kernel_hs`` and re-merges its ``[3, B, L, H*D]`` output."""
    monkeypatch.setenv(SWITCHES["headsplit"], "1")
    x = jnp.asarray(_qkv(B, L, H, D, seed=L + D), jnp.bfloat16)
    dout = jnp.asarray(np.random.default_rng(D).standard_normal((B, L, H * D)), jnp.bfloat16)
    (out, lse2), vjp = jax.vjp(lambda q: JA._make_fa(H)(q, causal, 0), x)
    assert lse2.shape == (H // (128 // D), 128 // D, B, L)
    (ref,) = vjp((dout, jnp.zeros_like(lse2)))
    t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    dqkv3 = A.flash_bwd_hs_plain(t(x), t(out), t(dout), torch.from_numpy(np.array(lse2)), H, causal)
    assert dqkv3.shape == (3, B, L, H * D)
    ours, ref = A.merge_dqkv(dqkv3).float().numpy(), _f32(ref)
    for i, part in enumerate(("dq", "dk", "dv")):
        a, r = ours[..., i * H * D:(i + 1) * H * D], ref[..., i * H * D:(i + 1) * H * D]
        rel = np.linalg.norm(a - r) / np.linalg.norm(r)
        worst = np.abs(a - r).max() / np.abs(r).max()
        assert rel <= GRAD_REL_TOL and worst <= GRAD_MAX_TOL, f"{part}: {rel:.3g}, {worst:.3g}"


@pytest.mark.parametrize("B,L,H,D,causal", [(3, 77, 4, 64, True), (2, 197, 2, 64, False),
                                             (5, 50, 2, 128, False)])
def test_head_split_backward_route_gives_the_qkv_layout(B, L, H, D, causal, monkeypatch):
    """The head-split backward wrapper and the Function's gradient come in
    the layout of qkv (the CUDA kernel stores it so): equal bit for bit to
    ``merge_dqkv(flash_bwd_hs_plain(...))``, and to ``jax.vjp`` of
    ``_make_fa``, whose ``_bwd_kernel_hs`` output JAX moves with
    ``moveaxis(dqkv3, 0, 2)``, within the whole-row backward tolerances."""
    monkeypatch.setenv(SWITCHES["headsplit"], "1")
    x = jnp.asarray(_qkv(B, L, H, D, seed=L + D + 1), jnp.bfloat16)
    dout = jnp.asarray(np.random.default_rng(D + 1).standard_normal((B, L, H * D)), jnp.bfloat16)
    (out, lse2), vjp = jax.vjp(lambda q: JA._make_fa(H)(q, causal, 0), x)
    (ref,) = vjp((dout, jnp.zeros_like(lse2)))
    t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    xt, outt, doutt, lse2t = t(x), t(out), t(dout), torch.from_numpy(np.array(lse2))
    dqkv = A.flash_attention_qkv_hs_bwd(xt, outt, doutt, lse2t, H, causal)
    assert dqkv.shape == xt.shape
    assert torch.equal(dqkv, A.merge_dqkv(A.flash_bwd_hs_plain(xt, outt, doutt, lse2t, H, causal)))
    xi = xt.clone().requires_grad_(True)
    fwd_out, _ = A.FlashAttentionHeadSplit.apply(xi, H, causal)
    (grad,) = torch.autograd.grad(fwd_out, xi, doutt)
    fwd_lse2 = A.flash_fwd_hs_plain(xt, H, causal)[1]
    assert torch.equal(grad, A.flash_attention_qkv_hs_bwd(xt, fwd_out.detach(), doutt, fwd_lse2, H, causal))
    ours, ref = dqkv.float().numpy(), _f32(ref)
    for i, part in enumerate(("dq", "dk", "dv")):
        a, r = ours[..., i * H * D:(i + 1) * H * D], ref[..., i * H * D:(i + 1) * H * D]
        rel = np.linalg.norm(a - r) / np.linalg.norm(r)
        worst = np.abs(a - r).max() / np.abs(r).max()
        assert rel <= GRAD_REL_TOL and worst <= GRAD_MAX_TOL, f"{part}: {rel:.3g}, {worst:.3g}"


@pytest.mark.parametrize("causal", [False, True])
def test_block_diagonal_plain_matches_pallas(causal):
    B, L, H, D = 9, 77, 8, 64  # B=9 exercises the TPU kernel's row padding to G=8
    x = _qkv(B, L, H, D, seed=1, qk_std=1.0)
    ref_out, ref_lse2 = JA._flash_fwd_bd(jnp.asarray(x, jnp.bfloat16), causal, H, 0)
    out, lse2 = A.flash_fwd_bd_plain(_bf16(x), H, causal)
    ref_out = _f32(ref_out)
    assert out.shape == ref_out.shape and lse2.shape == ref_lse2.shape == (B, H, L)
    np.testing.assert_allclose(out.float().numpy(), ref_out, atol=BD_OUT_TOL, rtol=0)
    assert np.linalg.norm(out.float().numpy() - ref_out) <= BD_OUT_REL_TOL * np.linalg.norm(ref_out)
    np.testing.assert_allclose(lse2.numpy(), np.asarray(ref_lse2), atol=BD_LSE_TOL, rtol=0)
    # the whole-row forward rounds elsewhere: the two differ beyond these bounds
    whole = A.flash_fwd_plain(_bf16(x), H, causal)[0].float().numpy()
    assert np.abs(whole - ref_out).max() > BD_OUT_TOL


@pytest.mark.parametrize("H,D", [(1, 64), (2, 64), (3, 64), (12, 64), (1, 128), (6, 128), (4, 16)])
def test_head_split_rule_is_jax_rule(H, D, monkeypatch):
    monkeypatch.setenv(SWITCHES["headsplit"], "1")
    assert A.head_split(H, D) == JA._head_split(H, D)
    want = "headsplit" if JA._head_split(H, D) else "kernel"
    assert whole_row_route("headsplit", 77, H, D) == want


@pytest.mark.parametrize("L,H,D,want", [
    (50, 12, 64, "blockdiag"), (77, 8, 64, "blockdiag"), (128, 8, 64, "blockdiag"),
    (129, 8, 64, "kernel"), (197, 12, 64, "kernel"), (77, 16, 64, "blockdiag"),
    (77, 17, 64, "kernel"), (77, 12, 128, "kernel"),
])
def test_block_diagonal_rule_is_jax_rule(L, H, D, want):
    """JAX takes the fold at L <= 128 and H*D <= 1024 (attention.py:713)."""
    assert whole_row_route("blockdiag", L, H, D) == want
    assert whole_row_route("kernel", L, H, D) == "kernel"
    assert whole_row_route("plain", L, H, D) == "plain"


def test_new_routes_are_kernel_routes_and_keep_vision_pairs():
    cuda = torch.device("cuda")
    vit = torch_config.get_model_config("ViT-B-32").vision
    for attention in ("headsplit", "blockdiag"):
        assert attention in ATTENTION_CHOICES
        assert kernel_route(3 * 768, 12, torch.bfloat16, cuda, attention)
        assert not kernel_route(3 * 768, 12, torch.bfloat16, torch.device("cpu"), attention)
        assert pack_pairs_auto(512, 50, vit, torch.bfloat16, cuda, attention)
    assert not pack_pairs_auto(512, 50, vit, torch.bfloat16, cuda, "plain")


def test_cpu_dispatch_runs_each_route_plain_version():
    x = _bf16(_qkv(2, 77, 2, 64, seed=3))
    plain = A.flash_fwd_plain(x, 2, True)[0]
    assert torch.equal(attention_core_qkv(x, 2, True, "headsplit"), plain)
    assert torch.equal(attention_core_qkv(x, 2, True, "blockdiag"), A.flash_fwd_bd_plain(x, 2, True)[0])
    assert not torch.equal(A.flash_fwd_bd_plain(x, 2, True)[0], plain)
    long_row = _bf16(_qkv(1, 129, 2, 64, seed=4))  # past the fold's 128 tokens: whole-row
    assert torch.equal(attention_core_qkv(long_row, 2, False, "blockdiag"),
                       A.flash_fwd_plain(long_row, 2, False)[0])
    seg = torch.ones(2, 77, dtype=torch.int32)  # segmented sites keep the segment kernel
    for attention in ("headsplit", "blockdiag"):
        assert torch.equal(attention_core_qkv_segmented(x, 2, seg, True, attention),
                           A.flash_fwd_seg_plain(x, seg, 2, True)[0])


@pytest.mark.parametrize("route", ["headsplit", "blockdiag"])
def test_route_functions_on_the_cpu_run_the_plain_kernels(route):
    """On the CPU the autograd Functions run the plain versions: the
    head-split gradient is K6's re-merged output, the block-diagonal one K3's
    from K7's residuals; no launch is counted."""
    x = _bf16(_qkv(3, 50, 2, 64, seed=5))
    dout = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 50, 128)).astype(np.float32))
    dout = dout.to(torch.bfloat16)
    A.reset_launch_counts()
    xi = x.clone().requires_grad_(True)
    if route == "headsplit":
        out, lse2 = A.FlashAttentionHeadSplit.apply(xi, 2, False)
        ref = A.merge_dqkv(A.flash_bwd_hs_plain(x, out.detach(), dout, lse2, 2, False))
        assert torch.equal(ref, A.flash_bwd_plain(x, out.detach(), dout, A.flash_fwd_plain(x, 2, False)[1], 2, False))
    else:
        out, lse2 = A.FlashAttentionBlockDiag.apply(xi, 2, False)
        ref = A.flash_bwd_plain(x, out.detach(), dout, lse2, 2, False)
    (grad,) = torch.autograd.grad(out, xi, dout)
    assert torch.equal(grad, ref)
    assert not any(A.launch_counts.values())


def _shared(compute_dtype):
    """JAX params and a port model holding the same weights."""
    jcfg = dataclasses.replace(jax_config.config_from_dict("tiny-hd64", HD64_RAW),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(torch_config.config_from_dict("tiny-hd64", HD64_RAW),
                               compute_dtype=compute_dtype)
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg),
                          strict=True)
    return jcfg, params, model


@pytest.mark.parametrize("attention", ["headsplit", "blockdiag"])
@pytest.mark.parametrize("tower", ["text", "vision"])
def test_towers_match_jax_towers_with_the_switch_on(attention, tower, monkeypatch):
    """bf16 towers at the tiny 64-wide-head config. Vision runs an odd batch,
    so both packages take the whole-row route there (an even one pair-packs
    onto the segment kernel, which no switch changes)."""
    monkeypatch.setattr(jax_kernels, "_pallas_enabled", lambda: True)
    monkeypatch.setenv(SWITCHES[attention], "1")
    jcfg, params, model = _shared("bfloat16")
    with torch.no_grad():
        if tower == "text":
            tokens = get_tokenizer()(["a photo of a dog.", "a diagram", "two cats on a warm mat"])
            ref = jax_clip.encode_text(params, jcfg, tokens, normalize=True)
            ours = torch_clip.encode_text(model, torch.from_numpy(tokens), normalize=True,
                                          attention=attention)
        else:
            x = np.random.default_rng(2).standard_normal((3, 64, 64, 3)).astype(np.float32)
            ref = jax_clip.encode_image(params, jcfg, x, normalize=True)
            ours = torch_clip.encode_image(model, torch.from_numpy(x), normalize=True,
                                           attention=attention)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape == (3, jcfg.embed_dim)
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOWER_TOL, rtol=0)
