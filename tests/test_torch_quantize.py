"""The port's int8 serving (latteclip_torch/models/quantize.py) against
latteclip_tpu/models/quantize.py, in float32 on the same weights.

* the int8 weights and their scales equal JAX's (the int8 values may differ
  by one on at most 1e-4 of entries, where a float quotient lands on .5);
* ``int8_dense`` equals JAX's ``int8_dense`` within 1e-5 of the largest
  output;
* on a tiny config of each family whose JAX quantised forward runs (native
  ViT and text, CoCa with its decoder, EVA02 with the plain MLP and with
  SwiGLU, EVA01, a timm ViT, Swin and ViT-relpos, whose block lists JAX's
  walk does not enter), ``replace_linear`` replaces the weights of the
  leaves JAX replaced, its count is JAX's with every stacked ``[L, in, out]``
  leaf counted once a layer, and image and text features (CoCa's decoder
  logits too) are within 1e-5 of JAX's quantised model. Both packages'
  activation quotients ``x / ax`` are recorded at every int8 product: the
  int8 activations must be equal except where JAX's quotient lies within
  1e-3 of a rounding boundary (float32 sums in another order may round the
  other way there: a flip moves that activation by one step, ~1/127 of its
  row's largest, far more than 1e-5). Where a flip occurred, the features
  are held by cosine >= 0.999 instead, and the flip count is asserted;
* the custom ``include`` of tests/test_quantize.py quantises the attention
  projections, and a leaf the port cannot map is refused;
* under ``ln_linear="fused"`` a quantised projection never reaches K8;
* a train step on a quantised model is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latteclip_tpu.core import config as jax_config
from latteclip_tpu.kernels import fused_ln_linear as jax_fused
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models import coca as jax_coca
from latteclip_tpu.models import quantize as jax_quant
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.kernels import fused_ln_linear as torch_fused
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models import coca as torch_coca
from latteclip_torch.models import quantize as torch_quant
from latteclip_torch.train.step import LatteHParams, make_flyp_step, make_train_step

from test_torch_coca import COCA_SMALL, shared as coca_shared, token_rows
from test_torch_towers import TOWERS, register_tiny_trunks, shared as tower_shared

torch.set_num_threads(1)
TOL = 1e-5

TINY = {  # tests/test_quantize.py's tiny CLIP
    "embed_dim": 32, "compute_dtype": "float32",
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64, "heads": 4,
                 "layers": 2},
}


def close(ours, theirs, msg=""):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, msg
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL * np.abs(theirs).max(), err_msg=msg)


@pytest.fixture
def quotients(monkeypatch):
    """Each package's ``x / ax`` at every int8 product, in call order (JAX's
    through an ordered callback, since its blocks run under ``lax.scan``)."""
    calls = {"jax": [], "torch": []}
    jax_dense, torch_dense = jax_quant.int8_dense, torch_fused.int8_dense

    def jax_rec(x, wq, b, dtype):
        xf = jnp.asarray(x, jnp.float32)
        ax = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
        jax.debug.callback(lambda r: calls["jax"].append(np.asarray(r).reshape(-1)), xf / ax,
                           ordered=True)
        return jax_dense(x, wq, b, dtype)

    def torch_rec(x, w, b, dtype):
        xf = x.float()
        ax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
        calls["torch"].append((xf / ax).reshape(-1).numpy())
        return torch_dense(x, w, b, dtype)

    monkeypatch.setattr(jax_quant, "int8_dense", jax_rec)
    monkeypatch.setattr(torch_fused, "int8_dense", torch_rec)
    return calls


def flips(calls) -> int:
    """Activations quantised differently by the two packages at the first
    int8 product where any differ; there each must sit at a rounding
    boundary of JAX's quotient (later products see the flip's effect)."""
    assert len(calls["jax"]) == len(calls["torch"]) > 0
    n = 0
    for rj, rt in zip(calls["jax"], calls["torch"]):
        assert rj.shape == rt.shape
        differ = np.round(rj) != np.round(rt)
        if differ.any():
            at_boundary = np.abs(np.abs(rj - np.trunc(rj)) - 0.5) < 1e-3
            assert at_boundary[differ].all(), "int8 activations differ away from a rounding boundary"
            n = int(differ.sum())
            break
    calls["jax"].clear()
    calls["torch"].clear()
    return n


def held(ours, theirs, n_flips, msg=""):
    """1e-5 of the largest entry with no flip, else cosine >= 0.999 a row."""
    if n_flips == 0:
        return close(ours, theirs, msg)
    a, b = ours.detach().numpy().reshape(len(ours), -1), np.asarray(theirs).reshape(len(ours), -1)
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    assert cos.min() >= 0.999, msg


def jax_count(tree) -> int:
    """JAX's quantised leaves, a stacked [L, in, out] one counted once a layer."""
    if isinstance(tree, dict):
        if "int8" in tree:
            return tree["int8"].shape[0] if tree["int8"].ndim == 3 else 1
        return sum(jax_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(jax_count(v) for v in tree)
    return 0


def native(seed=0):
    jcfg, tcfg = jax_config.config_from_dict("tiny", TINY), torch_config.config_from_dict("tiny", TINY)
    params = jax.tree.map(np.asarray, jax_clip.init_clip_params(jax.random.PRNGKey(seed), jcfg))
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(params, tcfg), strict=True)
    return jcfg, params, tcfg, model


def test_quantize_weight_equals_jax():
    w = np.random.default_rng(0).standard_normal((3, 64, 96)).astype(np.float32) * 0.1
    w[1, :, 5] = 0.0  # an all-zero channel takes the 1e-12 floor
    ref = jax_quant.quantize_weight(jnp.asarray(w))
    q, scale = torch_quant.quantize_weight(torch.from_numpy(w).transpose(-1, -2))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref["scale"]))
    diff = np.abs(q.transpose(-1, -2).numpy().astype(np.int32) - np.asarray(ref["int8"], np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    np.testing.assert_array_equal(
        torch_quant.dequantize_weight(q, scale).transpose(-1, -2).numpy(),
        np.asarray(jax_quant.dequantize_weight(ref)))


@pytest.mark.parametrize("rows,dtype", [(16, "float32"), (5, "float32"), (40, "bfloat16")])
def test_int8_dense_equals_jax(rows, dtype):
    """Fewer rows than ``torch._int_mm`` takes on the card (5) are padded;
    a K and N that are not multiples of 8 too."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((rows, 2, 60)).astype(np.float32)
    w = rng.standard_normal((60, 92)).astype(np.float32) * 0.05
    b = rng.standard_normal(92).astype(np.float32) * 0.01
    ref = jax_quant.int8_dense(jnp.asarray(x), jax_quant.quantize_weight(jnp.asarray(w)),
                               jnp.asarray(b), getattr(jnp, dtype))
    qw = torch_quant.Int8Weight(torch.from_numpy(w.T))
    ours = torch_quant.int8_dense(torch.from_numpy(x), qw, torch.from_numpy(b),
                                  getattr(torch, dtype))
    assert ours.dtype == getattr(torch, dtype)
    close(ours.float(), np.asarray(ref, np.float32))
    # and through dense(), the towers' entry
    assert torch.equal(torch_fused.dense(torch.from_numpy(x), qw, torch.from_numpy(b),
                                         getattr(torch, dtype)), ours)


def _features(jcfg, qparams, model, size, ctx, vocab, calls) -> int:
    x = np.random.default_rng(2).standard_normal((2, size, size, 3)).astype(np.float32)
    toks = np.random.default_rng(3).integers(1, vocab, size=(3, ctx)).astype(np.int32)
    total = 0
    with torch.no_grad():
        for what, ours_fn, jax_fn, inp in (
                ("image", torch_clip.encode_image, jax_clip.encode_image, x),
                ("text", torch_clip.encode_text, jax_clip.encode_text, toks)):
            theirs = jax_fn(qparams, jcfg, jnp.asarray(inp), normalize=True)
            t = torch.from_numpy(inp)
            ours = ours_fn(model, t.long() if what == "text" else t, normalize=True)
            if calls["jax"]:
                n = flips(calls)
                held(ours, theirs, n, what)
                total += n
            else:  # this tower has no quantised weight
                close(ours, theirs, what)
    return total


def _quantised_pair(jcfg, params, model, include=torch_quant.DEFAULT_INCLUDE):
    qparams, n_jax = jax_quant.replace_linear(params, include=include)
    model, n = torch_quant.replace_linear(model, include=include)
    assert n == jax_count(qparams) and n_jax > 0
    return qparams, model, n


def test_native_clip_matches_jax(quotients):
    jcfg, params, _, model = native()
    qparams, model, n = _quantised_pair(jcfg, params, model)
    assert n == 2 * (2 + 2)  # JAX's count is 4, one a stacked leaf
    blk = model.visual.transformer.resblocks[1]
    assert isinstance(blk.mlp.c_fc.weight, torch_quant.Int8Weight)
    assert isinstance(blk.attn.in_proj_weight, torch.nn.Parameter)
    np.testing.assert_array_equal(
        blk.mlp.c_fc.weight.int8.numpy().T,
        np.asarray(qparams["visual"]["blocks"]["c_fc_w"]["int8"][1]))
    assert "visual.transformer.resblocks.1.mlp.c_fc.weight.int8" in model.state_dict()
    assert _features(jcfg, qparams, model, 32, 77, 40000, quotients) == 0


def test_custom_include_matches_jax(quotients):
    """tests/test_quantize.py::test_replace_linear_custom_include."""
    jcfg, params, _, model = native()
    qparams, model, n = _quantised_pair(jcfg, params, model, ("in_proj_w", "out_proj_w"))
    assert n == 2 * (2 + 2)
    assert isinstance(model.transformer.resblocks[0].attn.in_proj_weight, torch_quant.Int8Weight)
    _features(jcfg, qparams, model, 32, 77, 40000, quotients)
    with pytest.raises(NotImplementedError, match="patch_kernel"):
        torch_quant.replace_linear(native()[3], include=("patch_kernel",))


@pytest.mark.parametrize("name", ["eva02_e", "eva02_b", "eva01", "vit_gap", "swin", "relpos"])
def test_timm_trunk_matches_jax(name, monkeypatch, quotients):
    register_tiny_trunks(monkeypatch)
    jcfg, params, _, model = tower_shared(name)
    qparams, model, n = _quantised_pair(jcfg, params, model)
    size = TOWERS[name]["vision_cfg"]["image_size"]
    _features(jcfg, qparams, model, size, 16, 500, quotients)


@pytest.mark.parametrize("seed", [0, 2])
def test_coca_matches_jax(seed, quotients):
    """Seed 0 puts one vision activation on a rounding boundary (a flip, held
    by cosine); seed 2 none (held at 1e-5)."""
    jcfg, params, tcfg, model = coca_shared(COCA_SMALL, seed=seed)
    qparams, model, n = _quantised_pair(jcfg, params, model)
    assert isinstance(model.text_decoder.cross_attn[0].mlp.c_fc.weight, torch_quant.Int8Weight)
    x = np.random.default_rng(seed + 1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    tokens = token_rows([3, 7, 12], 12, 96)
    out = jax_coca.coca_forward(qparams, jcfg, x, tokens)
    with torch.no_grad():
        ours = torch_coca.coca_forward(model, torch.from_numpy(x), torch.from_numpy(tokens).long())
    n_flips = flips(quotients)
    assert (n_flips > 0) == (seed == 0)
    for k in ("image_features", "text_features", "logits"):
        held(ours[k], out[k], n_flips, k)


def test_quantised_projection_never_reaches_the_fused_kernel(monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    ln_w, ln_b = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32), \
        (0.1 * rng.standard_normal(64)).astype(np.float32)
    w = (0.05 * rng.standard_normal((64, 128))).astype(np.float32)
    wb = (0.01 * rng.standard_normal(128)).astype(np.float32)
    monkeypatch.setattr(jax_fused, "_enabled", lambda: True)
    ref = jax_fused.ln_linear(jnp.asarray(x), ln_w, ln_b, jax_quant.quantize_weight(jnp.asarray(w)),
                              wb, jnp.float32)

    def refuse(*a, **k):
        raise AssertionError("a quantised weight reached the fused LayerNorm -> linear kernel")

    monkeypatch.setattr(torch_fused.FusedLnLinear, "apply", refuse)
    assert torch_fused.fused_route(2, 5, 64, 128)
    ours = torch_fused.ln_linear(torch.from_numpy(x), torch.from_numpy(ln_w), torch.from_numpy(ln_b),
                                 torch_quant.Int8Weight(torch.from_numpy(w.T)),
                                 torch.from_numpy(wb), torch.float32, route="fused")
    close(ours, ref)


def test_a_quantised_model_does_not_train():
    _, _, _, model = native()
    torch_quant.replace_linear(model)
    table = np.zeros((4, 77), np.int32)
    for make in (make_train_step, make_flyp_step):
        with pytest.raises(ValueError, match="quantised model serves only"):
            make(model, LatteHParams(), table)
