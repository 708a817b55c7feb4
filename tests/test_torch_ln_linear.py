"""latteclip_torch fused LayerNorm -> linear (K8) against latteclip_tpu: the
plain version against the Pallas kernel (values and VJP), the rule that picks
the fused route, the autograd Function, both towers with ``ln_linear="fused"``
against the JAX towers with ``LATTECLIP_FUSED_LN`` on, and one port train
step on the new routes against the default ones.

The JAX side patches ``fused_ln_linear._enabled`` true (it otherwise needs a
TPU), which runs ``_kernel`` in interpret mode, and for the towers also
``latteclip_tpu.kernels._pallas_enabled``, so that attention rounds as the
port's does.

Tolerances:
* values: both sides round the LayerNorm output to bf16, multiply the same
  bf16 operands in f32, add the f32 bias and round once, so they differ only
  where the f32 summation order flips one bf16 rounding (of xn or of y), by
  one bf16 ulp: atol = rtol = 1e-2 (observed 7.8e-3, on at most 0.1% of the
  elements; the JAX package holds its kernel to the unfused route at 1e-1);
* VJP: both are the gradient of the unfused composition in bf16, through
  different libraries' products: the gradients of x, the LayerNorm's
  scale and bias and W to ||d - ref|| / ||ref|| <= 1e-4 (observed <= 4.7e-5;
  the JAX test holds them at atol 2e-1 and rtol 1e-1). The bias gradient is
  a sum of the bf16 cotangent over B * L rows, which XLA's CPU reduction
  accumulates in bf16 and torch in f32: it is held to JAX at 5e-2 (observed
  0.9-1.8%) and to the float64 sum of the same cotangent at 4e-3, one bf16
  rounding;
* the Function in float32 against autograd through the unfused composition:
  the same function, 1e-5;
* towers in bf16: L2-normalised features to 1e-2, as tests/test_torch_model.py;
* the train step on the new routes against the default routes, bf16: loss to
  1e-2 relative, the gradient as one vector to cosine >= 0.99, the updated
  bank row by row to cosine >= 0.999 (the bounds of chip_smoke.py).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import latteclip_tpu.kernels.fused_ln_linear as JF
from latteclip_tpu import kernels as jax_kernels
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.models import clip as jax_clip
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.data.packing import pack_template_table
from latteclip_torch.kernels import fused_ln_linear as FL
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.train import state, step

torch.set_num_threads(1)

Y_TOL = 1e-2
GRAD_REL_TOL = 1e-4
BIAS_GRAD_REL_TOL = 5e-2
BIAS_GRAD_EXACT_TOL = 4e-3
F32_TOL = 1e-5
TOWER_TOL = 1e-2

HD64_RAW = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 64, "layers": 2, "width": 128, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 2},
}


def _inputs(B, L, D, O, seed):
    """x [B, L, D] (N(0.5, 2^2)), LN scale and bias, W in JAX's [D, O] and bias."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, D)) * 2 + 0.5).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    w = (rng.standard_normal((D, O)) * D ** -0.5).astype(np.float32)
    wb = (0.1 * rng.standard_normal(O)).astype(np.float32)
    return x, s, b, w, wb


def _port(x, s, b, w, wb, dtype=torch.bfloat16):
    """The same inputs for the port: x in ``dtype``, W as torch's [O, D]."""
    t = torch.from_numpy
    return t(x).to(dtype), t(s), t(b), t(np.ascontiguousarray(w.T)), t(wb)


@pytest.fixture
def jax_fused(monkeypatch):
    monkeypatch.setattr(JF, "_enabled", lambda: True)


@pytest.mark.parametrize("B,L,D,O", [(3, 77, 64, 192), (5, 13, 128, 256), (9, 50, 128, 512)])
def test_plain_version_matches_pallas_values_and_vjp(B, L, D, O, jax_fused):
    x, s, b, w, wb = _inputs(B, L, D, O, seed=B * L)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref, vjp = jax.vjp(JF.fused_ln_linear, xj, s, b, w, wb)
    ours = FL.fused_ln_linear_plain(*_port(x, s, b, w, wb))
    ref32 = np.asarray(ref.astype(jnp.float32))
    assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape == (B, L, O)
    np.testing.assert_allclose(ours.float().numpy(), ref32, atol=Y_TOL, rtol=Y_TOL)
    assert (ours.float().numpy() != ref32).mean() <= 1e-2

    dy = np.random.default_rng(O).standard_normal((B, L, O)).astype(np.float32)
    ref_grads = vjp(jnp.asarray(dy, jnp.bfloat16))
    args = [a.requires_grad_(True) for a in _port(x, s, b, w, wb)]
    y = FL.FusedLnLinear.apply(*args, FL.LN_EPS)
    grads = torch.autograd.grad(y, args, torch.from_numpy(dy).to(torch.bfloat16))
    for name, g, r in zip(("x", "scale", "bias", "w", "wb"), grads, ref_grads):
        g, r = g.float().numpy(), np.asarray(r.astype(jnp.float32))
        if name == "w":
            g = g.T
        assert g.shape == r.shape
        rel = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert rel <= (BIAS_GRAD_REL_TOL if name == "wb" else GRAD_REL_TOL), f"d{name}: {rel:.3g}"
    exact = torch.from_numpy(dy).to(torch.bfloat16).double().sum(dim=(0, 1)).numpy()
    dwb = grads[4].double().numpy()
    assert np.linalg.norm(dwb - exact) <= BIAS_GRAD_EXACT_TOL * np.linalg.norm(exact)


class _F32WeightFunction(torch.autograd.Function):
    """FusedLnLinear as it was before the bf16 copy of W: the kernel's plain
    version on the f32 W, the backward rounding ``w.to(x.dtype)`` itself."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w, wb, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w, wb)
        ctx.eps = eps
        return FL.fused_ln_linear_plain(x, ln_w, ln_b, w, wb, eps)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, w, wb = ctx.saved_tensors
        dt = x.dtype
        with torch.enable_grad():
            inputs = tuple(t.detach().requires_grad_(True) for t in (x, ln_w, ln_b))
            xn = FL.layer_norm(*inputs, ctx.eps)
        dy = dy.to(dt)
        O, D = w.shape
        dxn = torch.matmul(dy, w.to(dt))
        dw = torch.matmul(dy.reshape(-1, O).t(), xn.detach().reshape(-1, D)).to(w.dtype)
        dwb = dy.reshape(-1, O).sum(dim=0).to(wb.dtype)
        dx, dln_w, dln_b = torch.autograd.grad(xn, inputs, dxn)
        return dx, dln_w, dln_b, dw, dwb, None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,L,D,O", [(3, 77, 64, 192), (2, 50, 128, 512)])
def test_function_with_bf16_weight_copy_equals_f32_weight_path(B, L, D, O, dtype):
    """FusedLnLinear makes bf16(W) once a forward, reads it in the product
    and, in bf16, in the backward's dy . W: its output and all five
    gradients equal the f32-W path bit for bit (the product rounded W to
    bf16 already, and so did the backward's w.to(bf16)); so does the plain
    version given bf16(W) for W."""
    x, s, b, w, wb = _inputs(B, L, D, O, seed=B + L)
    args = _port(x, s, b, w, wb, dtype=dtype)
    dy = torch.from_numpy(np.random.default_rng(O).standard_normal((B, L, O)).astype(np.float32)).to(dtype)
    results = []
    for fn in (FL.FusedLnLinear, _F32WeightFunction):
        a = [t.clone().requires_grad_(True) for t in args]
        y = fn.apply(*a, FL.LN_EPS)
        results.append((y, *torch.autograd.grad(y, a, dy)))
    for name, ours, ref in zip(("y", "x", "ln_w", "ln_b", "w", "wb"), *results):
        assert ours.dtype == ref.dtype and torch.equal(ours, ref), name
    w16 = args[3].to(torch.bfloat16)
    assert torch.equal(FL.fused_ln_linear_plain(*args[:3], w16, args[4]),
                       FL.fused_ln_linear_plain(*args))


def test_fused_route_is_jax_group_size_rule():
    for b, l, d, o in itertools.product((1, 2, 3, 8, 256, 512), (1, 13, 50, 77, 100, 128, 197, 577),
                                        (64, 512, 768, 1024), (192, 1536, 2304, 3072, 4096)):
        assert FL.fused_route(b, l, d, o) == (JF._group_size(b, l, d, o) != 0), (b, l, d, o)


@pytest.mark.parametrize("name", ["ViT-B-32", "ViT-B-16"])
@pytest.mark.parametrize("batch", [1, 512])
def test_vit_b_takes_the_kernel_at_every_pair(name, batch):
    """Every LN -> projection pair of both towers takes the fused kernel:
    vision rows (and ViT-B/32's pairs at [B/2, 100, 768]), padded text at 77
    and packed text at 128."""
    cfg = torch_config.get_model_config(name)
    v, t = cfg.vision, cfg.text
    sites = [(batch, v.seq_len, v.width, v.mlp_ratio), (batch, 77, t.width, t.mlp_ratio),
             (336, 128, t.width, t.mlp_ratio)]
    if batch % 2 == 0 and 2 * v.seq_len <= 128:
        sites.append((batch // 2, 2 * v.seq_len, v.width, v.mlp_ratio))
    assert name != "ViT-B-32" or batch == 1 or (256, 100, 768, 4.0) in sites
    for b, l, d, ratio in sites:
        for o in (3 * d, int(d * ratio)):  # in_proj, c_fc
            assert FL.fused_route(b, l, d, o), (b, l, d, o)


def test_dispatch_follows_jax_rule(monkeypatch):
    x, s, b, w, wb = _port(*_inputs(2, 13, 64, 192, seed=0))
    unfused = lambda eps=FL.LN_EPS: FL.dense(FL.layer_norm(x, s, b, eps), w, wb, torch.bfloat16)  # noqa: E731
    fused = FL.fused_ln_linear_plain(x, s, b, w, wb)
    assert not torch.equal(fused, unfused())  # the routes round differently
    assert torch.equal(FL.ln_linear(x, s, b, w, wb, torch.bfloat16, route="fused"), fused)
    assert torch.equal(FL.ln_linear(x, s, b, w, wb, torch.bfloat16), unfused())
    # SigLIP's eps 1e-6, and a shape the TPU kernel's budget refuses, stay unfused
    assert torch.equal(FL.ln_linear(x, s, b, w, wb, torch.bfloat16, 1e-6, "fused"), unfused(1e-6))
    monkeypatch.setattr(FL, "_TPU_VMEM_BUDGET", 0)
    assert torch.equal(FL.ln_linear(x, s, b, w, wb, torch.bfloat16, route="fused"), unfused())
    with pytest.raises(ValueError, match="ln_linear"):
        FL.ln_linear(x, s, b, w, wb, torch.bfloat16, route="xla")
    FL.reset_launch_counts()
    FL.fused_ln_linear(x, s, b, w, wb)  # the CPU takes the plain version, uncounted
    assert FL.launch_counts == {"ln_linear": 0}


def test_function_gradient_is_unfused_gradient_in_float32():
    args = _port(*_inputs(3, 17, 64, 128, seed=4), dtype=torch.float32)
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 17, 128)).astype(np.float32))
    grads = []
    for fused in (True, False):
        a = [t.clone().requires_grad_(True) for t in args]
        y = (FL.FusedLnLinear.apply(*a, FL.LN_EPS) if fused
             else FL.dense(FL.layer_norm(*a[:3]), a[3], a[4], torch.float32))
        grads.append(torch.autograd.grad(y, a, dy))
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, atol=F32_TOL, rtol=F32_TOL)


def _configs(dtype):
    return (dataclasses.replace(jax_config.config_from_dict("tiny-hd64", HD64_RAW), compute_dtype=dtype),
            dataclasses.replace(torch_config.config_from_dict("tiny-hd64", HD64_RAW), compute_dtype=dtype))


def _shared(dtype, seed=0):
    jcfg, tcfg = _configs(dtype)
    params = jax_clip.init_clip_params(jax.random.PRNGKey(seed), jcfg)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg),
                          strict=True)
    return jcfg, params, model


@pytest.mark.parametrize("tower", ["text", "vision"])
def test_towers_match_jax_towers_with_fused_ln(tower, jax_fused, monkeypatch):
    monkeypatch.setattr(jax_kernels, "_pallas_enabled", lambda: True)
    jcfg, params, model = _shared("bfloat16")
    with torch.no_grad():
        if tower == "text":
            tokens = get_tokenizer()(["a photo of a dog.", "a diagram", "two cats on a warm mat"])
            ref = jax_clip.encode_text(params, jcfg, tokens, normalize=True)
            ours = torch_clip.encode_text(model, torch.from_numpy(tokens), normalize=True,
                                          ln_linear="fused")
        else:  # an even batch: two images a row on both sides
            x = np.random.default_rng(3).standard_normal((4, 64, 64, 3)).astype(np.float32)
            ref = jax_clip.encode_image(params, jcfg, x, normalize=True)
            ours = torch_clip.encode_image(model, torch.from_numpy(x), normalize=True,
                                           pack_pairs=True, ln_linear="fused")
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOWER_TOL, rtol=0)


def _step_inputs(rng, n_classes, size=64, batch=6):
    tok = get_tokenizer()
    caps = tok([f"a photo number {i} of something" for i in range(2 * batch)])
    return {
        "images": rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
        "per_image_tokens": caps[:batch], "per_group_tokens": caps[batch:],
        "zs_preds": rng.integers(0, n_classes, batch).astype(np.int32),
    }


@pytest.mark.parametrize("attention,ln_linear", [("headsplit", "fused"), ("blockdiag", "unfused")])
def test_train_step_on_new_routes_matches_default_routes(attention, ln_linear):
    """One bf16 step of the port at the tiny 64-wide-head config, padded
    captions: loss, gradient and updated bank on the new routes against the
    default ones from the same weights, then one whole step on the new
    routes."""
    _, _, model = _shared("bfloat16", seed=1)
    classes = [f"class {i}" for i in range(5)]
    templates = [lambda c: f"a photo of a {c}."]
    tok = get_tokenizer()
    table = torch.from_numpy(state.build_template_table(tok, classes, templates))
    bank = state.init_memory_bank(model, tok, classes, templates)
    batch = _step_inputs(np.random.default_rng(0), len(classes))
    hp = step.LatteHParams(augment=False)
    images = step.T.normalize_images(torch.from_numpy(batch["images"]))
    results = []
    for routes in ({}, {"attention": attention, "ln_linear": ln_linear}):
        model.zero_grad(set_to_none=True)
        loss, aux = step.latteclip_loss_fn(model, hp, batch, images, bank, bank, table, **routes)
        loss.backward()
        grad = torch.cat([p.grad.flatten().float() for p in model.parameters()])
        new_bank = step.update_memory_bank(bank, aux["preds"], aux["zs_preds"], aux["text_final"],
                                           aux["text_final_zs"])
        results.append((float(loss.detach()), grad, new_bank))
    (loss_d, grad_d, bank_d), (loss_n, grad_n, bank_n) = results
    assert loss_n == pytest.approx(loss_d, rel=1e-2)
    assert float(torch.nn.functional.cosine_similarity(grad_n, grad_d, dim=0)) >= 0.99
    assert float(torch.nn.functional.cosine_similarity(bank_n, bank_d, dim=1).min()) >= 0.999

    before = [p.detach().clone() for p in model.parameters()]
    st = state.create_train_state(model, torch.optim.SGD(model.parameters(), lr=1e-2), bank)
    fn = step.make_train_step(model, hp, table, attention=attention, ln_linear=ln_linear)
    metrics = fn(st, batch)
    assert np.isfinite(float(metrics["loss"])) and st.step == 1
    assert any(not torch.equal(a, p.detach()) for a, p in zip(before, model.parameters()))
    assert float((st.memory_bank.norm(dim=1) - 1).abs().max()) <= 1e-3


def test_packed_template_rows_take_the_fused_kernel_too():
    """The packed text path threads ``ln_linear`` as well: the packed
    template features on the fused route equal the padded ones on the fused
    route to bf16 tolerance (both are the same function of the tokens)."""
    _, _, model = _shared("bfloat16", seed=2)
    tok = get_tokenizer()
    table = state.build_template_table(tok, [f"class {i}" for i in range(7)], [lambda c: f"a {c}."])
    with torch.no_grad():
        padded = torch_clip.encode_text(model, torch.from_numpy(table), normalize=True,
                                        ln_linear="fused")
        packed = torch_clip.encode_text_packed(
            model, *(torch.from_numpy(a) for a in pack_template_table(table, 128)),
            normalize=True, ln_linear="fused")
    torch.testing.assert_close(packed, padded, atol=TOWER_TOL, rtol=0)
