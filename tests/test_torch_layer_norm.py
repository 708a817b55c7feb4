"""latteclip_torch LayerNorm on the CPU: the launch plan of
``csrc/layer_norm.cu`` over every LayerNorm width the model configurations
give, the CPU route (the plain composition, bit for bit, and no kernel
counted), and the plain version against the JAX package's ``layer_norm``.

The kernels themselves run only on the card (tests/test_torch_kernels_gpu.py).
The JAX comparison: both compute float32 statistics of the same bf16 or
float32 rows and round once; they differ in the order of the float32 sums,
so bf16 outputs are held to one bf16 rounding (atol = rtol = 1e-2) and
float32 ones to 1e-5.
"""
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latteclip_torch import config as C
from latteclip_torch.kernels import fused_ln_linear as FL
from latteclip_torch.models import clip as clip_mod, layers
from latteclip_tpu.models import layers as jax_layers

torch.set_num_threads(1)

CONFIGS = Path(C.__file__).resolve().parent / "model_configs"


@functools.lru_cache(maxsize=None)
def _layer_norm_widths():
    """{width: a model that has it} over every LayerNorm of every model in
    ``model_configs/`` (modules built on the meta device, no weights), and the
    vision heads' LayerNorms held as parameters (``ln_scale``)."""
    widths = {}
    for name in sorted(p.stem for p in CONFIGS.glob("*.json")):
        with torch.device("meta"):
            model = clip_mod.build_model(C.get_model_config(name))
        for mod in model.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                widths.setdefault(mod.normalized_shape[-1], name)
        for pname, p in model.named_parameters():
            if pname.endswith("ln_scale"):
                widths.setdefault(p.shape[-1], name)
    return widths


def test_the_config_widths_hold_the_main_paths_and_eva02s_mlp_norm():
    widths = _layer_norm_widths()
    assert {512, 768, 1024, 2730}.issubset(widths), sorted(widths)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_layer_norm_plan_covers_every_config_width(itemsize):
    """Every width gets a plan that the kernels take: accesses of 16 or 4
    bytes that divide the row (so every row starts aligned),
    at most 4 a lane, lanes enough to cover the row and not a warp more,
    CTAs of at most 8 warps where a row takes at most 8 (rows of 16-byte
    accesses always), and 512 backward threads an SM."""
    for D, name in sorted(_layer_norm_widths().items()):
        plan = FL.layer_norm_plan(D, itemsize)
        access = plan.vec * itemsize
        assert access in (16, 4) and D % plan.vec == 0, (name, D, plan)
        if D * itemsize % 16 == 0:
            assert access == 16 and plan.warps <= FL.LN_CTA_WARPS, (name, D, plan)
        assert 1 <= plan.k <= FL.LN_MAX_K and plan.warps <= FL.LN_MAX_WARPS, (name, D, plan)
        lanes = 32 * plan.warps
        assert lanes * plan.k * plan.vec >= D > lanes * (plan.k - 1) * plan.vec, (name, D, plan)
        assert (plan.warps - 1) * 32 * FL.LN_MAX_K * plan.vec < D, (name, D, plan)
        assert plan.rows * plan.warps <= FL.LN_CTA_WARPS or plan.rows == 1, (name, D, plan)
        threads = 32 * plan.warps * plan.rows
        assert plan.ctas_per_sm == max(1, FL.LN_BWD_THREADS_SM // threads), (name, D, plan)


@pytest.mark.parametrize("D,itemsize,plan", [
    (512, 2, (8, 2, 1, 8, 2)), (768, 2, (8, 3, 1, 8, 2)), (1024, 2, (8, 4, 1, 8, 2)),
    (2048, 2, (8, 4, 2, 4, 2)), (3072, 2, (8, 4, 3, 2, 2)), (2730, 2, (2, 4, 11, 1, 1)),
    (768, 4, (4, 3, 2, 4, 2)), (77, 4, (1, 3, 1, 8, 2)), (78, 2, (2, 2, 1, 8, 2)),
    (8192, 2, (8, 4, 8, 1, 2)),
])
def test_layer_norm_plan_at_known_widths(D, itemsize, plan):
    assert FL.layer_norm_plan(D, itemsize) == FL.LayerNormPlan(*plan)


@pytest.mark.parametrize("D,itemsize", [(8200, 2), (4100, 4), (4097, 2), (77, 2), (8194, 2), (0, 2), (768, 8)])
def test_layer_norm_plan_raises_past_its_limit(D, itemsize):
    with pytest.raises(ValueError):
        FL.layer_norm_plan(D, itemsize)


def test_layer_norm_plan_backward_grid():
    plan = FL.layer_norm_plan(768, 2)
    assert plan.bwd_ctas(100864, 132) == 264
    assert plan.bwd_ctas(1003, 132) == 126
    assert plan.bwd_ctas(1, 132) == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_layer_norm_is_the_plain_composition_and_counts_nothing(dtype):
    """A CPU tensor takes F.layer_norm in float32, cast back, bit for bit,
    both ways, through the module and the function; no kernel is counted."""
    g = torch.Generator().manual_seed(0)
    x = (2 * torch.randn(3, 7, 96, generator=g) + 0.5).to(dtype)
    w, b = 1 + 0.1 * torch.randn(96, generator=g), 0.1 * torch.randn(96, generator=g)
    dy = torch.randn(3, 7, 96, generator=g).to(dtype)
    FL.reset_launch_counts()
    grads = []
    for fn in (FL.layer_norm, FL.layer_norm_plain, None):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        if fn is None:
            y = torch.nn.functional.layer_norm(xs.float(), (96,), ws, bs, 1e-5).to(dtype)
        else:
            y = fn(xs, ws, bs, 1e-5)
        grads.append((y, *torch.autograd.grad(y, (xs, ws, bs), dy)))
    for other in grads[1:]:
        for a, c in zip(grads[0], other):
            assert a.dtype == c.dtype and torch.equal(a, c)
    mod = layers.LayerNorm(96)
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(b)
        assert torch.equal(mod(x), grads[0][0])
    assert FL.layer_norm_counts == {"forward": 0, "backward": 0}


@pytest.mark.parametrize("dtype,eps", [(torch.bfloat16, 1e-5), (torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-6)])
def test_plain_layer_norm_matches_jax(dtype, eps):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 9, 768)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(768)).astype(np.float32)
    b = (0.1 * rng.standard_normal(768)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    ours = FL.layer_norm_plain(xt, torch.from_numpy(w), torch.from_numpy(b), eps)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_layers.layer_norm(jnp.asarray(xt.float().numpy()).astype(jdt), jnp.asarray(w),
                                jnp.asarray(b), eps)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)
