"""The ViT-B/16 geometry (224 px, patch 16, L = 197 tokens, heads 64 wide)
against latteclip_tpu, on the same weights and images, at reduced depth and
width (2 layers of width 128, 2 heads). At L = 197 no batch pair-packs
(that needs 2L <= 128), so every vision layer takes the whole-row attention
route: on the card the long-row kernel, here its plain version.

The JAX side runs its plain XLA attention, and in bf16 also its Pallas
whole-row kernel in interpret mode (``latteclip_tpu.kernels._pallas_enabled``
patched true). Tolerances as in tests/test_torch_model.py: float32 features
to 1e-4 (the same arithmetic up to summation order), bf16 to 1e-2 (the two
packages round at different points, compounding over the layers).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from latteclip_tpu import kernels as jax_kernels
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.models import clip as jax_clip
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.vit import pack_pairs_auto

torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_TOL = 1e-2

B16_GEOMETRY_RAW = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 224, "layers": 2, "width": 128, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 2},
}


def _shared(compute_dtype):
    jcfg = jax_config.config_from_dict("b16-geometry", B16_GEOMETRY_RAW)
    tcfg = torch_config.config_from_dict("b16-geometry", B16_GEOMETRY_RAW)
    jcfg = dataclasses.replace(jcfg, compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(tcfg, compute_dtype=compute_dtype)
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg),
                          strict=True)
    return jcfg, tcfg, params, model


def test_geometry_is_vit_b16s():
    full = torch_config.get_model_config("ViT-B-16").vision
    cfg = torch_config.config_from_dict("b16-geometry", B16_GEOMETRY_RAW).vision
    assert (cfg.image_size, cfg.patch_size, cfg.seq_len, cfg.head_width) == \
           (full.image_size, full.patch_size, full.seq_len, full.head_width) == (224, 16, 197, 64)
    # no pairs at 197 tokens, even on the card
    assert not pack_pairs_auto(256, cfg.seq_len, cfg, torch.bfloat16, torch.device("cuda"), "kernel")


@pytest.mark.parametrize("compute_dtype,tol,pallas", [
    ("float32", F32_TOL, False), ("bfloat16", BF16_TOL, False), ("bfloat16", BF16_TOL, True),
])
def test_encode_image_at_197_tokens_matches_jax(compute_dtype, tol, pallas, monkeypatch):
    if pallas:
        monkeypatch.setattr(jax_kernels, "_pallas_enabled", lambda: True)
    jcfg, _, params, model = _shared(compute_dtype)
    with torch.no_grad():
        for B in (2, 3):  # an even batch takes the whole-row route too
            x = np.random.default_rng(B).standard_normal((B, 224, 224, 3)).astype(np.float32)
            ref = np.asarray(jax_clip.encode_image(params, jcfg, x, normalize=True))
            ours = torch_clip.encode_image(model, torch.from_numpy(x), normalize=True).numpy()
            assert ours.shape == ref.shape == (B, jcfg.embed_dim)
            np.testing.assert_allclose(ours, ref, atol=tol, rtol=0)
