"""The port's big_vision ``.npz`` importer (latteclip_torch/big_vision.py)
against latteclip_tpu/core/big_vision.py, on the synthetic SigLIP-schema
checkpoint of tests/test_big_vision.py (big_vision's key layout and flax
shapes, seeded): the port's model from ``load_big_vision_npz`` and from
``load_clip_pt`` gives JAX's image and text features within 1e-5 of the
largest, in float32; the biased patch embedding, the MAP head, the text
projection's bias and ``logit_bias`` land under the port's names; a
positional embedding of another grid is resized as JAX resizes it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latteclip_tpu.core.big_vision import load_big_vision_npz as jax_load
from latteclip_tpu.core.checkpoint import load_clip_pt as jax_load_clip_pt
from latteclip_tpu.core.config import config_from_dict as jax_config_from_dict
from latteclip_tpu.models import clip as jax_clip
from latteclip_torch.big_vision import load_big_vision_npz
from latteclip_torch.checkpoint import load_clip_pt
from latteclip_torch.config import config_from_dict
from latteclip_torch.models import clip as torch_clip

from test_big_vision import CTX, IMG, PATCH, VOCAB, D, H, LAYERS, MLP, npz_path  # noqa: F401

torch.set_num_threads(1)
TOL = 1e-5


def port_cfg(**vision):
    """tests/test_big_vision.py's ``tiny_cfg`` as a raw dict, for both packages."""
    return {
        "embed_dim": D, "init_logit_bias": -10.0, "gelu_tanh": True, "compute_dtype": "float32",
        "vision_cfg": {"image_size": IMG, "patch_size": PATCH, "width": D, "layers": LAYERS,
                       "head_width": D // H, "mlp_ratio": MLP / D, "pool_type": "map",
                       "no_cls_token": True, "no_ln_pre": True, **vision},
        "text_cfg": {"context_length": CTX, "vocab_size": VOCAB, "width": D, "heads": H,
                     "layers": LAYERS, "mlp_ratio": MLP / D, "no_causal_mask": True,
                     "pool_type": "last"},
    }


def close(ours, theirs):
    theirs = np.asarray(theirs)
    ours = ours.detach().numpy()
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL * np.abs(theirs).max())


def features_match(model, params, jcfg, image_size):
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, image_size, image_size, 3)).astype(np.float32)
    ids = rng.integers(0, VOCAB, size=(3, CTX)).astype(np.int32)
    with torch.no_grad():
        close(torch_clip.encode_image(model, torch.from_numpy(images), normalize=True),
              jax_clip.encode_image(params, jcfg, jnp.asarray(images), normalize=True))
        close(torch_clip.encode_text(model, torch.from_numpy(ids).long(), normalize=True),
              jax_clip.encode_text(params, jcfg, jnp.asarray(ids), normalize=True))


@pytest.mark.parametrize("image_size", [IMG, 2 * IMG])
def test_importer_matches_jax(npz_path, image_size):  # noqa: F811
    """At the checkpoint's grid, and at twice its image size (the positional
    embedding resized from 2 x 2 to 4 x 4)."""
    raw = port_cfg(image_size=image_size)
    jcfg, tcfg = jax_config_from_dict("bv", raw), config_from_dict("bv", raw)
    params = jax_load(npz_path, jcfg)
    sd = load_big_vision_npz(npz_path, tcfg)
    assert sd["visual.conv1.bias"].shape == (tcfg.vision.width,)
    assert "latteclip.visual.map_head.probe" in sd and "latteclip.text.text_projection_b" in sd
    assert float(sd["logit_bias"]) == -10.0 and float(sd["logit_scale"]) == pytest.approx(2.3)
    # the resize: float32 sums in another order than jax.image.resize's
    pos = np.asarray(params["visual"]["pos_embed"])
    np.testing.assert_allclose(sd["visual.positional_embedding"].numpy(), pos, rtol=0,
                               atol=1e-6 * np.abs(pos).max())
    model = torch_clip.CLIP(tcfg, text_projection_b=True, patch_bias=True)
    model.load_state_dict(sd, strict=True)
    features_match(model, params, jcfg, image_size)


def test_load_clip_pt_reads_npz(npz_path):  # noqa: F811
    raw = port_cfg()
    jcfg, tcfg = jax_config_from_dict("bv", raw), config_from_dict("bv", raw)
    params, jax_bank, jax_meta = jax_load_clip_pt(npz_path, jcfg)
    model, bank, classnames, meta = load_clip_pt(npz_path, tcfg, device="cpu")
    assert bank is None and classnames == [] and meta == {} and jax_bank == {} == jax_meta
    assert model.cfg.init_logit_bias == -10.0 and model.text_projection_b is not None
    features_match(model, params, jcfg, IMG)
