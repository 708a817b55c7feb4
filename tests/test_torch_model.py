"""latteclip_torch model slice against latteclip_tpu: config and asset
copies, the JAX-params converter, strict state-dict loading, and both towers
on the same weights and inputs.

Tolerances: in float32 compute both packages run the same arithmetic up to
summation order (the port's attention is a base-2 softmax, which is the same
function in f32), so features agree to 1e-4. In bf16 the two round at
different points: JAX's CPU route multiplies q by the scale in bf16 and takes
a natural-base softmax, the port's plain attention rounds q * D^-1/2 * log2 e
from f32 and takes a base-2 softmax; each bf16 rounding is up to 2^-9
relative and they compound over the layers. L2-normalized features differ by
up to 4.2e-3 on these configs and are held to 1e-2.
"""
import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.models import clip as jax_clip
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import load_clip_pt, state_dict_from_jax_params
from latteclip_torch.models import clip as torch_clip

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-4
BF16_TOL = 1e-2

# a tiny config whose heads are 64 wide in both towers (ViT-tiny-test's text
# heads are 16 wide)
HD64_RAW = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 64, "layers": 2, "width": 128, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 2},
}


def _configs(name):
    if name == "ViT-tiny-test":
        return jax_config.get_model_config(name), torch_config.get_model_config(name)
    return (jax_config.config_from_dict("tiny-hd64", HD64_RAW),
            torch_config.config_from_dict("tiny-hd64", HD64_RAW))


def _shared(name, compute_dtype):
    """JAX params and a port model holding the same weights."""
    jcfg, tcfg = _configs(name)
    jcfg = dataclasses.replace(jcfg, compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(tcfg, compute_dtype=compute_dtype)
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(params_np, tcfg), strict=True)
    return jcfg, params, model


VIT_JSONS = sorted(f for f in os.listdir(os.path.join(REPO, "latteclip_tpu", "core", "model_configs"))
                   if f.startswith("ViT-") and f.endswith(".json"))
# CoCa's and the HF text towers' configs
COCA_HF_JSONS = [f"{n}.json" for n in (
    "coca_ViT-B-32", "coca_ViT-L-14", "coca_base", "coca_tiny-test", "coca_roberta-ViT-B-32",
    "roberta-ViT-B-32", "xlm-roberta-base-ViT-B-32", "xlm-roberta-large-ViT-H-14",
    "mt5-base-ViT-B-32", "mt5-xl-ViT-H-14", "nllb-clip-base", "nllb-clip-large",
    "nllb-clip-base-siglip", "nllb-clip-large-siglip")]


@pytest.mark.parametrize("rel", [
    *(f"model_configs/{f}" for f in VIT_JSONS + COCA_HF_JSONS), "assets/clip_bpe_merges.txt.gz",
    "assets/imagenet_classnames.json", "assets/openai_imagenet_templates.json",
])
def test_data_copies_are_byte_identical(rel):
    src = ("latteclip_tpu/core/" if rel.startswith("model_configs") else "latteclip_tpu/") + rel
    assert filecmp.cmp(os.path.join(REPO, src), os.path.join(REPO, "latteclip_torch", rel),
                       shallow=False)


def test_config_matches_jax_and_refuses_other_towers():
    for name in ("ViT-B-32", "ViT-B-16", "ViT-tiny-test"):
        j, t = jax_config.get_model_config(name), torch_config.get_model_config(name)
        assert (t.embed_dim, t.vision.width, t.vision.layers, t.vision.patch_size,
                t.vision.heads, t.vision.seq_len) == \
               (j.embed_dim, j.vision.width, j.vision.layers, j.vision.patch_size,
                j.vision.heads, j.vision.seq_len)
        assert (t.text.width, t.text.heads, t.text.layers, t.text.context_length) == \
               (j.text.width, j.text.heads, j.text.layers, j.text.context_length)
    # multimodal_cfg (CoCa) and hf_model_name (an HF text tower) parse to JAX's fields
    for raw in ({"embed_dim": 8, "multimodal_cfg": {"width": 8}},
                {"embed_dim": 8, "text_cfg": {"hf_model_name": "roberta-base"}}):
        j, t = jax_config.config_from_dict("x", raw), torch_config.config_from_dict("x", raw)
        assert type(t).__name__ == type(j).__name__
        td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
        for sub in ("text", "multimodal"):  # the port's TextConfig has no pad_id (JAX's: 0)
            if sub in td and "pad_id" not in td[sub]:
                assert jd[sub].pop("pad_id") == 0
        assert td == jd
    # a big_vision .npz goes to its importer (tests/test_torch_big_vision.py)
    with pytest.raises(FileNotFoundError, match="weights.npz"):
        load_clip_pt("weights.npz", torch_config.get_model_config("ViT-B-32"), device="cpu")


@pytest.mark.parametrize("raw", [
    {"vision_cfg": {"no_cls_token": True, "pool_type": "avg"}},
    {"vision_cfg": {"no_ln_pre": True}},
    {"vision_cfg": {"final_ln_after_pool": True}},
    {"vision_cfg": {"ls_init_value": 1e-5}},
    {"text_cfg": {"pool_type": "last"}},
    {"text_cfg": {"no_causal_mask": True}},
    {"text_cfg": {"ls_init_value": 1e-5}},
    {"gelu_tanh": True},
])
def test_config_option_matches_jax(raw):
    """Each tower option of the native ViT configs, alone on tiny-hd64 in
    float32: both towers' features equal JAX's to F32_TOL, from JAX's seeded
    init with every parameter moved by N(0, 0.05^2) (so that LayerScale's
    gammas, LayerNorms and biases sit at no value that hides a misplaced
    one)."""
    base = {**HD64_RAW, "compute_dtype": "float32"}
    merged = {**base, **{k: ({**base[k], **v} if isinstance(v, dict) else v)
                         for k, v in raw.items()}}
    jcfg = jax_config.config_from_dict("opt", merged)
    tcfg = torch_config.config_from_dict("opt", merged)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + np.float32(0.05) * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg))
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(params, tcfg), strict=True)
    x = _images(4, jcfg.vision.image_size, seed=4)
    from latteclip_torch.models.tokenizer import get_tokenizer

    tokens = get_tokenizer()(["a photo of a dog.", "a diagram", "two cats on a warm mat"])
    with torch.no_grad():
        for ours, ref in ((torch_clip.encode_image(model, torch.from_numpy(x), normalize=True),
                           jax_clip.encode_image(params, jcfg, x, normalize=True)),
                          (torch_clip.encode_text(model, torch.from_numpy(tokens), normalize=True),
                           jax_clip.encode_text(params, jcfg, tokens, normalize=True))):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("name", ["ViT-tiny-test", "tiny-hd64"])
def test_state_dict_from_jax_params_equals_jax_writer(name):
    jcfg, tcfg = _configs(name)
    params_np = jax.tree.map(np.asarray, jax_clip.init_clip_params(jax.random.PRNGKey(1), jcfg))
    ours = state_dict_from_jax_params(params_np, tcfg)
    ref = jax_ckpt.params_to_pt_state_dict(params_np, jcfg)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v, np.float32).reshape(ours[k].shape))
        assert tuple(ours[k].shape) == np.asarray(v).shape
    torch_clip.CLIP(tcfg).load_state_dict(ours, strict=True)


def test_init_clip_params_is_seeded_and_refuses_missing_cuda():
    _, tcfg = _configs("ViT-tiny-test")
    a = torch_clip.init_clip_params(torch.Generator().manual_seed(3), tcfg, device="cpu")
    b = torch_clip.init_clip_params(torch.Generator().manual_seed(3), tcfg, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.logit_scale.item() == pytest.approx(tcfg.init_logit_scale)
    assert torch.all(a.visual.ln_pre.weight == 1) and torch.all(a.transformer.resblocks[0].attn.in_proj_bias == 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_clip.init_clip_params(torch.Generator().manual_seed(3), tcfg)


def _images(B, size, seed):
    return np.random.default_rng(seed).standard_normal((B, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["ViT-tiny-test", "tiny-hd64"])
@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_encode_image_matches_jax(name, compute_dtype, tol):
    jcfg, params, model = _shared(name, compute_dtype)
    size = jcfg.vision.image_size
    cases = [(4, True), (4, False), (3, None)]  # even batch packed / unpacked, odd batch
    with torch.no_grad():
        for B, pack in cases:
            x = _images(B, size, seed=B)
            ref = np.asarray(jax_clip.encode_image(params, jcfg, x, normalize=True))
            ours = torch_clip.encode_image(model, torch.from_numpy(x), normalize=True,
                                           pack_pairs=pack).numpy()
            assert ours.shape == ref.shape == (B, jcfg.embed_dim)
            np.testing.assert_allclose(ours, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("name", ["ViT-tiny-test", "tiny-hd64"])
@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_encode_text_matches_jax(name, compute_dtype, tol):
    from latteclip_torch.models.tokenizer import get_tokenizer

    jcfg, params, model = _shared(name, compute_dtype)
    tokens = get_tokenizer()(["a photo of a dog.", "a diagram", "two cats on a warm mat, asleep"])
    ref = np.asarray(jax_clip.encode_text(params, jcfg, tokens, normalize=True))
    with torch.no_grad():
        ours = torch_clip.encode_text(model, torch.from_numpy(tokens), normalize=True).numpy()
    assert ours.shape == ref.shape == (3, jcfg.embed_dim)
    np.testing.assert_allclose(ours, ref, atol=tol, rtol=0)


def test_pair_packing_is_the_same_function_on_the_port():
    _, _, model = _shared("tiny-hd64", "float32")
    x = torch.from_numpy(_images(4, 64, seed=9))
    with torch.no_grad():
        packed = torch_clip.encode_image(model, x, pack_pairs=True)
        unpacked = torch_clip.encode_image(model, x, pack_pairs=False)
    torch.testing.assert_close(packed, unpacked, atol=1e-5, rtol=1e-5)
