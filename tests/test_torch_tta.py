"""latteclip_torch's test-time adaptation (``data/augmix.py``,
``models/text.py::text_forward_embeds``, ``eval/tta.py``, ``--tta`` and
``--method tpt|rlcf``) against latteclip_tpu, ViT-tiny-test in float32 from
one set of weights.

Tolerances: AugMix views byte-equal from one seed (the same PIL operations
on the same draws); the prompt context's tokens equal and its vectors
bit-equal (rows of the same table); text features within 1e-5 (float32
summation order, tests/test_torch_model.py); ``avg_entropy`` within 1e-6
and ``select_confident`` equal; the ctx gradient of one TPT step within
1e-4 relative in norm (a 12-layer-deep float32 backward in another order);
the adapted base-view logits of TPT and RLCF after two AdamW steps within
1e-3 (optax's and torch's AdamW differ only in rounding; the logits are
``exp(logit_scale)``, 14.3 at init, times a cosine; 2e-5 is seen), where
the adaptation itself moves them by more than 1e-2; ``evaluate_tta``
metrics equal, as are the mains' ``TTA eval:`` lines.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.data.augmix import augmix_views as jax_augmix_views
from latteclip_tpu.data.eval_dataset import FlatFileDataset as JaxFlatFileDataset
from latteclip_tpu.eval import tta as jax_tta
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models.text import text_forward_embeds as jax_text_forward_embeds
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_tpu.train import main as jax_main
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.data import synthetic
from latteclip_torch.data.augmix import augmix_views
from latteclip_torch.data.eval_dataset import FlatFileDataset
from latteclip_torch.eval import tta
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.text import text_forward_embeds
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.train import main as torch_main

torch.set_num_threads(2)
FEAT_TOL = 1e-5
GRAD_REL_TOL = 1e-4
LOGIT_TOL = 1e-3
CLASSES = ["banded", "dotted", "striped", "zigzagged", "woven", "veined"]
TTA_CFG = dict(n_views=7, tta_steps=2, selection_p=0.25)


def _pair(seed):
    jcfg = dataclasses.replace(jax_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(torch_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    params = jax_clip.init_clip_params(jax.random.PRNGKey(seed), jcfg)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    return jcfg, params, model


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    base = tmp_path_factory.mktemp("tta")
    root = str(base / "fixture")
    synthetic.make_flat_dataset(root, num_train=6, num_val=6, classes=CLASSES, image_size=64)
    jcfg, params, model = _pair(0)
    _, reward_params, reward_model = _pair(9)
    feats = np.random.default_rng(0).standard_normal((8, jcfg.embed_dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return {"base": base, "root": root, "jcfg": jcfg, "params": params, "model": model,
            "reward_params": reward_params, "reward_model": reward_model, "feats": feats}


def _prompts(shared):
    theirs = jax_tta.build_prompt_context(shared["params"], shared["jcfg"], jax_get_tokenizer(),
                                          CLASSES)
    ours = tta.build_prompt_context(shared["model"], get_tokenizer(), CLASSES)
    return ours, theirs


def test_augmix_views_byte_equal():
    img = Image.fromarray(np.random.RandomState(0).randint(0, 255, (80, 96, 3), np.uint8))
    ours = augmix_views(img, 64, n_views=7, rng=np.random.default_rng(3))
    theirs = jax_augmix_views(img, 64, n_views=7, rng=np.random.default_rng(3))
    assert ours.shape == (8, 64, 64, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    assert not np.array_equal(ours[1], ours[0])


def test_prompt_context_and_embeds_forward_match_jax(shared):
    ours, theirs = _prompts(shared)
    assert ours.n_ctx == theirs.n_ctx == 4
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(theirs.tokens))
    np.testing.assert_array_equal(ours.eot_pos.numpy(), np.asarray(theirs.eot_pos))
    np.testing.assert_array_equal(ours.init_ctx.numpy(), np.asarray(theirs.init_ctx))
    # the embeddings entry point on caller-made embeddings
    rng = np.random.default_rng(1)
    embeds = (0.02 * rng.standard_normal((3, 77, 64))).astype(np.float32)
    eot = np.asarray([5, 76, 0])
    ref = jax_text_forward_embeds(shared["params"]["text"], shared["jcfg"].text,
                                  jnp.asarray(embeds), jnp.asarray(eot), dtype=jnp.float32)
    with torch.no_grad():
        got = text_forward_embeds(shared["model"], torch.from_numpy(embeds),
                                  torch.from_numpy(eot), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FEAT_TOL, rtol=0)
    ctx = np.asarray(theirs.init_ctx) + 0.01
    ref = jax_tta.prompt_text_features(shared["params"], shared["jcfg"], theirs, jnp.asarray(ctx))
    with torch.no_grad():
        got = tta.prompt_text_features(shared["model"], ours, torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FEAT_TOL, rtol=0)


def test_avg_entropy_and_selection_match_jax():
    logits = np.random.default_rng(2).standard_normal((16, 6)).astype(np.float32) * 4
    np.testing.assert_allclose(float(tta.avg_entropy(torch.from_numpy(logits))),
                               float(jax_tta.avg_entropy(jnp.asarray(logits))), atol=1e-6)
    for p in (0.1, 0.25, 0.5):
        np.testing.assert_array_equal(tta.select_confident(torch.from_numpy(logits), p).numpy(),
                                      np.asarray(jax_tta.select_confident(jnp.asarray(logits), p)))


def test_tpt_ctx_gradient_matches_jax_grad(shared):
    ours, theirs = _prompts(shared)
    params, jcfg, feats = shared["params"], shared["jcfg"], shared["feats"]

    def loss(c):
        text = jax_tta.prompt_text_features(params, jcfg, theirs, c)
        return jax_tta.avg_entropy(jnp.exp(params["logit_scale"]) * jnp.asarray(feats) @ text.T)

    ref = np.asarray(jax.grad(loss)(theirs.init_ctx))
    with tta.frozen(shared["model"]):
        ctx = ours.init_ctx.clone().requires_grad_(True)
        logits_of = tta.prompt_logits_fn(shared["model"], ours)
        tta.avg_entropy(logits_of(ctx, torch.from_numpy(feats))).backward()
    assert all(p.requires_grad for p in shared["model"].parameters())
    got = ctx.grad.numpy()
    assert np.linalg.norm(ref) > 0
    assert np.linalg.norm(got - ref) <= GRAD_REL_TOL * np.linalg.norm(ref)


def test_adapted_logits_match_jax(shared):
    """TPT and RLCF on one image's view features: two AdamW steps each."""
    ours, theirs = _prompts(shared)
    params, jcfg, feats = shared["params"], shared["jcfg"], shared["feats"]
    cfg = jax_tta.TTAConfig(sample_k=3, **TTA_CFG)
    tcfg = tta.TTAConfig(sample_k=3, **TTA_CFG)
    tok = jax_get_tokenizer()
    reward_text = np.array(jax_clip.encode_text(
        shared["reward_params"], jcfg, tok([f"{c} texture." for c in CLASSES]), normalize=True))
    # reward-model views near class texts, so that the clamped scores differ
    noise = np.random.default_rng(4).standard_normal(feats.shape).astype(np.float32)
    reward_feats = reward_text[np.arange(len(feats)) % len(CLASSES)] + 0.1 * noise
    reward_feats /= np.linalg.norm(reward_feats, axis=1, keepdims=True)
    ref_tpt = jax_tta.make_tpt_adapt_fn(params, jcfg, theirs, cfg)(jnp.asarray(feats))
    ref_rlcf = jax_tta.make_rlcf_adapt_fn(params, jcfg, shared["reward_params"], jcfg, theirs,
                                          cfg, jnp.asarray(reward_text))(jnp.asarray(feats),
                                                            jnp.asarray(reward_feats))
    with tta.frozen(shared["model"]):
        logits_of = tta.prompt_logits_fn(shared["model"], ours)
        got_tpt = tta.tpt_adapt(logits_of, ours, tcfg, torch.from_numpy(feats))
        got_rlcf = tta.rlcf_adapt(logits_of, ours, tcfg, torch.from_numpy(feats),
                                  torch.from_numpy(reward_feats),
                                  torch.from_numpy(reward_text))
    with torch.no_grad():
        base = tta.prompt_logits_fn(shared["model"], ours)(ours.init_ctx,
                                                           torch.from_numpy(feats[:1]))[0]
    for got, ref in ((got_tpt, ref_tpt), (got_rlcf, ref_rlcf)):
        assert got.shape == (len(CLASSES),)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=0)
        assert np.abs(got.numpy() - base.numpy()).max() > 10 * LOGIT_TOL   # the context moved


@pytest.mark.parametrize("method", ["tpt", "rlcf"])
def test_evaluate_tta_matches_jax(shared, method):
    jds = JaxFlatFileDataset(shared["root"], train=False, image_size=64, dataset_name="dtd")
    ds = FlatFileDataset(shared["root"], train=False, image_size=64, dataset_name="dtd")
    kw = dict(method=method, max_samples=4, seed=1)
    theirs = jax_tta.evaluate_tta(
        shared["params"], shared["jcfg"], jax_get_tokenizer(), jds,
        jax_tta.TTAConfig(sample_k=2, **TTA_CFG), reward_params=shared["reward_params"],
        reward_cfg=shared["jcfg"], **kw)
    ours = tta.evaluate_tta(shared["model"], get_tokenizer(), ds,
                            tta.TTAConfig(sample_k=2, **TTA_CFG),
                            reward_model=shared["reward_model"], **kw)
    assert ours == theirs and ours["n"] == 4


_TTA_LINE = re.compile(r"TTA eval: (\{.*\})")


def _tta_line(log_dir):
    (path,) = [os.path.join(d, "out.log") for d, _, files in os.walk(log_dir)
               if "out.log" in files]
    with open(path) as f:
        (line,) = [m.group(1) for m in map(_TTA_LINE.search, f) if m]
    return line


@pytest.mark.parametrize("flags", [["--tta"], ["--method", "rlcf", "--reward-model",
                                               "ViT-tiny-test"]])
def test_both_mains_run_tta(shared, tmp_path, flags):
    """The CLI: TPT, and RLCF with its reward model from --reward-pretrained."""
    reward = str(tmp_path / "reward.pt")
    jax_ckpt.save_clip_pt(reward, shared["reward_params"], shared["jcfg"])
    pretrained = str(tmp_path / "pretrained.pt")
    jax_ckpt.save_clip_pt(pretrained, shared["params"], shared["jcfg"])
    argv = ["--model", "ViT-tiny-test", "--precision", "fp32", "--pretrained", pretrained,
            "--eval-preprocess-path", shared["root"], "--zeroshot-eval-data", "dtd",
            "--tta-n-views", "7", "--tta-step", "2", "--tta-max-samples", "3",
            "--selection-p", "0.25", "--reward-pretrained", reward, *flags]
    assert jax_main.main([*argv, "--logs", str(tmp_path / "jax")]) == 0
    assert torch_main.main([*argv, "--logs", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    line = _tta_line(str(tmp_path / "torch"))
    assert line == _tta_line(str(tmp_path / "jax")) and "'n': 3.0" in line
