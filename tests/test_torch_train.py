"""latteclip_torch train modules against latteclip_tpu, piece by piece, on the
same numpy inputs: the objective, the caption fusion (both branches), the
memory-bank update, the AdamW decay set and one AdamW update, the schedules,
the packed text tower, and the colour augment with JAX's draws injected.

Tolerances: everything here is float32 on both sides and differs only in
summation order and in float32 against float64 host arithmetic (the
schedules), so values agree to 1e-5 relative or 1e-6 absolute, except where
stated: features through a text tower to 1e-4 (tests/test_torch_model.py),
and the colour augment to 1e-5 on pixels in [0, 1].
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from latteclip_tpu.core import config as jax_config
from latteclip_tpu.data import transforms as jax_T
from latteclip_tpu.data.packing import pack_token_rows as jax_pack_token_rows
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.train import objective as jax_obj
from latteclip_tpu.train import optim as jax_optim
from latteclip_tpu.train import step as jax_step
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.data import transforms as T
from latteclip_torch.data.packing import pack_token_rows, token_lengths
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.train import objective, optim, step

torch.set_num_threads(1)

F32_TOL = 1e-5
TOWER_TOL = 1e-4


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_clip_loss_and_confidence_weights_match_jax():
    rng = np.random.default_rng(0)
    img, txt, protos = _unit_rows(rng, 8, 16), _unit_rows(rng, 8, 16), _unit_rows(rng, 5, 16)
    scale = np.float32(14.3)
    ref = float(jax_obj.clip_loss(img, txt, scale))
    ours = float(objective.clip_loss(_t(img), _t(txt), torch.tensor(scale)))
    assert ours == pytest.approx(ref, rel=F32_TOL)
    ref_w = np.asarray(jax_obj.text_confidence_weights(txt, protos))
    ours_w = objective.text_confidence_weights(_t(txt).requires_grad_(True), _t(protos))
    assert not ours_w.requires_grad
    np.testing.assert_allclose(ours_w.numpy(), ref_w, atol=1e-6, rtol=0)
    logits = rng.standard_normal((6, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 6)
    ref_ce = float(jax_obj.cross_entropy_with_int_labels(logits, labels))
    assert float(objective.cross_entropy_with_int_labels(_t(logits), _t(labels))) == \
        pytest.approx(ref_ce, rel=F32_TOL)


@pytest.mark.parametrize("bug_compat", [False, True])
def test_fuse_text_streams_matches_jax(bug_compat):
    rng = np.random.default_rng(1)
    B = E = 16  # bug_compat runs only at batch == embed_dim
    feats = [_unit_rows(rng, B, E) for _ in range(4)]
    weights = [rng.random(B).astype(np.float32) + 1e-6 for _ in range(4)]
    ref = jax_step.fuse_text_streams(*feats, *weights, bug_compat=bug_compat)
    ours = step.fuse_text_streams(*map(_t, feats), *map(_t, weights), bug_compat=bug_compat)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=F32_TOL)
    if bug_compat:
        with pytest.raises(ValueError, match="batch == embed_dim"):
            step.fuse_text_streams(*(_t(f[:, :8]) for f in feats), *map(_t, weights), True)


def test_update_memory_bank_matches_jax():
    rng = np.random.default_rng(2)
    C, B, E = 7, 10, 16
    bank = _unit_rows(rng, C, E)
    preds, zs = rng.integers(0, C - 2, B), rng.integers(0, C - 2, B)  # two classes unseen
    tf, tfz = rng.standard_normal((B, E)).astype(np.float32), rng.standard_normal((B, E)).astype(np.float32)
    ref = np.asarray(jax_step.update_memory_bank(bank, preds, zs, tf, tfz))
    bank_t = _t(bank)
    ours = step.update_memory_bank(bank_t, _t(preds), _t(zs), _t(tf), _t(tfz))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ours[C - 2:].numpy(), bank[C - 2:])  # unseen rows kept
    assert torch.equal(bank_t, _t(bank))  # a new bank; the old one is untouched


@pytest.fixture(scope="module")
def tiny():
    """JAX params and a port model on the same float32 weights."""
    jcfg = dataclasses.replace(jax_config.get_model_config("ViT-tiny-test"), compute_dtype="float32")
    tcfg = dataclasses.replace(torch_config.get_model_config("ViT-tiny-test"), compute_dtype="float32")
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    return jcfg, tcfg, params, model


def test_decay_set_matches_jax_decay_mask(tiny):
    _, tcfg, params, model = tiny
    mask = jax_optim.decay_mask(params)
    # each leaf's flag broadcast to its parameter, mapped to the port's names
    # by the weights converter
    full = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    ref = {name: bool(t.flatten()[0]) for name, t in state_dict_from_jax_params(full, tcfg).items()}
    ours = optim.decay_mask(model)
    assert ours == ref
    assert ours["visual.conv1.weight"] and ours["transformer.resblocks.0.attn.in_proj_weight"]
    assert not ours["logit_scale"] and not ours["visual.class_embedding"]
    assert not ours["ln_final.weight"] and not ours["transformer.resblocks.1.mlp.c_fc.bias"]


@pytest.mark.parametrize("kind,kw", [
    ("cosine", dict(total_steps=20)),
    ("const", {}),
    ("const-cooldown", dict(total_steps=20, cooldown_steps=6, cooldown_power=2.0, cooldown_end_lr=1e-5)),
])
def test_schedules_match_jax(kind, kw):
    ref = jax_optim.make_schedule(kind, 1e-3, warmup=4, **kw)
    ours = optim.make_schedule(kind, 1e-3, warmup=4, **kw)
    for s in range(22):
        assert ours(s) == pytest.approx(float(ref(s)), rel=F32_TOL, abs=1e-10)
    with pytest.raises(ValueError):
        optim.make_schedule("linear", 1e-3, 4)


def test_adamw_updates_match_optax(tiny):
    """Two AdamW updates from the same gradients, with the learning rate
    still in warmup so that each update reads schedule(count)."""
    _, tcfg, params, _ = tiny
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    schedule_args = ("cosine", 1e-2, 3)
    tx = jax_optim.make_optimizer(jax_optim.make_schedule(*schedule_args, total_steps=10))
    opt_state = tx.init(params)
    opt = optim.make_optimizer(model, optim.make_schedule(*schedule_args, total_steps=10))
    leaves, treedef = jax.tree.flatten(params)
    new_params = params
    by_name = dict(model.named_parameters())
    for i in range(2):
        rng = np.random.default_rng(10 + i)
        grads = jax.tree.unflatten(treedef, [rng.standard_normal(np.shape(x)).astype(np.float32)
                                             for x in leaves])
        updates, opt_state = tx.update(grads, opt_state, new_params)
        new_params = optax.apply_updates(new_params, updates)
        for name, g in state_dict_from_jax_params(jax.tree.map(np.asarray, grads), tcfg).items():
            by_name[name].grad = g.reshape(by_name[name].shape)
        opt.step()
    assert opt.count == 2
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, new_params), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].reshape(p.shape).numpy(),
                                   atol=1e-6, rtol=F32_TOL, err_msg=name)


def test_encode_text_packed_matches_jax(tiny):
    jcfg, _, params, model = tiny
    tok = get_tokenizer()
    tokens = tok(["a photo of a dog.", "a diagram", "two cats on a warm mat, asleep",
                  "", "a photo of a small red boat on a lake at dawn"])
    pk = pack_token_rows(tokens, token_lengths(tokens), 32)
    ref = np.asarray(jax_clip.encode_text_packed(params, jcfg, *jax_pack_token_rows(
        tokens, token_lengths(tokens), 32), normalize=True))
    with torch.no_grad():
        ours = torch_clip.encode_text_packed(model, *map(_t, pk), normalize=True).numpy()
        padded = torch_clip.encode_text(model, _t(tokens), normalize=True).numpy()
    assert ours.shape == ref.shape == (5, jcfg.embed_dim)
    np.testing.assert_allclose(ours, ref, atol=TOWER_TOL, rtol=0)
    np.testing.assert_allclose(ours, padded, atol=TOWER_TOL, rtol=0)  # packing is the same function


def _jax_color_draws(key, B, aug):
    """The six per-image draws JAX's color_augment makes from ``key``."""
    kb, kc, ks, kh, kp, kg = jax.random.split(key, 6)
    bf, cf, sf, hf = aug.color_jitter

    def u(k, lo, hi):
        return np.asarray(jax.random.uniform(k, (B, 1, 1, 1), minval=lo, maxval=hi)).reshape(B)

    return {"brightness": u(kb, max(0.0, 1 - bf), 1 + bf), "contrast": u(kc, max(0.0, 1 - cf), 1 + cf),
            "saturation": u(ks, max(0.0, 1 - sf), 1 + sf),
            "hue": np.asarray(jax.random.uniform(kh, (B, 1, 1), minval=-hf, maxval=hf)).reshape(B),
            "jitter_draw": u(kp, 0.0, 1.0), "gray_draw": u(kg, 0.0, 1.0)}


def test_color_augment_with_jax_draws_matches_jax():
    B, aug = 12, jax_T.AugConfig()
    images = np.random.default_rng(4).integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
    images[0] = 128  # a gray image: zero saturation, hue undefined
    key = jax.random.PRNGKey(3)
    draws = _jax_color_draws(key, B, aug)
    assert (draws["jitter_draw"] >= 0.8).any() and (draws["gray_draw"] < 0.2).any()
    ref = np.asarray(jax_T.color_augment(images.astype(np.float32) / 255.0, key, aug))
    factors = {k: _t(v) for k, v in draws.items()}
    ours = T.color_augment(_t(images).float() / 255.0, None, T.AugConfig(), factors=factors)
    np.testing.assert_allclose(ours.numpy(), ref, atol=F32_TOL, rtol=0)
    mean, std = T.OPENAI_MEAN, T.OPENAI_STD
    ref_n = np.asarray(jax_T.train_augment_normalize(images, key, aug, mean=mean, std=std))
    ours_n = T.train_augment_normalize(_t(images), None, T.AugConfig(), mean, std, factors=factors)
    np.testing.assert_allclose(ours_n.numpy(), ref_n, atol=F32_TOL / 0.26, rtol=0)


def test_color_augment_draws_from_the_generator():
    x = torch.rand(6, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    a = T.color_augment(x, torch.Generator().manual_seed(5), T.AugConfig())
    b = T.color_augment(x, torch.Generator().manual_seed(5), T.AugConfig())
    c = T.color_augment(x, torch.Generator().manual_seed(6), T.AugConfig())
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0 and a.max() <= 1
    f = T.draw_color_factors(1000, torch.Generator().manual_seed(1), T.AugConfig(), "cpu")
    assert set(f) == set(T.FACTOR_NAMES)
    assert 0.5 <= float(f["brightness"].min()) and float(f["brightness"].max()) <= 1.5
    assert -0.1 <= float(f["hue"].min()) and float(f["hue"].max()) <= 0.1
