"""Training the timm-trunk and ResNet towers in the port against
latteclip_tpu, on two tiny float32 models with ViT-tiny-test's CLIP text
tower: an EVA02-B-like tower (two TrV blocks of two 64-wide heads, rope,
SwiGLU) and a ModifiedResNet (one bottleneck a stage, width 8, BatchNorm
statistics away from identity).

* four float32 SGD steps of the ``--method ours`` step (augment off,
  captions padded and packed) against JAX's step on the same weights, JAX's
  SGD masked as its ``make_optimizer`` masks BatchNorm's statistics: losses
  to 1e-5 relative (``LOSS_REL_TOL``), every parameter and the bank to 2e-5
  (the bounds of tests/test_torch_train_step.py), EVA's k bias included (JAX trains the key
  slice of its packed in-projection bias; with rope its gradient is not
  zero, and without it the losses part by 1e-3 at the second step); the
  ResNet's statistics bit-equal to their start in both packages;
* ``--lock-image-unlocked-groups`` refuses the towers without a stack of
  blocks with JAX's message, and unlocks EVA02's groups as JAX's
  ``mask_tower_updates`` does;
* both mains, one epoch of two steps per family from one ``--pretrained``
  file written by JAX (``--lock-image`` for the ResNet): losses within 1e-4
  relative each step, final parameters within 2 * lr * steps, each tensor's
  change in the same direction within ``TOWER_COS_GAP``, eval results equal,
  the locked tower and every BatchNorm statistic bit-equal to the start; and
  each package resumes the other's ``epoch_1.pt`` of these towers.
"""
import os

import jax
import numpy as np
import optax
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.data.packing import pack_template_table as jax_pack_template_table
from latteclip_tpu.models import tokenizer as jax_tokenizer
from latteclip_tpu.train import main as jax_main
from latteclip_tpu.train import optim as jax_optim
from latteclip_tpu.train import state as jax_state
from latteclip_tpu.train import step as jax_step
from latteclip_torch import checkpoint as torch_ckpt
from latteclip_torch import config as torch_config
from latteclip_torch.data.packing import pack_template_table
from latteclip_torch.models import tokenizer as torch_tokenizer
from latteclip_torch.train import main as torch_main
from latteclip_torch.train import optim as torch_optim
from latteclip_torch.train import state as torch_state
from latteclip_torch.train import step as torch_step
from test_torch_cli import (
    STEPS,
    _assert_checkpoints_agree,
    _assert_logs_agree,
    _checkpoint,
    _results,
    _run,
)
from test_torch_towers import canonical_params, register_tiny_trunks

torch.set_num_threads(2)
TEXT = {"context_length": 77, "vocab_size": 49408, "width": 64, "heads": 4, "layers": 2}
RAW = {
    "tiny-eva02": {"embed_dim": 32, "compute_dtype": "float32", "text_cfg": TEXT,
                   "vision_cfg": {"image_size": 48, "timm_model_name": "eva02_tiny_b"}},
    "tiny-rn": {"embed_dim": 32, "compute_dtype": "float32", "text_cfg": TEXT,
                "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1], "width": 8}},
}
# The losses' bound, relative. The loss reads logits of 100 * cos of float32
# unit vectors, so a difference of a few ulp (6e-8) in a feature, which two
# summation orders give, moves it by about 1e-5 at a loss of ~6: the bound of
# tests/test_torch_train_step.py (1e-5 absolute) sits at that floor. On
# EVA02's rope path JAX's sine and cosine differ from correctly rounded ones
# by an ulp in a few entries and four steps at lr 1e-2 carry the loss 1.6e-5
# apart (2.4e-6 relative) while every parameter stays within 6e-8; JAX
# against itself, jit against eager, moves 1.9e-6. A wrong rope, k bias or
# BatchNorm moves the loss by 1e-3 relative or more at the second step.
LOSS_REL_TOL = 1e-5
# 1 - cos between the packages' per-tensor parameter deltas (see
# tests/test_torch_cli.py::DELTA_COS_GAP and tests/test_torch_trainers_cli.py::
# FLYP_COS_GAP): the key third of the text towers' in_proj_bias is AdamW
# noise of about lr * g / eps with g summation noise, a third of the tensor,
# so 1 - cos <= 1e-4; a flipped update of one trained element gives ~1e-2.
TOWER_COS_GAP = 1e-4


def register(monkeypatch):
    """The tiny trunks in both packages' tables, the two tiny configs in
    both mains."""
    register_tiny_trunks(monkeypatch)
    for main, config_mod in ((jax_main, jax_config), (torch_main, torch_config)):
        real = config_mod.get_model_config

        def lookup(name, real=real, config_mod=config_mod):
            return config_mod.config_from_dict(name, RAW[name]) if name in RAW else real(name)
        monkeypatch.setattr(main, "get_model_config", lookup)


def _caption_rows(rng, n, eot):
    rows = np.zeros((n, 77), np.int32)
    for i, ln in enumerate(rng.integers(8, 40, n)):
        rows[i, :ln - 1] = rng.integers(1, 40000, ln - 1)
        rows[i, ln - 1] = eot
    return rows


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", list(RAW))
def test_train_step_matches_jax(name, packed, monkeypatch):
    from latteclip_torch.data.packing import (PackRowBucketer, pack_caption_batch,
                                              pack_rows_needed, token_lengths)

    register_tiny_trunks(monkeypatch)
    jcfg = jax_config.config_from_dict(name, RAW[name])
    tcfg = torch_config.config_from_dict(name, RAW[name])
    params = canonical_params(jcfg)
    from latteclip_torch.models import clip as torch_clip

    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(torch_ckpt.state_dict_from_jax_params(params, tcfg), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    size = tcfg.vision.image_size
    classes, templates = [f"class {i}" for i in range(6)], [lambda c: f"a photo of a {c}."]
    tok = torch_tokenizer.get_tokenizer()
    rng, bucket = np.random.default_rng(0), PackRowBucketer(multiple=8)
    batches = []
    for _ in range(2):
        b = {"images": rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8),
             "per_image_tokens": _caption_rows(rng, 8, tok.eot_token_id),
             "per_group_tokens": _caption_rows(rng, 8, tok.eot_token_id),
             "zs_preds": rng.integers(0, len(classes), 8).astype(np.int32)}
        if packed:
            lengths = token_lengths(np.concatenate([b["per_image_tokens"], b["per_group_tokens"]]))
            b.update(pack_caption_batch(b["per_image_tokens"], b["per_group_tokens"], 128,
                                        bucket.rows_for(pack_rows_needed(lengths, 128))))
        batches.append(b)
    table = jax_state.build_template_table(jax_tokenizer.get_tokenizer(), classes, templates)
    bank = jax_state.init_memory_bank(params, jcfg, jax_tokenizer.get_tokenizer(), classes,
                                      templates)
    frozen = lambda p: jax.tree.map(lambda t: not t, jax_optim.trainable_mask(p))  # noqa: E731
    tx = optax.chain(optax.sgd(1e-2), optax.masked(optax.set_to_zero(), frozen))
    jstate = jax_state.create_train_state(params, tx, bank)
    jfn = jax.jit(jax_step.make_train_step(
        jcfg, tx, jax_step.LatteHParams(augment=False, text_packing=packed), table,
        template_packed=jax_pack_template_table(table, 128) if packed else None))
    tbank = torch_state.init_memory_bank(model, tok, classes, templates)
    np.testing.assert_allclose(tbank.numpy(), np.asarray(bank), atol=2e-5, rtol=0)
    tstate = torch_state.create_train_state(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                                            tbank)
    tfn = torch_step.make_train_step(
        model, torch_step.LatteHParams(augment=False, text_packing=packed), table,
        template_packed=pack_template_table(table, 128) if packed else None)
    jl, tl = [], []
    for i in range(4):
        jstate, jm = jfn(jstate, batches[i % 2], jax.random.PRNGKey(i))
        jl.append(float(jm["loss"]))
        tl.append(float(tfn(tstate, batches[i % 2])["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL_TOL, atol=0)
    ref = torch_ckpt.state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), tcfg,
                                                k_bias=True)
    trained = {**model.state_dict(keep_vars=True), **dict(model.named_parameters())}
    assert sorted(trained) == sorted(ref)
    for k, v in trained.items():
        np.testing.assert_allclose(v.detach().numpy(), ref[k].numpy(), atol=2e-5, rtol=0,
                                   err_msg=k)
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, start[k]) and torch.equal(ref[k], start[k]), k
    np.testing.assert_allclose(tstate.memory_bank.numpy(), np.asarray(jstate.memory_bank),
                               atol=2e-5, rtol=0)


REFUSED = {
    "resnet": {"layers": [1, 1, 1, 1], "width": 8, "image_size": 64},
    "convnext": {"timm_model_name": "convnext_tinytest", "image_size": 32},
    "swin": {"timm_model_name": "swin_tinytest", "image_size": 56},
}


@pytest.mark.parametrize("tower", list(REFUSED))
def test_partial_unlock_refused_with_jax_message(tower, monkeypatch):
    register_tiny_trunks(monkeypatch)
    raw = dict(RAW["tiny-rn"], vision_cfg=REFUSED[tower])
    jcfg, tcfg = jax_config.config_from_dict(tower, raw), torch_config.config_from_dict(tower, raw)
    params = canonical_params(jcfg)
    tx = jax_optim.make_optimizer(optax.constant_schedule(1e-3), lock_image=True,
                                  lock_image_unlocked_groups=1)
    with pytest.raises(ValueError) as theirs:
        tx.update(jax.tree.map(np.zeros_like, params), tx.init(params), params)
    from latteclip_torch.models import clip as torch_clip

    with pytest.raises(ValueError) as ours:
        torch_optim.make_optimizer(torch_clip.CLIP(tcfg), torch_optim.make_schedule("const", 1e-3, 0),
                                   lock_image=True, lock_image_unlocked_groups=1)
    assert str(ours.value) == str(theirs.value)
    assert "has no 'blocks' stack" in str(ours.value)


@pytest.mark.parametrize("groups", [1, 2, 3, 4])
def test_eva02_unlocked_groups_equal_jax(groups, monkeypatch):
    """Updates of ones through JAX's ``mask_tower_updates("visual", n)``,
    written as a state dict, equal the port's mask for the same n."""
    register_tiny_trunks(monkeypatch)
    jcfg = jax_config.config_from_dict("tiny-eva02", RAW["tiny-eva02"])
    tcfg = torch_config.config_from_dict("tiny-eva02", RAW["tiny-eva02"])
    params = canonical_params(jcfg)
    ones = jax.tree.map(np.ones_like, params)
    tx = jax_optim.mask_tower_updates("visual", groups)
    masked, _ = tx.update(ones, tx.init(params), params)
    ref = torch_ckpt.state_dict_from_jax_params(jax.tree.map(np.asarray, masked), tcfg,
                                                k_bias=True)
    from latteclip_torch.models import clip as torch_clip

    mask = torch_optim.mask_tower_updates(torch_clip.CLIP(tcfg), "visual", groups)
    for name, keep in mask.items():
        assert torch.all(ref[name] == float(keep)), name


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both mains on each tiny tower, and each resuming the other's epoch 1."""
    base = tmp_path_factory.mktemp("towers_cli")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        register(mp)
        for name, extra in (("tiny-eva02", []), ("tiny-rn", ["--lock-image"])):
            jcfg = jax_config.config_from_dict(name, RAW[name])
            pretrained = str(base / f"{name}.pt")
            jax_ckpt.save_clip_pt(pretrained, canonical_params(jcfg), jcfg)
            argv = ["--pretrained", pretrained, "--model", name, *extra]
            runs = {"start": torch.load(pretrained, map_location="cpu",
                                        weights_only=True)["state_dict"], "extra": extra}
            runs["jax"] = _run(jax_main.main, str(base / name / "jax"), *argv)
            runs["torch"] = _run(torch_main.main, str(base / name / "torch"), *argv,
                                 "--device", "cpu")
            runs["torch_from_jax"] = _run(
                torch_main.main, str(base / name / "torch_from_jax"), *argv, "--device", "cpu",
                "--resume", os.path.join(runs["jax"], "checkpoints", "epoch_1.pt"))
            runs["jax_from_torch"] = _run(
                jax_main.main, str(base / name / "jax_from_torch"), *argv, "--resume",
                os.path.join(runs["torch"], "checkpoints", "epoch_1.pt"))
            out[name] = runs
    return out


def _frozen(runs):
    locked = "--lock-image" in runs["extra"]
    return lambda k: k.endswith(("running_mean", "running_var")) or (
        locked and k.startswith("visual."))


@pytest.mark.parametrize("name", list(RAW))
def test_cli_trains_like_jax(name, cli_runs):
    runs = cli_runs[name]
    _assert_logs_agree(runs["torch"], runs["jax"], expect_steps=STEPS)
    _assert_checkpoints_agree(runs["torch"], runs["jax"], runs["start"], frozen=_frozen(runs),
                              cos_gap=TOWER_COS_GAP)
    assert _results(runs["torch"]) == _results(runs["jax"])
    sd = _checkpoint(runs["torch"], 1)[0]
    prefix = "visual.trunk." if name == "tiny-eva02" else "visual.layer1.0."
    assert any(k.startswith(prefix) for k in sd)


@pytest.mark.parametrize("resumed,own", [("torch_from_jax", "jax"), ("jax_from_torch", "torch")])
@pytest.mark.parametrize("name", list(RAW))
def test_cross_package_resume(name, resumed, own, cli_runs):
    runs = cli_runs[name]
    epoch2 = [s for s in _steps_of(runs[own]) if s[0] == 1]
    got = _steps_of(runs[resumed])
    assert len(got) == len(epoch2) == 2
    for x, y in zip(got, epoch2):
        assert x[:3] == y[:3] and abs(x[4] - y[4]) <= 1e-4 * abs(y[4])
    _assert_checkpoints_agree(runs[resumed], runs[own], runs["start"], frozen=_frozen(runs),
                              cos_gap=TOWER_COS_GAP)


def _steps_of(run_dir):
    from test_torch_cli import _steps

    return _steps(run_dir)

