"""Training CoCa and an HF text tower in latteclip_torch against
latteclip_tpu, in float32 on the CPU.

* the v2 step (``--method ours``) on a tiny CoCa, four SGD steps from one
  set of weights (JAX's init plus N(0, 0.05^2)) and one template table,
  augment off: losses to ``LOSS_REL_TOL`` relative, every parameter and the
  bank to 2e-5 (the bounds of tests/test_torch_train_step.py), and the
  caption decoder, which the v2 objective never reads, bit-equal to its
  start in both packages (JAX's ``zero_update_subtrees``); then two AdamW
  steps: the decoder still bit-equal, and every moment under JAX's key
  (``flatten_opt_state``), the decoder's exactly (zeros, as JAX's moments
  see zero gradients), the others to ``MOMENT_REL_TOL`` of the leaf's
  largest entry (summation order, as above);
* the FLYP step with CoCaLoss (``coca_weights`` (2, 1)), four SGD steps, at
  the same bounds; and the v2 step on CLIPs with a two-layer RoBERTa and an
  mT5 tower (T5's learned relative-position bias trains);
* ``decay_mask``, the lock masks (``--lock-text``, ``--lock-*-unlocked-
  groups``) and the optimizer's checkpoint keys and shapes equal JAX's for
  CoCa, coca_roberta and an HF-tower CLIP;
* both mains on ``coca_tiny-test`` (``--method ours`` and ``--method
  flyp``) from one ``--pretrained`` file written by JAX, 2 epochs of batch
  32: the same per-step LR strings, losses within 1e-4 relative, final
  parameters and bank as tests/test_torch_cli.py holds them (the decoder
  bit-equal under ``ours``), equal eval results, ``text_decoder.*`` in the
  checkpoint; and each package resumes the other's ``epoch_1.pt``;
* JAX's refusals (``--gamma``, ``--siglip``, ``--text-packing`` with CoCa
  and with an HF tower) stop both mains with its messages.
"""
import dataclasses
import os

import jax
import numpy as np
import optax
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models import coca as jax_coca
from latteclip_tpu.train import main as jax_main
from latteclip_tpu.train import optim as jax_optim
from latteclip_tpu.train import state as jax_state
from latteclip_tpu.train import step as jax_step
from latteclip_torch import checkpoint as torch_ckpt
from latteclip_torch import config as torch_config
from latteclip_torch.models import clip as torch_clip
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
    _steps,
)
from test_torch_coca import COCA_ROBERTA, COCA_SMALL, perturbed
from test_torch_hf_text import raw_config

torch.set_num_threads(2)
LOSS_REL_TOL = 1e-5
PARAM_TOL = 2e-5
MOMENT_REL_TOL = 1e-3
# 1 - cos between the packages' per-tensor parameter deltas over the CLI
# runs: tests/test_torch_towers_train.py::TOWER_COS_GAP, for the same reason
# (AdamW's near-zero-gradient elements, a part of a few tensors)
COCA_COS_GAP = 1e-4
LR = 1e-4
COCA_CLI = ["--dataset-type", "synthetic", "--model", "coca_tiny-test", "--batch-size", "32",
            "--epochs", "2", "--warmup", "2", "--lr", str(LR), "--precision", "fp32",
            "--aug-cfg", "color_jitter_prob=0", "gray_scale_prob=0", "--workers", "2",
            "--no-save-most-recent"]


def shared(raw, name="t"):
    jcfg = dataclasses.replace(jax_config.config_from_dict(name, raw), compute_dtype="float32")
    tcfg = dataclasses.replace(torch_config.config_from_dict(name, raw), compute_dtype="float32")
    init = jax_coca.init_coca_params if "multimodal_cfg" in raw else jax_clip.init_clip_params
    params = perturbed(init(jax.random.PRNGKey(0), jcfg))
    model = torch_clip.build_model(tcfg)
    sd = jax_ckpt.params_to_pt_state_dict(params, jcfg)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return jcfg, params, tcfg, model


def rows(rng, n, ctx, vocab, pad):
    out = np.full((n, ctx), pad, np.int32)
    for i, ln in enumerate(rng.integers(2, ctx + 1, n)):
        out[i, :ln] = rng.integers(2, vocab, ln)
    return out


def inputs(tcfg, classes=5, batch=8, seed=0):
    """A template table, the bank (its normalized features) and two batches."""
    t = tcfg.text
    pad = getattr(t, "pad_id", 0) if type(t).__name__ == "HFTextConfig" else 0
    rng = np.random.default_rng(seed)
    table = rows(rng, classes, t.context_length, t.vocab_size, pad)
    size = tcfg.vision.image_size
    batches = [{"images": rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
                "per_image_tokens": rows(rng, batch, t.context_length, t.vocab_size, pad),
                "per_group_tokens": rows(rng, batch, t.context_length, t.vocab_size, pad),
                "zs_preds": rng.integers(0, classes, batch).astype(np.int32),
                "gt_labels": rng.integers(0, classes, batch).astype(np.int32)}
               for _ in range(2)]
    return table, batches


def bank_of(params, jcfg, table):
    return np.asarray(jax_clip.encode_text(params, jcfg, table, normalize=True))


def run_both(raw, make_jax, make_torch, jax_tx, torch_opt, steps=4):
    """(JAX state, port state, JAX losses, port losses, port model, start)."""
    jcfg, params, tcfg, model = shared(raw)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    table, batches = inputs(tcfg)
    bank = bank_of(params, jcfg, table)
    jstate = jax_state.create_train_state(params, jax_tx, bank)
    jfn = jax.jit(make_jax(jcfg, jax_tx, table))
    tstate = torch_state.create_train_state(model, torch_opt(model), torch.from_numpy(bank.copy()))
    tfn = make_torch(model, table)
    jl, tl = [], []
    for i in range(steps):
        jstate, jm = jfn(jstate, batches[i % 2], jax.random.PRNGKey(i))
        jl.append(float(jm["loss"]))
        tl.append(float(tfn(tstate, batches[i % 2])["loss"]))
    return jcfg, tcfg, jstate, tstate, jl, tl, start


def assert_params_agree(jstate, tstate, tcfg):
    ref = torch_ckpt.state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), tcfg)
    trained = tstate.model.state_dict()
    assert sorted(trained) == sorted(ref)
    for k, v in trained.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=PARAM_TOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(tstate.memory_bank.numpy(), np.asarray(jstate.memory_bank),
                               atol=PARAM_TOL, rtol=0)


HP = dict(augment=False, text_packing=False)
V2_CASES = {"coca": (COCA_SMALL, ("text_decoder",)), "hf_clip": (raw_config("roberta"), ()),
            "mt5_clip": (raw_config("mt5"), ())}


@pytest.mark.parametrize("case", list(V2_CASES))
def test_v2_step_matches_jax(case):
    raw, zero = V2_CASES[case]
    jcfg, tcfg, jstate, tstate, jl, tl, start = run_both(
        raw,
        lambda c, tx, table: jax_step.make_train_step(c, tx, jax_step.LatteHParams(**HP), table,
                                                      zero_update_subtrees=zero),
        lambda m, table: torch_step.make_train_step(m, torch_step.LatteHParams(**HP), table,
                                                    zero_update_subtrees=zero),
        optax.sgd(1e-2), lambda m: torch.optim.SGD(m.parameters(), lr=1e-2))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL_TOL, atol=0)
    assert_params_agree(jstate, tstate, tcfg)
    moved = [k for k, v in tstate.model.state_dict().items() if not torch.equal(v, start[k])]
    assert moved and all(not k.startswith("text_decoder.") for k in moved)
    if zero:
        ref = torch_ckpt.state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), tcfg)
        assert all(torch.equal(ref[k], start[k]) for k in start if k.startswith("text_decoder."))


def test_v2_adamw_keeps_the_decoder_and_its_moments_as_jax():
    sched = optax.constant_schedule(1e-3)
    jcfg, tcfg, jstate, tstate, jl, tl, start = run_both(
        COCA_SMALL,
        lambda c, tx, table: jax_step.make_train_step(c, tx, jax_step.LatteHParams(**HP), table,
                                                      zero_update_subtrees=("text_decoder",)),
        lambda m, table: torch_step.make_train_step(m, torch_step.LatteHParams(**HP), table,
                                                    zero_update_subtrees=("text_decoder",)),
        jax_optim.make_optimizer(sched),
        lambda m: torch_optim.make_optimizer(m, torch_optim.make_schedule("const", 1e-3, 0)),
        steps=2)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL_TOL, atol=0)
    decoder = [k for k in start if k.startswith("text_decoder.")]
    assert decoder and all(torch.equal(tstate.model.state_dict()[k], start[k]) for k in decoder)
    theirs = jax_ckpt.flatten_opt_state(jstate.opt_state)
    ours = torch_ckpt.optimizer_state(tstate.model, tstate.optimizer)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        mine = ours[k].numpy()
        assert mine.shape == np.shape(v), k
        if "['text_decoder']" in k:
            assert np.array_equal(mine, v) and not np.any(v), k
        else:
            np.testing.assert_allclose(mine, v, rtol=0,
                                       atol=MOMENT_REL_TOL * max(np.abs(v).max(), 1e-12), err_msg=k)


def test_flyp_coca_step_matches_jax():
    weights = (2.0, 1.0)
    jcfg, tcfg, jstate, tstate, jl, tl, start = run_both(
        COCA_SMALL,
        lambda c, tx, table: jax_step.make_flyp_step(c, tx, jax_step.LatteHParams(**HP), table,
                                                     coca_weights=weights),
        lambda m, table: torch_step.make_flyp_step(m, torch_step.LatteHParams(**HP), table,
                                                   coca_weights=weights),
        optax.sgd(1e-2), lambda m: torch.optim.SGD(m.parameters(), lr=1e-2))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL_TOL, atol=0)
    assert_params_agree(jstate, tstate, tcfg)
    assert not torch.equal(tstate.model.text_decoder.text_projection, start[
        "text_decoder.text_projection"])


MASK_CASES = {"coca": COCA_SMALL, "coca_roberta": COCA_ROBERTA, "hf_clip": raw_config("mt5")}


def _as_state_dict(tree, params, tcfg):
    """A JAX mask (a bool or an array a leaf) as the port's state dict."""
    return torch_ckpt.state_dict_from_jax_params(
        jax.tree.map(lambda m, p: np.broadcast_to(np.asarray(m, np.float32), np.shape(p)),
                     tree, params), tcfg)


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_decay_lock_masks_and_optimizer_keys_equal_jax(case):
    jcfg, params, tcfg, model = shared(MASK_CASES[case])
    ref = _as_state_dict(jax_optim.decay_mask(params), params, tcfg)
    assert torch_optim.decay_mask(model) == {k: bool(ref[k].all()) for k in ref}
    assert all(bool(ref[k].all()) == bool(ref[k].any()) for k in ref)
    ref = _as_state_dict(jax_optim.trainable_mask(params, lock_text=True), params, tcfg)
    assert torch_optim.trainable_mask(model, lock_text=True) == {k: bool(ref[k].all()) for k in ref}
    ones = jax.tree.map(np.ones_like, params)
    for tower in ("visual", "text"):
        for groups in (1, 2, 3):
            tx = jax_optim.mask_tower_updates(tower, groups)
            ref = _as_state_dict(tx.update(ones, tx.init(params), params)[0], params, tcfg)
            mask = torch_optim.mask_tower_updates(model, tower, groups)
            for name, keep in mask.items():
                assert torch.all(ref[name] == float(keep)), (tower, groups, name)
    tx = jax_optim.make_optimizer(optax.constant_schedule(1e-3), grad_clip_norm=1.0)
    theirs = jax_ckpt.flatten_opt_state(tx.init(params))
    opt = torch_optim.make_optimizer(model, torch_optim.make_schedule("const", 1e-3, 0),
                                     grad_clip_norm=1.0)
    ours = torch_ckpt.optimizer_state(model, opt)
    assert sorted(ours) == sorted(theirs)
    assert all(tuple(ours[k].shape) == np.shape(v) for k, v in theirs.items())


def _run_main(main, logs, *extra):
    import glob

    assert main([*COCA_CLI, "--logs", logs, *extra]) == 0
    (run_dir,) = glob.glob(os.path.join(logs, "*"))
    return run_dir


@pytest.fixture(scope="module")
def coca_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("coca_cli")
    cfg = jax_config.get_model_config("coca_tiny-test")
    pretrained = str(base / "coca.pt")
    jax_ckpt.save_clip_pt(pretrained, jax_coca.init_coca_params(jax.random.PRNGKey(0), cfg), cfg)
    start = torch.load(pretrained, map_location="cpu", weights_only=True)["state_dict"]
    out = {}
    for method in ("ours", "flyp"):
        argv = ["--pretrained", pretrained, "--method", method]
        runs = {"start": start}
        runs["jax"] = _run_main(jax_main.main, str(base / method / "jax"), *argv)
        runs["torch"] = _run_main(torch_main.main, str(base / method / "torch"), *argv,
                                  "--device", "cpu")
        runs["torch_from_jax"] = _run_main(
            torch_main.main, str(base / method / "torch_from_jax"), *argv, "--device", "cpu",
            "--resume", os.path.join(runs["jax"], "checkpoints", "epoch_1.pt"))
        runs["jax_from_torch"] = _run_main(
            jax_main.main, str(base / method / "jax_from_torch"), *argv, "--resume",
            os.path.join(runs["torch"], "checkpoints", "epoch_1.pt"))
        out[method] = runs
    return out


def _frozen(method):
    return (lambda k: k.startswith("text_decoder.")) if method == "ours" else (lambda k: False)


@pytest.mark.parametrize("method", ["ours", "flyp"])
def test_coca_cli_trains_like_jax(method, coca_runs):
    runs = coca_runs[method]
    _assert_logs_agree(runs["torch"], runs["jax"], expect_steps=STEPS)
    _assert_checkpoints_agree(runs["torch"], runs["jax"], runs["start"], frozen=_frozen(method),
                              cos_gap=COCA_COS_GAP)
    assert _results(runs["torch"]) == _results(runs["jax"])
    sd = _checkpoint(runs["torch"], 2)[0]
    assert any(k.startswith("text_decoder.cross_attn.") for k in sd)
    assert sorted(sd) == sorted(runs["start"])


@pytest.mark.parametrize("resumed,own", [("torch_from_jax", "jax"), ("jax_from_torch", "torch")])
@pytest.mark.parametrize("method", ["ours", "flyp"])
def test_coca_cross_package_resume(method, resumed, own, coca_runs):
    runs = coca_runs[method]
    epoch2 = [s for s in _steps(runs[own]) if s[0] == 1]
    got = _steps(runs[resumed])
    assert len(got) == len(epoch2) == 2
    for x, y in zip(got, epoch2):
        assert x[:3] == y[:3] and abs(x[4] - y[4]) <= 1e-4 * abs(y[4])
    _assert_checkpoints_agree(runs[resumed], runs[own], runs["start"], frozen=_frozen(method),
                              cos_gap=COCA_COS_GAP)


REFUSALS = {
    "gamma": ["--gamma", "0.5"],
    "siglip_flyp": ["--method", "flyp", "--siglip"],
    "text_packing": ["--text-packing", "128"],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_coca_refusals_equal_jax(case, tmp_path):
    messages = []
    for main, extra in ((jax_main.main, []), (torch_main.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main([*COCA_CLI, "--epochs", "1", "--logs", str(tmp_path / str(len(messages))),
                  *REFUSALS[case], *extra])
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "ROADMAP" not in messages[0]


def test_hf_text_packing_refused_as_jax(tmp_path, monkeypatch):
    """A tiny RoBERTa CLIP with a WordLevel tokenizer written to tmp_path,
    registered in both mains: ``--text-packing`` stops both with JAX's
    message."""
    pytest.importorskip("tokenizers")
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["a", "photo", "of", "the", "."]
    vocab = {w: i for i, w in enumerate(["<s>", "<pad>", "</s>", "<unk>", *words])}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tk, bos_token="<s>", eos_token="</s>",
                            pad_token="<pad>", unk_token="<unk>").save_pretrained(str(tmp_path / "tok"))
    raw = raw_config("roberta", ctx=16)
    raw["text_cfg"]["hf_tokenizer_name"] = str(tmp_path / "tok")
    raw["vision_cfg"] = {"image_size": 32, "layers": 1, "width": 64, "patch_size": 16}
    for main, config_mod in ((jax_main, jax_config), (torch_main, torch_config)):
        real = config_mod.get_model_config
        monkeypatch.setattr(main, "get_model_config", lambda name, real=real, c=config_mod:
                            c.config_from_dict(name, raw) if name == "tiny-hf" else real(name))
    messages = []
    argv = [*COCA_CLI, "--model", "tiny-hf", "--epochs", "1", "--text-packing", "128"]
    for main, extra in ((jax_main.main, []), (torch_main.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main([*argv, "--logs", str(tmp_path / str(len(messages))), *extra])
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "--text-packing supports" in messages[0]
