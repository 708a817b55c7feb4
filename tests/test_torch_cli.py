"""``python -m latteclip_torch.train.main`` against ``latteclip_tpu.train.main``.

* ``parse_args``: the port's parser has the JAX parser's ``dest``s and
  defaults, and parses each group of flags to the same values (one case per
  group); ``--device`` is the port's own;
* both mains on the synthetic fixture (written by each package's own
  ``synthetic.py``, byte-identical, tests/test_torch_pipeline.py) at
  ViT-tiny-test, ``--precision fp32``, from one ``--pretrained`` file written
  by ``latteclip_tpu.core.checkpoint.save_clip_pt``, the colour augment off
  (p = 0; the crop runs on the device in both), 2 epochs of batch 32: the
  per-step ``LR:`` strings are equal; the losses agree within 1e-4 relative
  (the packages differ in float32 summation order, 4.8e-7 on losses in
  tests/test_torch_train_step.py, and in the crop's rounding,
  tests/test_torch_crop.py); the final parameters within 2 * lr * steps
  absolute, the bound tests/test_torch_train_step.py argues for AdamW (each
  update is about lr per element, and noise can flip its sign); each
  tensor's change from the shared start in the same direction, cosine >=
  1 - 1e-6 (``DELTA_COS_GAP``, derived there); the bank rows at cosine >=
  0.9999; the ``results.jsonl`` eval metrics equal;
* cross-resume: each package resumes the other's ``epoch_1.pt`` (weights,
  bank, step, AdamW moments, schedule count) for epoch 2, and its
  ``epoch_2.pt`` agrees with the other package's own within the same bounds;
* the eval-only mode (no train data, ``--resume`` a checkpoint) writes the
  same ``results.jsonl`` record in both;
* ``--eval-config-path`` resolves the eval split from a YAML task registry
  in both mains to the same eval record, and without PyYAML the port
  refuses it with a ``SystemExit`` that names the package;
* every flag whose feature is not ported is refused with a ``SystemExit``
  naming the ROADMAP item, as is the JAX switch ``LATTECLIP_TEXT_XLA_ATTN=1``,
  and the default ``--device cuda`` raises where CUDA is absent.
"""
import glob
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.data import synthetic as jax_synthetic
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.train import main as jax_main
from latteclip_tpu.train import params as jax_params
from latteclip_torch.train import main as torch_main
from latteclip_torch.train import params as torch_params

torch.set_num_threads(2)
LR, STEPS = 1e-4, 4
# 1 - cos between the packages' per-tensor parameter deltas. Both run the
# same float32 AdamW; the float32 rounding of the stored weights alone moves
# a 4-update delta element (~4e-4) by at most 2^-24 * |p| <= 1.2e-7 (|p| <= 2),
# which costs 1 - cos <= (3e-4)^2 / 2 = 5e-8 at worst; the gradients' summation
# order (1e-6 relative, tests/test_torch_train_step.py) leaves Adam's
# normalised step alone except where a gradient element lies within that
# noise of 0. Observed: at most 8.5e-8 (visual in_proj_bias, 192 elements).
# A wrong update rule moves whole tensors: a flipped step in one element of a
# 192-element tensor already gives ~1e-2.
DELTA_COS_GAP = 1e-6
COMMON = ["--dataset-type", "synthetic", "--model", "ViT-tiny-test", "--batch-size", "32",
          "--epochs", "2", "--warmup", "2", "--lr", str(LR), "--precision", "fp32",
          "--aug-cfg", "color_jitter_prob=0", "gray_scale_prob=0", "--workers", "2"]

_STEP_RE = re.compile(r"Train Epoch: (\d+) \[\s*(\d+)/\d+\].*?(LR: [0-9.]+).*?"
                      r"Logit Scale: ([0-9.]+) Loss: ([0-9.e+-]+)")

FLAG_GROUPS = {
    "defaults": [],
    "data": ["--train-data", "a/{00000..00003}.tar", "--train-num-samples", "100",
             "--clip-prediction-path", "p.pkl", "--generated-captions-path", "c1",
             "--generated-captions-path", "c2", "--zeroshot-eval-data", "dtd",
             "--eval-preprocess-path", "e", "--workers", "3", "--dataset-resampled"],
    "model": ["--model", "ViT-B-16", "--precision", "fp32", "--grad-checkpointing",
              "--grad-checkpointing-text", "false", "--fuse-text-forward", "1",
              "--force-quick-gelu", "--pretrained", "w.pt"],
    "optim": ["--lr", "3e-4", "--beta1", "0.8", "--beta2", "0.9", "--eps", "1e-8", "--wd", "0.1",
              "--warmup", "7", "--lr-scheduler", "const-cooldown", "--epochs-cooldown", "2",
              "--grad-clip-norm", "1.5", "--accum-freq", "4", "--skip-scheduler"],
    "locking": ["--lock-image", "--lock-image-unlocked-groups", "2", "--lock-text",
                "--lock-text-unlocked-layers", "3"],
    "pipeline": ["--host-resize", "--raw-cache-mb", "0", "--aug-cfg", "scale=(0.5,1.0)",
                 "color_jitter_prob=0.5", "--text-packing", "128", "--text-packing-rows", "40",
                 "--text-context-cap", "auto", "--train-with-gt-text"],
    "objective": ["--alpha", "0.2", "--use-template-caption", "0", "--use-image-caption", "0.5",
                  "--use-zeroshot-pseudolabel", "0", "--fusion-bug-compat", "--method", "ours"],
    "bookkeeping": ["--logs", "L", "--name", "n", "--seed", "3", "--resume", "latest",
                    "--zeroshot-frequency", "2", "--save-frequency", "3",
                    "--delete-previous-checkpoint", "--log-every-n-steps", "1",
                    "--eval-batch-size", "7", "--no-save-most-recent"],
    "compat": ["--torchcompile", "--dist-url", "x", "--local-loss", "--gather-with-grad",
               "--subsample-ratio", "0.5", "--n-images", "2", "--val-frequency", "3"],
}


@pytest.mark.parametrize("group", list(FLAG_GROUPS))
def test_parse_args_matches_jax(group):
    ours = vars(torch_params.parse_args(FLAG_GROUPS[group]))
    theirs = vars(jax_params.parse_args(FLAG_GROUPS[group]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs


def _run(main, logs, *extra):
    assert main([*COMMON, "--logs", logs, *extra]) == 0
    (run_dir,) = glob.glob(os.path.join(logs, "*"))
    return run_dir


def _steps(run_dir):
    out = []
    with open(os.path.join(run_dir, "out.log")) as f:
        for line in f:
            m = _STEP_RE.search(line)
            if m:
                out.append((int(m.group(1)), int(m.group(2)), m.group(3), float(m.group(4)),
                            float(m.group(5))))
    return out


def _results(run_dir):
    with open(os.path.join(run_dir, "checkpoints", "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def _checkpoint(run_dir, epoch):
    obj = torch.load(os.path.join(run_dir, "checkpoints", f"epoch_{epoch}.pt"),
                     map_location="cpu", weights_only=True)
    sd = obj["state_dict"]
    bank = {k: v for k, v in sd.items() if k.startswith("memory_bank.")}
    return {k: v for k, v in sd.items() if k not in bank}, bank, obj


def _assert_checkpoints_agree(a_dir, b_dir, start, epoch=2):
    a, a_bank, a_obj = _checkpoint(a_dir, epoch)
    b, b_bank, b_obj = _checkpoint(b_dir, epoch)
    assert sorted(a) == sorted(b) and sorted(a_bank) == sorted(b_bank)
    assert a_obj["epoch"] == b_obj["epoch"] == epoch and a_obj["step"] == b_obj["step"] == STEPS
    assert sorted(a_obj["optimizer"]) == sorted(b_obj["optimizer"])
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=2 * LR * STEPS,
                                   err_msg=k)
        da = (a[k].double() - start[k].double()).flatten()
        db = (b[k].double() - start[k].double()).flatten()
        assert da.norm() > 0 and db.norm() > 0, k
        assert 1 - float(da @ db / (da.norm() * db.norm())) <= DELTA_COS_GAP, k
    for k in a_bank:
        cos = float(torch.nn.functional.cosine_similarity(a_bank[k], b_bank[k], dim=0))
        assert cos >= 0.9999, k


def _assert_logs_agree(a_dir, b_dir, expect_steps):
    a, b = _steps(a_dir), _steps(b_dir)
    assert len(a) == len(b) == expect_steps
    for x, y in zip(a, b):
        assert x[:3] == y[:3]
        assert abs(x[4] - y[4]) <= 1e-4 * abs(y[4])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    cfg = jax_config.get_model_config("ViT-tiny-test")
    pretrained = str(base / "pretrained.pt")
    jax_ckpt.save_clip_pt(pretrained, jax_clip.init_clip_params(jax.random.PRNGKey(0), cfg), cfg)
    pre = ["--pretrained", pretrained]
    out = {"base": base, "pretrained": pretrained,
           "start": torch.load(pretrained, map_location="cpu", weights_only=True)["state_dict"]}
    out["jax"] = _run(jax_main.main, str(base / "jax"), *pre)
    out["torch"] = _run(torch_main.main, str(base / "torch"), *pre, "--device", "cpu")
    out["torch_from_jax"] = _run(
        torch_main.main, str(base / "torch_from_jax"), *pre, "--device", "cpu", "--resume",
        os.path.join(out["jax"], "checkpoints", "epoch_1.pt"))
    out["jax_from_torch"] = _run(
        jax_main.main, str(base / "jax_from_torch"), *pre, "--resume",
        os.path.join(out["torch"], "checkpoints", "epoch_1.pt"))
    return out


def test_cli_trains_like_jax(runs):
    _assert_logs_agree(runs["torch"], runs["jax"], expect_steps=4)
    _assert_checkpoints_agree(runs["torch"], runs["jax"], runs["start"])
    assert _results(runs["torch"]) == _results(runs["jax"])
    assert os.path.exists(os.path.join(runs["torch"], "params.txt"))
    for name in ("epoch_1.pt", "epoch_2.pt", "epoch_latest.pt"):
        assert os.path.exists(os.path.join(runs["torch"], "checkpoints", name))


@pytest.mark.parametrize("resumed,own", [("torch_from_jax", "jax"), ("jax_from_torch", "torch")])
def test_cross_package_resume(runs, resumed, own):
    """The resumed run logs epoch 2 only, as the other package's own run did."""
    assert _steps(runs[resumed]) == [s for s in _steps(runs[resumed]) if s[0] == 1]
    epoch2 = [s for s in _steps(runs[own]) if s[0] == 1]
    got = _steps(runs[resumed])
    assert len(got) == len(epoch2) == 2
    for x, y in zip(got, epoch2):
        assert x[:3] == y[:3] and abs(x[4] - y[4]) <= 1e-4 * abs(y[4])
    _assert_checkpoints_agree(runs[resumed], runs[own], runs["start"])


def test_eval_only_equals_jax(runs, tmp_path):
    root = str(tmp_path / "fixture")
    jax_synthetic.make_full_fixture(root, num_train=8, num_val=20, image_size=64)
    ckpt = os.path.join(runs["jax"], "checkpoints", "epoch_2.pt")
    argv = ["--model", "ViT-tiny-test", "--precision", "fp32", "--zeroshot-eval-data", "dtd",
            "--eval-preprocess-path", root, "--resume", ckpt, "--eval-batch-size", "8",
            "--name", "eval"]
    assert jax_main.main(argv + ["--logs", str(tmp_path / "jax")]) == 0
    assert torch_main.main(argv + ["--logs", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    ours, theirs = _results(str(tmp_path / "torch" / "eval")), _results(str(tmp_path / "jax" / "eval"))
    assert ours == theirs and ours[0]["epoch"] == 2 and ours[0]["n"] == 20


REFUSED = {
    "method": ["--method", "flyp"], "gamma": ["--gamma", "0.5"], "siglip": ["--siglip"],
    "distill": ["--distill-model", "ViT-B-32", "--distill-pretrained", "x"],
    "report_to": ["--report-to", "tensorboard"], "remote_sync": ["--remote-sync", "x"],
    "profile": ["--profile"], "model_parallelism": ["--model-parallelism", "2"],
    "native_jpeg": ["--use-native-jpeg"], "coca": ["--model", "coca_ViT-B-32"],
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_unported_flags_are_refused(case, tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP.md, section 1, item [56]"):
        torch_main.main([*COMMON, "--logs", str(tmp_path), "--device", "cpu", *REFUSED[case]])


def test_text_xla_attention_switch_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("LATTECLIP_TEXT_XLA_ATTN", "1")
    with pytest.raises(SystemExit, match="LATTECLIP_TEXT_XLA_ATTN.*ROADMAP.md, section 1, item 6"):
        torch_main.main([*COMMON, "--logs", str(tmp_path), "--device", "cpu"])


def _eval_config(tmp_path, root):
    path = tmp_path / "eval.yaml"
    path.write_text("tasks:\n  dtd_val_zeroshot_classification:\n"
                    "    dataset_loading_kwargs: {dataset_name: dtd_zero_shot}\n"
                    "    dataset_specific_kwargs: {preprocess_path: $EVAL_ROOT, train: false}\n")
    return str(path)


def test_eval_config_path_equals_jax(runs, tmp_path, monkeypatch):
    root = str(tmp_path / "fixture")
    jax_synthetic.make_full_fixture(root, num_train=8, num_val=12, image_size=64)
    monkeypatch.setenv("EVAL_ROOT", root)
    argv = ["--model", "ViT-tiny-test", "--precision", "fp32", "--zeroshot-eval-data", "dtd",
            "--eval-config-path", _eval_config(tmp_path, root), "--pretrained",
            runs["pretrained"], "--eval-batch-size", "8", "--name", "eval"]
    assert jax_main.main(argv + ["--logs", str(tmp_path / "jax")]) == 0
    assert torch_main.main(argv + ["--logs", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    ours = _results(str(tmp_path / "torch" / "eval"))
    assert ours == _results(str(tmp_path / "jax" / "eval")) and ours[0]["n"] == 12


def test_eval_config_tasks_match_jax(tmp_path, monkeypatch):
    from latteclip_tpu.data import eval_config as jax_eval_config
    from latteclip_torch.data import eval_config

    root = str(tmp_path / "fixture")
    jax_synthetic.make_flat_dataset(root, num_train=3, num_val=5, image_size=32)
    monkeypatch.setenv("EVAL_ROOT", root)
    path = _eval_config(tmp_path, root)
    assert eval_config.load_eval_config(path) == jax_eval_config.load_eval_config(path)
    ours = eval_config.get_zero_shot_classification_data(path, "dtd_val_zeroshot_classification",
                                                         image_size=32)
    theirs = jax_eval_config.get_zero_shot_classification_data(
        path, "dtd_val_zeroshot_classification", image_size=32)
    assert ours.preprocess_path == theirs.preprocess_path == root
    assert (ours.image_ids, ours.class_names, ours.dataset_name) == \
        (theirs.image_ids, theirs.class_names, theirs.dataset_name) and len(ours) == 5
    assert [t("x") for t in ours.templates] == [t("x") for t in theirs.templates]
    assert eval_config.expand_env("${EVAL_ROOT}/a/$NOT_SET") == f"{root}/a/$NOT_SET"
    with pytest.raises(KeyError, match="not in"):
        eval_config.get_zero_shot_classification_data(path, "missing")


def test_eval_config_path_needs_pyyaml(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)   # import yaml raises ImportError
    argv = ["--model", "ViT-tiny-test", "--zeroshot-eval-data", "dtd", "--eval-config-path",
            _eval_config(tmp_path, str(tmp_path)), "--logs", str(tmp_path), "--device", "cpu"]
    with pytest.raises(SystemExit, match="PyYAML"):
        torch_main.main(argv)


def test_default_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main.main([*COMMON, "--logs", str(tmp_path)])


# a tiny SigLIP-like model (no class token, MAP head, tanh GELU, logit bias,
# non-causal text pooled at the last column) at the CLIP vocabulary
TINY_SIGLIP = {
    "embed_dim": 64, "gelu_tanh": True, "init_logit_bias": -10.0, "resize_mode": "shortest",
    "vision_cfg": {"image_size": 64, "patch_size": 16, "width": 64, "layers": 2,
                   "pool_type": "map", "no_cls_token": True, "no_ln_pre": True, "ln_eps": 1e-6},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64, "heads": 4, "layers": 2,
                 "pool_type": "last", "no_causal_mask": True, "ln_eps": 1e-6},
}


def _register_tiny_siglip(monkeypatch):
    from latteclip_torch import config as torch_config

    for main, config_mod in ((jax_main, jax_config), (torch_main, torch_config)):
        real = main.get_model_config
        monkeypatch.setattr(main, "get_model_config", lambda name, real=real, c=config_mod: (
            c.config_from_dict(name, TINY_SIGLIP) if name == "tiny-siglip" else real(name)))


@pytest.mark.parametrize("case", ["force_image_size", "siglip_squash"])
def test_vit_family_flags_train_like_jax(case, tmp_path, monkeypatch):
    """``--model ViT-S-32 --force-image-size 256`` (both packages resize the
    224-px checkpoint's positional embedding to the 8 x 8 grid on loading)
    and a tiny SigLIP-like model with ``--image-resize-mode squash``: one
    epoch of two steps of batch 8 from one JAX checkpoint, the losses within
    the file's bound."""
    if case == "force_image_size":
        model, extra = "ViT-S-32", ["--force-image-size", "256"]
    else:
        _register_tiny_siglip(monkeypatch)
        model, extra = "tiny-siglip", ["--image-resize-mode", "squash"]
    cfg = jax_main.get_model_config(model)
    pretrained = str(tmp_path / "pretrained.pt")
    jax_ckpt.save_clip_pt(pretrained, jax_clip.init_clip_params(jax.random.PRNGKey(0), cfg), cfg)
    argv = ["--model", model, "--batch-size", "8", "--epochs", "1", "--pretrained", pretrained,
            "--name", "run", *extra]
    jax_dir = _run(jax_main.main, str(tmp_path / "jax"), *argv)
    torch_dir = _run(torch_main.main, str(tmp_path / "torch"), *argv, "--device", "cpu")
    _assert_logs_agree(torch_dir, jax_dir, expect_steps=2)
    sd = _checkpoint(torch_dir, 1)[0]
    grid = (256 // 32) ** 2 + 1 if case == "force_image_size" else (64 // 16) ** 2
    assert tuple(sd["visual.positional_embedding"].shape) == (grid, cfg.vision.width)
    with open(os.path.join(torch_dir, "params.txt")) as f:
        assert ("image_resize_mode: squash" in f.read()) == (case == "siglip_squash")


def test_pretrained_tag_resolves_in_the_cache(runs, tmp_path, monkeypatch):
    """``--pretrained <tag>`` resolves to the registry's file name in
    ``$LATTECLIP_CACHE_DIR`` in both mains (a registry entry for ViT-tiny-test
    added to both packages' tables), takes the tag's QuickGELU, and trains
    alike; an unknown tag and a tag whose file is absent raise JAX's
    messages."""
    import shutil

    from latteclip_tpu.core import pretrained as jax_pretrained
    from latteclip_torch import pretrained as torch_pretrained

    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("LATTECLIP_CACHE_DIR", str(cache))
    for registry in (jax_pretrained, torch_pretrained):
        monkeypatch.setitem(registry.PRETRAINED, "ViT-tiny-test",
                            {"toy": registry._pcfg("weights/toy-tiny.pt", quick_gelu=True)})
    argv = ["--pretrained", "toy", "--epochs", "1", "--name", "tag"]
    errors = []
    for main, extra in ((jax_main.main, []), (torch_main.main, ["--device", "cpu"])):
        for tag in ("toy", "laion2b"):  # file absent; tag unknown
            with pytest.raises((FileNotFoundError, ValueError)) as e:
                main([*COMMON, "--logs", str(tmp_path / "none"), *argv, "--pretrained", tag, *extra])
            errors.append((type(e.value), str(e.value)))
    assert errors[:2] == errors[2:]
    shutil.copy(runs["pretrained"], cache / "toy-tiny.pt")
    jax_dir = _run(jax_main.main, str(tmp_path / "jax"), *argv)
    torch_dir = _run(torch_main.main, str(tmp_path / "torch"), *argv, "--device", "cpu")
    _assert_logs_agree(torch_dir, jax_dir, expect_steps=2)
    with open(os.path.join(torch_dir, "out.log")) as f:
        assert "pretrained tag implies QuickGELU" in f.read()
