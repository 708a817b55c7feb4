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
  update is about lr per element, and noise can flip its sign); the bank
  rows at cosine >= 0.9999; the ``results.jsonl`` eval metrics equal;
* cross-resume: each package resumes the other's ``epoch_1.pt`` (weights,
  bank, step, AdamW moments, schedule count) for epoch 2, and its
  ``epoch_2.pt`` agrees with the other package's own within the same bounds;
* the eval-only mode (no train data, ``--resume`` a checkpoint) writes the
  same ``results.jsonl`` record in both;
* every flag whose feature is not ported is refused with a ``SystemExit``
  naming the ROADMAP item, and the default ``--device cuda`` raises where
  CUDA is absent.
"""
import glob
import json
import os
import re

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


def _assert_checkpoints_agree(a_dir, b_dir, epoch=2):
    a, a_bank, a_obj = _checkpoint(a_dir, epoch)
    b, b_bank, b_obj = _checkpoint(b_dir, epoch)
    assert sorted(a) == sorted(b) and sorted(a_bank) == sorted(b_bank)
    assert a_obj["epoch"] == b_obj["epoch"] == epoch and a_obj["step"] == b_obj["step"] == STEPS
    assert sorted(a_obj["optimizer"]) == sorted(b_obj["optimizer"])
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=2 * LR * STEPS,
                                   err_msg=k)
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
    out = {"base": base, "pretrained": pretrained}
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
    _assert_checkpoints_agree(runs["torch"], runs["jax"])
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
    _assert_checkpoints_agree(runs[resumed], runs[own])


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
    "method": ["--method", "flyp"], "gamma": ["--gamma", "0.5"], "tta": ["--tta"],
    "extract_features": ["--extract-features-path", "x"],
    "group_weights": ["--extract-group-weight-path", "x"], "siglip": ["--siglip"],
    "distill": ["--distill-model", "ViT-B-32", "--distill-pretrained", "x"],
    "imagenet_val": ["--imagenet-val", "x"], "val_data": ["--val-data", "x"],
    "report_to": ["--report-to", "tensorboard"], "remote_sync": ["--remote-sync", "x"],
    "profile": ["--profile"], "model_parallelism": ["--model-parallelism", "2"],
    "native_jpeg": ["--use-native-jpeg"], "coca": ["--model", "coca_ViT-B-32"],
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_unported_flags_are_refused(case, tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP.md, section 1, item [56]"):
        torch_main.main([*COMMON, "--logs", str(tmp_path), "--device", "cpu", *REFUSED[case]])


def test_default_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main.main([*COMMON, "--logs", str(tmp_path)])
