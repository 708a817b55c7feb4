"""``python -m latteclip_torch.train.main`` against ``latteclip_tpu.train.main``
with the other trainers of the JAX CLI, on the fixture and flags of
tests/test_torch_cli.py (ViT-tiny-test, fp32, the colour augment off, 2
epochs of 2 steps of batch 32, from one ``--pretrained`` file written by
JAX's ``save_clip_pt``): ``--method flyp`` and ``--gamma 0.5`` with
``--text-packing 128`` (which must pack no captions: the pipeline of both
packages gets a packing length of 0), ``--method flyp_gt``, ``--method flyp
--siglip`` and ``--method flyp`` with a teacher (``--distill-model`` a tiny
config in float32, registered in both packages, since the registry's
configs compute in bf16, where the two packages round at different points;
``--distill-pretrained`` another seed written by JAX's writer). Each run's
losses agree within 1e-4 relative, the final parameters within 2 * lr *
steps and the eval results are equal, the bounds of tests/test_torch_cli.py
and for its reasons; each tensor's change from the start points the same
way within ``FLYP_COS_GAP`` (derived there).

A ``--siglip`` run resumed from the plain ``--method flyp`` run's
``epoch_1.pt`` runs in both packages alike: each injects ``logit_bias`` at
-10 again, logs that its moments stay fresh, and writes it to
``epoch_2.pt``. ``--report-to tensorboard --profile --remote-sync`` write
event files with the same scalars, a trace each and a synced copy.
"""
import dataclasses
import glob
import os

import jax
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.train import main as jax_main
from latteclip_torch import config as torch_config
from latteclip_torch.train import main as torch_main
from test_torch_cli import (
    _assert_checkpoints_agree,
    _assert_logs_agree,
    _checkpoint,
    _results,
    _run,
)

TEACHER = "tiny-teacher-fp32"
# 1 - cos between the packages' per-tensor parameter deltas. The key third of
# each attention in_proj_bias has a gradient of exactly 0 (softmax ignores a
# shift shared by a query's logits), so each package's f32 gradient there is
# summation noise g, and AdamW turns it into an update of about lr * g / eps
# per step (|g| << eps = 1e-6): up to delta ~ 2e-6 over 4 steps, with a sign
# of its own in each package, against about a ~ 2e-4 on the trained
# elements. With a third of the elements noise, 1 - cos <= (delta / a)^2 =
# 1e-4. Under FLYP the text gradients are smaller than under the v2 loss
# (whose gap tests/test_torch_cli.py observed at 8.5e-8), so the noise shows:
# observed 1.0e-6 (text in_proj_bias of block 0). A flipped update of one
# trained element of 192 gives about 1e-2.
FLYP_COS_GAP = 1e-4
CASES = {
    "flyp": ["--method", "flyp", "--text-packing", "128"],
    "gamma": ["--gamma", "0.5", "--text-packing", "128"],
    "flyp_gt": ["--method", "flyp_gt"],
    "siglip": ["--method", "flyp", "--siglip"],
    "teacher": ["--method", "flyp", "--distill-model", TEACHER],
}


def _register_teacher_config(monkeypatch):
    for config_mod, main in ((jax_config, None), (torch_config, torch_main)):
        real = config_mod.get_model_config

        def lookup(name, real=real):
            cfg = real("ViT-tiny-test" if name == TEACHER else name)
            return dataclasses.replace(cfg, compute_dtype="float32") if name == TEACHER else cfg
        monkeypatch.setattr(main or config_mod, "get_model_config", lookup)


def _capture_packing(monkeypatch):
    """The packing length each package's pipeline is built with."""
    seen = []
    for main in (jax_main, torch_main):
        real = main.TrainPipeline

        def build(data, cfg, *a, real=real, **k):
            seen.append(cfg.text_packing_len)
            return real(data, cfg, *a, **k)
        monkeypatch.setattr(main, "TrainPipeline", build)
    return seen


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    base = tmp_path_factory.mktemp("trainers")
    cfg = jax_config.get_model_config("ViT-tiny-test")
    out = {"base": base}
    for name, seed in (("pretrained", 0), ("teacher", 7)):
        out[name] = str(base / f"{name}.pt")
        jax_ckpt.save_clip_pt(out[name], jax_clip.init_clip_params(jax.random.PRNGKey(seed), cfg),
                              cfg)
    out["start"] = torch.load(out["pretrained"], map_location="cpu",
                              weights_only=True)["state_dict"]
    return out


def _both(files, tmp_path, *extra):
    argv = ["--pretrained", files["pretrained"], "--name", "run", *extra]
    jax_dir = _run(jax_main.main, str(tmp_path / "jax"), *argv)
    torch_dir = _run(torch_main.main, str(tmp_path / "torch"), *argv, "--device", "cpu")
    return jax_dir, torch_dir


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_cli_matches_jax(case, files, tmp_path, monkeypatch):
    extra = list(CASES[case])
    if case == "teacher":
        _register_teacher_config(monkeypatch)
        extra += ["--distill-pretrained", files["teacher"]]
    packing = _capture_packing(monkeypatch)
    jax_dir, torch_dir = _both(files, tmp_path, *extra)
    _assert_logs_agree(torch_dir, jax_dir, expect_steps=4)
    start = dict(files["start"])
    if case == "siglip":
        start["logit_bias"] = torch.tensor(-10.0)
    # v1 trains the image tower and the logit scale only
    frozen = ((lambda k: not k.startswith("visual.") and k != "logit_scale") if case == "gamma"
              else (lambda k: False))
    _assert_checkpoints_agree(torch_dir, jax_dir, start, frozen=frozen, cos_gap=FLYP_COS_GAP)
    assert _results(torch_dir) == _results(jax_dir)
    assert packing == [0, 0]
    sd = _checkpoint(torch_dir, 2)[0]
    assert ("logit_bias" in sd) == (case == "siglip")


def test_siglip_resume_from_a_plain_checkpoint(files, tmp_path):
    plain = _both(files, tmp_path / "plain", "--method", "flyp", "--epochs", "1")
    runs = {}
    for pkg, main, extra in (("jax", jax_main.main, []),
                             ("torch", torch_main.main, ["--device", "cpu"])):
        ckpt = os.path.join(plain[0 if pkg == "jax" else 1], "checkpoints", "epoch_1.pt")
        assert "logit_bias" not in _checkpoint(os.path.dirname(os.path.dirname(ckpt)), 1)[0]
        runs[pkg] = _run(main, str(tmp_path / pkg), "--pretrained", files["pretrained"],
                         "--name", "run", "--method", "flyp", "--siglip", "--resume", ckpt,
                         *extra)
        with open(os.path.join(runs[pkg], "out.log")) as f:
            assert "keeping fresh moments" in f.read(), pkg
    _assert_logs_agree(runs["torch"], runs["jax"], expect_steps=2)
    ours, theirs = _checkpoint(runs["torch"], 2), _checkpoint(runs["jax"], 2)
    assert sorted(ours[0]) == sorted(theirs[0]) and "logit_bias" in ours[0]
    assert float(ours[0]["logit_bias"]) == pytest.approx(float(theirs[0]["logit_bias"]), abs=1e-6)
    assert sorted(ours[2]["optimizer"]) == sorted(theirs[2]["optimizer"])
    assert _results(runs["torch"]) == _results(runs["jax"])


def _scalars(run_dir):
    from latteclip_torch.obs import tensorboard as tb

    (path,) = glob.glob(os.path.join(run_dir, "tensorboard", "events.out.tfevents.*"))
    return [tb.decode_scalar_event(r) for r in tb.read_records(path)[1:]]


def test_report_profile_and_remote_sync_match_jax(files, tmp_path):
    """``--report-to tensorboard --profile --remote-sync`` in both mains: the
    event files hold the same (tag, step) pairs, the losses within the
    file's bound and the eval's top-1 equal; each package writes its trace
    (the port a Chrome trace of steps 1-2, JAX an XPlane) and mirrors the
    run, checkpoint included, into the sync directory."""
    remote = str(tmp_path / "remote")
    jax_dir, torch_dir = _both(files, tmp_path, "--method", "flyp", "--epochs", "1",
                               "--report-to", "tensorboard", "--profile",
                               "--profile-start-step", "1", "--profile-num-steps", "1",
                               "--remote-sync", remote)
    ours, theirs = _scalars(torch_dir), _scalars(jax_dir)
    assert [(e["tag"], e["step"]) for e in ours] == [(e["tag"], e["step"]) for e in theirs]
    for a, b in zip(ours, theirs):
        if a["tag"] in ("train/loss", "train/contrastive_loss", "val/top1"):
            assert a["simple_value"] == pytest.approx(b["simple_value"], rel=1e-4), a["tag"]
    assert os.listdir(os.path.join(torch_dir, "trace")) == ["steps_1-2.pt.trace.json"]
    assert glob.glob(os.path.join(jax_dir, "trace", "**", "*.xplane.pb"), recursive=True)
    # both runs are named "run", so both packages mirror into one directory
    synced = os.path.join(remote, "run")
    assert os.path.exists(os.path.join(synced, "checkpoints", "epoch_1.pt"))
    assert "steps_1-2.pt.trace.json" in os.listdir(os.path.join(synced, "trace"))
