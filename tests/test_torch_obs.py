"""The port's observability modules against latteclip_tpu's:

* ``obs/tensorboard.py``: the CRC32C known vectors; the framed event bytes
  equal JAX's for the same ``(tag, value, step, wall_time)``, and so do the
  writers' whole files at a fixed clock; each package reads the other's
  event file; ``make_writers`` dispatch; the W&B writer through a stub
  module, as tests/test_tensorboard.py drives JAX's;
* ``obs/file_sync.py``: ``sync_dir`` and ``RemoteSync`` on a local
  destination, ``pt_load_path``, as tests/test_file_sync.py tests JAX's;
* ``obs/profiler.py``: ``StepTraceProfiler`` writes a Chrome trace that
  holds the steps of its window and no other, and ``close`` finishes a
  trace the run left open; ``profile_model``'s parameter counts equal
  JAX's, and its FLOPs are held to JAX's at ``FLOP_RATIO_MAX``.
"""
import json
import os
import sys
import time
import types

import pytest
import torch

from latteclip_tpu.obs import file_sync as jax_file_sync
from latteclip_tpu.obs import profiler as jax_profiler
from latteclip_tpu.obs import tensorboard as jax_tb
from latteclip_torch.obs import file_sync, profiler, tensorboard as tb

EVENTS = [("train/loss", 1.5, 10, 1.7e9 + 0.25), ("val/top1", 0.125, 2, 1.7e9 + 7.5),
          ("train/distill_loss", -3.25e-4, 2**40, 1.8e9)]


def test_crc32c_known_vectors():
    # RFC 3720 appendix test vectors for CRC32C (Castagnoli)
    assert tb.crc32c(b"") == 0x0
    assert tb.crc32c(b"123456789") == 0xE3069283
    assert tb.crc32c(bytes(32)) == 0x8A9136AA
    c = tb.crc32c(b"123456789")
    assert tb.masked_crc32c(b"123456789") == (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


@pytest.mark.parametrize("event", EVENTS)
def test_event_bytes_equal_jax(event):
    ours = tb.frame_record(tb.encode_scalar_event(*event))
    assert ours == jax_tb.frame_record(jax_tb.encode_scalar_event(*event))
    assert tb.encode_file_version_event(event[3]) == jax_tb.encode_file_version_event(event[3])


def _write(mod, log_dir):
    w = mod.SummaryWriter(log_dir)
    for tag, value, step, _ in EVENTS:
        w.add_scalar(tag, value, step)
    w.close()
    return w.path


def test_writers_write_the_same_file_and_read_each_other(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.75e9)
    paths = {name: _write(mod, str(tmp_path / name))
             for name, mod in (("torch", tb), ("jax", jax_tb))}
    with open(paths["torch"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()
    for reader, path in ((tb, paths["jax"]), (jax_tb, paths["torch"])):
        records = reader.read_records(path)
        assert reader.decode_scalar_event(records[0])["file_version"] == "brain.Event:2"
        got = [reader.decode_scalar_event(r) for r in records[1:]]
        assert [(e["tag"], e["step"], e["wall_time"]) for e in got] == \
            [(tag, step, 1.75e9) for tag, _, step, _ in EVENTS]
        assert [e["simple_value"] for e in got] == pytest.approx([v for _, v, _, _ in EVENTS])


def test_corrupt_record_is_detected(tmp_path):
    path = _write(tb, str(tmp_path))
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        tb.read_records(path)


def test_make_writers_dispatch(tmp_path):
    assert tb.make_writers("", str(tmp_path), "run", True) == []
    assert tb.make_writers("tensorboard", str(tmp_path), "run", False) == []
    ws = tb.make_writers("tensorboard", str(tmp_path), "run", True)
    assert len(ws) == 1 and ws[0].path.startswith(str(tmp_path / "run" / "tensorboard"))
    ws[0].close()
    with pytest.raises(ImportError, match="wandb requested"):
        tb.make_writers("wandb", str(tmp_path), "run", True)
    with pytest.raises(ValueError):
        tb.make_writers("nope", str(tmp_path), "run", True)


def test_wandb_writer_with_stub_module(tmp_path, monkeypatch):
    calls = {"log": [], "finish": 0}
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls.__setitem__("init", kw)
    stub.log = lambda data, step=None: calls["log"].append((step, dict(data)))
    stub.finish = lambda: calls.__setitem__("finish", calls["finish"] + 1)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    (w,) = tb.make_writers("wandb", str(tmp_path), "myrun", True, wandb_project="proj-x",
                           wandb_notes="n", wandb_resume="auto", config={"lr": 1e-5})
    assert calls["init"] == {"project": "proj-x", "name": "myrun", "id": "myrun", "notes": "n",
                             "tags": [], "resume": "auto", "config": {"lr": 1e-5}}
    w.add_scalar("train/loss", 1.5, 3)
    w.add_scalar("train/lr", 0.1, 3)
    w.add_scalar("train/loss", 1.2, 4)
    w.flush()
    assert calls["log"] == [(3, {"train/loss": 1.5, "train/lr": 0.1}), (4, {"train/loss": 1.2})]
    w.add_scalar("val/top1", 0.9, 5)
    w.close()
    assert calls["log"][-1] == (5, {"val/top1": 0.9}) and calls["finish"] == 1


def _touch(path, content=b"x"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(content)


@pytest.mark.parametrize("mod", [file_sync, jax_file_sync], ids=["torch", "jax"])
def test_sync_dir_copies_newer_files_and_skips_latest(mod, tmp_path):
    src, dst = str(tmp_path / "run"), str(tmp_path / "remote")
    _touch(os.path.join(src, "out.log"), b"log")
    _touch(os.path.join(src, "checkpoints", "epoch_1.pt"), b"ckpt")
    _touch(os.path.join(src, "checkpoints", "epoch_latest.pt"), b"latest")
    assert mod.sync_dir(src, dst) is True
    assert open(os.path.join(dst, "out.log"), "rb").read() == b"log"
    assert open(os.path.join(dst, "checkpoints", "epoch_1.pt"), "rb").read() == b"ckpt"
    assert not os.path.exists(os.path.join(dst, "checkpoints", "epoch_latest.pt"))
    time.sleep(0.05)
    _touch(os.path.join(src, "out.log"), b"log2")
    assert mod.sync_dir_local(src, dst) is True
    assert open(os.path.join(dst, "out.log"), "rb").read() == b"log2"


def test_remote_sync_final_sync_and_pt_load_path(tmp_path):
    src, dst = str(tmp_path / "run"), str(tmp_path / "remote")
    _touch(os.path.join(src, "results.jsonl"), b"{}")
    rs = file_sync.RemoteSync(src, dst, frequency_s=3600, protocol="fsspec").start()
    assert rs.final_sync() is True
    assert os.path.exists(os.path.join(dst, "results.jsonl"))
    p = str(tmp_path / "model.pt")
    _touch(p)
    assert file_sync.pt_load_path(p) == p
    with pytest.raises(FileNotFoundError):
        file_sync.pt_load_path("s3://no-such-bucket/model.pt", cache_dir=str(tmp_path))


def _traced_steps(trace_dir, start, num, run):
    """``run`` steps, each under a ``step<i>`` range, traced from ``start``;
    returns the profiler and the step ranges its trace holds."""
    prof = profiler.StepTraceProfiler(trace_dir, start_step=start, num_steps=num)
    x = torch.ones(32, 32)
    for i in range(run):
        prof.on_step(i, sync=lambda: None)
        with torch.profiler.record_function(f"step{i}"):
            x = torch.tanh(x @ x.T / 32)
    prof.close(sync=lambda: None)
    with open(prof.path) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    return prof, sorted(n for n in names if n and n.startswith("step"))


def test_step_trace_profiler_covers_its_window(tmp_path):
    prof, steps = _traced_steps(str(tmp_path / "trace"), start=2, num=2, run=6)
    assert steps == ["step2", "step3"]
    assert prof.path == str(tmp_path / "trace" / "steps_2-4.pt.trace.json")
    prof.close()   # idempotent


def test_step_trace_profiler_closes_a_trace_left_open(tmp_path):
    prof, steps = _traced_steps(str(tmp_path / "trace"), start=1, num=100, run=3)
    assert steps == ["step1", "step2"]
    assert os.path.basename(prof.path) == "steps_1-3.pt.trace.json"


# XLA's HLO cost analysis, JAX's count, counts a scanned stack of blocks
# once, whatever its depth, so the two are compared at one block a tower;
# there it counts the elementwise work (LayerNorm, softmax, GELU, the bias
# and residual adds, the normalisation) besides the products, which are all
# that torch's FlopCounterMode counts. That work is O(width) a token against
# O(width^2) for the products, a few percent at CLIP's widths: JAX's count
# must lie in [1, FLOP_RATIO_MAX] times the port's. Observed at ViT-B/32's
# widths: 1.040 (image) and 1.051 (text).
FLOP_RATIO_MAX = 1.1
ONE_BLOCK_B32 = {
    "embed_dim": 512,
    "vision_cfg": {"image_size": 224, "layers": 1, "width": 768, "patch_size": 32},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 512, "heads": 8, "layers": 1},
}


def _register(monkeypatch, name, raw):
    from latteclip_tpu.core import config as jax_config
    from latteclip_torch import config as torch_config

    for mod in (jax_config, torch_config):
        real = mod.get_model_config
        monkeypatch.setattr(mod, "get_model_config", lambda n, real=real, mod=mod: (
            mod.config_from_dict(n, raw) if n == name else real(n)))


def test_profile_model_matches_jax(monkeypatch):
    _register(monkeypatch, "one-block-b32", ONE_BLOCK_B32)
    for name in ("ViT-tiny-test", "one-block-b32"):
        ours = profiler.profile_model(name, device="cpu")
        theirs = jax_profiler.profile_model(name)
        for key in ("model", "image_size", "image_width", "text_width", "embed_dim", "mparams",
                    "mparams_image", "mparams_text"):
            assert ours[key] == theirs[key], (name, key)
    for key in ("image_gflops", "text_gflops", "gflops"):
        assert 1.0 <= theirs[key] / ours[key] <= FLOP_RATIO_MAX, key
    # the products counted: 2 m n k each, here ViT-B/32's patch embedding,
    # one block of each tower and the projections at batch 1
    assert ours["image_gflops"] == round(947466240 / 1e9, 2)
    assert ours["text_gflops"] == round(497108992 / 1e9, 2)
