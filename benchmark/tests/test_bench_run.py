"""Whole runs of the harness on the CPU at ViT-tiny-test's size (the look for
a card skipped): the last line's schema, and ``correct`` false with the timed
path broken underneath, once for each fault a cell can have, and with the
control in the program's place."""
import json

import numpy as np
import pytest
import torch

from benchmark import calibrate, run
from benchmark.tests.tiny import make_root, run_cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["tiny_b32_train_packed", "tiny_b16_eval"])
def test_last_line_schema(root, capsys, cell, trace):
    rc, out = run_cell(root, cell, capsys, trace)
    assert rc == 0
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and out["checks"]
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    m = run.manifest(root)
    section = "per_layer" if trace else "end_to_end"
    names = {e["name"] for e in run.cell_metrics(m, section, cell)}
    assert set(out["metrics"]) <= names and all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
        # the CPU trace holds no device time: the device readers give nothing
        assert not any(k.startswith(("attn_roofline", "device_idle")) for k in out["metrics"])
    else:
        assert names == set(out["metrics"])


def _broken_train_step(monkeypatch, broken):
    from latteclip_torch.train import step as S

    real = S.make_train_step
    monkeypatch.setattr(S, "make_train_step", lambda *a, **k: broken(real(*a, **k)))


def test_a_step_that_returns_its_state_unchanged_is_not_correct(root, capsys, monkeypatch):
    def unchanged(step):
        def call(state, batch, gen=None):
            params = [p.detach().clone() for p in state.model.parameters()]
            bank = state.memory_bank
            out = step(state, batch, gen)
            with torch.no_grad():
                for p, q in zip(state.model.parameters(), params):
                    p.copy_(q)
            state.memory_bank = bank
            return out
        return call

    _broken_train_step(monkeypatch, unchanged)
    rc, out = run_cell(root, "tiny_b32_train_packed", capsys)
    assert rc == 0 and out["correct"] is False
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(root, capsys, monkeypatch):
    def half(step):
        def call(state, batch, gen=None):
            n = len(batch["zs_preds"]) // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, gen)
        return call

    _broken_train_step(monkeypatch, half)
    rc, out = run_cell(root, "tiny_b32_train_padded", capsys)
    assert rc == 0 and out["correct"] is False
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"]["limit"]


def test_a_bank_update_that_skips_half_the_classes_is_not_correct(root, capsys, monkeypatch):
    def skips(step):
        def call(state, batch, gen=None):
            before = state.memory_bank.clone()
            out = step(state, batch, gen)
            with torch.no_grad():
                half = before.shape[0] // 2
                state.memory_bank[:half] = before[:half]
            return out
        return call

    _broken_train_step(monkeypatch, skips)
    rc, out = run_cell(root, "tiny_b32_train_packed", capsys)
    assert rc == 0 and out["correct"] is False
    checks = out["checks"]
    assert checks["bank_update_gap"]["value"] > checks["bank_update_gap"]["limit"]
    # the bank itself moves by about alpha: the skipped rows hide in its rounding
    assert checks["bank_gap"]["value"] < checks["bank_gap"]["limit"]


def test_an_altered_answer_is_not_correct(root, capsys):
    undo = calibrate.patch_eval("alter")
    try:
        rc, out = run_cell(root, "tiny_b16_eval", capsys)
    finally:
        undo()
    assert rc == 0 and out["correct"] is False
    assert out["checks"]["logit_err"]["value"] > out["checks"]["logit_err"]["limit"]


def test_the_train_control_fails_a_number(root, capsys):
    """The fp8 reference in the program's place reads above a limit."""
    calibrate.main(["--workload", "tiny_b32_train_packed", "--seeds", "3", "--faults", "control"],
                   device="cpu", root=root)
    reading = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = run.load_json(root, "benchmark", "limits", "tiny_b32_train_packed.json")
    assert any(reading[k] > limits[k] for k in limits), reading


def test_the_eval_control_fails_a_number(root, capsys):
    """The fp8 reference in the program's place reads above the limit."""
    calibrate.main(["--workload", "tiny_b16_eval", "--seeds", "3", "--faults", "fp8"],
                   device="cpu", root=root)
    reading = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = run.load_json(root, "benchmark", "limits", "tiny_b16_eval.json")
    assert any(reading[k] > limits[k] for k in limits), reading


def test_the_reference_is_the_port_in_float32(root, capsys, monkeypatch):
    """With the port computing in float32 the reference follows it to
    float32 rounding: the reference is the same function."""
    import dataclasses

    orig = run.Ctx.port_config
    monkeypatch.setattr(run.Ctx, "port_config",
                        lambda self: dataclasses.replace(orig(self), compute_dtype="float32"))
    for cell in ("tiny_b32_train_packed", "tiny_b32_train_padded", "tiny_b16_eval"):
        rc, out = run_cell(root, cell, capsys)
        values = {k: c["value"] for k, c in out["checks"].items()}
        assert rc == 0 and out["correct"] is True and max(values.values()) < 1e-4, (cell, values)
    assert np.isfinite(list(values.values())).all()
