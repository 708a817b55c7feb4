"""The readers of the program's spans and counters (``benchmark/program.py``)
in traced tiny runs on the CPU: every host and counter metric listed for the
cell is reported, no stream metric (the CPU has no events), and none at all
with a program that has no recorder."""
import sys

import pytest

from benchmark import run
from benchmark.tests.tiny import make_root, run_cell

HOST = {"tiny_b32_train_packed": {"sync_wait_ms.train.b32", "step_host_ms.train.b32",
                                  "input_wait_ms.train.b32", "pack_fill.train.b32"},
        "tiny_b16_eval": {"eval_host_ms.eval", "input_wait_ms.eval"}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


def _program_metrics(root, cell):
    m = run.manifest(root)
    return {e["name"] for e in run.cell_metrics(m, "per_layer", cell)
            if e["source"] in ("program_span", "program_counter")}


@pytest.mark.parametrize("cell", sorted(HOST))
def test_a_traced_cell_reports_its_program_metrics(root, capsys, cell):
    rc, out = run_cell(root, cell, capsys, trace=1)
    assert rc == 0 and out["correct"]
    got = out["metrics"]
    listed = _program_metrics(root, cell)
    assert HOST[cell] <= listed and set(got) & listed == HOST[cell]
    assert not any("_stream_ms" in k for k in got)
    assert all(v["value"] >= 0 for k, v in got.items() if k in HOST[cell])
    if cell.startswith("tiny_b32"):
        assert 0 < got["pack_fill.train.b32"]["value"] <= 100
        assert got["step_host_ms.train.b32"]["value"] > got["sync_wait_ms.train.b32"]["value"]


def test_a_program_without_the_recorder_reports_none_of_them(root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "latteclip_torch.obs.trace", None)  # import fails
    from benchmark import program

    assert program.window({"kind": "train", "trace": {}}, "train") is None
    assert program.fill({"kind": "train", "trace": {}}, "train", "a", "b") is None
