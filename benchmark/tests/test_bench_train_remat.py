"""The ``train_remat`` kind of cell on the CPU, at ViT-tiny-test's size on a
batch-8 copy of its mix: it rematerialises every block (``layers.
remat_counts`` moves) where the ``train`` kind leaves the counter still, it
restores the port's ``make_train_step``, and under ``--trace 1`` it reports
the ``l14_train_remat`` cell's program metrics that the CPU can read: the
host ones and the replay share, not the stream times (the CPU has no
events)."""
import pytest

from benchmark import run
from benchmark.tests.tiny import _dump, make_root, run_cell

CELL = "tiny_l14_train_remat"
BLOCKS = "layers.remat_counts.blocks"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(str(tmp_path_factory.mktemp("bench")))
    mix = run.load_json(root, "benchmark", "traffic", "train_packed_remat.json")
    assert mix["kind"] == "train_remat"
    _dump(dict(mix, batch=8), root, "benchmark", "traffic", "train_packed_remat.json")
    return root


def _blocks():
    from latteclip_torch.obs import trace

    return trace.counters().get(BLOCKS, 0)


def test_the_remat_kind_rematerialises_and_the_train_kind_does_not(root, capsys):
    from latteclip_torch.train import step as S

    make = S.make_train_step
    before = _blocks()
    rc, out = run_cell(root, "tiny_b32_train_packed", capsys)
    assert rc == 0 and out["correct"] and _blocks() == before
    rc, out = run_cell(root, CELL, capsys)
    assert rc == 0 and out["correct"] and _blocks() > before
    assert S.make_train_step is make
    m = run.manifest(root)
    assert set(out["metrics"]) == {e["name"] for e in run.cell_metrics(m, "end_to_end", CELL)}
    assert set(out["metrics"]) == {"train_images_per_s.b16", "setup_s"}


def test_a_traced_remat_cell_reports_its_program_metrics(root, capsys):
    rc, out = run_cell(root, CELL, capsys, trace=1)
    assert rc == 0 and out["correct"]
    got = out["metrics"]
    m = run.manifest(root)
    listed = {e["name"] for e in run.cell_metrics(m, "per_layer", CELL)}
    assert set(got) <= listed
    assert {"train_mfu.l14", "attn_replay.train.l14"} <= set(got)
    assert not any("_stream_ms" in k for k in got)
    # the CPU takes the plain attention, which the recompute runs again
    assert got["attn_replay.train.l14"]["value"] == 0.0
    assert got["train_mfu.l14"]["value"] > 0
