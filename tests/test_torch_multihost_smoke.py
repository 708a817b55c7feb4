"""The port's multi-process smoke, in the suite (the counterpart of
tests/test_multihost_smoke.py): ``latteclip_torch.tools.multihost_smoke``
spawns two gloo ranks on the CPU, runs two v2 steps on ViT-tiny-test in
float32 with packed captions, eval, the checkpoint gathered and written by
rank 0, a resume on every rank and one more step, at tp 1 (data parallel)
and tp 2 (the MLPs Megatron-sharded across the two ranks). The ranks must
agree bit for bit, the resume must equal the continuation, and the first
step must equal one process on the concatenated batch (loss 1e-5
relative, gradient cosine >= 0.99999, bank 1e-5); the checkpoint reloads
into that process with rank 0's image features. Each mode's ranks join
within 120 s or are killed."""
import pytest

from latteclip_torch.tools import multihost_smoke as smoke


@pytest.mark.parametrize("tp", [1, 2])
def test_multihost_smoke(tp):
    cfg = smoke.SmokeConfig(tp=tp, fp32=True, text_packing=128)
    report = smoke.run(cfg, world=2)
    assert report["failures"] == []
    ranks = report["ranks"]
    assert [(r["data_index"], r["model_index"]) for r in ranks] == (
        [(0, 0), (1, 0)] if tp == 1 else [(0, 0), (0, 1)])
    assert len(ranks[0]["losses"]) == cfg.steps
    assert ranks[0]["cont_loss"] == ranks[0]["resume_loss"]
    assert ranks[0]["c_fc_rows"] * tp == 256   # ViT-tiny-test's MLP width
    assert report["reference"]["reload_features_max_abs_diff"] == 0.0


def test_smoke_main_reports_each_mode(capsys):
    assert smoke.main(["--tp", "1", "--fp32", "--steps", "1"]) == 0
    out = capsys.readouterr().out
    assert "MULTIHOST SMOKE (tp=1): OK" in out and out.count("multihost_smoke {") == 1
