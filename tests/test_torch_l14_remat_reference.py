"""The ``l14_train_remat`` cell's comparison on the CPU, at ViT-L/14's widths
and head counts (vision 1024 wide, 16 heads of 64, patch 14; text 768 wide,
12 heads; embedding 768) cut to 2 vision and 2 text layers and 56-px images
(17 tokens), batch 8:

* the port's v2 step with every block rematerialised, computing in float32,
  run through ``benchmark/run.py``'s ``main(device="cpu")`` on a temporary
  root, is ``correct`` and follows ``benchmark/reference.py`` within 1e-4
  on every check but one (float32 rounding: the reference is the same
  function). ``bank_update_gap`` divides each bank row's distance by the
  row's change over the first step: the rows agree to about 9e-7 (a few
  float32 ulps of a unit row at these widths), and a change of about
  ``alpha / 2`` makes that about 2e-4, so it is held within 1e-3;
* the same step with remat off (the ``train`` kind) gives the same readings
  within 1e-6: the recompute runs the same float32 operations on the same
  inputs.

Each run goes in a fresh interpreter (this file run as a script), since
``benchmark/run.py`` refuses to give a result in a process that has loaded
JAX, as the test suite's other files do, and sets cache directories in the
environment of the process that imports it.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = {"layers": 2, "image_size": 56}
CELLS = {"remat": ("l14_cut_remat", "train_packed_remat"), "no_remat": ("l14_cut", "train_packed")}


def make_cut_root(tmp: str) -> str:
    """The benchmark in ``tmp`` with two cells on ViT-L-14 cut to ``CUT``:
    ``l14_cut_remat`` (the ``train_remat`` kind) and ``l14_cut`` (``train``),
    both at batch 8 with the ``l14_train_remat`` limits."""
    import shutil

    from benchmark import run
    from benchmark.tests.tiny import _dump, make_root

    root = make_root(tmp)
    raw = run.load_json(run.ROOT, "benchmark", "configs", "ViT-L-14.json")
    raw["vision_cfg"] = dict(raw["vision_cfg"], layers=CUT["layers"], image_size=CUT["image_size"])
    raw["text_cfg"] = dict(raw["text_cfg"], layers=CUT["layers"])
    _dump(raw, root, "benchmark", "configs", "l14_cut.json")
    mix = run.load_json(root, "benchmark", "traffic", "train_packed_remat.json")
    _dump(dict(mix, batch=8), root, "benchmark", "traffic", "train_packed_remat.json")
    m = run.manifest(root)
    m["configs"].append({"name": "l14_cut", "source": "x", "file": "benchmark/configs/l14_cut.json",
                         "reduced": ["layers", "image_size"], "why": "CPU tests"})
    limits = os.path.join(root, "benchmark", "limits", "l14_train_remat.json")
    for name, traffic in CELLS.values():
        m["workloads"].append({"name": name, "config": "l14_cut", "traffic": traffic, "chips": 1,
                               "why": "CPU tests"})
        shutil.copy(limits, os.path.join(root, "benchmark", "limits", name + ".json"))
    for e in m["end_to_end"]:
        if "workloads" in e and "l14_train_remat" in e["workloads"]:
            e["workloads"] = e["workloads"] + [name for name, _ in CELLS.values()]
    _dump(m, root, "BENCHMARK.json")
    return root


def run_cut(root: str, workload: str) -> int:
    """One run of ``workload`` on the CPU, the port's ViT-L-14 cut to ``CUT``
    and computing in float32."""
    import dataclasses

    import torch

    from benchmark import run
    from latteclip_torch import config as C

    torch.set_num_threads(2)
    real = C.get_model_config

    def cut(name):
        cfg = real(name)
        if name != "ViT-L-14":
            return cfg
        return dataclasses.replace(
            cfg, compute_dtype="float32",
            vision=dataclasses.replace(cfg.vision, layers=CUT["layers"], image_size=CUT["image_size"]),
            text=dataclasses.replace(cfg.text, layers=CUT["layers"]))

    C.get_model_config = cut
    return run.main(["--workload", workload, "--seed", str(2 ** 31 + 4321), "--seconds", "0.3",
                     "--trace", "0"], device="cpu", root=root)


def _script(*args) -> str:
    """This file run as a script in a fresh interpreter -> its standard output."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("l14"))
    _script("root", root)
    return {case: json.loads(_script("run", root, name).strip().splitlines()[-1])
            for case, (name, _) in CELLS.items()}


def test_the_remat_step_follows_the_reference_in_float32(readings):
    out = readings["remat"]
    values = {k: c["value"] for k, c in out["checks"].items()}
    assert out["correct"] is True and out["failed"] == 0, values
    assert set(values) == {"loss_gap", "update_gap", "bank_gap", "bank_update_gap"}
    assert values.pop("bank_update_gap") < 1e-3 and max(values.values()) < 1e-4, values


def test_remat_off_gives_the_same_readings(readings):
    on, off = (readings[c]["checks"] for c in ("remat", "no_remat"))
    assert readings["no_remat"]["correct"] is True
    assert set(on) == set(off)
    for k in on:
        assert abs(on[k]["value"] - off[k]["value"]) <= 1e-6, (k, on[k], off[k])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "root":
        make_cut_root(sys.argv[2])
        sys.exit(0)
    sys.exit(run_cut(sys.argv[2], sys.argv[3]))
