"""A copy of the benchmark in a temporary root whose manifest adds ``tiny_*``
cells: every cell again on ViT-tiny-test at a few images, for the CPU."""
from __future__ import annotations

import json
import os
import shutil

from benchmark import run

TINY = {"model": "ViT-tiny-test", "embed_dim": 32,
        "vision_cfg": {"image_size": 64, "layers": 2, "width": 64, "patch_size": 16, "head_width": 64},
        "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64, "heads": 4, "layers": 2},
        "reduced": ["layers", "width"], "source": "a test size"}


def _dump(obj, *parts):
    with open(os.path.join(*parts), "w") as f:
        json.dump(obj, f)


def make_root(tmp: str) -> str:
    """A root with BENCHMARK.json and benchmark/ holding the tiny cells."""
    shutil.copytree(os.path.join(run.ROOT, "benchmark"), os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = run.manifest()
    _dump(TINY, tmp, "benchmark", "configs", "tiny.json")
    m["configs"].append({"name": "tiny", "source": "x", "file": "benchmark/configs/tiny.json",
                         "reduced": ["layers", "width"], "why": "CPU tests"})
    for w in list(m["workloads"]):
        m["workloads"].append(dict(w, name="tiny_" + w["name"], config="tiny"))
        limits = os.path.join(tmp, "benchmark", "limits", w["name"] + ".json")
        if os.path.exists(limits):
            shutil.copy(limits, os.path.join(tmp, "benchmark", "limits", "tiny_" + w["name"] + ".json"))
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e:
            e["workloads"] = e["workloads"] + ["tiny_" + x for x in e["workloads"]]
    _dump(m, tmp, "BENCHMARK.json")
    for name in ("train_packed", "train_padded"):
        mix = run.load_json(tmp, "benchmark", "traffic", name + ".json")
        _dump(dict(mix, batch=8), tmp, "benchmark", "traffic", name + ".json")
    mix = run.load_json(tmp, "benchmark", "traffic", "eval_requests.json")
    _dump(dict(mix, request_images=8, classes=20, trace_requests=2), tmp, "benchmark", "traffic",
          "eval_requests.json")
    return tmp


def run_cell(root: str, workload: str, capsys, trace: int = 0, seed: int = 2 ** 31 + 12345):
    """One CPU run -> (exit code, the last line's object or None)."""
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], device="cpu", root=root)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None)
