"""The manifest and every file it names load, and new cells, mixes and metrics
are found from files alone."""
import json
import os
import re

import pytest

from benchmark import run
from benchmark.tests.tiny import make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_names_files_that_load():
    m = run.manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"][1] == "benchmark/run.py"
    for w in m["workloads"]:
        wl, raw, mix = run.find_cell(m, w["name"])
        assert raw["model"] and run.cell_kind(mix["kind"]) is not None and w["chips"] == 1
        assert os.path.exists(os.path.join(run.HERE, "limits", w["name"] + ".json"))
        assert run.cell_metrics(m, "end_to_end", w["name"]), w["name"]
        assert run.cell_metrics(m, "per_layer", w["name"]), w["name"]
    for e in m["per_layer"]:
        assert callable(run.reader(e["name"]))
        assert e["moves"] in {x["name"] for x in m["end_to_end"]}
    for e in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for c in m["configs"]:
        assert c["reduced"] == [] and run.load_json(run.ROOT, c["file"])["reduced"] == []
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"] + m["workloads"] + m["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_every_cell_reports_setup_and_another_end_to_end_metric():
    m = run.manifest()
    for w in m["workloads"]:
        e2e = {e["name"] for e in run.cell_metrics(m, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2


def test_a_new_config_mix_and_metric_are_found_from_new_files(tmp_path):
    root = make_root(str(tmp_path))
    with open(os.path.join(root, "benchmark", "traffic", "train_shortcaps.json"), "w") as f:
        json.dump(dict(run.load_json(root, "benchmark", "traffic", "train_packed.json"),
                       caption_median=12), f)
    with open(os.path.join(root, "benchmark", "metrics", "steps_traced.py"), "w") as f:
        f.write("def read(rec):\n    return rec.get('traced')\n")
    m = run.manifest(root)
    m["workloads"].append({"name": "tiny_short", "config": "tiny", "traffic": "train_shortcaps",
                           "chips": 1, "why": "x"})
    wl, raw, mix = run.find_cell(m, "tiny_short", root)
    assert raw["model"] == "ViT-tiny-test" and mix["caption_median"] == 12
    assert run.reader("steps_traced", root)({"traced": 3}) == 3


def test_a_new_kind_of_cell_is_found_from_its_module_and_an_unknown_kind_fails(tmp_path, capsys):
    root = make_root(str(tmp_path))
    with open(os.path.join(root, "benchmark", "probe_cell.py"), "w") as f:
        f.write("def run(ctx):\n    return 'probe'\n")
    assert run.cell_kind("probe", root).run(None) == "probe"
    assert run.cell_kind("train", root) is not None and run.cell_kind("eval", root) is not None
    assert run.cell_kind("trian", root) is None and run.cell_kind("../run", root) is None
    mix = dict(run.load_json(root, "benchmark", "traffic", "train_packed.json"), kind="trian")
    with open(os.path.join(root, "benchmark", "traffic", "train_typo.json"), "w") as f:
        json.dump(mix, f)
    m = run.manifest(root)
    m["workloads"].append({"name": "tiny_typo", "config": "tiny", "traffic": "train_typo",
                           "chips": 1, "why": "x"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    rc = run.main(["--workload", "tiny_typo", "--seed", "1", "--seconds", "0.1", "--trace", "0"],
                  device="cpu", root=root)
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_grouped_metric_reports_its_quantity():
    assert run.quantity("train_images_per_s.b16") == "train_images_per_s"
    assert run.quantity("setup_s") == "setup_s"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "latteclip_tpu_like", types.ModuleType("latteclip_tpu_like"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]


def test_no_card_no_result(capsys):
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "b32_train_packed", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
