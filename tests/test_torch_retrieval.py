"""latteclip_torch's paired validation and ImageNet-folder eval
(``eval/retrieval.py``, ``data/folder_dataset.py``, ``eval/imagenet_metadata.py``,
the loop's ``--val-data`` and ``--imagenet-val`` branches) against
latteclip_tpu, ViT-tiny-test in float32 from one set of weights.

Tolerances: ``clip_retrieval_metrics`` equal (the same numpy on the same
features); ``validation_loss``'s ``clip_val_loss`` within 1e-5 and its
ranks equal (features differ in float32 summation order only); dataset
samples byte-equal (the same PIL geometry); the 80-template ImageNet
classifier within 1e-4 (tests/test_torch_zero_shot.py). The mains train one
epoch from one ``--pretrained`` file and write ``results.jsonl`` with equal
keys, accuracies, ranks and counts, and losses within 1e-4 relative (the
trained weights differ in float32 summation order, tests/test_torch_cli.py).
The mains' ImageNet classifier takes 2 of the 80 templates for all 1000
classes: 80,000 rows through the text tower take minutes on a CPU; the 80
are held by the classifier test and the byte-identical asset
(tests/test_torch_model.py).
"""
import csv
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import latteclip_tpu.eval.imagenet_metadata as jax_imagenet
from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.data.folder_dataset import CsvDataset as JaxCsvDataset
from latteclip_tpu.data.folder_dataset import ImageFolderDataset as JaxImageFolderDataset
from latteclip_tpu.eval import retrieval as jax_retrieval
from latteclip_tpu.eval import zero_shot as jax_zs
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_tpu.train import main as jax_main
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.data.folder_dataset import CsvDataset, ImageFolderDataset
from latteclip_torch.eval import imagenet_metadata, retrieval
from latteclip_torch.eval import zero_shot as zs
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.train import main as torch_main

torch.set_num_threads(2)
LOSS_TOL = 1e-5
CLF_TOL = 1e-4
RESULT_REL_TOL = 1e-4
IMAGENET_DIRS, IMAGES_PER_DIR, FILLED_DIRS = 1000, 2, 6


def _image(rng, h, w):
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """An ImageNet folder of 1000 class directories, the first few holding
    images (PNG and JPEG, non-square), and a CSV of image-caption pairs."""
    base = tmp_path_factory.mktemp("retrieval")
    rng = np.random.default_rng(0)
    folder = base / "imagenet"
    for i in range(IMAGENET_DIRS):
        os.makedirs(folder / f"n{i:08d}")
    for i in range(FILLED_DIRS):
        for j in range(IMAGES_PER_DIR):
            ext = "png" if j else "JPEG"
            _image(rng, 70 + 5 * j, 90).save(folder / f"n{i:08d}" / f"img{j}.{ext}")
    (folder / f"n{0:08d}" / "notes.txt").write_text("not an image")
    pairs = base / "pairs"
    os.makedirs(pairs)
    words = ["tench", "goldfish", "shark", "hen", "kite", "jay", "newt", "frog"]
    with open(base / "val.csv", "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["filepath", "title"])
        for i in range(12):
            name = f"p{i}.jpg"
            _image(rng, 64 + 4 * i, 64).save(pairs / name)
            # relative and absolute paths
            w.writerow([f"pairs/{name}" if i % 2 else str(pairs / name),
                        f"a photo of a {words[i % len(words)]} number {i}"])
    jcfg = dataclasses.replace(jax_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(torch_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    pretrained = str(base / "pretrained.pt")
    jax_ckpt.save_clip_pt(pretrained, params, jcfg)
    return {"base": base, "folder": str(folder), "csv": str(base / "val.csv"), "jcfg": jcfg,
            "params": params, "model": model, "pretrained": pretrained}


def test_clip_retrieval_metrics_match_jax():
    rng = np.random.default_rng(1)
    img = rng.standard_normal((20, 8)).astype(np.float32)
    txt = img + 0.8 * rng.standard_normal((20, 8)).astype(np.float32)
    ours = retrieval.clip_retrieval_metrics(img, txt, 14.0)
    assert ours == jax_retrieval.clip_retrieval_metrics(img, txt, 14.0)
    assert len(ours) == 10 and ours["image_to_text_median_rank"] == int(
        ours["image_to_text_median_rank"])
    unit = img / np.linalg.norm(img, axis=1, keepdims=True)
    exact = retrieval.clip_retrieval_metrics(unit, unit, 1.0)   # each row ranks itself first
    assert exact["image_to_text_R@1"] == exact["text_to_image_mean_rank"] == 1.0


def test_folder_and_csv_samples_match_jax(data):
    for kw in ({}, {"k_shot": 1, "seed": 3}):
        ours = ImageFolderDataset(data["folder"], image_size=32, **kw)
        theirs = JaxImageFolderDataset(data["folder"], image_size=32, **kw)
        assert ours.class_names == theirs.class_names and len(ours.class_names) == IMAGENET_DIRS
        assert ours.image_ids == theirs.image_ids
        assert len(ours) == FILLED_DIRS * (kw.get("k_shot") or IMAGES_PER_DIR)
        assert ours.display_class_names == theirs.display_class_names
        for i in range(len(ours)):
            a, b = ours.load_sample(i), theirs.load_sample(i)
            assert a[0] == b[0] and a[2] == b[2] == ours.label_of(a[0])
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(np.asarray(ours.load_image(i)),
                                          np.asarray(theirs.load_image(i)))
    ours, theirs = CsvDataset(data["csv"], image_size=32), JaxCsvDataset(data["csv"], image_size=32)
    assert len(ours) == len(theirs) == 12
    for i in range(len(ours)):
        (a, ca), (b, cb) = ours.load_sample(i), theirs.load_sample(i)
        assert ca == cb
        np.testing.assert_array_equal(a, b)


def test_validation_loss_and_val_pairs_match_jax(data):
    ours = retrieval.evaluate_val_pairs(data["model"], CsvDataset(data["csv"], image_size=64),
                                        batch_size=5, tokenizer=get_tokenizer())
    theirs = jax_retrieval.evaluate_val_pairs(data["params"], data["jcfg"],
                                              JaxCsvDataset(data["csv"], image_size=64),
                                              batch_size=5, tokenizer=jax_get_tokenizer())
    assert sorted(ours) == sorted(theirs) and ours["num_samples"] == 12
    assert abs(ours.pop("clip_val_loss") - theirs.pop("clip_val_loss")) <= LOSS_TOL
    assert ours == theirs
    assert retrieval.validation_loss(data["model"], iter(())) == {}


def test_imagenet_classifier_matches_jax(data):
    """The 80 OpenAI templates over a few ImageNet classes."""
    names = imagenet_metadata.imagenet_classnames()
    assert names == jax_imagenet.imagenet_classnames() and len(names) == 1000
    templates = imagenet_metadata.openai_imagenet_templates()
    jtemplates = jax_imagenet.openai_imagenet_templates()
    assert len(templates) == 80
    assert [t("x") for t in templates] == [t("x") for t in jtemplates]
    ours = zs.build_zero_shot_classifier(data["model"], get_tokenizer(), names[:3], templates)
    theirs = jax_zs.build_zero_shot_classifier(data["params"], data["jcfg"], jax_get_tokenizer(),
                                               names[:3], jtemplates)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=CLF_TOL, rtol=0)


def _results(log_dir):
    with open(os.path.join(log_dir, "eval", "checkpoints", "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_both_mains_with_val_data_and_imagenet_val(data, monkeypatch):
    two = [lambda c: f"a bad photo of a {c}.", lambda c: f"a photo of many {c}."]
    monkeypatch.setattr(jax_imagenet, "openai_imagenet_templates", lambda: two)
    monkeypatch.setattr(imagenet_metadata, "openai_imagenet_templates", lambda: two)
    argv = ["--dataset-type", "synthetic", "--model", "ViT-tiny-test", "--batch-size", "32",
            "--epochs", "1", "--warmup", "1", "--lr", "1e-4", "--precision", "fp32",
            "--aug-cfg", "color_jitter_prob=0", "gray_scale_prob=0", "--workers", "2",
            "--pretrained", data["pretrained"], "--val-data", data["csv"],
            "--imagenet-val", data["folder"], "--eval-batch-size", "8", "--name", "eval",
            "--no-save-most-recent"]
    assert jax_main.main([*argv, "--logs", str(data["base"] / "jax")]) == 0
    assert torch_main.main([*argv, "--logs", str(data["base"] / "torch"), "--device", "cpu"]) == 0
    (ours,), (theirs,) = _results(str(data["base"] / "torch")), _results(str(data["base"] / "jax"))
    assert sorted(ours) == sorted(theirs)
    assert ours["num_samples"] == 12
    assert ours["imagenet-zeroshot-val-n"] == FILLED_DIRS * IMAGES_PER_DIR
    for key, value in theirs.items():
        if key == "clip_val_loss":
            assert abs(ours[key] - value) <= RESULT_REL_TOL * abs(value), key
        else:
            assert ours[key] == value, key
