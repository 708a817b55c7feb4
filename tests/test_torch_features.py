"""latteclip_torch's pseudo-label job (``eval/features.py``,
``--extract-features-path``) against latteclip_tpu's, ViT-tiny-test in
float32 from one set of weights (carried across by
``state_dict_from_jax_params``, or by a ``--pretrained`` file written by the
JAX package).

The pickle must have the same records, keys and value types: ``image``
float32 within 1e-5 (the packages differ in float32 summation order only,
tests/test_torch_model.py holds the towers to 1e-4 on unnormalised
features), ``top_class_ids`` int64 and equal, ``top_logit`` (100 x cosine)
within 1e-4 x 100, class names and ground truth equal. The port's own pickle
then feeds the port's training run through ``--clip-prediction-path``.
"""
import dataclasses
import logging
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.data.eval_dataset import FlatFileDataset as JaxFlatFileDataset
from latteclip_tpu.eval import features as jax_features
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_tpu.train import main as jax_main
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.data import synthetic
from latteclip_torch.data.eval_dataset import FlatFileDataset
from latteclip_torch.eval import features
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.train import main as torch_main

torch.set_num_threads(2)
FEAT_TOL = 1e-5
LOGIT_TOL = 100 * 1e-4


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    base = tmp_path_factory.mktemp("features")
    root = str(base / "fixture")
    synthetic.make_full_fixture(root, num_train=64, num_val=8, image_size=64)
    jcfg = dataclasses.replace(jax_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(torch_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    pretrained = str(base / "pretrained.pt")
    jax_ckpt.save_clip_pt(pretrained, params, jcfg)
    return {"base": base, "root": root, "jcfg": jcfg, "params": params, "model": model,
            "pretrained": pretrained}


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_pickles_agree(ours, theirs):
    assert list(ours) == list(theirs)
    for image_id, rec in theirs.items():
        got = ours[image_id]
        assert list(got) == list(rec), image_id
        for key, value in rec.items():
            assert type(got[key]) is type(value), (image_id, key)
            if isinstance(value, np.ndarray):
                assert got[key].dtype == value.dtype and got[key].shape == value.shape
        np.testing.assert_allclose(got["image"], rec["image"], atol=FEAT_TOL, rtol=0)
        np.testing.assert_array_equal(got["top_class_ids"], rec["top_class_ids"])
        np.testing.assert_allclose(got["top_logit"], rec["top_logit"], atol=LOGIT_TOL, rtol=0)
        assert got["class_names"] == rec["class_names"]
        assert (got["gt_classname"], got["gt_class_id"]) == (rec["gt_classname"],
                                                             rec["gt_class_id"])


@pytest.mark.parametrize("split,batch", [("train", 24), ("val", 8)])
def test_extract_features_matches_jax(shared, tmp_path, caplog, split, batch):
    """The function: the same pickle and the same accuracy log line (the
    last batch of the train split is padded, 64 = 2 x 24 + 16)."""
    train = split == "train"
    ds = FlatFileDataset(shared["root"], train=train, image_size=64, dataset_name="dtd")
    jds = JaxFlatFileDataset(shared["root"], train=train, image_size=64, dataset_name="dtd")
    with caplog.at_level(logging.INFO):
        theirs = jax_features.extract_features(shared["params"], shared["jcfg"],
                                               jax_get_tokenizer(), jds, str(tmp_path / "jax"),
                                               split, batch_size=batch)
        ours = features.extract_features(shared["model"], get_tokenizer(), ds,
                                         str(tmp_path / "torch"), split, batch_size=batch)
    assert len(ours) == len(ds)
    assert_pickles_agree(ours, theirs)
    assert_pickles_agree(_load(tmp_path / "torch" / f"clip_features_{split}.pkl"),
                         _load(tmp_path / "jax" / f"clip_features_{split}.pkl"))
    lines = [r.getMessage() for r in caplog.records if "extract_features[" in r.getMessage()]
    assert len(lines) == 2 and lines[0] == lines[1]


def test_extract_features_refuses_an_empty_split(shared, tmp_path):
    ds = FlatFileDataset(shared["root"], train=False, image_size=64, dataset_name="dtd")
    ds.image_ids = []
    with pytest.raises(ValueError, match="no samples"):
        features.extract_features(shared["model"], get_tokenizer(), ds, str(tmp_path), "val")


def _main_args(shared, *extra):
    return ["--model", "ViT-tiny-test", "--precision", "fp32", "--pretrained",
            shared["pretrained"], "--eval-preprocess-path", shared["root"],
            "--zeroshot-eval-data", "dtd", "--batch-size", "16", "--workers", "2", *extra]


def test_both_mains_extract_features(shared):
    out = shared["base"] / "mains"
    for pkg, main, extra in (("jax", jax_main.main, []),
                             ("torch", torch_main.main, ["--device", "cpu"])):
        assert main(_main_args(shared, "--logs", str(out / pkg / "logs"),
                               "--extract-features-path", str(out / pkg), *extra)) == 0
    ours = _load(out / "torch" / "clip_features_train.pkl")
    assert len(ours) == 64
    assert_pickles_agree(ours, _load(out / "jax" / "clip_features_train.pkl"))


def test_port_pickle_trains_the_port(shared):
    """The join: the port's pickle is the ``--clip-prediction-path`` of a
    port training epoch on the fixture's tar shard and captions."""
    out = shared["base"] / "join"
    root = shared["root"]
    assert torch_main.main(_main_args(shared, "--logs", str(out / "feat"), "--device", "cpu",
                                      "--extract-features-path", str(out))) == 0
    pkl = str(out / "clip_features_train.pkl")
    assert torch_main.main(_main_args(
        shared, "--logs", str(out / "logs"), "--device", "cpu", "--name", "join",
        "--train-data", os.path.join(root, "webdataset", "train_tars", "00000.tar"),
        "--train-num-samples", "64", "--clip-prediction-path", pkl,
        "--generated-captions-path", os.path.join(root, "captions_per_image"),
        "--generated-common-captions-path", os.path.join(root, "captions_per_group"),
        "--epochs", "1", "--lr", "1e-4", "--warmup", "1")) == 0
    ckpt_dir = out / "logs" / "join" / "checkpoints"
    assert (ckpt_dir / "epoch_1.pt").exists()
    with open(ckpt_dir / "results.jsonl") as f:
        assert "top1" in f.read()
