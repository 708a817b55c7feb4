"""latteclip_torch's fusion-weight job (``eval/group_weights.py``,
``--extract-group-weight-path``) and ``ClipTokenizer.decode`` against
latteclip_tpu, ViT-tiny-test in float32 from one ``--pretrained`` file.

* the job's sample stream: the train pipeline at ``shuffle_buffer=1`` gives
  the same samples (image bytes, caption tokens, labels) in both packages,
  and the job covers each train sample once, the last batch padded;
* both mains: ``group_weights.npy`` within 1e-5 (each weight is a ratio of
  confidence margins of float32 features that differ in summation order,
  about 1e-7 here), ``all_labels.json`` equal;
* ``decode`` equals JAX's on the golden corpus, on byte sequences that are
  not UTF-8, and on encoded text (each word ends in a space).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from latteclip_tpu.core import checkpoint as jax_ckpt
from latteclip_tpu.core import config as jax_config
from latteclip_tpu.data import pipeline as jax_pipeline
from latteclip_tpu.eval import group_weights as jax_gw
from latteclip_tpu.models import clip as jax_clip
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_tpu.train import main as jax_main
from latteclip_tpu.train.state import init_memory_bank as jax_init_memory_bank
from latteclip_torch import config as torch_config
from latteclip_torch.checkpoint import state_dict_from_jax_params
from latteclip_torch.data import pipeline, synthetic
from latteclip_torch.eval import group_weights
from latteclip_torch.models import clip as torch_clip
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.train import main as torch_main

torch.set_num_threads(2)
WEIGHT_TOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_tokenizer.json")
CLASSES = ["banded", "dotted", "striped", "zigzagged"]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    base = tmp_path_factory.mktemp("gw")
    root = str(base / "fixture")
    synthetic.make_full_fixture(root, num_train=40, num_val=4, image_size=64)
    jcfg = dataclasses.replace(jax_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    params = jax_clip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    pretrained = str(base / "pretrained.pt")
    jax_ckpt.save_clip_pt(pretrained, params, jcfg)
    return {"base": base, "root": root, "jcfg": jcfg, "params": params,
            "pretrained": pretrained}


def _train_data(build, root, tok):
    return build(os.path.join(root, "webdataset", "train_tars", "00000.tar"),
                 os.path.join(root, "clip_features_train.pkl"),
                 [os.path.join(root, "captions_per_image")],
                 [os.path.join(root, "captions_per_group")], CLASSES, tok)


def test_sample_stream_matches_jax(fixture):
    """The samples the job reads: PipelineConfig(batch, size, shuffle_buffer=1),
    epoch 0, equal field by field (the image bytes exactly)."""
    ours = _train_data(pipeline.build_train_data, fixture["root"], get_tokenizer())
    theirs = _train_data(jax_pipeline.build_train_data, fixture["root"], jax_get_tokenizer())
    cfg = dict(batch_size=16, image_size=64, shuffle_buffer=1)
    a = pipeline.TrainPipeline(ours, pipeline.PipelineConfig(**cfg), len(ours.zs_top1))
    b = jax_pipeline.TrainPipeline(theirs, jax_pipeline.PipelineConfig(**cfg),
                                   len(theirs.zs_top1))
    sa, sb = a._sample_stream(0), b._sample_stream(0)
    for _ in range(len(ours.zs_top1)):
        x, y = next(sa), next(sb)
        assert sorted(x) == sorted(y)
        for key in y:
            np.testing.assert_array_equal(np.asarray(x[key]), np.asarray(y[key]), err_msg=key)


def test_extract_group_weights_matches_jax(fixture, tmp_path):
    """The function, at a batch that leaves a padded tail (40 = 16 + 16 + 8)."""
    jcfg, params = fixture["jcfg"], fixture["params"]
    tcfg = dataclasses.replace(torch_config.get_model_config("ViT-tiny-test"),
                               compute_dtype="float32")
    model = torch_clip.CLIP(tcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg))
    templates = [lambda c: f"{c} texture."]
    bank = np.array(jax_init_memory_bank(params, jcfg, jax_get_tokenizer(), CLASSES, templates))
    theirs = jax_gw.extract_group_weights(
        params, jcfg, _train_data(jax_pipeline.build_train_data, fixture["root"],
                                  jax_get_tokenizer()),
        bank, templates, jax_get_tokenizer(), str(tmp_path / "jax"), batch_size=16,
        image_size=64)
    ours = group_weights.extract_group_weights(
        model, _train_data(pipeline.build_train_data, fixture["root"], get_tokenizer()),
        torch.from_numpy(bank), templates, get_tokenizer(), str(tmp_path / "torch"),
        batch_size=16, image_size=64)
    assert ours.shape == theirs.shape == (40,)
    assert ((ours >= 0) & (ours <= 1)).all()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=WEIGHT_TOL, rtol=0)
    with open(tmp_path / "torch" / "all_labels.json") as f, \
            open(tmp_path / "jax" / "all_labels.json") as g:
        assert json.load(f) == json.load(g)


def test_both_mains_extract_group_weights(fixture):
    out = fixture["base"] / "mains"
    common = ["--dataset-type", "synthetic", "--model", "ViT-tiny-test", "--precision", "fp32",
              "--pretrained", fixture["pretrained"], "--batch-size", "24", "--workers", "2"]
    for pkg, main, extra in (("jax", jax_main.main, []),
                             ("torch", torch_main.main, ["--device", "cpu"])):
        assert main([*common, "--logs", str(out / pkg / "logs"),
                     "--extract-group-weight-path", str(out / pkg), *extra]) == 0
    ours = np.load(out / "torch" / "group_weights.npy")
    assert ours.shape == (64,) and ours.dtype == np.float32   # the fixture's 64 train images
    np.testing.assert_allclose(ours, np.load(out / "jax" / "group_weights.npy"),
                               atol=WEIGHT_TOL, rtol=0)
    with open(out / "torch" / "all_labels.json") as f, open(out / "jax" / "all_labels.json") as g:
        labels = json.load(f)
        assert labels == json.load(g) and len(labels) == 64
    assert labels[0]["per_image_text"].startswith("a per image caption about")


def test_decode_matches_jax():
    ours, theirs = get_tokenizer(), jax_get_tokenizer()
    with open(GOLDEN) as f:
        golden = json.load(f)
    for ids in golden["ids"]:
        assert ours.decode(ids) == theirs.decode(ids)
    for text in ("a photo of a dog", "naïve café, 3.5 km!", "zigzagged texture."):
        assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))
    assert ours.decode(ours.encode("a photo of a dog")) == "a photo of a dog "
    # byte-level pieces that are not UTF-8 alone (the halves of "é"), and an
    # id past the merges (the special tokens decode to their own names)
    split = [ours.encoder[ours.byte_encoder[b]] for b in "é".encode()[:1]] + [49406, 49407]
    assert ours.decode(split) == theirs.decode(split)
