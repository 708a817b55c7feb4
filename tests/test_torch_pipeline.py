"""The port's input pipeline against ``latteclip_tpu.data`` on one fixture.

Everything here is numpy, PIL and the standard library on both sides, so
the comparisons are exact (bit-equal arrays, equal lists, equal bytes):

* ``TrainPipeline`` batches for the same seed on ``make_full_fixture``: the
  host PIL crop and the on-device canvases with their crop boxes, captions
  padded and packed at 128, and the text context cap; two epochs, so the
  decode and raw-record caches are replayed;
* the tar reader: shard patterns, the shuffled, resampled and split shard
  orders, the samples of a shard and the shuffle buffer;
* the port's ``synthetic.py`` writes byte-identical image, json, caption and
  pickle files, and tar shards with the same members and contents;
* ``FlatFileDataset`` and ``iter_batches`` (padded final batch, ``valid``);
* ``prefetch`` raises a producer's error in the consumer.
"""
import dataclasses
import os
import tarfile

import numpy as np
import pytest

from latteclip_tpu.data import pipeline as jax_pipeline
from latteclip_tpu.data import synthetic as jax_synthetic
from latteclip_tpu.data import tar_reader as jax_tar
from latteclip_tpu.data.eval_dataset import FlatFileDataset as JaxFlatFileDataset
from latteclip_tpu.data.eval_dataset import iter_batches as jax_iter_batches
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_torch.data import pipeline, synthetic, tar_reader
from latteclip_torch.data.eval_dataset import FlatFileDataset, iter_batches
from latteclip_torch.models.tokenizer import get_tokenizer

CLASSES = [c.lower().replace("_", " ") for c in synthetic.DEFAULT_CLASSES]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pipeline_fixture"))
    jax_synthetic.make_full_fixture(path, num_train=40, num_val=12, image_size=64)
    return path


def _data(mod, tok, root, cap=None):
    data = mod.build_train_data(
        os.path.join(root, "webdataset", "train_tars"),
        os.path.join(root, "clip_features_train.pkl"),
        [os.path.join(root, "captions_per_image")],
        [os.path.join(root, "captions_per_group")], CLASSES, tok)
    if cap:
        table = tok([f"a photo of a {c}." for c in CLASSES])
        data, table, eff, truncated = mod.apply_context_cap(data, cap, tok.eot_token_id, table)
        return data, (table, eff, truncated)
    return data, None


PIPE_CASES = {
    "host_crop": dict(ondevice_resize=False),
    "canvas": dict(ondevice_resize=True, canvas_size=96),
    "host_crop_packed": dict(ondevice_resize=False, text_packing_len=128),
    "canvas_packed": dict(ondevice_resize=True, canvas_size=96, text_packing_len=128),
    "canvas_capped": dict(ondevice_resize=True, canvas_size=96, cap="auto"),
    "canvas_capped_packed": dict(ondevice_resize=True, canvas_size=96, cap=24,
                                 text_packing_len=128),
    "resampled": dict(ondevice_resize=True, canvas_size=96, resampled=True, seed=3),
}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_train_batches_equal_jax(root, case):
    kw = dict(PIPE_CASES[case])
    cap = kw.pop("cap", None)
    ours_data, ours_cap = _data(pipeline, get_tokenizer(), root, cap)
    theirs_data, theirs_cap = _data(jax_pipeline, jax_get_tokenizer(), root, cap)
    if cap:
        np.testing.assert_array_equal(ours_cap[0], theirs_cap[0])
        assert ours_cap[1:] == theirs_cap[1:]
    common = dict(batch_size=16, image_size=48, num_threads=3, shuffle_buffer=8, **kw)
    ours = pipeline.TrainPipeline(ours_data, pipeline.PipelineConfig(**common), num_samples=40)
    theirs = jax_pipeline.TrainPipeline(theirs_data, jax_pipeline.PipelineConfig(**common),
                                        num_samples=40)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 3
    for epoch in range(2):
        a, b = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{case} epoch {epoch} {k}")


def test_tar_reader_equals_jax(root):
    pattern = os.path.join(root, "webdataset", "train_tars", "{00000..00001}.tar")
    shards = tar_reader.expand_shard_pattern(pattern)
    assert shards == jax_tar.expand_shard_pattern(pattern)
    tar_dir = os.path.join(root, "webdataset", "train_tars")
    assert tar_reader.expand_shard_pattern(tar_dir) == jax_tar.expand_shard_pattern(tar_dir)
    assert (tar_reader.expand_shard_pattern(f"{pattern}::{tar_dir}")
            == jax_tar.expand_shard_pattern(f"{pattern}::{tar_dir}"))
    many = [f"s{i}" for i in range(9)]
    for seed, epoch in ((0, 0), (3, 1), (7, 2002)):
        assert (tar_reader.shuffled_shards(many, seed, epoch)
                == jax_tar.shuffled_shards(many, seed, epoch))
        assert (tar_reader.resampled_shards(many, seed, epoch)
                == jax_tar.resampled_shards(many, seed, epoch))
        weights = [1.0 + i for i in range(9)]
        assert (tar_reader.resampled_shards(many, seed, epoch, weights)
                == jax_tar.resampled_shards(many, seed, epoch, weights))
    for index, count in ((0, 1), (1, 3), (2, 4)):
        assert tar_reader.split_shards(many, index, count) == jax_tar.split_shards(many, index, count)
    samples = list(tar_reader.iter_shards_samples(shards[:1]))
    assert samples == list(jax_tar.iter_shards_samples(shards[:1]))
    assert len(samples) == 40 and {"jpg", "json", "txt"} <= set(samples[0])
    for bufsize in (1, 5, 64):
        assert (list(tar_reader.ShuffleBuffer(bufsize, 11)(iter(range(50))))
                == list(jax_tar.ShuffleBuffer(bufsize, 11)(iter(range(50)))))


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = path
    return out


def _tar_members(path):
    with tarfile.open(path) as tf:
        return [(m.name, tf.extractfile(m).read()) for m in tf if m.isfile()]


def test_synthetic_fixture_is_byte_identical(tmp_path):
    ours_root, theirs_root = str(tmp_path / "ours"), str(tmp_path / "theirs")
    ours = synthetic.make_full_fixture(ours_root, num_train=12, num_val=6, image_size=48)
    theirs = jax_synthetic.make_full_fixture(theirs_root, num_train=12, num_val=6, image_size=48)
    assert ours["ids"] == theirs["ids"]
    a, b = _files(ours_root), _files(theirs_root)
    assert sorted(a) == sorted(b)
    for rel in a:
        if rel.endswith(".tar"):
            assert _tar_members(a[rel]) == _tar_members(b[rel]), rel
        else:
            with open(a[rel], "rb") as f, open(b[rel], "rb") as g:
                assert f.read() == g.read(), rel


@pytest.mark.parametrize("batch,pad_final,drop_last", [(5, True, False), (5, False, False),
                                                       (5, False, True), (12, True, False)])
def test_eval_reader_equals_jax(root, batch, pad_final, drop_last):
    ours = FlatFileDataset(root, image_size=40, dataset_name="dtd")
    theirs = JaxFlatFileDataset(root, image_size=40, dataset_name="dtd")
    assert ours.image_ids == theirs.image_ids
    assert ours.display_class_names == theirs.display_class_names
    assert [t("x") for t in ours.templates] == [t("x") for t in theirs.templates]
    a = list(iter_batches(ours, batch, num_threads=2, pad_final=pad_final, drop_last=drop_last))
    b = list(jax_iter_batches(theirs, batch, num_threads=2, pad_final=pad_final,
                              drop_last=drop_last))
    assert len(a) == len(b)
    for (ia, xa, la, va), (ib, xb, lb, vb) in zip(a, b):
        assert ia == ib and va == vb
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(la, lb)


def test_prefetch_raises_producer_errors():
    def producer():
        yield {"x": np.zeros(2)}
        raise OSError("shard vanished")

    it = pipeline.prefetch(producer())
    assert next(it)["x"].shape == (2,)
    with pytest.raises(OSError, match="shard vanished"):
        next(it)


def test_native_jpeg_is_refused(root):
    data, _ = _data(pipeline, get_tokenizer(), root)
    cfg = dataclasses.replace(pipeline.PipelineConfig(), use_native_jpeg=True)
    with pytest.raises(ValueError, match="not ported"):
        pipeline.TrainPipeline(data, cfg, num_samples=8)
