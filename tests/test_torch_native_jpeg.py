"""The port's native JPEG decoder (latteclip_torch/native/) against the JAX
package's (latteclip_tpu/native/):

* ``fastjpeg.c`` is a byte-identical copy;
* the port builds it with the host's C compiler into ``build/native/`` at
  the repository root (never beside the source) and says so in
  ``build_status``; a compiler that fails gives None and the reason,
  ``LATTECLIP_DISABLE_NATIVE=1`` turns it off, and a cached library that
  does not load (built on another host) is built again;
* ``probe`` and ``decode_crop_resize`` give JAX's module's bytes on the same
  JPEG and box, at DCT scales 1/1 to 1/8;
* ``TrainPipeline`` batches with ``use_native_jpeg=True`` equal JAX's for
  two epochs, every JPEG decoded natively (``decode_counts``); with the
  decoder off they fall back to PIL and equal JAX's fallback batches.
"""
import filecmp
import io
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import latteclip_tpu.native as jax_native
import latteclip_torch.native as native
from latteclip_tpu.data import pipeline as jax_pipeline
from latteclip_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from latteclip_torch.data import pipeline
from latteclip_torch.models.tokenizer import get_tokenizer

from test_torch_pipeline import _data, root  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def test_source_is_byte_identical():
    assert filecmp.cmp(REPO / "latteclip_tpu" / "native" / "fastjpeg.c", native.SOURCE,
                       shallow=False)


def test_builds_under_build_native():
    st = native.build_status()
    assert st["loaded"] and st["error"] is None, st
    assert Path(st["path"]).parent == REPO / "build" / "native"
    assert not list(native.SOURCE.parent.glob("*.so"))


def test_failed_build_and_switch_give_none(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    native.load_fastjpeg.cache_clear()
    try:
        assert native.load_fastjpeg() is None
        assert not native.build_status()["loaded"] and "no-such-compiler" in \
            native.build_status()["error"]
        native.load_fastjpeg.cache_clear()
        monkeypatch.setenv("LATTECLIP_DISABLE_NATIVE", "1")
        assert native.load_fastjpeg() is None
    finally:
        native.load_fastjpeg.cache_clear()
        monkeypatch.undo()
        native.load_fastjpeg()


def test_a_library_that_does_not_load_is_built_again(tmp_path, monkeypatch):
    """A cached library from another host (here: bytes that are no library)
    is rebuilt in place and loads."""
    import hashlib

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    digest = hashlib.sha256(native.SOURCE.read_bytes()).hexdigest()[:12]
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / f"_fastjpeg_{digest}.so").write_bytes(b"not a library")
    native.load_fastjpeg.cache_clear()
    try:
        assert native.load_fastjpeg() is not None and native.build_status()["loaded"]
    finally:
        native.load_fastjpeg.cache_clear()
        monkeypatch.undo()
        native.load_fastjpeg()


def _jpeg(w, h, seed):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(1, h // 8), max(1, w // 8), 3), dtype=np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BICUBIC)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("w,h,box,out", [
    (640, 480, (0, 0, 640, 480), 224),     # whole image, DCT scale 1/2
    (640, 480, (100, 50, 300, 200), 224),  # a crop, scale 1/1
    (2000, 1500, (0, 0, 2000, 1500), 224),  # scale 1/8
    (333, 517, (10, 20, 200, 300), 96),
])
def test_decode_equals_jax(w, h, box, out):
    ours, theirs = native.load_fastjpeg(), jax_native.load_fastjpeg()
    assert ours is not None and theirs is not None
    data = _jpeg(w, h, seed=w + h)
    assert ours.probe(data) == theirs.probe(data) == (w, h)
    a = ours.decode_crop_resize(data, *box, out)
    assert len(a) == out * out * 3 and a == theirs.decode_crop_resize(data, *box, out)
    with pytest.raises(ValueError):
        ours.decode_crop_resize(b"not a jpeg", 0, 0, 1, 1, 8)


@pytest.mark.parametrize("disabled", [False, True], ids=["native", "pil_fallback"])
def test_train_batches_equal_jax(root, disabled, monkeypatch):  # noqa: F811
    if disabled:
        monkeypatch.setenv("LATTECLIP_DISABLE_NATIVE", "1")
    for mod in (native, jax_native):
        mod.load_fastjpeg.cache_clear()
    try:
        common = dict(batch_size=16, image_size=48, num_threads=3, shuffle_buffer=8,
                      use_native_jpeg=True)
        ours = pipeline.TrainPipeline(_data(pipeline, get_tokenizer(), root)[0],
                                      pipeline.PipelineConfig(**common), num_samples=40)
        theirs = jax_pipeline.TrainPipeline(_data(jax_pipeline, jax_get_tokenizer(), root)[0],
                                            jax_pipeline.PipelineConfig(**common), num_samples=40)
        for epoch in range(2):
            a, b = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
            assert len(a) == len(b) == 3
            for x, y in zip(a, b):
                assert sorted(x) == sorted(y)
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"epoch {epoch} {k}")
        # every sample assembled (the loader reads past the last batch's):
        # natively, or by PIL once an image and from the decode cache after
        c = ours.decode_counts
        if disabled:
            assert c["native"] == 0 and c["pil"] == 40 and c["cached"] >= 2 * 3 * 16 - 40
        else:
            assert c["native"] >= 2 * 3 * 16 and c["pil"] == c["cached"] == 0
    finally:
        monkeypatch.undo()
        for mod in (native, jax_native):
            mod.load_fastjpeg.cache_clear()
