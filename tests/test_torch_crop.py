"""The port's crop and host geometry against ``latteclip_tpu.data.transforms``.

* ``device_random_resized_crop``: the port builds the same Keys-cubic,
  antialiased weight matrices as ``jax.image.scale_and_translate`` (the
  formula of ``compute_weight_mat``) and applies them as two batched
  matmuls, in float32. Its sample positions ``(i + 0.5) / scale -
  translation / scale - 0.5`` carry float32 rounding of about one ulp of the
  position (7.6e-6 at 96 pixels, 1.5e-5 past 128), and the Keys kernel's
  slope times a pixel value of up to 255 turns that ulp into up to 1e-2 of
  output. JAX's own float32 result moves by as much with the way XLA
  compiles it: on the CPU its eager and jitted evaluations of one crop
  differ by 1.2e-2 at [8, 256, 256] -> 224, so a bound of 1e-3 against JAX
  cannot hold for any float32 implementation. The crop is therefore held
  (a) against the same formula evaluated in float64, within 1.5e-2 in
  [0, 255] units (JAX's jitted crop is 8.8e-3 from it at that shape), (b)
  against JAX's jitted crop, within 2e-2 at the maximum (1/50 of one uint8
  level) and 1e-3 in the mean, and (c) against JAX within 1e-3 where the
  positions are exact (the identity box at the canvas size);
* on non-square images through the pipeline's edge-replicated canvases, a
  constant image stays within 2 levels of its value (tests/test_ondevice_resize.py);
* ``train_augment_normalize(boxes=)`` with the colour augment off (p = 0)
  equals JAX's, within the crop's bound divided by the smallest std;
* the host geometry (``random_crop_box``, ``random_resized_crop``,
  ``eval_resize_crop``) is bit-equal: the same numpy draws and PIL calls.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from latteclip_tpu.data import transforms as JT
from latteclip_tpu.data.pipeline import LatteCLIPTrainData as JaxTrainData
from latteclip_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from latteclip_tpu.data.pipeline import TrainPipeline as JaxTrainPipeline
from latteclip_torch.data import transforms as T
from latteclip_torch.data.pipeline import LatteCLIPTrainData, PipelineConfig, TrainPipeline

CROP_CASES = [(6, 96, 224), (8, 256, 224), (8, 96, 48), (4, 64, 48), (3, 120, 64)]


def _f64_crop(imgs, boxes, size):
    """scale_and_translate's formula (Keys cubic, antialiased) in float64."""
    out = []
    for img, (left, top, cw, ch) in zip(imgs.astype(np.float64), boxes.astype(np.float64)):
        mats = []
        for n, start, extent in ((img.shape[0], top, ch), (img.shape[1], left, cw)):
            scale = size / extent
            inv = 1.0 / scale
            sf = (np.arange(size) + 0.5) * inv - (-start * size / extent) * inv - 0.5
            x = np.abs(sf[None, :] - np.arange(n)[:, None]) / max(inv, 1.0)
            w = np.where(x >= 1, ((-0.5 * x + 2.5) * x - 4) * x + 2, ((1.5 * x - 2.5) * x) * x + 1)
            w = np.where(x >= 2, 0.0, w)
            total = w.sum(0, keepdims=True)
            w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                         w / np.where(total != 0, total, 1), 0.0)
            mats.append(np.where(((sf >= -0.5) & (sf <= n - 0.5))[None, :], w, 0.0))
        out.append(np.einsum("hwc,hy,wx->yxc", img, mats[0], mats[1], optimize=True))
    return np.stack(out)


def _inputs(n, cv, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, cv, cv, 3)).astype(np.uint8)
    boxes = np.stack([rng.uniform(0, cv / 6, n), rng.uniform(0, cv / 6, n),
                      rng.uniform(cv * 0.5, cv * 0.8, n), rng.uniform(cv * 0.5, cv * 0.8, n)],
                     1).astype(np.float32)
    return imgs, boxes


def _jax_crop(imgs, boxes, size):
    fn = jax.jit(JT.device_random_resized_crop, static_argnums=2)
    return np.asarray(fn(jnp.asarray(imgs), jnp.asarray(boxes), size))


@pytest.mark.parametrize("n,cv,size", CROP_CASES)
def test_crop_matches_formula_in_float64(n, cv, size):
    imgs, boxes = _inputs(n, cv)
    ours = T.device_random_resized_crop(torch.from_numpy(imgs), torch.from_numpy(boxes), size)
    assert ours.dtype == torch.float32 and ours.shape == (n, size, size, 3)
    assert np.abs(ours.numpy() - _f64_crop(imgs, boxes, size)).max() <= 1.5e-2


@pytest.mark.parametrize("n,cv,size", CROP_CASES)
def test_crop_matches_jax(n, cv, size):
    imgs, boxes = _inputs(n, cv)
    ours = T.device_random_resized_crop(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                        size).numpy()
    diff = np.abs(ours - _jax_crop(imgs, boxes, size))
    assert diff.max() <= 2e-2 and diff.mean() <= 1e-3


@pytest.mark.parametrize("cv", [64, 96])
def test_identity_crop_matches_jax_tightly(cv):
    imgs, _ = _inputs(4, cv, seed=1)
    boxes = np.tile(np.asarray([0, 0, cv, cv], np.float32), (4, 1))
    ours = T.device_random_resized_crop(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                        cv).numpy()
    assert np.abs(ours - _jax_crop(imgs, boxes, cv)).max() <= 1e-3
    assert np.abs(ours - imgs).max() <= 1e-3


def _jpeg(w, h, value=128):
    buf = io.BytesIO()
    Image.fromarray(np.full((h, w, 3), value, np.uint8)).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


@pytest.mark.parametrize("w,h", [(120, 80), (70, 130)])
def test_nonsquare_canvas_and_crop_match_jax(w, h):
    CV, size = 96, 64
    raw = {"__key__": "x", "jpg": _jpeg(w, h)}
    kw = dict(shards=[], class_names=["a"], zs_top1={"x": 0}, per_image_tokens=[],
              group_tokens={}, class_to_image_ids={0: ["x"]}, gt_label={})
    ours = TrainPipeline(LatteCLIPTrainData(**kw), PipelineConfig(
        batch_size=1, image_size=size, ondevice_resize=True, canvas_size=CV), num_samples=1)
    theirs = JaxTrainPipeline(JaxTrainData(**kw), JaxPipelineConfig(
        batch_size=1, image_size=size, ondevice_resize=True, canvas_size=CV), num_samples=1)
    s = ours._assemble_ondevice(raw, "x", raw["jpg"], np.random.default_rng(0))
    j = theirs._assemble_ondevice(raw, "x", raw["jpg"], np.random.default_rng(0))
    np.testing.assert_array_equal(s["image"], j["image"])
    np.testing.assert_array_equal(s["crop_box"], j["crop_box"])
    out = T.device_random_resized_crop(torch.from_numpy(s["image"][None]),
                                       torch.from_numpy(s["crop_box"][None]), size).numpy()
    assert np.abs(out - 128.0).max() < 2.0
    assert np.abs(out - _jax_crop(s["image"][None], s["crop_box"][None], size)).max() <= 2e-2


def test_train_augment_normalize_with_boxes_matches_jax():
    imgs, boxes = _inputs(4, 96, seed=2)
    aug_t = T.AugConfig(color_jitter_prob=0.0, gray_scale_prob=0.0)
    aug_j = JT.AugConfig(color_jitter_prob=0.0, gray_scale_prob=0.0)
    ours = T.train_augment_normalize(torch.from_numpy(imgs), torch.Generator().manual_seed(0),
                                     aug_t, boxes=torch.from_numpy(boxes), size=64).numpy()
    theirs = np.asarray(jax.jit(
        lambda x, b: JT.train_augment_normalize(x, jax.random.PRNGKey(0), aug_j, boxes=b,
                                                size=64))(jnp.asarray(imgs), jnp.asarray(boxes)))
    assert ours.shape == theirs.shape == (4, 64, 64, 3)
    assert np.abs(ours - theirs).max() <= 2e-2 / 255.0 / min(T.OPENAI_STD)


@pytest.mark.parametrize("seed", range(4))
def test_random_crop_box_matches_jax(seed):
    for w, h in ((64, 64), (120, 80), (80, 300), (500, 60)):
        for scale in ((0.9, 1.0), (0.08, 1.0)):
            ours = T.random_crop_box(w, h, np.random.default_rng(seed), scale)
            assert ours == JT.random_crop_box(w, h, np.random.default_rng(seed), scale)


def test_host_geometry_matches_jax():
    img = Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 80, 3)).astype(np.uint8))
    np.testing.assert_array_equal(T.random_resized_crop(img, 32, np.random.default_rng(3)),
                                  JT.random_resized_crop(img, 32, np.random.default_rng(3)))
    for mode in ("shortest", "squash", "longest"):
        np.testing.assert_array_equal(T.eval_resize_crop(img, 32, mode),
                                      JT.eval_resize_crop(img, 32, mode))
    with pytest.raises(ValueError):
        T.eval_resize_crop(img, 32, "nope")
