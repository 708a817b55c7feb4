"""AugMix views for test-time adaptation (port of
``latteclip_tpu/data/augmix.py``).

The reference's TTA input recipe (``datautils.py:93-127``,
``augmix_ops.py``): for each test image, ``1 + n_views`` crops, the plain
resize and centre crop first, then ``n_views`` AugMix mixes of a random
resized crop (scale 0.5-1, a horizontal flip half the time). PIL operations,
bounded by the severity, mixed with Dirichlet and Beta weights. Every draw
comes from the caller's ``np.random.Generator`` in the JAX package's order,
so one seed gives byte-equal views in both packages.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
from PIL import Image, ImageOps

from latteclip_torch.data.transforms import eval_resize_crop, random_resized_crop

_MAX_LEVEL = 10


def _autocontrast(img, _level, _rng):
    return ImageOps.autocontrast(img)


def _equalize(img, _level, _rng):
    return ImageOps.equalize(img)


def _posterize(img, level, _rng):
    bits = 4 - int(level / _MAX_LEVEL * 4)
    return ImageOps.posterize(img, max(1, bits))


def _rotate(img, level, rng):
    degrees = level / _MAX_LEVEL * 30
    return img.rotate(degrees if rng.random() > 0.5 else -degrees)


def _solarize(img, level, _rng):
    thresh = 256 - int(level / _MAX_LEVEL * 128)
    return ImageOps.solarize(img, thresh)


def _shear_x(img, level, rng):
    v = level / _MAX_LEVEL * 0.3
    v = v if rng.random() > 0.5 else -v
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0))


def _shear_y(img, level, rng):
    v = level / _MAX_LEVEL * 0.3
    v = v if rng.random() > 0.5 else -v
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0))


def _translate_x(img, level, rng):
    v = int(level / _MAX_LEVEL * img.size[0] / 3)
    v = v if rng.random() > 0.5 else -v
    return img.transform(img.size, Image.AFFINE, (1, 0, v, 0, 1, 0))


def _translate_y(img, level, rng):
    v = int(level / _MAX_LEVEL * img.size[1] / 3)
    v = v if rng.random() > 0.5 else -v
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v))


AUGMIX_OPS: List[Callable] = [
    _autocontrast, _equalize, _posterize, _rotate, _solarize,
    _shear_x, _shear_y, _translate_x, _translate_y,
]


def augmix(
    img: Image.Image,
    rng: np.random.Generator,
    severity: int = 3,
    width: int = 3,
    depth: int = -1,
    alpha: float = 1.0,
) -> np.ndarray:
    """AugMix a PIL image -> uint8 HWC array of the same size."""
    ws = rng.dirichlet([alpha] * width).astype(np.float32)
    m = np.float32(rng.beta(alpha, alpha))
    base = np.asarray(img, dtype=np.float32)
    mix = np.zeros_like(base)
    for i in range(width):
        aug = img.copy()
        d = depth if depth > 0 else int(rng.integers(1, 4))
        for _ in range(d):
            op = AUGMIX_OPS[int(rng.integers(len(AUGMIX_OPS)))]
            aug = op(aug, rng.integers(1, severity + 1), rng)
        mix += ws[i] * np.asarray(aug, dtype=np.float32)
    out = (1 - m) * base + m * mix
    return np.clip(out, 0, 255).astype(np.uint8)


def augmix_views(
    img: Image.Image,
    image_size: int,
    n_views: int = 63,
    rng: np.random.Generator = None,
) -> np.ndarray:
    """[1 + n_views, S, S, 3] uint8: base view first, AugMix variants after
    (reference AugMixAugmenter.__call__, datautils.py:122-127)."""
    rng = rng or np.random.default_rng()
    views = [eval_resize_crop(img, image_size)]
    for _ in range(n_views):
        pre = random_resized_crop(img, image_size, rng, scale=(0.5, 1.0))
        if rng.random() < 0.5:
            pre = pre[:, ::-1]  # horizontal flip
        views.append(augmix(Image.fromarray(pre), rng))
    return np.stack(views)
