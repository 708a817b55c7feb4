"""Image geometry, normalization and the train augment (port of
``latteclip_tpu/data/transforms.py``: ``OPENAI_MEAN``/``OPENAI_STD``,
``model_mean_std``, the host geometry ``eval_resize_crop``,
``random_crop_box``, ``random_resized_crop`` and ``load_rgb`` (PIL),
``normalize_images``, ``AugConfig``, ``color_augment``,
``device_random_resized_crop`` and ``train_augment_normalize``).

The augment is LatteCLIP's forced recipe: colour jitter (0.5, 0.5, 0.5, 0.1)
with p = 0.8 and grayscale with p = 0.2, on the device, batched, in NHWC, with
the JAX package's arithmetic (jitter sub-ops in the fixed order brightness,
contrast, saturation, hue). Its random draws come from an explicit
``torch.Generator``; ``factors=`` takes them from the caller instead, so a
test can hand both packages the same draws.

The on-device random resized crop reproduces ``jax.image.scale_and_translate``
with the Keys cubic kernel and antialiasing: per sample and axis an explicit
``[in, out]`` weight matrix (sample positions, the kernel widened by the
downsampling factor, renormalised columns, zero columns for samples outside
the input), built on the device in float32, then two batched matmuls.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from latteclip_torch.obs.trace import span

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)

# ITU-R 601-2 luma weights (torchvision rgb_to_grayscale)
_LUMA = (0.2989, 0.587, 0.114)
FACTOR_NAMES = ("brightness", "contrast", "saturation", "hue", "jitter_draw", "gray_draw")


@dataclasses.dataclass(frozen=True)
class AugConfig:
    """LatteCLIP's forced train augmentation (reference main.py:233-235)."""

    scale_min: float = 0.9
    scale_max: float = 1.0
    color_jitter: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 0.1)
    color_jitter_prob: float = 0.8
    gray_scale_prob: float = 0.2


def model_mean_std(cfg) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """The config's image_mean/image_std when set, else OpenAI CLIP's."""
    mean = getattr(cfg, "image_mean", None) or OPENAI_MEAN
    std = getattr(cfg, "image_std", None) or OPENAI_STD
    return tuple(mean), tuple(std)


def eval_resize_crop(img: Image.Image, size: int, resize_mode: str = "shortest") -> np.ndarray:
    """Eval geometry -> uint8 [size, size, 3]: ``shortest`` resizes the
    shortest edge to ``size`` (bicubic, the long edge truncated as
    torchvision does) and centre-crops; ``squash`` resizes both edges;
    ``longest`` resizes the longest edge and pads the other with black."""
    w, h = img.size
    if resize_mode == "squash":
        return np.asarray(img.resize((size, size), Image.BICUBIC), dtype=np.uint8)
    if resize_mode == "longest":
        scale = size / max(w, h)
        new_w, new_h = max(1, round(w * scale)), max(1, round(h * scale))
        img = img.resize((new_w, new_h), Image.BICUBIC)
        canvas = np.zeros((size, size, 3), np.uint8)
        top, left = (size - new_h) // 2, (size - new_w) // 2
        canvas[top:top + new_h, left:left + new_w] = np.asarray(img, dtype=np.uint8)
        return canvas
    if resize_mode != "shortest":
        raise ValueError(f"unknown resize_mode: {resize_mode}")
    if w <= h:
        new_w, new_h = size, max(size, int(size * h / w))
    else:
        new_w, new_h = max(size, int(size * w / h)), size
    img = img.resize((new_w, new_h), Image.BICUBIC)
    left = int(round((new_w - size) / 2.0))
    top = int(round((new_h - size) / 2.0))
    return np.asarray(img.crop((left, top, left + size, top + size)), dtype=np.uint8)


def random_crop_box(w: int, h: int, rng: np.random.Generator,
                    scale: Tuple[float, float] = (0.9, 1.0),
                    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box sampling -> (left, top, cw, ch):
    ten tries at an area and log-aspect draw, then a centre crop at the
    clamped aspect."""
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            return left, top, cw, ch
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def random_resized_crop(img: Image.Image, size: int, rng: np.random.Generator,
                        scale: Tuple[float, float] = (0.9, 1.0),
                        ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)) -> np.ndarray:
    """RandomResizedCrop on the host (PIL bicubic) -> uint8 [size, size, 3]."""
    left, top, cw, ch = random_crop_box(*img.size, rng, scale, ratio)
    img = img.resize((size, size), Image.BICUBIC, box=(left, top, left + cw, top + ch))
    return np.asarray(img, dtype=np.uint8)


def load_rgb(path_or_file) -> Image.Image:
    img = Image.open(path_or_file)
    return img.convert("RGB") if img.mode != "RGB" else img


def _standardize(x: torch.Tensor, mean, std) -> torch.Tensor:
    with span("wait"):  # on CUDA each copy of a host list waits for the stream to drain
        m = torch.tensor(mean, dtype=torch.float32, device=x.device)
        s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def normalize_images(batch_u8: torch.Tensor, mean: Tuple[float, ...] = OPENAI_MEAN,
                     std: Tuple[float, ...] = OPENAI_STD) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalized float32 [B, H, W, 3]."""
    return _standardize(batch_u8.float() / 255.0, mean, std)


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    g = x[..., 0] * _LUMA[0] + x[..., 1] * _LUMA[1] + x[..., 2] * _LUMA[2]
    return g[..., None]


def _rgb_to_hsv(x: torch.Tensor):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.amax(dim=-1)
    minc = x.amin(dim=-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-8), 0.0)
    safe_delta = delta.clamp_min(1e-8)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return h, s, maxc


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """channel_n = v - v*s*clip(min(k, 4-k), 0, 1) with k = (n + 6h) mod 6."""

    def channel(n: float) -> torch.Tensor:
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=-1)


def _blend(a: torch.Tensor, b: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return torch.clamp(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def draw_color_factors(batch: int, generator: torch.Generator, aug: AugConfig,
                       device) -> Dict[str, torch.Tensor]:
    """The six per-image draws of :func:`color_augment`, each [B] float32:
    the brightness, contrast, saturation and hue factors, and the two
    uniforms that decide jitter and grayscale."""
    bf, cf, sf, hf = aug.color_jitter

    def u(lo, hi):
        r = torch.rand(batch, generator=generator, device=device, dtype=torch.float32)
        return lo + (hi - lo) * r

    return {
        "brightness": u(max(0.0, 1 - bf), 1 + bf),
        "contrast": u(max(0.0, 1 - cf), 1 + cf),
        "saturation": u(max(0.0, 1 - sf), 1 + sf),
        "hue": u(-hf, hf),
        "jitter_draw": u(0.0, 1.0),
        "gray_draw": u(0.0, 1.0),
    }


def color_augment(x: torch.Tensor, generator: Optional[torch.Generator], aug: AugConfig,
                  factors: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Batched colour jitter + random grayscale on float32 [B, H, W, 3] in
    [0, 1]. The draws come from ``generator`` unless ``factors`` (the keys of
    :data:`FACTOR_NAMES`, each [B]) gives them."""
    if factors is None:
        factors = draw_color_factors(x.shape[0], generator, aug, x.device)
    f = {k: factors[k].to(x.device, torch.float32).reshape(-1, 1, 1, 1) for k in FACTOR_NAMES}
    jittered = _blend(x, torch.zeros_like(x), f["brightness"])
    mean_gray = _grayscale(jittered).mean(dim=(1, 2, 3), keepdim=True)
    jittered = _blend(jittered, mean_gray.expand_as(jittered), f["contrast"])
    jittered = _blend(jittered, _grayscale(jittered).expand_as(jittered), f["saturation"])
    h, s, v = _rgb_to_hsv(jittered)
    h = torch.remainder(h + f["hue"][..., 0], 1.0)
    jittered = torch.clamp(_hsv_to_rgb(h, s, v), 0.0, 1.0)
    x = torch.where(f["jitter_draw"] < aug.color_jitter_prob, jittered, x)
    return torch.where(f["gray_draw"] < aug.gray_scale_prob, _grayscale(x).expand_as(x), x)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def crop_weights(in_size: int, out_size: int, start: torch.Tensor,
                 extent: torch.Tensor) -> torch.Tensor:
    """Per-sample resampling matrices [B, in_size, out_size] (float32) that
    map the span [start, start + extent) of an axis onto ``out_size``
    pixels: ``scale_and_translate``'s ``compute_weight_mat`` with the Keys
    cubic kernel, antialiased, at scale ``out / extent`` and translation
    ``-start * out / extent``."""
    dev = start.device
    scale = out_size / extent
    translation = -start * out_size / extent
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    sample_f = (out_pos[None, :] * inv_scale[:, None] - (translation * inv_scale)[:, None]
                - 0.5)                                                    # [B, out]
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_pos[None, :, None]).abs() / kernel_scale[:, None, None]
    weights = _keys_cubic(x)                                              # [B, in, out]
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def device_random_resized_crop(batch_u8: torch.Tensor, boxes: torch.Tensor,
                               size: int) -> torch.Tensor:
    """uint8 canvases [B, CV, CV, 3] and crop boxes [B, 4] (left, top, cw,
    ch in canvas pixels) -> float32 [B, size, size, 3] in [0, 255]: the
    separable antialiased Keys-cubic resample of each box, as two batched
    matmuls (rows, then columns)."""
    B, H, W, C = batch_u8.shape
    boxes = boxes.to(batch_u8.device, torch.float32)
    left, top, cw, ch = boxes.unbind(dim=1)
    wy = crop_weights(H, size, top, ch)                                  # [B, H, S]
    wx = crop_weights(W, size, left, cw)                                 # [B, W, S]
    x = batch_u8.float().reshape(B, H, W * C)
    rows = torch.bmm(wy.transpose(1, 2), x).reshape(B, size, W, C)       # [B, S, W, C]
    cols = torch.bmm(rows.permute(0, 1, 3, 2).reshape(B, size * C, W), wx)  # [B, S*C, S]
    return cols.reshape(B, size, C, size).permute(0, 1, 3, 2)


def train_augment_normalize(batch_u8: torch.Tensor, generator: Optional[torch.Generator],
                            aug: AugConfig = AugConfig(), mean: Tuple[float, ...] = OPENAI_MEAN,
                            std: Tuple[float, ...] = OPENAI_STD,
                            factors: Optional[Dict[str, torch.Tensor]] = None,
                            boxes: Optional[torch.Tensor] = None,
                            size: int = 224) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> colour-augmented, normalized float32 (train
    path). With ``boxes`` the images are canvases and the random resized
    crop to ``size`` runs first, on the device."""
    if boxes is not None:
        x = device_random_resized_crop(batch_u8, boxes, size).clamp(0.0, 255.0) / 255.0
    else:
        x = batch_u8.float() / 255.0
    x = color_augment(x, generator, aug, factors)
    return _standardize(x, mean, std)
