"""Image normalization and the train colour augment (port of
``latteclip_tpu/data/transforms.py``: ``OPENAI_MEAN``/``OPENAI_STD``,
``model_mean_std``, ``normalize_images``, ``AugConfig``, ``color_augment``
and ``train_augment_normalize`` without crop boxes).

The augment is LatteCLIP's forced recipe: colour jitter (0.5, 0.5, 0.5, 0.1)
with p = 0.8 and grayscale with p = 0.2, on the device, batched, in NHWC, with
the JAX package's arithmetic (jitter sub-ops in the fixed order brightness,
contrast, saturation, hue). Its random draws come from an explicit
``torch.Generator``; ``factors=`` takes them from the caller instead, so a
test can hand both packages the same draws. The on-device random resized crop
(``device_random_resized_crop``) is not ported yet (ROADMAP.md, section 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)

# ITU-R 601-2 luma weights (torchvision rgb_to_grayscale)
_LUMA = (0.2989, 0.587, 0.114)
FACTOR_NAMES = ("brightness", "contrast", "saturation", "hue", "jitter_draw", "gray_draw")


@dataclasses.dataclass(frozen=True)
class AugConfig:
    """LatteCLIP's forced train augmentation (reference main.py:233-235).
    The crop's scale range comes with the crop (ROADMAP.md, section 1)."""

    color_jitter: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 0.1)
    color_jitter_prob: float = 0.8
    gray_scale_prob: float = 0.2


def model_mean_std(cfg) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """The config's image_mean/image_std when set, else OpenAI CLIP's."""
    mean = getattr(cfg, "image_mean", None) or OPENAI_MEAN
    std = getattr(cfg, "image_std", None) or OPENAI_STD
    return tuple(mean), tuple(std)


def _standardize(x: torch.Tensor, mean, std) -> torch.Tensor:
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


def train_augment_normalize(batch_u8: torch.Tensor, generator: Optional[torch.Generator],
                            aug: AugConfig = AugConfig(), mean: Tuple[float, ...] = OPENAI_MEAN,
                            std: Tuple[float, ...] = OPENAI_STD,
                            factors: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> colour-augmented, normalized float32 (train path)."""
    x = color_augment(batch_u8.float() / 255.0, generator, aug, factors)
    return _standardize(x, mean, std)
