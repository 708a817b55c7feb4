"""Image normalization for the eval path (port of the eval half of
``latteclip_tpu/data/transforms.py``: ``OPENAI_MEAN``/``OPENAI_STD``,
``model_mean_std`` and ``normalize_images``). Host-side resize/crop and the
train augmentations come with the training slice."""
from __future__ import annotations

from typing import Tuple

import torch

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


def model_mean_std(cfg) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """The config's image_mean/image_std when set, else OpenAI CLIP's."""
    mean = getattr(cfg, "image_mean", None) or OPENAI_MEAN
    std = getattr(cfg, "image_std", None) or OPENAI_STD
    return tuple(mean), tuple(std)


def normalize_images(batch_u8: torch.Tensor, mean: Tuple[float, ...] = OPENAI_MEAN,
                     std: Tuple[float, ...] = OPENAI_STD) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalized float32 [B, H, W, 3]."""
    x = batch_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s
