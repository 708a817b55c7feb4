"""2-D sin-cos positional embeddings (port of ``latteclip_tpu/models/pos_embed.py``),
for ``VisionConfig.pos_embed_type == "sin_cos_2d"``."""
from __future__ import annotations

import numpy as np


def sincos_1d(embed_dim: int, positions: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", positions.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int, cls_token: bool = True) -> np.ndarray:
    """[grid**2 (+1), embed_dim] fixed embedding (float32); row 0 is zeros
    for the class token where ``cls_token``."""
    assert embed_dim % 2 == 0
    grid = np.arange(grid_size, dtype=np.float64)
    ww, hh = np.meshgrid(grid, grid)
    pos = np.concatenate([sincos_1d(embed_dim // 2, hh), sincos_1d(embed_dim // 2, ww)], axis=1)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos.astype(np.float32)
