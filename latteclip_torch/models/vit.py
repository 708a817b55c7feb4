"""Vision transformer tower (port of ``latteclip_tpu/models/vit.py``).

Images are NHWC ``[B, H, W, 3]`` at :func:`vit_forward`, as in JAX. The
stride-P patch convolution runs as patchify + one matmul against
``conv1.weight`` reshaped to ``[D, P*P*3]``; class token, learned positions,
pre-LN stack, ``ln_post``, token or average pooling and the projection
follow OpenCLIP's ``VisionTransformer``.

Pair-packing: at ViT-B/32's L=50, two images share one row of 100 tokens
and the segment-masked kernel keeps each image to itself, with exactly the
same attention math. The port packs only when that kernel will run (a bf16
CUDA tensor, even batch, 2L <= 128, head_dim 64 or 128); ``pack_pairs=``
overrides the rule, so a test can force it on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from latteclip_torch.config import VisionConfig
from latteclip_torch.kernels import kernel_route
from latteclip_torch.models import layers


class VisionTransformer(nn.Module):
    """Parameters under OpenCLIP's ``visual.*`` names."""

    def __init__(self, cfg: VisionConfig, embed_dim: int):
        super().__init__()
        if cfg.pool_type not in ("tok", "avg"):
            raise NotImplementedError(f"vision pool_type {cfg.pool_type!r} is not ported")
        D, P = cfg.width, cfg.patch_size
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, D, kernel_size=P, stride=P, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(D))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.seq_len, D))
        self.ln_pre = layers.LayerNorm(D, eps=cfg.ln_eps)
        self.transformer = layers.Transformer(D, cfg.layers, cfg.heads, cfg.mlp_ratio, cfg.ln_eps)
        self.ln_post = layers.LayerNorm(D, eps=cfg.ln_eps)
        self.proj = nn.Parameter(torch.empty(D, embed_dim))


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch*patch*C] patch vectors in (i, j, c) order."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def pack_pairs_auto(B: int, L: int, cfg: VisionConfig, dtype: torch.dtype,
                    device: torch.device, attention: str = "kernel") -> bool:
    """Pack two images per row only where the segment-masked kernel runs."""
    return (B % 2 == 0 and 2 * L <= 128
            and kernel_route(3 * cfg.width, cfg.heads, dtype, device, attention))


def vit_forward(
    visual: VisionTransformer,
    images: torch.Tensor,
    *,
    dtype: torch.dtype = torch.bfloat16,
    quick_gelu: bool = False,
    attention: str = "kernel",
    pack_pairs: Optional[bool] = None,
    ln_linear: str = "unfused",
) -> torch.Tensor:
    """Images [B, H, W, 3] -> pooled features [B, embed_dim] (float32).
    ``attention`` and ``ln_linear`` select the routes of
    :meth:`layers.ResidualAttentionBlock.forward`."""
    cfg = visual.cfg
    act = layers.activation(quick_gelu)
    B = images.shape[0]
    P = cfg.patch_size
    # conv1.weight [D, 3, P, P] -> [D, P*P*3] in patchify's (i, j, c) order
    w = visual.conv1.weight.permute(0, 2, 3, 1).reshape(cfg.width, P * P * 3)
    x = layers.dense(patchify(images, P), w, None, dtype)               # [B, N, D]
    cls = visual.class_embedding.to(dtype).expand(B, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + visual.positional_embedding.to(dtype)
    x = visual.ln_pre(x)

    L = x.shape[1]
    if pack_pairs is None:
        pack_pairs = pack_pairs_auto(B, L, cfg, dtype, x.device, attention)
    if pack_pairs:
        if B % 2:
            raise ValueError(f"pair-packing needs an even batch, got {B}")
        seg = torch.arange(1, 3, dtype=torch.int32, device=x.device).repeat_interleave(L)
        x = visual.transformer(
            x.reshape(B // 2, 2 * L, cfg.width), causal=False, act=act, dtype=dtype,
            seg_ids=seg.expand(B // 2, 2 * L), attention=attention, ln_linear=ln_linear)
        x = x.reshape(B, L, cfg.width)
    else:
        x = visual.transformer(x, causal=False, act=act, dtype=dtype, attention=attention,
                               ln_linear=ln_linear)

    x = visual.ln_post(x)
    pooled = x[:, 1:].mean(dim=1) if cfg.pool_type == "avg" else x[:, 0]
    return layers.dense(pooled, visual.proj.t(), None, dtype).float()
