"""Swin Transformer vision tower (port of ``latteclip_tpu/models/swin.py``).

timm's ``swin_base_patch4_window7_224`` as OpenCLIP builds it
(``timm_pool=''``: the trunk's average pool; ``timm_proj='linear'``: an
unbiased head linear):

- patch embed: stride-4 conv (patchify and one matmul), then LayerNorm;
- four stages of pre-LN blocks with window attention over 7 x 7 windows,
  biased by a learned ``[(2w-1)^2, heads]`` table gathered through
  :func:`relative_position_index`; every odd block shifts the grid by
  ``w // 2`` and masks pairs from different regions (no shift where the
  grid is one window);
- patch merging at the input of stages 1-3: 2 x 2 neighbours concatenated
  in timm's order, LayerNorm, an unbiased linear 4C -> 2C;
- final LayerNorm, average pool, the head linear.

The attention is plain torch, as JAX runs it through ``xla_attention``
(logits and softmax in float32 over compute-dtype operands): 49-token
windows with an additive bias are not a shape for the flash kernels.
Parameter names are timm's (``visual.trunk.layers.{s}.blocks.{b}.attn.
relative_position_bias_table``, ``visual.trunk.layers.{s}.downsample.
reduction.weight``, ...).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from latteclip_torch.config import SWIN_TRUNKS, SwinVisionConfig
from latteclip_torch.kernels.fused_ln_linear import dense, layer_norm
from latteclip_torch.models import layers
from latteclip_torch.models.vit import patchify


def relative_position_index(w: int) -> np.ndarray:
    """timm/MSRA [w*w, w*w] index into a (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def shift_attn_mask(grid: int, w: int, shift: int) -> np.ndarray:
    """[nW, w*w, w*w] additive mask (0 / -1e9) of the shifted windows: the
    region labels laid out in the rolled frame, as Swin's ``img_mask``."""
    img = np.zeros((grid, grid), np.int32)
    cnt = 0
    slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    nw = grid // w
    wins = img.reshape(nw, w, nw, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return np.where(wins[:, :, None] != wins[:, None, :], -1e9, 0.0).astype(np.float32)


def biased_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """JAX ``xla_attention`` with an additive float32 ``bias``: q, k, v
    ``[B, L, H, D]`` -> ``[B, L, H, D]`` in ``dtype``; q scaled by D^-0.5 in
    ``dtype``, logits and softmax in float32, probabilities rounded to
    ``dtype`` before the product with v."""
    q = (q * q.shape[-1] ** -0.5).to(dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.to(dtype).float()) + bias.float()
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.to(dtype).float()).to(dtype)


def _partition(x: torch.Tensor, w: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * (H // w) * (W // w), w * w, C)


def _merge(x: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    C = x.shape[-1]
    return x.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, odd: bool, mlp_ratio: float,
                 eps: float):
        super().__init__()
        self.heads, self.window, self.odd = heads, window, odd
        self.norm1 = layers.LayerNorm(dim, eps=eps)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, 3 * dim)
        self.attn.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = layers.LayerNorm(dim, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.register_buffer("rel_index", torch.from_numpy(relative_position_index(window)),
                             persistent=False)
        self._masks: Dict = {}

    def _mask(self, grid: int, shift: int, device) -> torch.Tensor:
        key = (grid, shift, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shift_attn_mask(grid, self.window, shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, *, dtype: torch.dtype, residuals=None) -> torch.Tensor:
        """JAX ``_swin_block`` on ``x [B, H, W, C]``."""
        B, H, W, C = x.shape
        w, heads = self.window, self.heads
        shift = w // 2 if self.odd and H > w else 0
        a = self.attn
        h = self.norm1(x).to(dtype)
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        win = _partition(h, w)                                          # [B*nW, N, C]
        BW, N = win.shape[:2]
        qkv = dense(win, a.qkv.weight, a.qkv.bias, dtype)
        q, k, v = (t.reshape(BW, N, heads, C // heads) for t in qkv.split(C, dim=-1))
        table = a.relative_position_bias_table
        bias = table[self.rel_index.reshape(-1)].reshape(N, N, heads)
        bias = bias.permute(2, 0, 1).float()[None]                      # [1, h, N, N]
        if shift:
            mask = self._mask(H, shift, x.device)                       # [nW, N, N]
            bias = bias + mask[:, None].repeat(B, 1, 1, 1)              # [B*nW, h, N, N]
        out = biased_attention(q, k, v, bias, dtype).reshape(BW, N, C)
        out = _merge(dense(out, a.proj.weight, a.proj.bias, dtype), w, B, H, W)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = x + out
        h = self.norm2(x).to(dtype)
        h = layers.gelu(dense(h, self.mlp.fc1.weight, self.mlp.fc1.bias, dtype))
        return x + dense(h, self.mlp.fc2.weight, self.mlp.fc2.bias, dtype)


class SwinTower(nn.Module):
    def __init__(self, cfg: SwinVisionConfig, embed_dim: int):
        super().__init__()
        t = SWIN_TRUNKS[cfg.trunk]
        D0, P, w, eps = t["embed_dim"], t["patch_size"], t["window"], cfg.ln_eps
        self.cfg = cfg
        self.trunk = nn.Module()
        self.trunk.patch_embed = nn.Module()
        self.trunk.patch_embed.proj = nn.Conv2d(3, D0, P, stride=P)
        self.trunk.patch_embed.norm = layers.LayerNorm(D0, eps=eps)
        self.trunk.layers = nn.ModuleList()
        dim = D0
        for s, depth in enumerate(t["depths"]):
            stage = nn.Module()
            if s > 0:
                stage.downsample = nn.Module()
                stage.downsample.norm = layers.LayerNorm(2 * dim, eps=eps)
                stage.downsample.reduction = nn.Linear(2 * dim, dim, bias=False)
            stage.blocks = nn.ModuleList(
                SwinBlock(dim, t["heads"][s], w, b % 2 == 1, t["mlp_ratio"], eps)
                for b in range(depth))
            self.trunk.layers.append(stage)
            if s < len(t["depths"]) - 1:
                dim *= 2
        self.trunk.norm = layers.LayerNorm(dim, eps=eps)
        self.head = nn.Module()
        self.head.proj = nn.Linear(dim, embed_dim, bias=False)


def init_rule(name: str, cfg: SwinVisionConfig, embed_dim: int):
    """JAX ``init_swin_params``'s rule for one ``visual.*`` parameter."""
    t = SWIN_TRUNKS[cfg.trunk]
    leaf = name.rsplit(".", 1)[-1]
    if ".norm" in name:
        return ("const", 1.0 if leaf == "weight" else 0.0)
    if leaf == "bias":
        return ("const", 0.0)
    if leaf == "relative_position_bias_table":
        return ("normal", 0.02)
    if ".patch_embed." in name:
        return ("normal", t["embed_dim"] ** -0.5)
    if name.startswith("visual.head."):
        return ("normal", cfg.embed_width ** -0.5)
    dim = t["embed_dim"] * 2 ** int(name.split(".layers.")[1].split(".")[0])
    if name.endswith("mlp.fc2.weight"):
        return ("normal", int(dim * t["mlp_ratio"]) ** -0.5)
    return ("normal", dim ** -0.5)  # qkv, proj, fc1, reduction


def swin_forward(visual: SwinTower, images: torch.Tensor, *, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False) -> torch.Tensor:
    """Images [B, H, W, 3] -> pooled features [B, embed_dim] (float32)."""
    cfg, tr = visual.cfg, visual.trunk
    t = SWIN_TRUNKS[cfg.trunk]
    w, P = t["window"], t["patch_size"]
    B, grid = images.shape[0], cfg.image_size // P
    last = grid // 2 ** (len(t["depths"]) - 1)
    if last % w:
        raise ValueError(f"image_size {cfg.image_size} gives a final-stage grid of {last}, "
                         f"not divisible by the window size {w}")
    pe = tr.patch_embed
    conv_w = pe.proj.weight.permute(0, 2, 3, 1).reshape(pe.proj.weight.shape[0], P * P * 3)
    x = dense(patchify(images, P), conv_w, pe.proj.bias, dtype)
    x = pe.norm(x).reshape(B, grid, grid, -1).to(dtype)
    for stage in tr.layers:
        if hasattr(stage, "downsample"):
            Bx, H, W, C = x.shape
            x = x.reshape(Bx, H // 2, 2, W // 2, 2, C)
            # timm's order: (0, 0), (1, 0), (0, 1), (1, 1)
            x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1],
                           x[:, :, 1, :, 1]], dim=-1)
            d = stage.downsample
            x = dense(d.norm(x), d.reduction.weight, None, dtype)
        x = layers.run_blocks(stage.blocks, x, remat, dtype=dtype)
    x = x.reshape(B, -1, x.shape[-1])
    pooled = layer_norm(x, tr.norm.weight, tr.norm.bias, cfg.ln_eps).mean(dim=1)
    return dense(pooled, visual.head.proj.weight, None, dtype).float()
