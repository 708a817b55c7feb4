"""VisionTransformerRelPos vision tower (port of
``latteclip_tpu/models/vit_relpos.py``).

timm's ``vit_relpos_medium_patch16_cls_224`` as OpenCLIP builds it
(``timm_pool=''``: the trunk's token pool; ``timm_proj='linear'``: an
unbiased head linear):

- patch embed: a biased stride-16 conv (patchify and one matmul), a class
  token and no absolute position embedding;
- pre-LN blocks with LayerScale, an unbiased fused qkv and a rel-pos MLP
  bias (``RelPosMlp``, mode ``'cr'``): the ``[2g-1, 2g-1, 2]`` table of
  ``sign(c) * ln(1 + |c|)`` relative coordinates through a biased
  2 -> hidden -> heads ReLU MLP, gathered by the Swin index of the grid
  (:func:`latteclip_torch.models.swin.relative_position_index`) and padded
  with a zero row and column for the class token;
- final LayerNorm, the class token, the head linear.

The bias MLP runs in float32 and the attention is plain torch, as JAX
runs both in XLA. LayerScale's float32 ``gamma`` promotes the residual
stream to float32 after the first block, as JAX's type promotion does.
Parameter names are timm's (``visual.trunk.blocks.{i}.attn.rel_pos.mlp.
fc1.weight``, ``visual.trunk.blocks.{i}.ls1.gamma``, ...).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latteclip_torch.config import RELPOS_TRUNKS, RelPosVisionConfig
from latteclip_torch.kernels.fused_ln_linear import dense, layer_norm
from latteclip_torch.models import layers
from latteclip_torch.models.swin import biased_attention, relative_position_index
from latteclip_torch.models.vit import patchify


def rel_log_coords(g: int) -> np.ndarray:
    """[2g-1, 2g-1, 2] table of sign(c) * ln(1 + |c|) over (dy, dx)."""
    r = np.arange(-(g - 1), g, dtype=np.float32)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    return np.sign(table) * np.log1p(np.abs(table))


class RelPosBlock(nn.Module):
    def __init__(self, width: int, heads: int, hidden: int, rel_hidden: int, eps: float):
        super().__init__()
        self.heads = heads
        self.norm1 = layers.LayerNorm(width, eps=eps)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(width, 3 * width, bias=False)
        self.attn.rel_pos = nn.Module()
        self.attn.rel_pos.mlp = nn.Module()
        self.attn.rel_pos.mlp.fc1 = nn.Linear(2, rel_hidden)
        self.attn.rel_pos.mlp.fc2 = nn.Linear(rel_hidden, heads)
        self.attn.proj = nn.Linear(width, width)
        self.ls1 = layers.LayerScale(width)
        self.norm2 = layers.LayerNorm(width, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(width, hidden)
        self.mlp.fc2 = nn.Linear(hidden, width)
        self.ls2 = layers.LayerScale(width)

    def rel_bias(self, g: int, table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """``RelPosMlp.get_bias()``: [1, heads, N+1, N+1] float32, zero on
        the class token's row and column."""
        m = self.attn.rel_pos.mlp
        h = F.relu(table @ m.fc1.weight.t() + m.fc1.bias)
        h = h @ m.fc2.weight.t() + m.fc2.bias                           # [2g-1, 2g-1, heads]
        flat = h.reshape(-1, self.heads)[index.reshape(-1)]
        bias = flat.reshape(g * g, g * g, self.heads).permute(2, 0, 1)
        return F.pad(bias, (1, 0, 1, 0))[None].float()

    def forward(self, x: torch.Tensor, *, g: int, table: torch.Tensor, index: torch.Tensor,
                dtype: torch.dtype, residuals=None) -> torch.Tensor:
        """JAX ``_relpos_block``."""
        B, N, C = x.shape
        hd = C // self.heads
        h = self.norm1(x).to(dtype)
        q, k, v = (t.reshape(B, N, self.heads, hd)
                   for t in dense(h, self.attn.qkv.weight, None, dtype).split(C, dim=-1))
        out = biased_attention(q, k, v, self.rel_bias(g, table, index), dtype).reshape(B, N, C)
        out = dense(out, self.attn.proj.weight, self.attn.proj.bias, dtype)
        x = x + out * self.ls1.gamma
        h = self.norm2(x).to(dtype)
        h = layers.gelu(dense(h, self.mlp.fc1.weight, self.mlp.fc1.bias, dtype))
        h = dense(h, self.mlp.fc2.weight, self.mlp.fc2.bias, dtype)
        return x + h * self.ls2.gamma


class RelPosTower(nn.Module):
    def __init__(self, cfg: RelPosVisionConfig, embed_dim: int):
        super().__init__()
        t = RELPOS_TRUNKS[cfg.trunk]
        D, P = t["width"], t["patch_size"]
        self.cfg = cfg
        self.trunk = nn.Module()
        self.trunk.patch_embed = nn.Module()
        self.trunk.patch_embed.proj = nn.Conv2d(3, D, P, stride=P)
        self.trunk.cls_token = nn.Parameter(torch.empty(1, 1, D))
        self.trunk.blocks = nn.ModuleList(
            RelPosBlock(D, t["heads"], int(D * t["mlp_ratio"]), t["rel_pos_hidden"], cfg.ln_eps)
            for _ in range(t["layers"]))
        self.trunk.norm = layers.LayerNorm(D, eps=cfg.ln_eps)
        self.head = nn.Module()
        self.head.proj = nn.Linear(D, embed_dim, bias=False)


def init_rule(name: str, cfg: RelPosVisionConfig, embed_dim: int):
    """JAX ``init_relpos_params``'s rule for one ``visual.*`` parameter."""
    t = RELPOS_TRUNKS[cfg.trunk]
    D, hidden = t["width"], int(t["width"] * t["mlp_ratio"])
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "gamma":
        return ("const", t["init_values"])
    if ".norm" in name:
        return ("const", 1.0 if leaf == "weight" else 0.0)
    if leaf == "bias":
        return ("const", 0.0)
    if name.endswith("rel_pos.mlp.fc1.weight"):
        return ("normal", 2 ** -0.5)
    if name.endswith("rel_pos.mlp.fc2.weight"):
        return ("normal", t["rel_pos_hidden"] ** -0.5)
    if name.endswith("cls_token"):
        return ("normal", 1e-6)
    if name.endswith("mlp.fc2.weight"):
        return ("normal", hidden ** -0.5)
    return ("normal", D ** -0.5)  # patch conv, qkv, proj, fc1, head


def relpos_forward(visual: RelPosTower, images: torch.Tensor, *,
                   dtype: torch.dtype = torch.bfloat16, remat: bool = False) -> torch.Tensor:
    """Images [B, H, W, 3] -> pooled features [B, embed_dim] (float32)."""
    cfg, tr = visual.cfg, visual.trunk
    t = RELPOS_TRUNKS[cfg.trunk]
    P, D = t["patch_size"], t["width"]
    g, B = cfg.image_size // P, images.shape[0]
    w = tr.patch_embed.proj.weight.permute(0, 2, 3, 1).reshape(D, P * P * 3)
    x = dense(patchify(images, P), w, tr.patch_embed.proj.bias, dtype)
    x = torch.cat([tr.cls_token.to(dtype).expand(B, 1, D), x], dim=1)
    table = torch.from_numpy(rel_log_coords(g)).to(x.device)
    index = torch.from_numpy(relative_position_index(g)).to(x.device)
    x = layers.run_blocks(tr.blocks, x, remat, g=g, table=table, index=index, dtype=dtype)
    pooled = layer_norm(x, tr.norm.weight, tr.norm.bias, cfg.ln_eps)[:, 0]
    return dense(pooled, visual.head.proj.weight, None, dtype).float()
