"""ConvNeXt vision tower (port of ``latteclip_tpu/models/convnext.py``).

timm's ConvNeXt trunk as OpenCLIP's ``convnext_*`` configs build it
(``timm_pool=''``: average pool and the head LayerNorm) and the
``timm_proj`` head (an unbiased linear, or timm's Mlp with hidden
``2 * embed_dim`` and an unbiased second layer):

- stem: 4x4/4 conv, then LayerNorm over channels;
- stage s: LayerNorm and a 2x2/2 conv (s > 0), then blocks of
  7x7 depthwise conv -> LayerNorm -> Linear C->4C -> GELU -> Linear 4C->C
  -> ``gamma`` (LayerScale) -> drop-path -> residual.

Activations are channels-last ``[B, H, W, C]``, as in JAX; the convolutions
run through ``F.conv2d`` on their NCHW views. Drop-path runs only with
``train`` and a ``generator``, as JAX gates it on ``train`` and an rng; the
JAX package's train step passes neither, so it never runs in training, and
the port's step passes neither too. Parameter names are timm's
(``visual.trunk.stem.0.weight``, ``visual.trunk.stages.{s}.blocks.{b}.
conv_dw.weight``, ``visual.trunk.head.norm.weight``,
``visual.head.proj.weight`` or ``visual.head.mlp.fc1.weight``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from latteclip_torch.config import ConvNeXtVisionConfig
from latteclip_torch.kernels.fused_ln_linear import dense, layer_norm
from latteclip_torch.models import layers


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
              padding: int, dtype: torch.dtype, groups: int = 1) -> torch.Tensor:
    """A conv on channels-last ``[B, H, W, C]`` with a torch ``[O, I, kh, kw]``
    weight, in ``dtype``."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w.to(dtype),
                 None if b is None else b.to(dtype), stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth: keep with ``1 - rate``, survivors
    scaled by ``1 / (1 - rate)`` (timm ``drop_path``)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=x.device) < keep
    return torch.where(mask, x.float() / keep, 0.0).to(x.dtype)


def _ln(ch: int, eps: float) -> nn.Module:
    return layers.LayerNorm(ch, eps=eps)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = _ln(dim, eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, 4 * dim)
        self.mlp.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, rate: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        C = x.shape[-1]
        y = conv_nhwc(x, self.conv_dw.weight, self.conv_dw.bias, 1, 3, dtype, groups=C)
        y = self.norm(y)
        y = layers.gelu(dense(y, self.mlp.fc1.weight, self.mlp.fc1.bias, dtype))
        y = dense(y, self.mlp.fc2.weight, self.mlp.fc2.bias, dtype)
        y = (y.float() * self.gamma.float()).to(dtype)
        return x + drop_path(y, rate, generator)


class ConvNeXtTower(nn.Module):
    def __init__(self, cfg: ConvNeXtVisionConfig, embed_dim: int):
        super().__init__()
        depths, dims, eps = cfg.depths, cfg.dims, cfg.ln_eps
        self.cfg = cfg
        self.trunk = nn.Module()
        self.trunk.stem = nn.Module()
        self.trunk.stem.add_module("0", nn.Conv2d(3, dims[0], 4, stride=4))
        self.trunk.stem.add_module("1", _ln(dims[0], eps))
        self.trunk.stages = nn.ModuleList()
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            stage = nn.Module()
            if s > 0:
                stage.downsample = nn.Module()
                stage.downsample.add_module("0", _ln(dims[s - 1], eps))
                stage.downsample.add_module("1", nn.Conv2d(dims[s - 1], dim, 2, stride=2))
            stage.blocks = nn.ModuleList(ConvNeXtBlock(dim, eps) for _ in range(depth))
            self.trunk.stages.append(stage)
        D = dims[-1]
        self.trunk.head = nn.Module()
        self.trunk.head.norm = _ln(D, eps)
        if cfg.proj not in ("linear", "mlp", "none"):
            raise ValueError(f"unknown convnext proj '{cfg.proj}'")
        if cfg.proj != "none":
            self.head = nn.Module()
            if cfg.proj == "linear":
                self.head.proj = nn.Linear(D, embed_dim, bias=False)
            else:
                self.head.mlp = nn.Module()
                self.head.mlp.fc1 = nn.Linear(D, 2 * embed_dim)
                self.head.mlp.fc2 = nn.Linear(2 * embed_dim, embed_dim, bias=False)


def init_rule(name: str, cfg: ConvNeXtVisionConfig, embed_dim: int):
    """JAX ``init_convnext_params``'s rule for one ``visual.*`` parameter:
    truncated normal (at two standard deviations) of std 0.02 for the
    trunk's convolutions and linears, the head's of std fan_in^-0.5."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "gamma":
        return ("const", cfg.ls_init_value)
    if leaf == "bias":
        return ("const", 0.0)
    if ".norm." in name or ".stem.1." in name or ".downsample.0." in name:
        return ("const", 1.0)
    if name.startswith("visual.head.proj") or name.startswith("visual.head.mlp.fc1"):
        return ("trunc_normal", cfg.embed_width ** -0.5)
    if name.startswith("visual.head.mlp.fc2"):
        return ("trunc_normal", (2 * embed_dim) ** -0.5)
    return ("trunc_normal", 0.02)


def convnext_forward(visual: ConvNeXtTower, images: torch.Tensor, *,
                     dtype: torch.dtype = torch.bfloat16, remat: bool = False,
                     train: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Images [B, S, S, 3] -> features [B, embed_dim] (float32). ``remat``
    rematerialises each block in the backward."""
    cfg, t = visual.cfg, visual.trunk
    total = sum(cfg.depths)
    ramp = np.linspace(0.0, cfg.drop_path, total) if cfg.drop_path else np.zeros(total)
    gen = generator if train and cfg.drop_path > 0 else None
    stem_conv, stem_norm = getattr(t.stem, "0"), getattr(t.stem, "1")
    x = stem_norm(conv_nhwc(images, stem_conv.weight, stem_conv.bias, 4, 0, dtype))
    done = 0
    remat = remat and torch.is_grad_enabled()
    for stage in t.stages:
        if hasattr(stage, "downsample"):
            norm, conv = getattr(stage.downsample, "0"), getattr(stage.downsample, "1")
            x = conv_nhwc(norm(x), conv.weight, conv.bias, 2, 0, dtype)
        for block in stage.blocks:
            rate = float(ramp[done])
            done += 1
            if remat:
                x = torch.utils.checkpoint.checkpoint(block, x, dtype, rate, gen,
                                                      use_reentrant=False)
            else:
                x = block(x, dtype, rate, gen)
    pooled = x.float().mean(dim=(1, 2))
    h = t.head.norm
    pooled = layer_norm(pooled, h.weight, h.bias, cfg.ln_eps)
    if cfg.proj == "linear":
        out = dense(pooled, visual.head.proj.weight, None, dtype)
    elif cfg.proj == "mlp":
        m = visual.head.mlp
        y = layers.gelu(dense(pooled, m.fc1.weight, m.fc1.bias, dtype))
        out = dense(y, m.fc2.weight, None, dtype)
    else:
        out = pooled
    return out.float()
