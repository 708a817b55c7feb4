"""CLIP model: module, seeded init and the encode functions.

Port of ``latteclip_tpu/models/clip.py`` (``init_clip_params``,
``encode_image``, ``encode_text``, ``encode_text_packed``) for the native ViT
and text towers. The
module's state dict has OpenCLIP's layout (``visual.*``,
``transformer.resblocks.{i}.*``, ``token_embedding.weight``,
``positional_embedding``, ``ln_final.*``, ``text_projection``,
``logit_scale``), so a real OpenCLIP checkpoint loads with ``strict=True``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from latteclip_torch.config import CLIPConfig
from latteclip_torch.device import resolve_device
from latteclip_torch.models import layers
from latteclip_torch.models.text import text_forward, text_forward_packed
from latteclip_torch.models.vit import VisionTransformer, vit_forward


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        t = cfg.text
        self.cfg = cfg
        self.visual = VisionTransformer(cfg.vision, cfg.embed_dim)
        self.transformer = layers.Transformer(t.width, t.layers, t.heads, t.mlp_ratio, t.ln_eps)
        self.token_embedding = nn.Embedding(t.vocab_size, t.width)
        self.positional_embedding = nn.Parameter(torch.empty(t.context_length, t.width))
        self.ln_final = layers.LayerNorm(t.width, eps=t.ln_eps)
        self.text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(float(cfg.init_logit_scale)))

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)


def _init_rule(name: str, cfg: CLIPConfig):
    """("normal", std) or ("const", value) for one parameter, following the
    JAX package's init (models/vit.py::init_vit_params,
    models/text.py::init_text_params)."""
    tower = cfg.vision if name.startswith("visual.") else cfg.text
    D, L = tower.width, tower.layers
    scale = D ** -0.5
    proj_std = scale * (2 * L) ** -0.5
    leaf = name.rsplit(".", 1)[-1]
    if ".ln_" in name or name.startswith("ln_"):
        return ("const", 1.0 if leaf == "weight" else 0.0)
    if leaf.endswith("bias"):
        return ("const", 0.0)
    if name == "logit_scale":
        return ("const", cfg.init_logit_scale)
    if name == "token_embedding.weight":
        return ("normal", 0.02)
    if name == "positional_embedding":
        return ("normal", 0.01)
    if name.endswith("attn.out_proj.weight") or name.endswith("mlp.c_proj.weight"):
        return ("normal", proj_std)
    if name.endswith("mlp.c_fc.weight"):
        return ("normal", (2 * D) ** -0.5)
    # in_proj_weight, conv1, class/positional embeddings, proj, text_projection
    return ("normal", scale)


def init_clip_params(generator: torch.Generator, cfg: CLIPConfig, *, device="cuda") -> CLIP:
    """A CLIP module with seeded random weights (float32) on ``device``.

    Normals come from ``generator`` (a CPU ``torch.Generator``) in the
    module's parameter order, so a seed gives the same weights on any device."""
    dev = resolve_device(device)
    model = CLIP(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            kind, value = _init_rule(name, cfg)
            if kind == "const":
                p.fill_(value)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * value)
    return model.to(dev)


def encode_image(model: CLIP, images: torch.Tensor, *, normalize: bool = False,
                 attention: str = "kernel", pack_pairs: Optional[bool] = None,
                 ln_linear: str = "unfused") -> torch.Tensor:
    """Normalized images [B, H, W, 3] -> features [B, embed_dim] (float32).
    ``attention`` (``kernels.ATTENTION_CHOICES``) and ``ln_linear``
    (``"unfused"`` or ``"fused"``) select the kernel routes."""
    cfg = model.cfg
    feats = vit_forward(model.visual, images, dtype=model.compute_dtype,
                        quick_gelu=cfg.quick_gelu, attention=attention, pack_pairs=pack_pairs,
                        ln_linear=ln_linear)
    return layers.l2_normalize(feats) if normalize else feats


def encode_text(model: CLIP, tokens: torch.Tensor, *, normalize: bool = False,
                attention: str = "kernel", ln_linear: str = "unfused") -> torch.Tensor:
    """Token ids [B, ctx] -> features [B, embed_dim] (float32)."""
    cfg = model.cfg
    feats = text_forward(model, tokens, dtype=model.compute_dtype,
                         quick_gelu=cfg.quick_gelu, attention=attention, ln_linear=ln_linear)
    return layers.l2_normalize(feats) if normalize else feats


def encode_text_packed(model: CLIP, tokens: torch.Tensor, positions: torch.Tensor,
                       seg_ids: torch.Tensor, eot_row: torch.Tensor, eot_col: torch.Tensor, *,
                       normalize: bool = False, attention: str = "kernel",
                       ln_linear: str = "unfused") -> torch.Tensor:
    """Rows packed by :mod:`latteclip_torch.data.packing` -> features
    [N, embed_dim] (float32), as :func:`encode_text` gives on the padded rows."""
    cfg = model.cfg
    feats = text_forward_packed(model, tokens, positions, seg_ids, eot_row, eot_col,
                                dtype=model.compute_dtype, quick_gelu=cfg.quick_gelu,
                                attention=attention, ln_linear=ln_linear)
    return layers.l2_normalize(feats) if normalize else feats
