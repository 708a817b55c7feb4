"""CLIP model: module, seeded init and the encode functions.

Port of ``latteclip_tpu/models/clip.py`` (``init_clip_params``,
``encode_image``, ``encode_text``, ``encode_text_packed``) for the native ViT
and text towers. The
module's state dict has OpenCLIP's layout (``visual.*``,
``transformer.resblocks.{i}.*``, ``token_embedding.weight``,
``positional_embedding``, ``ln_final.*``, ``text_projection``,
``logit_scale``), so a real OpenCLIP checkpoint loads with ``strict=True``;
plus ``logit_bias`` where the config sets ``init_logit_bias``, and the keys
the JAX package writes under its own namespace: a SigLIP tower's MAP head
(``latteclip.visual.map_head.*``, flax layout) and the text projection's
bias (``latteclip.text.text_projection_b``, from a checkpoint that has one).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from latteclip_torch.config import CLIPConfig
from latteclip_torch.device import resolve_device
from latteclip_torch.models import layers
from latteclip_torch.models.text import text_forward, text_forward_packed
from latteclip_torch.models.pos_embed import sincos_2d
from latteclip_torch.models.vit import MapHead, VisionTransformer, vit_forward


class CLIP(nn.Module):
    """``text_projection_b`` adds the text projection's bias, which no config
    sets: the JAX package has it only from a checkpoint."""

    def __init__(self, cfg: CLIPConfig, *, text_projection_b: bool = False):
        super().__init__()
        t, v = cfg.text, cfg.vision
        self.cfg = cfg
        self.visual = VisionTransformer(v, cfg.embed_dim)
        self.transformer = layers.Transformer(t.width, t.layers, t.heads, t.mlp_ratio, t.ln_eps,
                                              layer_scale=t.ls_init_value is not None)
        self.token_embedding = nn.Embedding(t.vocab_size, t.width)
        self.positional_embedding = nn.Parameter(torch.empty(t.context_length, t.width))
        self.ln_final = layers.LayerNorm(t.width, eps=t.ln_eps)
        self.text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(float(cfg.init_logit_scale)))
        if cfg.init_logit_bias is not None:
            self.logit_bias = nn.Parameter(torch.tensor(float(cfg.init_logit_bias)))
        if v.pool_type == "map" or text_projection_b:
            self.latteclip = nn.Module()  # the JAX package's own checkpoint namespace
            if v.pool_type == "map":
                self.latteclip.visual = nn.Module()
                self.latteclip.visual.map_head = MapHead(v.width, int(v.width * v.mlp_ratio))
            if text_projection_b:
                self.latteclip.text = nn.Module()
                self.latteclip.text.text_projection_b = nn.Parameter(torch.empty(cfg.embed_dim))

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    @property
    def map_head(self) -> Optional[MapHead]:
        extra = self._modules.get("latteclip")
        return extra.visual.map_head if extra is not None and hasattr(extra, "visual") else None

    @property
    def text_projection_b(self) -> Optional[torch.Tensor]:
        extra = self._modules.get("latteclip")
        return (extra.text.text_projection_b
                if extra is not None and hasattr(extra, "text") else None)


def _init_rule(name: str, cfg: CLIPConfig):
    """("normal", std), ("const", value) or ("sincos", None) for one
    parameter, following the JAX package's init (models/vit.py::
    init_vit_params and init_map_head_params, models/text.py::
    init_text_params, models/clip.py::init_clip_params)."""
    visual = name.startswith(("visual.", "latteclip.visual."))
    tower = cfg.vision if visual else cfg.text
    D, L = tower.width, tower.layers
    scale = D ** -0.5
    proj_std = scale * (2 * L) ** -0.5
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("latteclip.visual.map_head."):  # flax names: *_w, *_b, ln_*
        if leaf in ("ln_scale", "ln_bias"):
            return ("const", 1.0 if leaf == "ln_scale" else 0.0)
        return ("const", 0.0) if leaf.endswith("_b") else ("normal", scale)
    if leaf == "gamma":  # LayerScale
        return ("const", tower.ls_init_value)
    if name == "logit_bias":
        return ("const", cfg.init_logit_bias)
    if name == "visual.positional_embedding" and cfg.vision.pos_embed_type == "sin_cos_2d":
        return ("sincos", None)
    if ".ln_" in name or name.startswith("ln_"):
        return ("const", 1.0 if leaf == "weight" else 0.0)
    if leaf.endswith("bias") or leaf == "text_projection_b":
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
            elif kind == "sincos":
                v = cfg.vision
                p.copy_(torch.from_numpy(sincos_2d(v.width, v.grid, not v.no_cls_token)))
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * value)
    return model.to(dev)


def encode_image(model: CLIP, images: torch.Tensor, *, normalize: bool = False,
                 attention: str = "kernel", pack_pairs: Optional[bool] = None,
                 ln_linear: str = "unfused", remat: bool = False, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normalized images [B, H, W, 3] -> features [B, embed_dim] (float32).
    ``attention`` (``kernels.ATTENTION_CHOICES``) and ``ln_linear``
    (``"unfused"`` or ``"fused"``) select the kernel routes; ``remat``
    rematerialises each block in the backward; ``train`` applies the
    config's patch dropout, drawn from ``generator``."""
    cfg = model.cfg
    feats = vit_forward(model.visual, images, dtype=model.compute_dtype,
                        quick_gelu=cfg.quick_gelu, gelu_tanh=cfg.gelu_tanh,
                        map_head=model.map_head, attention=attention, pack_pairs=pack_pairs,
                        ln_linear=ln_linear, remat=remat, train=train, generator=generator)
    return layers.l2_normalize(feats) if normalize else feats


def encode_text(model: CLIP, tokens: torch.Tensor, *, normalize: bool = False,
                attention: str = "kernel", ln_linear: str = "unfused",
                remat: bool = False) -> torch.Tensor:
    """Token ids [B, ctx] -> features [B, embed_dim] (float32)."""
    cfg = model.cfg
    feats = text_forward(model, tokens, dtype=model.compute_dtype,
                         quick_gelu=cfg.quick_gelu, gelu_tanh=cfg.gelu_tanh, attention=attention,
                         ln_linear=ln_linear, remat=remat)
    return layers.l2_normalize(feats) if normalize else feats


def encode_text_packed(model: CLIP, tokens: torch.Tensor, positions: torch.Tensor,
                       seg_ids: torch.Tensor, eot_row: torch.Tensor, eot_col: torch.Tensor, *,
                       normalize: bool = False, attention: str = "kernel",
                       ln_linear: str = "unfused", remat: bool = False) -> torch.Tensor:
    """Rows packed by :mod:`latteclip_torch.data.packing` -> features
    [N, embed_dim] (float32), as :func:`encode_text` gives on the padded rows."""
    cfg = model.cfg
    feats = text_forward_packed(model, tokens, positions, seg_ids, eot_row, eot_col,
                                dtype=model.compute_dtype, quick_gelu=cfg.quick_gelu,
                                gelu_tanh=cfg.gelu_tanh, attention=attention,
                                ln_linear=ln_linear, remat=remat)
    return layers.l2_normalize(feats) if normalize else feats
