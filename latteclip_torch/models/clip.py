"""CLIP model: module, seeded init and the encode functions.

Port of ``latteclip_tpu/models/clip.py`` (``init_clip_params``,
``encode_image``, ``encode_text``, ``encode_text_packed``) for every tower of
the JAX package: the native ViT (with its timm trunks, :class:`~latteclip_torch.
models.vit.TimmVisionTransformer`), EVA02, ModifiedResNet, ConvNeXt, Swin and
ViT-relpos, chosen by the type of ``cfg.vision``; the native text tower or
an HF-architecture one (:class:`~latteclip_torch.models.hf_text.HFTextTower`
under ``text.*``, the reference's CustomTextCLIP layout, chosen by the type
of ``cfg.text``); and CoCa (:class:`~latteclip_torch.models.coca.CoCa`, for a
:class:`~latteclip_torch.config.CoCaConfig`), which :func:`init_clip_params`
seeds and the encoders serve like a CLIP. The vision towers other
than the native ViT carry the names of JAX's ``params_to_pt_state_dict``
(timm's ``visual.trunk.*``, OpenCLIP's ``visual.head.*`` and ModifiedResNet
layout). The
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

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from latteclip_torch.config import (
    CLIPConfig,
    CoCaConfig,
    ConvNeXtVisionConfig,
    Eva02VisionConfig,
    RelPosVisionConfig,
    ResNetVisionConfig,
    SwinVisionConfig,
    VisionConfig,
)
from latteclip_torch.device import resolve_device
from latteclip_torch.models import coca, convnext, eva02, hf_text, layers, resnet, swin, vit, vit_relpos
from latteclip_torch.models.hf_text import HFTextConfig, HFTextTower
from latteclip_torch.models.text import text_forward, text_forward_packed
from latteclip_torch.models.pos_embed import sincos_2d
from latteclip_torch.models.vit import MapHead, VisionTransformer, vit_forward

# vision config type -> (tower module, its init rule)
_TOWERS = {
    ResNetVisionConfig: (resnet.ModifiedResNet, resnet.init_rule),
    ConvNeXtVisionConfig: (convnext.ConvNeXtTower, convnext.init_rule),
    Eva02VisionConfig: (eva02.Eva02VisionTower, eva02.init_rule),
    SwinVisionConfig: (swin.SwinTower, swin.init_rule),
    RelPosVisionConfig: (vit_relpos.RelPosTower, vit_relpos.init_rule),
}


def vision_tower(v, embed_dim: int) -> nn.Module:
    """The vision tower module of the config ``v``."""
    if isinstance(v, VisionConfig):
        cls = vit.TimmVisionTransformer if v.timm_trunk else VisionTransformer
        return cls(v, embed_dim)
    return _TOWERS[type(v)][0](v, embed_dim)


class CLIP(nn.Module):
    """``text_projection_b`` adds the text projection's bias, which no config
    sets: the JAX package has it only from a checkpoint; ``patch_bias``
    likewise the native tower's ``visual.conv1.bias`` (JAX ``patch_bias``,
    from a big_vision ``.npz``). An HF text tower
    sits under ``text`` (``hf_pooler``: :class:`HFTextTower`'s ``pooler``)."""

    def __init__(self, cfg: CLIPConfig, *, text_projection_b: bool = False,
                 hf_pooler: Optional[bool] = None, patch_bias: bool = False):
        super().__init__()
        t, v = cfg.text, cfg.vision
        self.cfg = cfg
        self.visual = vision_tower(v, cfg.embed_dim)
        if patch_bias:  # a big_vision checkpoint's biased patch embedding
            self.visual.conv1.bias = nn.Parameter(torch.empty(v.width))
        if isinstance(t, HFTextConfig):
            self.text = HFTextTower(t, cfg.embed_dim, pooler=hf_pooler)
        else:
            self.transformer = layers.Transformer(t.width, t.layers, t.heads, t.mlp_ratio,
                                                  t.ln_eps, layer_scale=t.ls_init_value is not None)
            self.token_embedding = nn.Embedding(t.vocab_size, t.width)
            self.positional_embedding = nn.Parameter(torch.empty(t.context_length, t.width))
            self.ln_final = layers.LayerNorm(t.width, eps=t.ln_eps)
            self.text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(float(cfg.init_logit_scale)))
        if cfg.init_logit_bias is not None:
            self.logit_bias = nn.Parameter(torch.tensor(float(cfg.init_logit_bias)))
        map_pool = isinstance(v, VisionConfig) and v.pool_type == "map"
        if map_pool or text_projection_b:
            self.latteclip = nn.Module()  # the JAX package's own checkpoint namespace
            if map_pool:
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


def add_logit_bias(model: CLIP, value: float) -> CLIP:
    """Give ``model`` a trainable ``logit_bias`` of ``value`` on its device,
    as JAX's CLI injects one into a plain CLIP trained with the SigLIP loss;
    the config records it as ``init_logit_bias``."""
    dev = model.logit_scale.device
    model.logit_bias = nn.Parameter(torch.tensor(float(value), device=dev))
    model.cfg = dataclasses.replace(model.cfg, init_logit_bias=float(value))
    return model


def build_model(cfg, **kwargs) -> nn.Module:
    """The module of ``cfg``, unseeded: :class:`CLIP`, or :class:`CoCa` for
    a :class:`CoCaConfig`."""
    return coca.CoCa(cfg, **kwargs) if isinstance(cfg, CoCaConfig) else CLIP(cfg, **kwargs)


def _init_rule(name: str, cfg: CLIPConfig):
    """("normal", std), ("const", value) or ("sincos", None) for one
    parameter, following the JAX package's init (models/vit.py::
    init_vit_params, init_attn_pool_params and init_map_head_params,
    models/text.py::init_text_params, models/hf_text.py::
    init_hf_text_params, models/coca.py::init_coca_params,
    models/clip.py::init_clip_params)."""
    visual = name.startswith(("visual.", "latteclip.visual."))
    v = cfg.vision
    if visual and not isinstance(v, VisionConfig):
        return _TOWERS[type(v)][1](name, v, cfg.embed_dim)
    if visual and v.timm_trunk:
        return vit.timm_init_rule(name, v, cfg.embed_dim)
    if name.startswith("visual.attn_pool."):
        if name.endswith("query"):
            return ("normal", 1.0)
        if ".ln_" in name:
            return ("const", 1.0 if name.endswith("weight") else 0.0)
        return ("const", 0.0) if name.endswith("bias") else ("normal", cfg.embed_dim ** -0.5)
    tower = v if visual else cfg.text
    if name.startswith("text.") and isinstance(cfg.text, HFTextConfig):
        return hf_text.init_rule(name[len("text."):], cfg.text)
    if name.startswith("text_decoder."):
        tower, name = cfg.multimodal, name[len("text_decoder."):]
    elif name.startswith("text."):  # CoCa's class-token text tower
        name = name[len("text."):]
        if name in ("cls_emb", "positional_embedding"):
            return ("normal", 0.01)
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
    """A CLIP (or CoCa) module with seeded random weights (float32) on
    ``device``.

    Normals come from ``generator`` (a CPU ``torch.Generator``) in the
    module's parameter order, so a seed gives the same weights on any device:
    N(0, std^2), He's N(0, 2 / fan_in) for the ModifiedResNet's convolutions,
    or N(0, std^2) truncated at two standard deviations (ConvNeXt's) drawn
    by the inverse CDF. Buffers (BatchNorm's statistics) keep their
    identity values."""
    dev = resolve_device(device)
    model = build_model(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            kind, value = _init_rule(name, cfg)
            if kind == "const":
                p.fill_(value)
            elif kind == "sincos":
                v = cfg.vision
                p.copy_(torch.from_numpy(sincos_2d(v.width, v.grid, not v.no_cls_token)))
            elif kind == "trunc_normal":
                lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
                u = lo + (1.0 - 2.0 * lo) * torch.rand(p.shape, generator=generator,
                                                       dtype=torch.float64)
                p.copy_((math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) * value).float())
            else:
                std = (2.0 / p[0].numel()) ** 0.5 if kind == "he_normal" else value
                p.copy_(torch.randn(p.shape, generator=generator).mul_(std))
    return model.to(dev)


def encode_image(model: CLIP, images: torch.Tensor, *, normalize: bool = False,
                 attention: str = "kernel", pack_pairs: Optional[bool] = None,
                 ln_linear: str = "unfused", remat: bool = False, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normalized images [B, H, W, 3] -> features [B, embed_dim] (float32).
    ``attention`` (``kernels.ATTENTION_CHOICES``) and ``ln_linear``
    (``"unfused"`` or ``"fused"``) select the kernel routes; ``remat``
    rematerialises each block in the backward; ``train`` applies the
    config's patch dropout (ConvNeXt's drop-path), drawn from ``generator``.
    Each tower takes what its JAX forward takes: EVA02 the attention route
    and remat, Swin and ViT-relpos remat, ModifiedResNet none of them."""
    cfg, v, dtype = model.cfg, model.cfg.vision, model.compute_dtype
    if isinstance(v, VisionConfig):
        feats = vit_forward(model.visual, images, dtype=dtype,
                            quick_gelu=cfg.quick_gelu, gelu_tanh=cfg.gelu_tanh,
                            map_head=model.map_head, attention=attention, pack_pairs=pack_pairs,
                            ln_linear=ln_linear, remat=remat, train=train, generator=generator)
    elif isinstance(v, Eva02VisionConfig):
        feats = eva02.eva02_forward(model.visual, images, dtype=dtype, attention=attention,
                                    remat=remat)
    elif isinstance(v, ResNetVisionConfig):
        feats = resnet.resnet_forward(model.visual, images, dtype=dtype)
    elif isinstance(v, ConvNeXtVisionConfig):
        feats = convnext.convnext_forward(model.visual, images, dtype=dtype, remat=remat,
                                          train=train, generator=generator)
    elif isinstance(v, SwinVisionConfig):
        feats = swin.swin_forward(model.visual, images, dtype=dtype, remat=remat)
    else:
        feats = vit_relpos.relpos_forward(model.visual, images, dtype=dtype, remat=remat)
    return layers.l2_normalize(feats) if normalize else feats


def encode_text(model: CLIP, tokens: torch.Tensor, *, normalize: bool = False,
                attention: str = "kernel", ln_linear: str = "unfused",
                remat: bool = False) -> torch.Tensor:
    """Token ids [B, ctx] -> features [B, embed_dim] (float32). CoCa pools at
    its class token (never at the argmax id) and an HF tower with its own
    pooler; both attend on plain torch, so ``attention`` and ``ln_linear``
    select nothing there (and CoCa's text tower takes no ``remat``, as in
    JAX)."""
    cfg = model.cfg
    if isinstance(cfg, CoCaConfig):
        feats = coca.encode_text_tokens(model, tokens, dtype=model.compute_dtype)[0]
    elif isinstance(cfg.text, HFTextConfig):
        feats = model.text(tokens, dtype=model.compute_dtype, remat=remat)
    else:
        feats = text_forward(model, tokens, dtype=model.compute_dtype,
                             quick_gelu=cfg.quick_gelu, gelu_tanh=cfg.gelu_tanh,
                             attention=attention, ln_linear=ln_linear, remat=remat)
    return layers.l2_normalize(feats) if normalize else feats


def encode_text_packed(model: CLIP, tokens: torch.Tensor, positions: torch.Tensor,
                       seg_ids: torch.Tensor, eot_row: torch.Tensor, eot_col: torch.Tensor, *,
                       normalize: bool = False, attention: str = "kernel",
                       ln_linear: str = "unfused", remat: bool = False) -> torch.Tensor:
    """Rows packed by :mod:`latteclip_torch.data.packing` -> features
    [N, embed_dim] (float32), as :func:`encode_text` gives on the padded rows
    (the native argmax tower only, as in JAX)."""
    cfg = model.cfg
    if isinstance(cfg.text, HFTextConfig) or getattr(cfg.text, "embed_cls", False):
        raise NotImplementedError("packed text encode supports the native CLIP text tower only")
    feats = text_forward_packed(model, tokens, positions, seg_ids, eot_row, eot_col,
                                dtype=model.compute_dtype, quick_gelu=cfg.quick_gelu,
                                gelu_tanh=cfg.gelu_tanh, attention=attention,
                                ln_linear=ln_linear, remat=remat)
    return layers.l2_normalize(feats) if normalize else feats
