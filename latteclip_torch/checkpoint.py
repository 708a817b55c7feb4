"""Checkpoint IO for the port (from ``latteclip_tpu/core/checkpoint.py``).

* :func:`load_clip_pt` reads an OpenCLIP/LatteCLIP ``.pt`` file (a bare
  state dict or a ``{"state_dict": ..., "epoch": ...}`` training checkpoint)
  or a ``.safetensors`` file,
  strips the ``module.``/``clip_model.`` wrapper prefixes, splits off the
  ``memory_bank.<class>`` prototype keys and loads the rest into a
  :class:`~latteclip_torch.models.clip.CLIP` with ``strict=True``.
* :func:`save_clip_pt` writes the training checkpoint in the same layout
  (``state_dict`` under OpenCLIP's names with ``memory_bank.<class>`` keys,
  plus ``epoch``, ``name``, ``step`` and ``optimizer``) to ``path + ".tmp"``
  and renames it into place.
* :func:`state_dict_from_jax_params` turns the JAX package's parameter tree
  (numpy arrays, ``[in, out]`` weights stacked on a layer axis) into the
  port's state dict; it mirrors ``params_to_pt_state_dict``: the native-ViT
  branch, LayerScale (``ls_1.gamma``, ``ls_2.gamma``), the MAP head
  (``latteclip.visual.map_head.*``), ``logit_bias`` and the text
  projection's bias (``latteclip.text.text_projection_b``) included, and
  each other vision tower's converter (timm's ``visual.trunk.*`` for EVA01,
  EVA02, ViT-medium, ConvNeXt, Swin and ViT-relpos, with OpenCLIP's
  ``visual.head.*``; OpenCLIP's ModifiedResNet keys with BatchNorm's running
  statistics), EVA02's q/k channels permuted back from JAX's rotate-half
  order to timm's; an HF text tower under ``text.transformer.*`` (HF's own
  names, BERT, T5 or M2M style) with its projection at
  ``text.proj[.N].weight``; and a CoCa model in the layout of JAX's
  ``coca_params_to_state_dict`` (``text.*`` beside ``text_decoder.*``, the
  attentional pool at ``visual.attn_pool.*``).
  :func:`jax_params_from_state_dict` is its inverse.
* :func:`resize_vision_pos_embed` resizes a vision positional embedding to
  another grid (``--force-image-size``, or a checkpoint of another image
  size), as ``load_clip_pt`` does on loading.
* :func:`optimizer_state` and :func:`restore_optimizer_state` write and read
  ``optimizer`` with the keys the JAX package's ``flatten_opt_state`` gives
  its optax state for the same flags: tree paths such as
  ``[0][0].mu['visual']['patch_kernel']`` (AdamW's moments, in the JAX
  parameter layout), ``[0][0].count`` and ``[0][2].count`` (AdamW's and the
  schedule's count), ``[1]`` in front under ``--grad-clip-norm``, and under
  ``--accum-freq`` ``.inner_opt_state`` in front plus ``.mini_step``,
  ``.gradient_step`` and ``.acc_grads[...]``. So ``restore_opt_state``
  accepts the port's file and the port accepts JAX's.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import struct
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from latteclip_torch.config import (
    RELPOS_TRUNKS,
    SWIN_TRUNKS,
    CLIPConfig,
    CoCaConfig,
    ConvNeXtVisionConfig,
    Eva02VisionConfig,
    RelPosVisionConfig,
    ResNetVisionConfig,
    SwinVisionConfig,
    VisionConfig,
)
from latteclip_torch.data.transforms import crop_weights
from latteclip_torch.device import resolve_device
from latteclip_torch.models.clip import CLIP, build_model
from latteclip_torch.models.hf_text import (
    HFTextConfig,
    export_hf_state_dict,
    import_hf_state_dict,
    proj_from_state_dict,
    proj_to_state_dict,
)

# JAX stacked block key -> (OpenCLIP suffix, transpose [in, out] -> [out, in])
_BLOCK_KEYS = {
    "ln_1_scale": ("ln_1.weight", False),
    "ln_1_bias": ("ln_1.bias", False),
    "in_proj_w": ("attn.in_proj_weight", True),
    "in_proj_b": ("attn.in_proj_bias", False),
    "out_proj_w": ("attn.out_proj.weight", True),
    "out_proj_b": ("attn.out_proj.bias", False),
    "ln_2_scale": ("ln_2.weight", False),
    "ln_2_bias": ("ln_2.bias", False),
    "c_fc_w": ("mlp.c_fc.weight", True),
    "c_fc_b": ("mlp.c_fc.bias", False),
    "c_proj_w": ("mlp.c_proj.weight", True),
    "c_proj_b": ("mlp.c_proj.bias", False),
}
_LS_KEYS = {"ls_1_gamma": ("ls_1.gamma", False), "ls_2_gamma": ("ls_2.gamma", False)}
# CoCa's cross-attention blocks: the image tokens' LayerNorm
_CROSS_EXTRA = {"ln_1_kv_scale": ("ln_1_kv.weight", False), "ln_1_kv_bias": ("ln_1_kv.bias", False)}
_ATTN_POOL_KEYS = {
    "query": "query", "q_proj_w": "attn.q_proj_weight", "k_proj_w": "attn.k_proj_weight",
    "v_proj_w": "attn.v_proj_weight", "in_proj_b": "attn.in_proj_bias",
    "out_proj_w": "attn.out_proj.weight", "out_proj_b": "attn.out_proj.bias",
    "ln_q_scale": "ln_q.weight", "ln_q_bias": "ln_q.bias",
    "ln_k_scale": "ln_k.weight", "ln_k_bias": "ln_k.bias",
}
_HF_PREFIX = "text.transformer."
_MAP_HEAD = "latteclip.visual.map_head."
_TEXT_PROJECTION_B = "latteclip.text.text_projection_b"
_VISUAL_KEYS = {
    "pos_embed": "visual.positional_embedding",
    "ln_pre_scale": "visual.ln_pre.weight",
    "ln_pre_bias": "visual.ln_pre.bias",
    "ln_post_scale": "visual.ln_post.weight",
    "ln_post_bias": "visual.ln_post.bias",
    "class_embedding": "visual.class_embedding",
    "proj": "visual.proj",
}
_TEXT_KEYS = {
    "token_embedding": "token_embedding.weight",
    "pos_embed": "positional_embedding",
    "ln_final_scale": "ln_final.weight",
    "ln_final_bias": "ln_final.bias",
    "text_projection": "text_projection",
}


# -- the other vision towers: JAX parameter subtree <-> timm/OpenCLIP keys ----
# (numpy copies of latteclip_tpu/core/checkpoint.py::_<tower>_visual_{to,from}_sd)


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(_f32(w).T)


def _oihw(w) -> np.ndarray:
    """An HWIO kernel in torch's OIHW."""
    return np.ascontiguousarray(_f32(w).transpose(3, 2, 0, 1))


def _hwio(w) -> np.ndarray:
    return _f32(w).transpose(2, 3, 1, 0)


def _patch_to_conv(kernel, P: int, D: int) -> np.ndarray:
    return np.ascontiguousarray(_f32(kernel).reshape(P, P, 3, D).transpose(3, 2, 0, 1))


def _conv_to_patch(conv) -> np.ndarray:
    conv = _f32(conv)
    return conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0])


def _pick(sd, prefix: str, keys: Mapping[str, Tuple[str, bool]]) -> Dict[str, np.ndarray]:
    """{JAX key: sd[prefix + suffix]} over ``keys`` (suffix -> (JAX key,
    transpose))."""
    return {ours: (_f32(sd[prefix + suffix]).T if transpose else _f32(sd[prefix + suffix]))
            for suffix, (ours, transpose) in keys.items()}


def _put(p, prefix: str, keys: Mapping[str, Tuple[str, bool]], i=None) -> Dict[str, np.ndarray]:
    """The inverse of :func:`_pick`, from layer ``i`` of stacked leaves."""
    out = {}
    for suffix, (ours, transpose) in keys.items():
        a = p[ours] if i is None else p[ours][i]
        out[prefix + suffix] = _t(a) if transpose else _f32(a)
    return out


def _stack_layers(sd, prefix: str, n: int, keys) -> Dict[str, np.ndarray]:
    per = [_pick(sd, f"{prefix}{i}.", keys) for i in range(n)]
    return {k: np.stack([p[k] for p in per]) for k in per[0]} if per else {}


_BN = {"weight": ("scale", False), "bias": ("bias", False),
       "running_mean": ("mean", False), "running_var": ("var", False)}


def _k_bias(sd, attn_prefix: str, D: int) -> np.ndarray:
    """EVA's k bias: the port's unsaved ``attn.k_bias`` where ``sd`` has it
    (moments, the trained model), else zero as in a checkpoint."""
    key = attn_prefix + "k_bias"
    return _f32(sd[key]) if key in sd else np.zeros(D, np.float32)


def _bn_from_sd(sd, torch_prefix: str, ours: str) -> Dict[str, np.ndarray]:
    return {f"{ours}_{k}": a for k, a in _pick(sd, torch_prefix + ".", _BN).items()}


def _bn_to_sd(p, ours: str, torch_prefix: str) -> Dict[str, np.ndarray]:
    return {f"{torch_prefix}.{suffix}": _f32(p[f"{ours}_{k}"]) for suffix, (k, _) in _BN.items()}


def _resnet_from_sd(sd, cfg) -> Dict[str, Any]:
    stem: Dict[str, np.ndarray] = {}
    for i in (1, 2, 3):
        stem[f"conv{i}_w"] = _hwio(sd[f"visual.conv{i}.weight"])
        stem.update(_bn_from_sd(sd, f"visual.bn{i}", f"bn{i}"))
    stages = []
    for s, blocks in enumerate(cfg.layers):
        stage = []
        for b in range(blocks):
            pre = f"visual.layer{s + 1}.{b}"
            p: Dict[str, np.ndarray] = {}
            for i in (1, 2, 3):
                p[f"conv{i}_w"] = _hwio(sd[f"{pre}.conv{i}.weight"])
                p.update(_bn_from_sd(sd, f"{pre}.bn{i}", f"bn{i}"))
            if f"{pre}.downsample.0.weight" in sd:
                p["down_conv_w"] = _hwio(sd[f"{pre}.downsample.0.weight"])
                p.update(_bn_from_sd(sd, f"{pre}.downsample.1", "down_bn"))
            stage.append(p)
        stages.append(stage)
    attnpool = {"pos_embed": _f32(sd["visual.attnpool.positional_embedding"])}
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("c", "c_proj")):
        attnpool[f"{ours}_w"] = _f32(sd[f"visual.attnpool.{theirs}.weight"])
        attnpool[f"{ours}_b"] = _f32(sd[f"visual.attnpool.{theirs}.bias"])
    return {"stem": stem, "stages": stages, "attnpool": attnpool}


def _resnet_to_sd(v, cfg, k_bias: bool = False) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for i in (1, 2, 3):
        sd[f"visual.conv{i}.weight"] = _oihw(v["stem"][f"conv{i}_w"])
        sd.update(_bn_to_sd(v["stem"], f"bn{i}", f"visual.bn{i}"))
    for s, stage in enumerate(v["stages"]):
        for b, p in enumerate(stage):
            pre = f"visual.layer{s + 1}.{b}"
            for i in (1, 2, 3):
                sd[f"{pre}.conv{i}.weight"] = _oihw(p[f"conv{i}_w"])
                sd.update(_bn_to_sd(p, f"bn{i}", f"{pre}.bn{i}"))
            if "down_conv_w" in p:
                sd[f"{pre}.downsample.0.weight"] = _oihw(p["down_conv_w"])
                sd.update(_bn_to_sd(p, "down_bn", f"{pre}.downsample.1"))
    ap = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _f32(ap["pos_embed"])
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("c", "c_proj")):
        sd[f"visual.attnpool.{theirs}.weight"] = _f32(ap[f"{ours}_w"])
        sd[f"visual.attnpool.{theirs}.bias"] = _f32(ap[f"{ours}_b"])
    return sd


# timm ViT block suffix -> (JAX stacked key, transpose)
_TIMM_BLOCK = {
    "norm1.weight": ("ln_1_scale", False), "norm1.bias": ("ln_1_bias", False),
    "attn.qkv.weight": ("in_proj_w", True),
    "attn.proj.weight": ("out_proj_w", True), "attn.proj.bias": ("out_proj_b", False),
    "norm2.weight": ("ln_2_scale", False), "norm2.bias": ("ln_2_bias", False),
    "mlp.fc1.weight": ("c_fc_w", True), "mlp.fc1.bias": ("c_fc_b", False),
    "mlp.fc2.weight": ("c_proj_w", True), "mlp.fc2.bias": ("c_proj_b", False),
}


def _timm_vit_from_sd(sd, cfg) -> Dict[str, Any]:
    """EVA01 (``eva*``: q/v biases, class token, ``norm``, the biased
    ``trunk.head``) or a plain timm ViT (full qkv bias, ``fc_norm``,
    OpenCLIP's ``head.proj``) -> the native ViT subtree, with the identity
    ``ln_pre`` the JAX tree keeps for trunks that have none."""
    eva, D = cfg.timm_trunk.startswith("eva"), cfg.width
    blocks = _stack_layers(sd, "visual.trunk.blocks.", cfg.layers, _TIMM_BLOCK)
    blocks["in_proj_b"] = np.stack([
        np.concatenate([_f32(sd[f"visual.trunk.blocks.{i}.attn.q_bias"]),
                        _k_bias(sd, f"visual.trunk.blocks.{i}.attn.", D),
                        _f32(sd[f"visual.trunk.blocks.{i}.attn.v_bias"])]) if eva
        else _f32(sd[f"visual.trunk.blocks.{i}.attn.qkv.bias"]) for i in range(cfg.layers)])
    norm = "norm" if eva else "fc_norm"
    out = {
        "patch_kernel": _conv_to_patch(sd["visual.trunk.patch_embed.proj.weight"]),
        "patch_bias": _f32(sd["visual.trunk.patch_embed.proj.bias"]),
        "pos_embed": _f32(sd["visual.trunk.pos_embed"]).reshape(-1, D),
        "ln_pre_scale": np.ones(D, np.float32),
        "ln_pre_bias": np.zeros(D, np.float32),
        "blocks": blocks,
        "ln_post_scale": _f32(sd[f"visual.trunk.{norm}.weight"]),
        "ln_post_bias": _f32(sd[f"visual.trunk.{norm}.bias"]),
    }
    if eva:
        out["class_embedding"] = _f32(sd["visual.trunk.cls_token"]).reshape(D)
        out["proj"] = _t(sd["visual.trunk.head.weight"])
        out["proj_b"] = _f32(sd["visual.trunk.head.bias"])
    else:
        out["proj"] = _t(sd["visual.head.proj.weight"])
    return out


def _timm_vit_to_sd(v, cfg, k_bias: bool = False) -> Dict[str, np.ndarray]:
    eva, D = cfg.timm_trunk.startswith("eva"), cfg.width
    norm = "norm" if eva else "fc_norm"
    sd = {"visual.trunk.patch_embed.proj.weight": _patch_to_conv(v["patch_kernel"],
                                                                 cfg.patch_size, D),
          "visual.trunk.patch_embed.proj.bias": _f32(v["patch_bias"]),
          "visual.trunk.pos_embed": _f32(v["pos_embed"])[None],
          f"visual.trunk.{norm}.weight": _f32(v["ln_post_scale"]),
          f"visual.trunk.{norm}.bias": _f32(v["ln_post_bias"])}
    if eva:
        sd["visual.trunk.cls_token"] = _f32(v["class_embedding"]).reshape(1, 1, D)
        sd["visual.trunk.head.weight"] = _t(v["proj"])
        sd["visual.trunk.head.bias"] = _f32(v["proj_b"])
    else:
        sd["visual.head.proj.weight"] = _t(v["proj"])
    b = v["blocks"]
    for i in range(cfg.layers):
        pre = f"visual.trunk.blocks.{i}."
        sd.update(_put(b, pre, _TIMM_BLOCK, i))
        ipb = _f32(b["in_proj_b"][i])
        if eva:
            sd[pre + "attn.q_bias"], sd[pre + "attn.v_bias"] = ipb[:D].copy(), ipb[2 * D:].copy()
            if k_bias:
                sd[pre + "attn.k_bias"] = ipb[D:2 * D].copy()
        else:
            sd[pre + "attn.qkv.bias"] = ipb
    return sd


def rope_perm_interleaved_to_half(head_dim: int) -> np.ndarray:
    """The q/k channel permutation from timm's interleaved rope pairing to
    the JAX package's rotate-half one: ``new[i] = old[2i]``,
    ``new[i + D/2] = old[2i + 1]``."""
    half = head_dim // 2
    return np.concatenate([np.arange(half) * 2, np.arange(half) * 2 + 1])


def _eva02_rope_qk_perm(ipw: np.ndarray, ipb: np.ndarray, cfg, inverse: bool = False):
    """Permute the q and k output channels of the packed in-projection from
    timm's order to JAX's (``inverse``: back); v untouched, nothing without
    rope."""
    if not cfg.use_rope:
        return ipw, ipb
    D, Dh = cfg.width, cfg.head_width
    perm = rope_perm_interleaved_to_half(Dh)
    if inverse:
        perm = np.argsort(perm)
    idx = np.arange(D).reshape(D // Dh, Dh)[:, perm].reshape(-1)
    full = np.concatenate([idx, D + idx, 2 * D + np.arange(D)])
    return ipw[:, full], ipb[full]


_EVA02_BLOCK = {
    "norm1.weight": ("ln_1_scale", False), "norm1.bias": ("ln_1_bias", False),
    "attn.proj.weight": ("out_proj_w", True), "attn.proj.bias": ("out_proj_b", False),
    "norm2.weight": ("ln_2_scale", False), "norm2.bias": ("ln_2_bias", False),
}
_EVA02_NORM = {"attn.norm.weight": ("attn_norm_scale", False),
               "attn.norm.bias": ("attn_norm_bias", False)}
_EVA02_SWIGLU = {
    "mlp.fc1_g.weight": ("w1g", True), "mlp.fc1_g.bias": ("b1g", False),
    "mlp.fc1_x.weight": ("w1x", True), "mlp.fc1_x.bias": ("b1x", False),
    "mlp.norm.weight": ("ln_sub_scale", False), "mlp.norm.bias": ("ln_sub_bias", False),
    "mlp.fc2.weight": ("w2", True), "mlp.fc2.bias": ("b2", False),
}
_EVA02_MLP = {
    "mlp.fc1.weight": ("c_fc_w", True), "mlp.fc1.bias": ("c_fc_b", False),
    "mlp.fc2.weight": ("c_proj_w", True), "mlp.fc2.bias": ("c_proj_b", False),
}


def _eva02_keys(cfg) -> Dict[str, Tuple[str, bool]]:
    return {**_EVA02_BLOCK, **(_EVA02_NORM if cfg.inner_attn_norm else {}),
            **(_EVA02_SWIGLU if cfg.swiglu else _EVA02_MLP)}


def _eva02_from_sd(sd, cfg) -> Dict[str, Any]:
    """timm's EVA02 keys -> the JAX subtree: fused ``attn.qkv`` with q/v
    biases or split ``attn.{q,k,v}_proj`` pack into one in-projection with
    a zero k bias, its q/k channels in JAX's rotate-half order."""
    D = cfg.width
    blocks = _stack_layers(sd, "visual.trunk.blocks.", cfg.layers, _eva02_keys(cfg))
    ipws, ipbs = [], []
    for i in range(cfg.layers):
        pre = f"visual.trunk.blocks.{i}.attn."
        if pre + "qkv.weight" in sd:
            ipw = _f32(sd[pre + "qkv.weight"]).T
            q_b, v_b = _f32(sd[pre + "q_bias"]), _f32(sd[pre + "v_bias"])
        else:
            ipw = np.concatenate([_f32(sd[f"{pre}{n}_proj.weight"]).T for n in "qkv"], axis=1)
            q_b, v_b = _f32(sd[pre + "q_proj.bias"]), _f32(sd[pre + "v_proj.bias"])
        ipw, ipb = _eva02_rope_qk_perm(ipw, np.concatenate([q_b, _k_bias(sd, pre, D), v_b]), cfg)
        ipws.append(ipw)
        ipbs.append(ipb)
    blocks["in_proj_w"], blocks["in_proj_b"] = np.stack(ipws), np.stack(ipbs)
    return {
        "patch_kernel": _conv_to_patch(sd["visual.trunk.patch_embed.proj.weight"]),
        "patch_bias": _f32(sd["visual.trunk.patch_embed.proj.bias"]),
        "class_embedding": _f32(sd["visual.trunk.cls_token"]).reshape(D),
        "pos_embed": _f32(sd["visual.trunk.pos_embed"]).reshape(-1, D),
        "blocks": blocks,
        "ln_post_scale": _f32(sd["visual.trunk.norm.weight"]),
        "ln_post_bias": _f32(sd["visual.trunk.norm.bias"]),
        "proj": _t(sd["visual.trunk.head.weight"]),
        "proj_b": _f32(sd["visual.trunk.head.bias"]),
    }


def _eva02_to_sd(v, cfg, k_bias: bool = False) -> Dict[str, np.ndarray]:
    D = cfg.width
    sd = {"visual.trunk.patch_embed.proj.weight": _patch_to_conv(v["patch_kernel"],
                                                                 cfg.patch_size, D),
          "visual.trunk.patch_embed.proj.bias": _f32(v["patch_bias"]),
          "visual.trunk.cls_token": _f32(v["class_embedding"]).reshape(1, 1, D),
          "visual.trunk.pos_embed": _f32(v["pos_embed"])[None],
          "visual.trunk.norm.weight": _f32(v["ln_post_scale"]),
          "visual.trunk.norm.bias": _f32(v["ln_post_bias"]),
          "visual.trunk.head.weight": _t(v["proj"]),
          "visual.trunk.head.bias": _f32(v["proj_b"])}
    b = v["blocks"]
    for i in range(cfg.layers):
        pre = f"visual.trunk.blocks.{i}."
        sd.update(_put(b, pre, _eva02_keys(cfg), i))
        ipw, ipb = _eva02_rope_qk_perm(_f32(b["in_proj_w"][i]), _f32(b["in_proj_b"][i]), cfg,
                                       inverse=True)
        if cfg.qkv_fused:
            sd[pre + "attn.qkv.weight"] = _t(ipw)
            sd[pre + "attn.q_bias"] = ipb[:D].copy()
            sd[pre + "attn.v_bias"] = ipb[2 * D:].copy()
        else:
            for j, n in enumerate("qkv"):
                sd[f"{pre}attn.{n}_proj.weight"] = _t(ipw[:, j * D:(j + 1) * D])
            sd[pre + "attn.q_proj.bias"] = ipb[:D].copy()
            sd[pre + "attn.v_proj.bias"] = ipb[2 * D:].copy()
        if k_bias:
            sd[pre + "attn.k_bias"] = ipb[D:2 * D].copy()
    return sd


_SWIN_BLOCK = {
    "norm1.weight": ("ln_1_scale", False), "norm1.bias": ("ln_1_bias", False),
    "attn.qkv.weight": ("in_proj_w", True), "attn.qkv.bias": ("in_proj_b", False),
    "attn.relative_position_bias_table": ("bias_table", False),
    "attn.proj.weight": ("out_proj_w", True), "attn.proj.bias": ("out_proj_b", False),
    "norm2.weight": ("ln_2_scale", False), "norm2.bias": ("ln_2_bias", False),
    "mlp.fc1.weight": ("c_fc_w", True), "mlp.fc1.bias": ("c_fc_b", False),
    "mlp.fc2.weight": ("c_proj_w", True), "mlp.fc2.bias": ("c_proj_b", False),
}
_SWIN_MERGE = {"norm.weight": ("norm_scale", False), "norm.bias": ("norm_bias", False),
               "reduction.weight": ("reduction_w", True)}


def _swin_from_sd(sd, cfg) -> Dict[str, Any]:
    stages = []
    for s, depth in enumerate(SWIN_TRUNKS[cfg.trunk]["depths"]):
        stage: Dict[str, Any] = {}
        if s > 0:
            stage["merge"] = _pick(sd, f"visual.trunk.layers.{s}.downsample.", _SWIN_MERGE)
        stage["blocks"] = [_pick(sd, f"visual.trunk.layers.{s}.blocks.{b}.", _SWIN_BLOCK)
                           for b in range(depth)]
        stages.append(stage)
    return {
        "patch_kernel": _conv_to_patch(sd["visual.trunk.patch_embed.proj.weight"]),
        "patch_bias": _f32(sd["visual.trunk.patch_embed.proj.bias"]),
        "patch_norm_scale": _f32(sd["visual.trunk.patch_embed.norm.weight"]),
        "patch_norm_bias": _f32(sd["visual.trunk.patch_embed.norm.bias"]),
        "stages": stages,
        "norm_scale": _f32(sd["visual.trunk.norm.weight"]),
        "norm_bias": _f32(sd["visual.trunk.norm.bias"]),
        "proj": _t(sd["visual.head.proj.weight"]),
    }


def _swin_to_sd(v, cfg, k_bias: bool = False) -> Dict[str, np.ndarray]:
    P = SWIN_TRUNKS[cfg.trunk]["patch_size"]
    D0 = np.shape(v["patch_norm_scale"])[0]
    sd = {"visual.trunk.patch_embed.proj.weight": _patch_to_conv(v["patch_kernel"], P, D0),
          "visual.trunk.patch_embed.proj.bias": _f32(v["patch_bias"]),
          "visual.trunk.patch_embed.norm.weight": _f32(v["patch_norm_scale"]),
          "visual.trunk.patch_embed.norm.bias": _f32(v["patch_norm_bias"]),
          "visual.trunk.norm.weight": _f32(v["norm_scale"]),
          "visual.trunk.norm.bias": _f32(v["norm_bias"]),
          "visual.head.proj.weight": _t(v["proj"])}
    for s, stage in enumerate(v["stages"]):
        if "merge" in stage:
            sd.update(_put(stage["merge"], f"visual.trunk.layers.{s}.downsample.", _SWIN_MERGE))
        for b, p in enumerate(stage["blocks"]):
            sd.update(_put(p, f"visual.trunk.layers.{s}.blocks.{b}.", _SWIN_BLOCK))
    return sd


_RELPOS_BLOCK = {
    "norm1.weight": ("ln_1_scale", False), "norm1.bias": ("ln_1_bias", False),
    "attn.qkv.weight": ("in_proj_w", True),
    "attn.rel_pos.mlp.fc1.weight": ("mlp_fc1_w", True),
    "attn.rel_pos.mlp.fc1.bias": ("mlp_fc1_b", False),
    "attn.rel_pos.mlp.fc2.weight": ("mlp_fc2_w", True),
    "attn.rel_pos.mlp.fc2.bias": ("mlp_fc2_b", False),
    "attn.proj.weight": ("out_proj_w", True), "attn.proj.bias": ("out_proj_b", False),
    "ls1.gamma": ("ls_1", False),
    "norm2.weight": ("ln_2_scale", False), "norm2.bias": ("ln_2_bias", False),
    "mlp.fc1.weight": ("c_fc_w", True), "mlp.fc1.bias": ("c_fc_b", False),
    "mlp.fc2.weight": ("c_proj_w", True), "mlp.fc2.bias": ("c_proj_b", False),
    "ls2.gamma": ("ls_2", False),
}


def _relpos_from_sd(sd, cfg) -> Dict[str, Any]:
    t = RELPOS_TRUNKS[cfg.trunk]
    return {
        "patch_kernel": _conv_to_patch(sd["visual.trunk.patch_embed.proj.weight"]),
        "patch_bias": _f32(sd["visual.trunk.patch_embed.proj.bias"]),
        "class_embedding": _f32(sd["visual.trunk.cls_token"]).reshape(t["width"]),
        "blocks": [_pick(sd, f"visual.trunk.blocks.{i}.", _RELPOS_BLOCK)
                   for i in range(t["layers"])],
        "norm_scale": _f32(sd["visual.trunk.norm.weight"]),
        "norm_bias": _f32(sd["visual.trunk.norm.bias"]),
        "proj": _t(sd["visual.head.proj.weight"]),
    }


def _relpos_to_sd(v, cfg, k_bias: bool = False) -> Dict[str, np.ndarray]:
    t = RELPOS_TRUNKS[cfg.trunk]
    D = t["width"]
    sd = {"visual.trunk.patch_embed.proj.weight": _patch_to_conv(v["patch_kernel"],
                                                                 t["patch_size"], D),
          "visual.trunk.patch_embed.proj.bias": _f32(v["patch_bias"]),
          "visual.trunk.cls_token": _f32(v["class_embedding"]).reshape(1, 1, D),
          "visual.trunk.norm.weight": _f32(v["norm_scale"]),
          "visual.trunk.norm.bias": _f32(v["norm_bias"]),
          "visual.head.proj.weight": _t(v["proj"])}
    for i, p in enumerate(v["blocks"]):
        sd.update(_put(p, f"visual.trunk.blocks.{i}.", _RELPOS_BLOCK))
    return sd


_CONVNEXT_BLOCK = {
    "conv_dw.bias": ("dw_b", False), "norm.weight": ("norm_scale", False),
    "norm.bias": ("norm_bias", False), "mlp.fc1.weight": ("fc1_w", True),
    "mlp.fc1.bias": ("fc1_b", False), "mlp.fc2.weight": ("fc2_w", True),
    "mlp.fc2.bias": ("fc2_b", False), "gamma": ("gamma", False),
}


def _convnext_from_sd(sd, cfg) -> Dict[str, Any]:
    stem = {"conv_w": _hwio(sd["visual.trunk.stem.0.weight"]),
            "conv_b": _f32(sd["visual.trunk.stem.0.bias"]),
            "norm_scale": _f32(sd["visual.trunk.stem.1.weight"]),
            "norm_bias": _f32(sd["visual.trunk.stem.1.bias"])}
    stages = []
    for s, depth in enumerate(cfg.depths):
        stage: Dict[str, Any] = {}
        if s > 0:
            pre = f"visual.trunk.stages.{s}.downsample"
            stage["down"] = {"norm_scale": _f32(sd[f"{pre}.0.weight"]),
                             "norm_bias": _f32(sd[f"{pre}.0.bias"]),
                             "conv_w": _hwio(sd[f"{pre}.1.weight"]),
                             "conv_b": _f32(sd[f"{pre}.1.bias"])}
        pre = f"visual.trunk.stages.{s}.blocks."
        blocks = {"dw_w": np.stack([_hwio(sd[f"{pre}{b}.conv_dw.weight"]) for b in range(depth)])}
        blocks.update(_stack_layers(sd, pre, depth, _CONVNEXT_BLOCK))
        stage["blocks"] = blocks
        stages.append(stage)
    head = {"norm_scale": _f32(sd["visual.trunk.head.norm.weight"]),
            "norm_bias": _f32(sd["visual.trunk.head.norm.bias"])}
    if "visual.head.proj.weight" in sd:
        head["proj_w"] = _t(sd["visual.head.proj.weight"])
    if "visual.head.mlp.fc1.weight" in sd:
        head["mlp_fc1_w"] = _t(sd["visual.head.mlp.fc1.weight"])
        head["mlp_fc1_b"] = _f32(sd["visual.head.mlp.fc1.bias"])
        head["mlp_fc2_w"] = _t(sd["visual.head.mlp.fc2.weight"])
    return {"stem": stem, "stages": stages, "head": head}


def _convnext_to_sd(v, cfg, k_bias: bool = False) -> Dict[str, np.ndarray]:
    st = v["stem"]
    sd = {"visual.trunk.stem.0.weight": _oihw(st["conv_w"]),
          "visual.trunk.stem.0.bias": _f32(st["conv_b"]),
          "visual.trunk.stem.1.weight": _f32(st["norm_scale"]),
          "visual.trunk.stem.1.bias": _f32(st["norm_bias"])}
    for s, stage in enumerate(v["stages"]):
        if s > 0:
            pre, d = f"visual.trunk.stages.{s}.downsample", stage["down"]
            sd.update({f"{pre}.0.weight": _f32(d["norm_scale"]), f"{pre}.0.bias": _f32(d["norm_bias"]),
                       f"{pre}.1.weight": _oihw(d["conv_w"]), f"{pre}.1.bias": _f32(d["conv_b"])})
        blocks = stage["blocks"]
        for b in range(np.shape(blocks["gamma"])[0]):
            pre = f"visual.trunk.stages.{s}.blocks.{b}."
            sd[pre + "conv_dw.weight"] = _oihw(blocks["dw_w"][b])
            sd.update(_put(blocks, pre, _CONVNEXT_BLOCK, b))
    h = v["head"]
    sd["visual.trunk.head.norm.weight"] = _f32(h["norm_scale"])
    sd["visual.trunk.head.norm.bias"] = _f32(h["norm_bias"])
    if "proj_w" in h:
        sd["visual.head.proj.weight"] = _t(h["proj_w"])
    if "mlp_fc1_w" in h:
        sd["visual.head.mlp.fc1.weight"] = _t(h["mlp_fc1_w"])
        sd["visual.head.mlp.fc1.bias"] = _f32(h["mlp_fc1_b"])
        sd["visual.head.mlp.fc2.weight"] = _t(h["mlp_fc2_w"])
    return sd


def _tower_converters(v):
    """``(JAX subtree -> state dict, state dict -> JAX subtree)`` of a vision
    tower whose keys are not the native ViT's, else None."""
    if isinstance(v, VisionConfig):
        return (_timm_vit_to_sd, _timm_vit_from_sd) if v.timm_trunk else None
    return {ResNetVisionConfig: (_resnet_to_sd, _resnet_from_sd),
            ConvNeXtVisionConfig: (_convnext_to_sd, _convnext_from_sd),
            Eva02VisionConfig: (_eva02_to_sd, _eva02_from_sd),
            SwinVisionConfig: (_swin_to_sd, _swin_from_sd),
            RelPosVisionConfig: (_relpos_to_sd, _relpos_from_sd)}[type(v)]


def _normalize_state_dict(sd: Dict[str, Any], fold_text: bool = True) -> Dict[str, Any]:
    """Strip DDP (``module.``) and CustomCLIP (``clip_model.``) prefixes and,
    with ``fold_text``, fold a separate-tower ``text.*`` layout back into the
    fused one (never a CoCa file's, whose ``text.*`` sits beside
    ``text_decoder.*``)."""
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items() if k.startswith("module.")}
    if any(k.startswith("clip_model.") for k in sd):
        out = {}
        for k, v in sd.items():
            if k.startswith("clip_model."):
                out[k[len("clip_model."):]] = v
            elif k.startswith("memory_bank.") or not any(
                    k.startswith(p) for p in ("visual.", "transformer.", "image_adapter.")):
                out.setdefault(k, v)
        sd = {k: v for k, v in out.items() if not k.startswith("image_adapter.")}
    if (fold_text and any(k.startswith("text.") for k in sd) and "text_projection" not in sd
            and not any(k.startswith("text_decoder.") for k in sd)):
        sd = {(k[len("text."):] if k.startswith("text.") else k): v for k, v in sd.items()}
    return sd


def _unstack_blocks(blocks: Dict[str, np.ndarray], prefix: str, stem: str = "resblocks",
                    extra: Optional[Mapping] = None) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    keys = {**_BLOCK_KEYS, **_LS_KEYS, **(extra or {})}
    unknown = set(blocks) - set(keys)
    if unknown:
        raise NotImplementedError(f"block parameters {sorted(unknown)} are not ported")
    for ours, (suffix, transpose) in keys.items():
        if ours not in blocks:
            continue
        arr = np.asarray(blocks[ours], dtype=np.float32)
        for i in range(arr.shape[0]):
            out[f"{prefix}{stem}.{i}.{suffix}"] = arr[i].T if transpose else arr[i]
    return out


def _vit_to_sd(v, cfg) -> Dict[str, np.ndarray]:
    """The native ViT's keys (``visual.*``), with CoCa's attentional pool."""
    P, D = cfg.patch_size, cfg.width
    sd = {"visual.conv1.weight": _patch_to_conv(v["patch_kernel"], P, D)}
    if "patch_bias" in v:
        sd["visual.conv1.bias"] = v["patch_bias"]
    sd.update({name: v[k] for k, name in _VISUAL_KEYS.items() if k in v})
    sd.update(_unstack_blocks(v["blocks"], "visual.transformer."))
    sd.update({_MAP_HEAD + k: a for k, a in v.get("map_head", {}).items()})
    sd.update({"visual.attn_pool." + theirs: v["attn_pool"][ours]
               for ours, theirs in _ATTN_POOL_KEYS.items() if "attn_pool" in v})
    return sd


def _vit_from_sd(sd, cfg) -> Dict[str, np.ndarray]:
    P, D = cfg.patch_size, cfg.width
    visual = {k: sd[name] for k, name in _VISUAL_KEYS.items() if name in sd}
    visual["patch_kernel"] = sd["visual.conv1.weight"].transpose(2, 3, 1, 0).reshape(P * P * 3, D)
    if "visual.conv1.bias" in sd:
        visual["patch_bias"] = sd["visual.conv1.bias"]
    visual["blocks"] = _stack_blocks(sd, "visual.transformer.resblocks.")
    map_head = {k[len(_MAP_HEAD):]: a for k, a in sd.items() if k.startswith(_MAP_HEAD)}
    if map_head:
        visual["map_head"] = map_head
    if "visual.attn_pool.query" in sd:
        visual["attn_pool"] = {ours: sd["visual.attn_pool." + theirs]
                               for ours, theirs in _ATTN_POOL_KEYS.items()}
    return visual


def _hf_text_to_sd(t, cfg: HFTextConfig) -> Dict[str, np.ndarray]:
    sd = {_HF_PREFIX + k: a for k, a in export_hf_state_dict(t, cfg).items()}
    sd.update(proj_to_state_dict(t, "text."))
    return sd


def _hf_text_from_sd(sd, cfg: HFTextConfig) -> Dict[str, np.ndarray]:
    text = import_hf_state_dict({k[len(_HF_PREFIX):]: a for k, a in sd.items()
                                 if k.startswith(_HF_PREFIX)}, cfg)
    text.update(proj_from_state_dict(sd, "text."))
    return text


_COCA_TEXT_KEYS = {
    "token_embedding": "text.token_embedding.weight", "cls_emb": "text.cls_emb",
    "pos_embed": "text.positional_embedding", "ln_final_scale": "text.ln_final.weight",
    "ln_final_bias": "text.ln_final.bias", "text_projection": "text.text_projection",
}
_DECODER_KEYS = {"ln_final_scale": "text_decoder.ln_final.weight",
                 "ln_final_bias": "text_decoder.ln_final.bias",
                 "text_projection": "text_decoder.text_projection"}


def _coca_to_sd(params, cfg) -> Dict[str, np.ndarray]:
    """JAX ``coca_params_to_state_dict`` (without the memory bank)."""
    t, d = params["text"], params["text_decoder"]
    sd = {"logit_scale": np.asarray(params["logit_scale"], np.float32).reshape(())}
    sd.update(_vit_to_sd(params["visual"], cfg.vision))
    if isinstance(cfg.text, HFTextConfig):
        sd.update(_hf_text_to_sd(t, cfg.text))
    else:
        sd.update({name: t[k] for k, name in _COCA_TEXT_KEYS.items()})
        sd.update(_unstack_blocks(t["blocks"], "text.transformer."))
    sd.update(_unstack_blocks(d["blocks"], "text_decoder."))
    sd.update(_unstack_blocks(d["cross"], "text_decoder.", "cross_attn", _CROSS_EXTRA))
    sd.update({name: d[k] for k, name in _DECODER_KEYS.items()})
    return sd


def _coca_from_sd(sd, cfg) -> Dict[str, Any]:
    """JAX ``coca_state_dict_to_params``."""
    if isinstance(cfg.text, HFTextConfig):
        text = _hf_text_from_sd(sd, cfg.text)
    else:
        text = {k: sd[name] for k, name in _COCA_TEXT_KEYS.items()}
        text["blocks"] = _stack_blocks(sd, "text.transformer.resblocks.")
    decoder = {k: sd[name] for k, name in _DECODER_KEYS.items()}
    decoder["blocks"] = _stack_blocks(sd, "text_decoder.resblocks.")
    decoder["cross"] = _stack_blocks(sd, "text_decoder.cross_attn.", _CROSS_EXTRA)
    return {"visual": _vit_from_sd(sd, cfg.vision), "text": text, "text_decoder": decoder,
            "logit_scale": sd["logit_scale"].reshape(())}


def state_dict_from_jax_params(params: Dict[str, Any], cfg: CLIPConfig, *,
                               k_bias: bool = False) -> "OrderedDict[str, torch.Tensor]":
    """JAX parameter tree (numpy leaves) -> the port's float32 state dict;
    ``k_bias`` adds EVA's trained k bias, which a checkpoint leaves out
    (:class:`~latteclip_torch.models.layers.EvaAttention`), under its
    parameter name."""
    if isinstance(cfg, CoCaConfig):
        return OrderedDict((k, torch.from_numpy(np.array(a, dtype=np.float32, order="C")))
                           for k, a in _coca_to_sd(params, cfg).items())
    v, t = params["visual"], params["text"]
    hf = isinstance(cfg.text, HFTextConfig)
    convert = _tower_converters(cfg.vision)
    visual_keys = set() if convert else \
        set(v) - set(_VISUAL_KEYS) - {"patch_kernel", "patch_bias", "blocks", "map_head"}
    text_keys = set() if hf else set(t) - set(_TEXT_KEYS) - {"blocks", "text_projection_b"}
    extra = visual_keys | text_keys | \
        (set(params) - {"visual", "text", "logit_scale", "logit_bias"})
    if extra:
        raise NotImplementedError(f"parameters {sorted(extra)} belong to towers not ported yet")
    sd: Dict[str, np.ndarray] = {"logit_scale": np.asarray(params["logit_scale"], np.float32).reshape(())}
    if convert:
        sd.update(convert[0](v, cfg.vision, k_bias=k_bias))
    else:
        sd.update(_vit_to_sd(v, cfg.vision))
    if hf:
        sd.update(_hf_text_to_sd(t, cfg.text))
    else:
        sd.update({name: t[k] for k, name in _TEXT_KEYS.items()})
        sd.update(_unstack_blocks(t["blocks"], "transformer."))
    if "text_projection_b" in t:
        sd[_TEXT_PROJECTION_B] = t["text_projection_b"]
    if "logit_bias" in params:
        sd["logit_bias"] = np.asarray(params["logit_bias"], np.float32).reshape(())
    return OrderedDict(
        (k, torch.from_numpy(np.array(a, dtype=np.float32, order="C"))) for k, a in sd.items())


def resize_vision_pos_embed(pos: torch.Tensor, target_seq: int,
                            cls_token: bool = True) -> torch.Tensor:
    """Resize a [L, D] vision positional embedding to ``target_seq`` rows
    over a square grid: JAX ``jax.image.resize(method="bicubic")``, Keys'
    cubic (a = -0.5) at half-pixel centres, weights renormalised at the
    edges and antialiased when it shrinks (:func:`crop_weights` over the
    whole grid). With ``cls_token`` row 0 is the class token's and is kept
    as it is; without, every row is a patch's."""
    if pos.shape[0] == target_seq:
        return pos
    n_tok = 1 if cls_token else 0
    tok, grid_part = pos[:n_tok], pos[n_tok:].float()
    old_g = int(round(len(grid_part) ** 0.5))
    new_g = int(round((target_seq - n_tok) ** 0.5))
    if old_g * old_g != len(grid_part) or new_g * new_g != target_seq - n_tok:
        raise ValueError(f"cannot grid-resize pos embed of {pos.shape[0]} rows "
                         f"(cls_token={cls_token}) to {target_seq}: non-square grid")
    w = crop_weights(old_g, new_g, torch.zeros(1), torch.full((1,), float(old_g)))[0]
    img = grid_part.reshape(old_g, old_g, -1)
    rows = torch.einsum("ho,hwd->owd", w, img)
    resized = torch.einsum("wp,owd->opd", w, rows).reshape(new_g * new_g, -1)
    return torch.cat([tok.to(resized.dtype), resized], dim=0)


_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file (HF hub checkpoints): a u64-LE header length,
    a JSON header of name -> {dtype, shape, data_offsets}, then the raw
    little-endian buffers. Each tensor's bytes are read straight into its own
    storage, so the host holds the checkpoint once."""
    out = {}
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            lo, hi = meta["data_offsets"]
            flat = torch.empty(hi - lo, dtype=torch.uint8)
            f.seek(8 + header_len + lo)
            if f.readinto(memoryview(flat.numpy())) != hi - lo:
                raise ValueError(f"{path}: {name} is truncated")
            out[name] = flat.view(_ST_DTYPES[meta["dtype"]]).reshape(meta["shape"])
    return out


# buffers of OpenCLIP/timm modules that the port derives or does not keep
_DERIVED_BUFFERS = ("num_batches_tracked", "relative_position_index", "attn_mask",
                    "rel_coords_log", "rel_pos.relative_position_index")


def _is_torchscript_zip(path: str) -> bool:
    import zipfile

    try:
        with zipfile.ZipFile(path) as z:
            return any(n.endswith("constants.pkl") for n in z.namelist())
    except (zipfile.BadZipFile, OSError):
        return False


def load_clip_pt(path: str, cfg: CLIPConfig, device="cuda"
                 ) -> Tuple[CLIP, Optional[torch.Tensor], List[str], Dict[str, Any]]:
    """Load a ``.pt`` checkpoint -> ``(model, memory_bank [C, D] or None,
    classnames, meta)``; ``meta`` holds the training checkpoint's other keys
    (epoch, name, step, optimizer). An OpenAI TorchScript archive loads
    through ``torch.jit.load``; the buffers timm and OpenCLIP keep that the
    port derives or drops (``num_batches_tracked``, Swin's and relpos's
    indices and masks) are skipped. As in JAX, the vision positional
    embedding (a timm trunk's ``pos_embed`` too) is resized to ``cfg``'s
    grid, the model has
    ``text_projection_b`` and ``logit_bias`` where the file does (the
    returned model's config takes the file's logit bias). A big_vision
    ``.npz`` (SigLIP) reads through :mod:`latteclip_torch.big_vision`."""
    dev = resolve_device(device)
    if path.endswith(".npz"):  # big_vision (SigLIP): no bank, no classnames, as in JAX
        from latteclip_torch.big_vision import load_big_vision_npz

        obj = load_big_vision_npz(path, cfg)
    elif path.endswith(".safetensors"):
        obj = load_safetensors(path)
    elif _is_torchscript_zip(path):  # OpenAI's original checkpoints (RN50, ...)
        obj = {k: v.float() for k, v in torch.jit.load(path, map_location="cpu").state_dict().items()
               if k not in ("input_resolution", "context_length", "vocab_size")}
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    meta: Dict[str, Any] = {}
    if isinstance(obj, dict) and "state_dict" in obj:
        meta = {k: v for k, v in obj.items() if k != "state_dict"}
        obj = obj["state_dict"]
    hf = isinstance(cfg.text, HFTextConfig)
    sd = _normalize_state_dict(dict(obj), fold_text=not hf)
    classnames = [k[len("memory_bank."):] for k in sd if k.startswith("memory_bank.")]
    bank = None
    if classnames:
        bank = torch.stack([torch.as_tensor(sd.pop(f"memory_bank.{c}")).float()
                            for c in classnames]).to(dev)
    sd = {k: v for k, v in sd.items() if not k.endswith(_DERIVED_BUFFERS)}
    v = cfg.vision
    for key in ("visual.positional_embedding", "visual.trunk.pos_embed"):
        if key in sd and isinstance(v, (VisionConfig, Eva02VisionConfig)):
            pos = torch.as_tensor(sd[key])
            resized = resize_vision_pos_embed(pos.reshape(-1, pos.shape[-1]), v.seq_len,
                                              cls_token=not getattr(v, "no_cls_token", False))
            sd[key] = resized.reshape((1,) * (pos.dim() - 2) + tuple(resized.shape))
    bias = float(torch.as_tensor(sd["logit_bias"])) if "logit_bias" in sd else None
    if bias != cfg.init_logit_bias:
        cfg = dataclasses.replace(cfg, init_logit_bias=bias)
    kwargs = {}
    if hf:
        sd, kwargs["hf_pooler"] = _hf_text_keys(sd, cfg.text)
    if not isinstance(cfg, CoCaConfig):
        kwargs["text_projection_b"] = _TEXT_PROJECTION_B in sd
        kwargs["patch_bias"] = "visual.conv1.bias" in sd
    model = build_model(cfg, **kwargs)
    model.load_state_dict(sd, strict=True)
    return model.to(dev), bank, classnames, meta


def _hf_text_keys(sd: Dict[str, Any], cfg: HFTextConfig) -> Tuple[Dict[str, Any], bool]:
    """An HF tower's keys as JAX reads them (``import_hf_state_dict``, then
    written back): the prefixes of a live ``AutoModel`` stripped, the keys
    JAX leaves out dropped (``position_ids``, a pooler head the tower does
    not pool with, an encoder-decoder's decoder), a folded layout
    (``transformer.*``, ``proj.*``) put back under ``text.``; and whether
    the tower keeps BERT's pooler head."""
    if not any(k.startswith(_HF_PREFIX) for k in sd):
        sd = {("text." + k if k.startswith(("transformer.", "proj.")) else k): v
              for k, v in sd.items()}
    tree = import_hf_state_dict({k[len(_HF_PREFIX):]: v for k, v in sd.items()
                                 if k.startswith(_HF_PREFIX)}, cfg)
    out = {k: v for k, v in sd.items() if not k.startswith(_HF_PREFIX)}
    out.update({_HF_PREFIX + k: torch.from_numpy(a) for k, a in export_hf_state_dict(tree, cfg).items()})
    return out, "pooler_w" in tree


def _stack_blocks(sd: Mapping[str, np.ndarray], prefix: str,
                  extra: Optional[Mapping] = None) -> Dict[str, np.ndarray]:
    layers = len({k[len(prefix):].split(".", 1)[0] for k in sd if k.startswith(prefix)})
    keys = {**_BLOCK_KEYS, **(_LS_KEYS if f"{prefix}0.ls_1.gamma" in sd else {}), **(extra or {})}
    out = {}
    for ours, (suffix, transpose) in keys.items():
        arrs = [sd[f"{prefix}{i}.{suffix}"] for i in range(layers)]
        out[ours] = np.stack([a.T if transpose else a for a in arrs])
    return out


def jax_params_from_state_dict(sd: Mapping[str, Any], cfg: CLIPConfig) -> Dict[str, Any]:
    """The port's state dict (tensors or arrays under its names) -> the JAX
    package's parameter tree of float32 numpy arrays: blocks stacked on a
    layer axis, weights ``[in, out]``, the patch kernel ``[P*P*3, D]``."""
    sd = {k: np.asarray(torch.as_tensor(v).detach().float().cpu()) for k, v in sd.items()}
    if isinstance(cfg, CoCaConfig):
        return _coca_from_sd(sd, cfg)
    convert = _tower_converters(cfg.vision)
    visual = convert[1](sd, cfg.vision) if convert else _vit_from_sd(sd, cfg.vision)
    if isinstance(cfg.text, HFTextConfig):
        text = _hf_text_from_sd(sd, cfg.text)
    else:
        text = {k: sd[name] for k, name in _TEXT_KEYS.items()}
        text["blocks"] = _stack_blocks(sd, "transformer.resblocks.")
    if _TEXT_PROJECTION_B in sd:
        text["text_projection_b"] = sd[_TEXT_PROJECTION_B]
    params = {"visual": visual, "text": text, "logit_scale": sd["logit_scale"].reshape(())}
    if "logit_bias" in sd:
        params["logit_bias"] = sd["logit_bias"].reshape(())
    return params


def _flatten(tree, prefix: str) -> Dict[str, np.ndarray]:
    """{prefix + "['a'][0]['b']": leaf}, ``jax.tree_util.keystr``'s spelling
    (lists, the stages and blocks of some towers, index without quotes)."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        key = f"{prefix}[{k!r}]"
        out.update(_flatten(v, key) if isinstance(v, (Mapping, list)) else {key: v})
    return out


def _listify(node):
    """Nodes whose keys are all list indices become lists."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_listify(node[i]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def _unflatten(flat: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "["):
            continue
        parts = [p[1:-1] if p.startswith("'") else int(p)
                 for p in key[len(prefix) + 1:-1].split("][")]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(torch.as_tensor(v).float())
    return _listify(tree)


def _prefixes(optimizer, accum) -> Tuple[str, str]:
    """(AdamW state, schedule state) key prefixes of the JAX chain
    ``MultiSteps(chain(clip, chain(adamw, masks)))`` for these flags."""
    chain = (".inner_opt_state" if accum is not None else "") + (
        "[1]" if getattr(optimizer, "grad_clip_norm", None) is not None else "")
    return chain + "[0][0]", chain + "[0][2]"


def _count(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


def optimizer_state(model: CLIP, optimizer, accum=None) -> Dict[str, torch.Tensor]:
    """The ``optimizer`` entry of a checkpoint under the JAX package's keys
    (module docstring): AdamW's moments of every parameter (zeros before
    the first update), its count and the schedule's (both
    ``optimizer.count``), and the accumulator of ``accum``."""
    cfg = model.cfg
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    # the JAX tree holds BatchNorm's statistics, which never update: zeros
    buffers = {n: torch.zeros_like(b) for n, b in model.state_dict().items() if n not in params}

    def moments(key):
        return {**buffers, **{n: optimizer.state[params[n]][key] if params[n] in optimizer.state
                              else torch.zeros_like(params[n]) for n in names}}

    adam, sched = _prefixes(optimizer, accum)
    flat: Dict[str, Any] = {f"{adam}.count": _count(optimizer.count)}
    flat.update(_flatten(jax_params_from_state_dict(moments("exp_avg"), cfg), f"{adam}.mu"))
    flat.update(_flatten(jax_params_from_state_dict(moments("exp_avg_sq"), cfg), f"{adam}.nu"))
    flat[f"{sched}.count"] = _count(optimizer.count)
    if accum is not None:
        flat[".mini_step"] = _count(accum.mini_step)
        flat[".gradient_step"] = _count(accum.gradient_step)
        flat.update(_flatten(jax_params_from_state_dict(
            {**buffers, **dict(zip(names, accum.grads))}, cfg), ".acc_grads"))
    # np.array, not np.ascontiguousarray: that one turns 0-d leaves into [1]
    return {k: torch.from_numpy(np.array(v, order="C")) if isinstance(v, np.ndarray) else v
            for k, v in flat.items()}


def restore_optimizer_state(model: CLIP, optimizer, saved: Mapping[str, Any], accum=None,
                            allow_missing: Sequence[str] = ("logit_bias",)) -> None:
    """Load :func:`optimizer_state`'s keys (from either package) into
    ``optimizer`` and ``accum``: moments, counts and the accumulator. A key
    these flags need and the file lacks raises ``KeyError``, except for a
    parameter whose name holds one of ``allow_missing``: one added after the
    checkpoint was written (``--siglip`` adds ``logit_bias`` to a plain CLIP)
    keeps fresh moments (zeros, at the restored count) and a zero
    accumulator, and the fact is logged, as JAX's ``restore_opt_state``
    does."""
    cfg = model.cfg
    adam, sched = _prefixes(optimizer, accum)
    for key in (f"{adam}.count", f"{sched}.count"):
        if key not in saved:
            raise KeyError(f"checkpoint optimizer state missing leaf {key}")
    count = int(torch.as_tensor(saved[f"{sched}.count"]).reshape(()))
    mu = state_dict_from_jax_params(_unflatten(saved, f"{adam}.mu"), cfg, k_bias=True)
    nu = state_dict_from_jax_params(_unflatten(saved, f"{adam}.nu"), cfg, k_bias=True)
    adam_count = float(torch.as_tensor(saved[f"{adam}.count"]).reshape(()))
    fresh = set()
    for name, p in model.named_parameters():
        if name not in mu:
            if not any(m in name for m in allow_missing):
                raise KeyError(f"checkpoint optimizer state missing the moments of {name}")
            logging.getLogger("latteclip_torch").warning(
                "optimizer moments of %s absent from checkpoint; keeping fresh moments (param "
                "injected after the checkpoint was written)", name)
            fresh.add(name)
        optimizer.state[p] = {
            "step": torch.tensor(adam_count, dtype=torch.float32),
            **{key: (torch.zeros_like(p) if name in fresh
                     else m[name].to(p.device, p.dtype).reshape(p.shape))
               for key, m in (("exp_avg", mu), ("exp_avg_sq", nu))}}
    optimizer.count = count
    if accum is not None:
        for key in (".mini_step", ".gradient_step"):
            if key not in saved:
                raise KeyError(f"checkpoint optimizer state missing leaf {key}")
        accum.mini_step = int(torch.as_tensor(saved[".mini_step"]).reshape(()))
        accum.gradient_step = int(torch.as_tensor(saved[".gradient_step"]).reshape(()))
        acc = state_dict_from_jax_params(_unflatten(saved, ".acc_grads"), cfg, k_bias=True)
        for g, (name, p) in zip(accum.grads, model.named_parameters()):
            if name in fresh:
                g.zero_()
            else:
                g.copy_(acc[name].reshape(p.shape))


def state_dict_with_bank(model: CLIP, memory_bank: Optional[torch.Tensor] = None,
                         classnames: Optional[Sequence[str]] = None) -> "OrderedDict[str, torch.Tensor]":
    """The model's float32 state dict on the host, then ``memory_bank.<class>``
    rows. An int8 model (``models/quantize.py``) is refused: it serves only."""
    from latteclip_torch.models.quantize import is_quantized

    if is_quantized(model):
        raise ValueError("an int8 model is not saved: save the float model it came from")
    sd = OrderedDict((k, v.detach().float().cpu().contiguous())
                     for k, v in model.state_dict().items())
    if memory_bank is not None:
        if classnames is None or len(classnames) != len(memory_bank):
            raise ValueError("memory_bank needs one class name per row")
        for cname, row in zip(classnames, torch.as_tensor(memory_bank).detach().float().cpu()):
            sd[f"memory_bank.{cname}"] = row.clone()
    return sd


def save_clip_pt(path: str, model: CLIP, *, epoch: Optional[int] = None,
                 name: Optional[str] = None, memory_bank: Optional[torch.Tensor] = None,
                 classnames: Optional[Sequence[str]] = None,
                 optimizer: Optional[Dict[str, torch.Tensor]] = None,
                 step: Optional[int] = None) -> None:
    """Write a training checkpoint in OpenCLIP's layout (module docstring)
    to ``path + ".tmp"``, then ``os.replace`` it onto ``path``.
    ``optimizer`` is :func:`optimizer_state`'s dict."""
    obj: Dict[str, Any] = {"state_dict": state_dict_with_bank(model, memory_bank, classnames)}
    if epoch is not None:
        obj["epoch"] = epoch
    if name is not None:
        obj["name"] = name
    if optimizer is not None:
        obj["optimizer"] = optimizer
    if step is not None:
        obj["step"] = int(step)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
