"""Checkpoint IO for the port (from ``latteclip_tpu/core/checkpoint.py``).

* :func:`load_clip_pt` reads an OpenCLIP/LatteCLIP ``.pt`` file (a bare
  state dict or a ``{"state_dict": ..., "epoch": ...}`` training checkpoint),
  strips the ``module.``/``clip_model.`` wrapper prefixes, splits off the
  ``memory_bank.<class>`` prototype keys and loads the rest into a
  :class:`~latteclip_torch.models.clip.CLIP` with ``strict=True``.
* :func:`state_dict_from_jax_params` turns the JAX package's parameter tree
  (numpy arrays, ``[in, out]`` weights stacked on a layer axis) into the
  port's state dict; it mirrors the native-ViT branch of
  ``params_to_pt_state_dict``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from latteclip_torch.config import CLIPConfig
from latteclip_torch.device import resolve_device
from latteclip_torch.models.clip import CLIP

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


def _normalize_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip DDP (``module.``) and CustomCLIP (``clip_model.``) prefixes and
    fold a separate-tower ``text.*`` layout back into the fused one."""
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
    if (any(k.startswith("text.") for k in sd) and "text_projection" not in sd
            and not any(k.startswith("text_decoder.") for k in sd)):
        sd = {(k[len("text."):] if k.startswith("text.") else k): v for k, v in sd.items()}
    return sd


def _unstack_blocks(blocks: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    unknown = set(blocks) - set(_BLOCK_KEYS)
    if unknown:
        raise NotImplementedError(f"block parameters {sorted(unknown)} are not ported")
    for ours, (suffix, transpose) in _BLOCK_KEYS.items():
        if ours not in blocks:
            continue
        arr = np.asarray(blocks[ours], dtype=np.float32)
        for i in range(arr.shape[0]):
            out[f"{prefix}resblocks.{i}.{suffix}"] = arr[i].T if transpose else arr[i]
    return out


def state_dict_from_jax_params(params: Dict[str, Any], cfg: CLIPConfig) -> "OrderedDict[str, torch.Tensor]":
    """JAX parameter tree (numpy leaves) -> the port's float32 state dict."""
    v, t = params["visual"], params["text"]
    extra = (set(v) - set(_VISUAL_KEYS) - {"patch_kernel", "blocks"}) | \
        (set(t) - set(_TEXT_KEYS) - {"blocks"}) | (set(params) - {"visual", "text", "logit_scale"})
    if extra:
        raise NotImplementedError(f"parameters {sorted(extra)} belong to towers not ported yet")
    P, D = cfg.vision.patch_size, cfg.vision.width
    sd: Dict[str, np.ndarray] = {
        "logit_scale": np.asarray(params["logit_scale"], np.float32).reshape(()),
        "visual.conv1.weight": np.asarray(v["patch_kernel"], np.float32)
        .reshape(P, P, 3, D).transpose(3, 2, 0, 1),
    }
    sd.update({name: v[k] for k, name in _VISUAL_KEYS.items()})
    sd.update(_unstack_blocks(v["blocks"], "visual.transformer."))
    sd.update({name: t[k] for k, name in _TEXT_KEYS.items()})
    sd.update(_unstack_blocks(t["blocks"], "transformer."))
    return OrderedDict(
        (k, torch.from_numpy(np.array(a, dtype=np.float32, order="C"))) for k, a in sd.items())


def load_clip_pt(path: str, cfg: CLIPConfig, device="cuda"
                 ) -> Tuple[CLIP, Optional[torch.Tensor], List[str], Dict[str, Any]]:
    """Load a ``.pt`` checkpoint -> ``(model, memory_bank [C, D] or None,
    classnames, meta)``; ``meta`` holds the training checkpoint's other keys
    (epoch, name, step, optimizer)."""
    dev = resolve_device(device)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    meta: Dict[str, Any] = {}
    if isinstance(obj, dict) and "state_dict" in obj:
        meta = {k: v for k, v in obj.items() if k != "state_dict"}
        obj = obj["state_dict"]
    sd = _normalize_state_dict(dict(obj))
    classnames = [k[len("memory_bank."):] for k in sd if k.startswith("memory_bank.")]
    bank = None
    if classnames:
        bank = torch.stack([torch.as_tensor(sd.pop(f"memory_bank.{c}")).float()
                            for c in classnames]).to(dev)
    model = CLIP(cfg)
    model.load_state_dict(sd, strict=True)
    return model.to(dev), bank, classnames, meta
