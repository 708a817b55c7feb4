"""Importer for Google big_vision ``.npz`` image-text checkpoints (the
SigLIP family): port of ``latteclip_tpu/core/big_vision.py``.

big_vision keeps flax kernels ``(in, out)``, as the JAX package's tree does,
so the checkpoint is read into that tree's layout first (head-axis reshapes
and per-layer stacking only, as JAX's importer does), then written to the
port's state-dict names by :func:`latteclip_torch.checkpoint.state_dict_from_jax_params`:

* ``params/img/embedding/kernel`` ``(P, P, 3, D)`` -> ``visual.conv1.weight``
  with its bias in ``visual.conv1.bias``;
* attention ``query/key/value`` kernels ``(D, H, hd)`` -> the packed
  ``attn.in_proj_weight`` ``[3D, D]``; ``out/kernel (H, hd, D)`` ->
  ``attn.out_proj.weight``; ``encoderblock_{i}`` -> ``resblocks.{i}``;
* ``MAPHead_0`` -> ``latteclip.visual.map_head.*`` (JAX's names);
* ``params/txt`` -> the text tower, ``head/bias`` ->
  ``latteclip.text.text_projection_b``;
* ``params/t``, ``params/b`` -> ``logit_scale``, ``logit_bias``.

The positional embedding is resized to ``cfg``'s grid by the port's resize,
as JAX's importer does; a patch size other than ``cfg``'s is refused.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from latteclip_torch.checkpoint import resize_vision_pos_embed, state_dict_from_jax_params


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _attn_in_proj(w, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    """q/k/v kernels (D, H, hd) + biases (H, hd) -> (D, 3D), (3D,)."""
    ks, bs = [], []
    for n in ("query", "key", "value"):
        kern = _f32(w[f"{prefix}{n}/kernel"])
        ks.append(kern.reshape(kern.shape[0], -1))
        bs.append(_f32(w[f"{prefix}{n}/bias"]).reshape(-1))
    return np.concatenate(ks, axis=1), np.concatenate(bs)


def _attn_out_proj(w, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    """out kernel (H, hd, D) + bias (D,) -> (D, D), (D,)."""
    kern = _f32(w[f"{prefix}out/kernel"])
    return kern.reshape(-1, kern.shape[-1]), _f32(w[f"{prefix}out/bias"])


def _stacked_blocks(w, prefix: str, n_layers: int) -> Dict[str, np.ndarray]:
    per_layer = []
    for i in range(n_layers):
        bp = f"{prefix}encoderblock_{i}/"
        mp = bp + "MultiHeadDotProductAttention_0/"
        in_w, in_b = _attn_in_proj(w, mp)
        out_w, out_b = _attn_out_proj(w, mp)
        per_layer.append({
            "ln_1_scale": _f32(w[f"{bp}LayerNorm_0/scale"]),
            "ln_1_bias": _f32(w[f"{bp}LayerNorm_0/bias"]),
            "in_proj_w": in_w, "in_proj_b": in_b, "out_proj_w": out_w, "out_proj_b": out_b,
            "ln_2_scale": _f32(w[f"{bp}LayerNorm_1/scale"]),
            "ln_2_bias": _f32(w[f"{bp}LayerNorm_1/bias"]),
            "c_fc_w": _f32(w[f"{bp}MlpBlock_0/Dense_0/kernel"]),
            "c_fc_b": _f32(w[f"{bp}MlpBlock_0/Dense_0/bias"]),
            "c_proj_w": _f32(w[f"{bp}MlpBlock_0/Dense_1/kernel"]),
            "c_proj_b": _f32(w[f"{bp}MlpBlock_0/Dense_1/bias"]),
        })
    return {k: np.stack([layer[k] for layer in per_layer]) for k in per_layer[0]}


def _map_head(w, prefix: str) -> Dict[str, np.ndarray]:
    mp = prefix + "MultiHeadDotProductAttention_0/"
    out = {}
    for name, n in (("q", "query"), ("k", "key"), ("v", "value")):
        kern = _f32(w[f"{mp}{n}/kernel"])
        out[f"{name}_w"] = kern.reshape(kern.shape[0], -1)
        out[f"{name}_b"] = _f32(w[f"{mp}{n}/bias"]).reshape(-1)
    out["out_w"], out["out_b"] = _attn_out_proj(w, mp)
    out["probe"] = _f32(w[f"{prefix}probe"]).reshape(1, -1)
    out["ln_scale"] = _f32(w[f"{prefix}LayerNorm_0/scale"])
    out["ln_bias"] = _f32(w[f"{prefix}LayerNorm_0/bias"])
    for i, name in ((0, "fc1"), (1, "fc2")):
        out[f"{name}_w"] = _f32(w[f"{prefix}MlpBlock_0/Dense_{i}/kernel"])
        out[f"{name}_b"] = _f32(w[f"{prefix}MlpBlock_0/Dense_{i}/bias"])
    return out


def load_big_vision_npz(path: str, cfg) -> Dict[str, torch.Tensor]:
    """``.npz`` checkpoint -> the port's float32 state dict for ``cfg`` (a
    SigLIP-style config: no class token, ``pool_type='map'``, non-causal
    ``pool_type='last'`` text with a projection bias)."""
    w = np.load(path)
    vcfg, tcfg = cfg.vision, cfg.text
    patch_kernel = _f32(w["params/img/embedding/kernel"])
    P = vcfg.patch_size
    if patch_kernel.shape[:2] != (P, P):
        raise ValueError(f"patch size mismatch: checkpoint {patch_kernel.shape[:2]} vs config "
                         f"{(P, P)}; resampling is not supported")
    D = patch_kernel.shape[-1]
    visual = {
        "patch_kernel": patch_kernel.reshape(-1, D),
        "patch_bias": _f32(w["params/img/embedding/bias"]),
        "pos_embed": _f32(w["params/img/pos_embedding"]).reshape(-1, D),
        # big_vision ViTs have no pre-LN; the identity keeps the tree uniform
        "ln_pre_scale": np.ones((D,), np.float32),
        "ln_pre_bias": np.zeros((D,), np.float32),
        "blocks": _stacked_blocks(w, "params/img/Transformer/", vcfg.layers),
        "ln_post_scale": _f32(w["params/img/Transformer/encoder_norm/scale"]),
        "ln_post_bias": _f32(w["params/img/Transformer/encoder_norm/bias"]),
    }
    if visual["pos_embed"].shape[0] != vcfg.seq_len:
        visual["pos_embed"] = resize_vision_pos_embed(
            torch.from_numpy(visual["pos_embed"]), vcfg.seq_len,
            cls_token=not vcfg.no_cls_token).numpy()
    if not vcfg.no_cls_token and "params/img/cls" in w:
        visual["class_embedding"] = _f32(w["params/img/cls"]).reshape(-1)
    if vcfg.pool_type == "map":
        visual["map_head"] = _map_head(w, "params/img/MAPHead_0/")
    tD = _f32(w["params/txt/Embed_0/embedding"]).shape[-1]
    text = {
        "token_embedding": _f32(w["params/txt/Embed_0/embedding"]),
        "pos_embed": _f32(w["params/txt/pos_embedding"]).reshape(-1, tD),
        "blocks": _stacked_blocks(w, "params/txt/Encoder_0/", tcfg.layers),
        "ln_final_scale": _f32(w["params/txt/Encoder_0/encoder_norm/scale"]),
        "ln_final_bias": _f32(w["params/txt/Encoder_0/encoder_norm/bias"]),
        "text_projection": _f32(w["params/txt/head/kernel"]),
        "text_projection_b": _f32(w["params/txt/head/bias"]),
    }
    params = {"visual": visual, "text": text,
              "logit_scale": np.float32(_f32(w["params/t"]).reshape(-1)[0]),
              "logit_bias": np.float32(_f32(w["params/b"]).reshape(-1)[0])}
    return state_dict_from_jax_params(params, cfg)
