"""Checkpoint IO for the port (from ``latteclip_tpu/core/checkpoint.py``).

* :func:`load_clip_pt` reads an OpenCLIP/LatteCLIP ``.pt`` file (a bare
  state dict or a ``{"state_dict": ..., "epoch": ...}`` training checkpoint),
  strips the ``module.``/``clip_model.`` wrapper prefixes, splits off the
  ``memory_bank.<class>`` prototype keys and loads the rest into a
  :class:`~latteclip_torch.models.clip.CLIP` with ``strict=True``.
* :func:`save_clip_pt` writes the training checkpoint in the same layout
  (``state_dict`` under OpenCLIP's names with ``memory_bank.<class>`` keys,
  plus ``epoch``, ``name``, ``step`` and ``optimizer``) to ``path + ".tmp"``
  and renames it into place.
* :func:`state_dict_from_jax_params` turns the JAX package's parameter tree
  (numpy arrays, ``[in, out]`` weights stacked on a layer axis) into the
  port's state dict; it mirrors the native-ViT branch of
  ``params_to_pt_state_dict``. :func:`jax_params_from_state_dict` is its
  inverse.
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

import os
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


def _stack_blocks(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    layers = len({k[len(prefix):].split(".", 1)[0] for k in sd if k.startswith(prefix)})
    out = {}
    for ours, (suffix, transpose) in _BLOCK_KEYS.items():
        arrs = [sd[f"{prefix}{i}.{suffix}"] for i in range(layers)]
        out[ours] = np.stack([a.T if transpose else a for a in arrs])
    return out


def jax_params_from_state_dict(sd: Mapping[str, Any], cfg: CLIPConfig) -> Dict[str, Any]:
    """The port's state dict (tensors or arrays under its names) -> the JAX
    package's parameter tree of float32 numpy arrays: blocks stacked on a
    layer axis, weights ``[in, out]``, the patch kernel ``[P*P*3, D]``."""
    sd = {k: np.asarray(torch.as_tensor(v).detach().float().cpu()) for k, v in sd.items()}
    P, D = cfg.vision.patch_size, cfg.vision.width
    visual = {k: sd[name] for k, name in _VISUAL_KEYS.items()}
    visual["patch_kernel"] = sd["visual.conv1.weight"].transpose(2, 3, 1, 0).reshape(P * P * 3, D)
    visual["blocks"] = _stack_blocks(sd, "visual.transformer.resblocks.")
    text = {k: sd[name] for k, name in _TEXT_KEYS.items()}
    text["blocks"] = _stack_blocks(sd, "transformer.resblocks.")
    return {"visual": visual, "text": text, "logit_scale": sd["logit_scale"].reshape(())}


def _flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """{prefix + "['a']['b']": leaf}, ``jax.tree_util.keystr``'s spelling."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}[{k!r}]"
        out.update(_flatten(v, key) if isinstance(v, Mapping) else {key: v})
    return out


def _unflatten(flat: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "["):
            continue
        parts = [p.strip("'") for p in key[len(prefix) + 1:-1].split("][")]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(torch.as_tensor(v).float())
    return tree


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

    def moments(key):
        return {n: optimizer.state[params[n]][key] if params[n] in optimizer.state
                else torch.zeros_like(params[n]) for n in names}

    adam, sched = _prefixes(optimizer, accum)
    flat: Dict[str, Any] = {f"{adam}.count": _count(optimizer.count)}
    flat.update(_flatten(jax_params_from_state_dict(moments("exp_avg"), cfg), f"{adam}.mu"))
    flat.update(_flatten(jax_params_from_state_dict(moments("exp_avg_sq"), cfg), f"{adam}.nu"))
    flat[f"{sched}.count"] = _count(optimizer.count)
    if accum is not None:
        flat[".mini_step"] = _count(accum.mini_step)
        flat[".gradient_step"] = _count(accum.gradient_step)
        flat.update(_flatten(jax_params_from_state_dict(dict(zip(names, accum.grads)), cfg),
                             ".acc_grads"))
    # np.array, not np.ascontiguousarray: that one turns 0-d leaves into [1]
    return {k: torch.from_numpy(np.array(v, order="C")) if isinstance(v, np.ndarray) else v
            for k, v in flat.items()}


def restore_optimizer_state(model: CLIP, optimizer, saved: Mapping[str, Any], accum=None) -> None:
    """Load :func:`optimizer_state`'s keys (from either package) into
    ``optimizer`` and ``accum``: moments, counts and the accumulator. A key
    these flags need and the file lacks raises ``KeyError``."""
    cfg = model.cfg
    adam, sched = _prefixes(optimizer, accum)
    for key in (f"{adam}.count", f"{sched}.count"):
        if key not in saved:
            raise KeyError(f"checkpoint optimizer state missing leaf {key}")
    count = int(torch.as_tensor(saved[f"{sched}.count"]).reshape(()))
    mu = state_dict_from_jax_params(_unflatten(saved, f"{adam}.mu"), cfg)
    nu = state_dict_from_jax_params(_unflatten(saved, f"{adam}.nu"), cfg)
    adam_count = float(torch.as_tensor(saved[f"{adam}.count"]).reshape(()))
    for name, p in model.named_parameters():
        optimizer.state[p] = {"step": torch.tensor(adam_count, dtype=torch.float32),
                              "exp_avg": mu[name].to(p.device, p.dtype).reshape(p.shape),
                              "exp_avg_sq": nu[name].to(p.device, p.dtype).reshape(p.shape)}
    optimizer.count = count
    if accum is not None:
        for key in (".mini_step", ".gradient_step"):
            if key not in saved:
                raise KeyError(f"checkpoint optimizer state missing leaf {key}")
        accum.mini_step = int(torch.as_tensor(saved[".mini_step"]).reshape(()))
        accum.gradient_step = int(torch.as_tensor(saved[".gradient_step"]).reshape(()))
        acc = state_dict_from_jax_params(_unflatten(saved, ".acc_grads"), cfg)
        for g, (name, p) in zip(accum.grads, model.named_parameters()):
            g.copy_(acc[name].reshape(p.shape))


def save_clip_pt(path: str, model: CLIP, *, epoch: Optional[int] = None,
                 name: Optional[str] = None, memory_bank: Optional[torch.Tensor] = None,
                 classnames: Optional[Sequence[str]] = None,
                 optimizer: Optional[Dict[str, torch.Tensor]] = None,
                 step: Optional[int] = None) -> None:
    """Write a training checkpoint in OpenCLIP's layout (module docstring)
    to ``path + ".tmp"``, then ``os.replace`` it onto ``path``.
    ``optimizer`` is :func:`optimizer_state`'s dict."""
    sd = OrderedDict((k, v.detach().float().cpu().contiguous())
                     for k, v in model.state_dict().items())
    if memory_bank is not None:
        if classnames is None or len(classnames) != len(memory_bank):
            raise ValueError("memory_bank needs one class name per row")
        for cname, row in zip(classnames, memory_bank.detach().float().cpu()):
            sd[f"memory_bank.{cname}"] = row.clone()
    obj: Dict[str, Any] = {"state_dict": sd}
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
