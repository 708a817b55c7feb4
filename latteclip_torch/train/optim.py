"""Optimizer, learning-rate schedules, tower locking, gradient clipping and
accumulation (port of ``latteclip_tpu/train/optim.py``: ``decay_mask``, the
schedules, ``trainable_mask``, ``unlock_groups_vector``,
``mask_tower_updates`` and ``make_optimizer``).

AdamW with the reference's defaults for ViT models, beta (0.9, 0.98),
eps 1e-6, weight decay 0.2 (reference ``src/training/params.py:5-11``), and
its two decay groups (``src/training/main.py:342-357``): a parameter decays
iff it has at least two dimensions and its name holds none of ``bn``,
``ln``, ``bias`` and ``logit_scale``. The port's parameters are unstacked
``nn.Parameter``s under OpenCLIP's names, so the rule applies as written.

``torch.optim.AdamW`` computes optax's ``adamw`` update: decoupled decay
on the parameter before the step, bias-corrected moments, eps outside the
square root. The learning rate of each update is ``schedule(count)`` with
``count`` the number of updates before it, as optax evaluates it.

Schedules replicate ``src/training/scheduler.py``: linear warmup
``base_lr * (step + 1) / warmup``, then cosine, constant, or constant with
a cooldown.

Locking, clipping and accumulation follow the JAX package's optax chain,
``MultiSteps(chain(clip_by_global_norm, chain(adamw, masks)))``, not
OpenCLIP, where the two differ:

* locked towers keep ``requires_grad``: their gradients are computed and
  ``clip_by_global_norm`` runs before the masks, so the global norm counts
  the locked towers' gradients too (an OpenCLIP run that sets
  ``requires_grad=False`` clips by another factor);
* a locked parameter gets no update and no weight decay (its group's
  learning rate is 0), but its AdamW moments still evolve, as optax's do
  under ``masked(set_to_zero())`` after ``adamw``;
* ``--lock-*-unlocked-groups n`` unlocks the last n of the reference's
  groups ``[embeddings/pre, block_0 .. block_{L-2}, [block_{L-1},
  ln_post], proj]``: n = 1 is the projection alone, ``ln_post``/``ln_final``
  travels with the last block;
* with ``accum_steps = k`` (``optax.MultiSteps``) every call adds its
  gradient to a running mean and only every k-th call clips it and takes
  one AdamW update, whose schedule count advances per update; the train
  state's ``step`` and the memory bank advance on every call
  (:class:`latteclip_torch.train.state.Accumulation`).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from latteclip_torch.config import (
    CLIPConfig,
    Eva02VisionConfig,
    RelPosVisionConfig,
    SwinVisionConfig,
    VisionConfig,
)

from latteclip_torch.models.hf_text import HFTextConfig

Schedule = Callable[[int], float]


# Swin's and ViT-relpos's blocks: the JAX tree keeps them as lists under a
# key "blocks", which JAX's decay_mask takes for a stack on a layer axis, so
# it counts one dimension less and their matrices get no weight decay there
_LISTED_BLOCKS = re.compile(r"visual\.trunk\.(layers\.\d+\.)?blocks\.")
# timm's leading batch axis, which the JAX tree does not have
_TIMM_BATCH_AXES = {"visual.trunk.cls_token": 2, "visual.trunk.pos_embed": 1}


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where AdamW's weight decay applies: 2-D and
    more, and no norm, bias (``*bias``, the MAP head's ``*_b``) or logit
    scale, as JAX's ``decay_mask`` decides on the same parameters: timm's
    class token and positions without their batch axis, and the blocks of
    a Swin or ViT-relpos tower one dimension less, as JAX counts them."""
    listed = isinstance(getattr(model, "cfg", None), CLIPConfig) and \
        isinstance(model.cfg.vision, (SwinVisionConfig, RelPosVisionConfig))
    return {
        name: p.ndim - (1 if listed and _LISTED_BLOCKS.match(name) else 0)
        - _TIMM_BATCH_AXES.get(name, 0) >= 2
        and not name.endswith("_b")
        and not any(k in name for k in ("bn", "ln", "bias", "logit_scale"))
        for name, p in model.named_parameters()
    }


def _warm(base_lr: float, warmup: int, step: int) -> float:
    return base_lr * (step + 1.0) / max(warmup, 1)


def warmup_cosine(base_lr: float, warmup: int, total_steps: int) -> Schedule:
    """cosine_lr semantics (scheduler.py:43-53)."""

    def schedule(step: int) -> float:
        if step < warmup:
            return _warm(base_lr, warmup, step)
        e, es = step - warmup, max(total_steps - warmup, 1)
        return 0.5 * (1.0 + math.cos(math.pi * e / es)) * base_lr

    return schedule


def warmup_const(base_lr: float, warmup: int) -> Schedule:
    """const_lr semantics (scheduler.py:13-21)."""

    def schedule(step: int) -> float:
        return _warm(base_lr, warmup, step) if step < warmup else base_lr

    return schedule


def warmup_const_cooldown(base_lr: float, warmup: int, total_steps: int, cooldown_steps: int,
                          cooldown_power: float = 1.0, cooldown_end_lr: float = 0.0) -> Schedule:
    """const_lr_cooldown semantics (scheduler.py:24-40)."""

    def schedule(step: int) -> float:
        if step < warmup:
            return _warm(base_lr, warmup, step)
        start = total_steps - cooldown_steps
        if step < start:
            return base_lr
        decay = (1.0 - (step - start) / max(cooldown_steps, 1)) ** cooldown_power
        return decay * (base_lr - cooldown_end_lr) + cooldown_end_lr

    return schedule


def make_schedule(kind: str, base_lr: float, warmup: int, total_steps: int = 0,
                  cooldown_steps: int = 0, cooldown_power: float = 1.0,
                  cooldown_end_lr: float = 0.0) -> Schedule:
    if kind == "cosine":
        return warmup_cosine(base_lr, warmup, total_steps)
    if kind == "const":
        return warmup_const(base_lr, warmup)
    if kind == "const-cooldown":
        return warmup_const_cooldown(base_lr, warmup, total_steps, cooldown_steps,
                                     cooldown_power, cooldown_end_lr)
    raise ValueError(f"unknown lr scheduler: {kind}")


def _visual(name: str) -> bool:
    return name.startswith(("visual.", "latteclip.visual."))


def _text(name: str) -> bool:
    """The JAX tree's ``text`` subtree: not CoCa's ``text_decoder``."""
    return not _visual(name) and name not in ("logit_scale", "logit_bias") \
        and not name.startswith("text_decoder.")


_TOWER = {"visual": _visual, "text": _text}


def tower_parameters(model: nn.Module, tower: str) -> List[nn.Parameter]:
    """The parameters of ``tower`` (``"visual"`` or ``"text"``): those of the
    JAX package's parameter subtree of that name."""
    return [p for name, p in model.named_parameters() if _TOWER[tower](name)]

# the reference's lock groups by tower (transformer.py:435-466): the
# blocks ("<prefix><i>."), the head (embeddings and pre-norm) and the post
# group that travels with the last block; the projection is what remains
_GROUPS = {
    "text": ("transformer.resblocks.", ("token_embedding.", "positional_embedding"),
             ("ln_final.",)),
    "visual": ("visual.transformer.resblocks.",
               ("visual.conv1.", "visual.class_embedding", "visual.positional_embedding",
                "visual.ln_pre."),
               ("visual.ln_post.", "latteclip.visual.map_head.", "visual.attn_pool.")),
    "coca_text": ("text.transformer.resblocks.", ("text.token_embedding.",
                                                  "text.positional_embedding"),
                  ("text.ln_final.", "text.cls_emb")),
    "visual_timm": ("visual.trunk.blocks.",
                    ("visual.trunk.patch_embed.", "visual.trunk.cls_token", "visual.trunk.pos_embed"),
                    ("visual.trunk.norm.", "visual.trunk.fc_norm.")),
}


def _groups(model: nn.Module, tower: str) -> Tuple[str, tuple, tuple]:
    """(blocks prefix, head prefixes, post prefixes) of ``tower``; a vision
    tower without a stack of blocks in the JAX tree (ModifiedResNet,
    ConvNeXt, Swin) raises JAX's ``ValueError``, as does ViT-relpos, whose
    JAX blocks are a list that its ``mask_tower_updates`` cannot slice."""
    if tower == "text":
        t = model.cfg.text
        if isinstance(t, HFTextConfig):
            # an HF tower's stack; its other leaves (embeddings, norms, the
            # projection) sit in no group of JAX's and stay trainable
            stem = {"mt5": "block.", "m2m_100": "layers."}.get(t.model_type, "encoder.layer.")
            return "text.transformer." + stem, (), ()
        return _GROUPS["coca_text" if getattr(t, "embed_cls", False) else "text"]
    v = model.cfg.vision
    if isinstance(v, VisionConfig):
        return _GROUPS["visual_timm" if v.timm_trunk else "visual"]
    if isinstance(v, Eva02VisionConfig):
        return _GROUPS["visual_timm"]
    return None


def trainable_mask(model: nn.Module, *, lock_image: bool = False,
                   lock_text: bool = False) -> Dict[str, bool]:
    """Parameter name -> True where the update applies: ``lock_image`` and
    ``lock_text`` freeze whole towers (reference ``--lock-image`` and
    ``--lock-text``, main.py:294-305); ``logit_scale`` always trains."""
    return {name: not ((lock_image and _visual(name)) or (lock_text and _text(name)))
            for name, _ in model.named_parameters()}


def unlock_groups_vector(num_layers: int, unlocked_groups: int) -> List[bool]:
    """Per block: True for the last ``unlocked_groups`` blocks, which train."""
    return [i >= num_layers - unlocked_groups for i in range(num_layers)]


def mask_tower_updates(model: nn.Module, tower: str, unlocked_groups: int) -> Dict[str, bool]:
    """Parameter name -> True where the update applies under
    ``unlocked_groups > 0`` for ``tower`` (``"visual"`` or ``"text"``): the
    last ``unlocked_groups - 1`` blocks, the post group from 2, the head
    only once every group is unlocked, the projection always; names outside
    the tower keep their updates."""
    groups = _groups(model, tower)
    if groups is None:
        raise ValueError(
            f"partial unlocking (unlocked_groups={unlocked_groups}) is "
            f"only supported for transformer towers; the {tower!r} tower "
            "has no 'blocks' stack (use full locking instead)")
    prefix, head, post = groups
    num_layers = len({n[len(prefix):].split(".", 1)[0]
                      for n, _ in model.named_parameters() if n.startswith(prefix)})
    keep = unlock_groups_vector(num_layers, max(unlocked_groups - 1, 0))
    out = {}
    for name, _ in model.named_parameters():
        if not _TOWER[tower](name):
            out[name] = True
        elif name.startswith(prefix) and "relative_attention_bias" not in name:
            # (T5's relative bias, held by block 0 here, is a top-level leaf in JAX)
            out[name] = keep[int(name[len(prefix):].split(".", 1)[0])]
        elif name.startswith(head):
            out[name] = unlocked_groups >= num_layers + 2
        elif name.startswith(post):
            out[name] = unlocked_groups >= 2
        else:  # the projection and anything unmatched stay trainable, as in JAX
            out[name] = unlocked_groups >= 1
    return out


class ScheduledAdamW(torch.optim.AdamW):
    """AdamW whose every :meth:`step` first sets the learning rate to
    ``schedule(count)`` times each group's ``lr_scale`` (0 for locked
    parameters), ``count`` being the updates taken before it.
    ``grad_clip_norm`` and ``accum_steps`` are read by
    :func:`apply_gradients`."""

    def __init__(self, params, schedule: Schedule, *, grad_clip_norm: Optional[float] = None,
                 accum_steps: int = 1, **kwargs):
        super().__init__(params, lr=float(schedule(0)), **kwargs)
        self.schedule = schedule
        self.count = 0
        self.grad_clip_norm = grad_clip_norm
        self.accum_steps = accum_steps

    @torch.no_grad()
    def step(self, closure=None):
        lr = float(self.schedule(self.count))
        for group in self.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        loss = super().step(closure)
        self.count += 1
        return loss


def make_optimizer(model: nn.Module, schedule: Schedule, *, beta1: float = 0.9,
                   beta2: float = 0.98, eps: float = 1e-6, weight_decay: float = 0.2,
                   grad_clip_norm: Optional[float] = None, accum_steps: int = 1,
                   lock_image: bool = False, lock_text: bool = False,
                   lock_image_unlocked_groups: int = 0,
                   lock_text_unlocked_groups: int = 0) -> ScheduledAdamW:
    """AdamW over ``model``'s parameters in the reference's two decay groups,
    locked parameters apart with learning rate 0 (module docstring)."""
    decay = decay_mask(model)
    masks = [trainable_mask(model, lock_image=lock_image and not lock_image_unlocked_groups,
                            lock_text=lock_text and not lock_text_unlocked_groups)]
    if lock_image and lock_image_unlocked_groups:
        masks.append(mask_tower_updates(model, "visual", lock_image_unlocked_groups))
    if lock_text and lock_text_unlocked_groups:
        masks.append(mask_tower_updates(model, "text", lock_text_unlocked_groups))
    named = list(model.named_parameters())
    trains = {n: all(m[n] for m in masks) for n, _ in named}
    groups = []
    for wd, lr_scale, pick in ((weight_decay, 1.0, lambda n: trains[n] and decay[n]),
                               (0.0, 1.0, lambda n: trains[n] and not decay[n]),
                               (0.0, 0.0, lambda n: not trains[n])):
        params = [p for n, p in named if pick(n)]
        if params:
            groups.append({"params": params, "weight_decay": wd, "lr_scale": lr_scale})
    return ScheduledAdamW(groups, schedule, grad_clip_norm=grad_clip_norm,
                          accum_steps=accum_steps, betas=(beta1, beta2), eps=eps)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float, mesh=None,
                         sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """optax ``clip_by_global_norm``: every gradient times ``max_norm /
    norm`` where the norm over all of them is at least ``max_norm``; the
    norm is returned (a device scalar, no host sync). Where ``sharded``
    marks model-sharded gradients (on ``mesh``), their squared norms are
    summed over the model group and the replicated ones counted once."""
    if mesh is None or not any(sharded or ()):
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    else:
        def squares(pick: bool) -> torch.Tensor:
            chosen = [g for g, s in zip(grads, sharded) if s == pick]
            return torch.stack(torch._foreach_norm(chosen)).square().sum()

        norm = (squares(False) + mesh.all_reduce_(squares(True), mesh.model_group)).sqrt()
    torch._foreach_mul_(list(grads), torch.where(norm < max_norm, 1.0, max_norm / norm))
    return norm
