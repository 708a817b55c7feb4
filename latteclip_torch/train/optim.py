"""Optimizer and learning-rate schedules (port of ``latteclip_tpu/train/optim.py``:
``decay_mask``, the schedules and ``make_optimizer``).

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
a cooldown. Tower locking, gradient clipping and accumulation are not
ported yet (ROADMAP.md, section 1).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn

Schedule = Callable[[int], float]


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where AdamW's weight decay applies."""
    return {
        name: p.ndim >= 2 and not any(k in name for k in ("bn", "ln", "bias", "logit_scale"))
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


class ScheduledAdamW(torch.optim.AdamW):
    """AdamW whose every :meth:`step` first sets the learning rate to
    ``schedule(count)``, ``count`` being the updates taken before it."""

    def __init__(self, params, schedule: Schedule, **kwargs):
        super().__init__(params, lr=float(schedule(0)), **kwargs)
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = float(self.schedule(self.count))
        for group in self.param_groups:
            group["lr"] = lr
        loss = super().step(closure)
        self.count += 1
        return loss


def make_optimizer(model: nn.Module, schedule: Schedule, *, beta1: float = 0.9,
                   beta2: float = 0.98, eps: float = 1e-6,
                   weight_decay: float = 0.2) -> ScheduledAdamW:
    """AdamW over ``model``'s parameters in the reference's two decay groups."""
    mask = decay_mask(model)
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if mask[n]], "weight_decay": weight_decay},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ]
    return ScheduledAdamW(groups, schedule, betas=(beta1, beta2), eps=eps)
