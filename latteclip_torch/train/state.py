"""Train state: model, optimizer, step count, the prototype memory bank and
the gradient accumulator (port of ``latteclip_tpu/train/state.py``:
``TrainState``, ``init_memory_bank``, ``build_template_table``,
``create_train_state``; the accumulator is ``optax.MultiSteps``' state).

The bank is a dense ``[C, D]`` float32 tensor, one L2-normalized row per
class in classname order. ``prototypes`` is the epoch-start snapshot of the
bank (reference ``src/training/train.py:347-350``): the confidence weights
read it all epoch while the per-step classifier and anchors read the live
bank. It is always a copy, never an alias, since the step replaces the bank
every step. Unlike JAX's immutable state, this one is updated in place by
the train step. ``mesh`` and ``tp_dims`` place it across ranks
(:func:`latteclip_torch.mesh.shard_train_state`): the bank, the step and
every other leaf replicated, the MLP leaves named in ``tp_dims`` (name ->
split dim) held as this rank's shard.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models.tokenizer import ClipTokenizer


@dataclasses.dataclass
class Accumulation:
    """``optax.MultiSteps``' state for ``every`` > 1 calls an update:
    ``mini_step`` counts the calls since the last update, ``gradient_step``
    the updates, and ``grads`` holds the running mean of this cycle's
    gradients (one float32 tensor a parameter, in ``model.parameters()``
    order; zeros after an update)."""

    every: int
    grads: List[torch.Tensor]
    mini_step: int = 0
    gradient_step: int = 0


@dataclasses.dataclass
class TrainState:
    step: int
    model: clip_mod.CLIP
    optimizer: torch.optim.Optimizer
    memory_bank: torch.Tensor          # [C, D] float32, L2-normalized rows
    prototypes: torch.Tensor           # [C, D] epoch-start snapshot
    accum: Optional[Accumulation] = None
    mesh: Optional[object] = None      # latteclip_torch.mesh.Mesh, None in one process
    tp_dims: Dict[str, int] = dataclasses.field(default_factory=dict)

    def start_epoch(self) -> "TrainState":
        """Snapshot the live bank into the epoch prototypes (train.py:347-350)."""
        self.prototypes = self.memory_bank.clone()
        return self


@torch.no_grad()
def init_memory_bank(model: clip_mod.CLIP, tokenizer: ClipTokenizer, classnames: Sequence[str],
                     templates: Sequence[Callable[[str], str]], *,
                     attention: str = "kernel", ln_linear: str = "unfused") -> torch.Tensor:
    """bank[c] = normalized encode_text(templates[0](classname)), the
    reference's ``init_memory_bank`` (model.py:489-499)."""
    dev = next(model.parameters()).device
    tokens = torch.from_numpy(build_template_table(tokenizer, classnames, templates)).to(dev)
    return clip_mod.encode_text(model, tokens, normalize=True, attention=attention,
                                ln_linear=ln_linear).float()


def build_template_table(tokenizer: ClipTokenizer, classnames: Sequence[str],
                         templates: Sequence[Callable[[str], str]]) -> np.ndarray:
    """[C, ctx] int32: the tokens of templates[0](classname) for every class."""
    return tokenizer([templates[0](c) for c in classnames])


def create_train_state(model: clip_mod.CLIP, optimizer: torch.optim.Optimizer,
                       memory_bank: torch.Tensor) -> TrainState:
    """A state at step 0; with ``optimizer.accum_steps`` > 1 it carries a
    zeroed :class:`Accumulation`."""
    bank = torch.as_tensor(memory_bank, dtype=torch.float32).to(next(model.parameters()).device)
    every = getattr(optimizer, "accum_steps", 1)
    accum = None
    if every > 1:
        accum = Accumulation(every, [torch.zeros_like(p, dtype=torch.float32)
                                     for p in model.parameters()])
    return TrainState(step=0, model=model, optimizer=optimizer, memory_bank=bank,
                      prototypes=bank.clone(), accum=accum)
