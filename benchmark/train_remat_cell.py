"""A fine-tune cell with every block of both towers rematerialised, as the
CLI's ``--grad-checkpointing`` trains: ``train_cell.run`` with the port's
step (``train/step.py::make_train_step``) built under
``dataclasses.replace(hp, remat=True)``. The feed, window, trace, reference
and check are the train cell's own, and its records keep ``"kind":
"train"``, so that the train readers apply. ``make_train_step`` is wrapped
for the call and restored after it.
"""
from __future__ import annotations

import dataclasses

from benchmark import train_cell


def run(ctx) -> dict:
    from latteclip_torch.train import step as S

    make = S.make_train_step

    def remat_step(model, hp, *args, **kwargs):
        return make(model, dataclasses.replace(hp, remat=True), *args, **kwargs)

    S.make_train_step = remat_step
    try:
        return train_cell.run(ctx)
    finally:
        S.make_train_step = make
