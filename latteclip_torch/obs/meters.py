"""Metric meters and throughput accounting (port of
``latteclip_tpu/obs/meters.py``: ``AverageMeter``, ``DeviceMeterBank``,
``Throughput``, ``append_results_jsonl``; reference train.py:35-51,595-600).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class DeviceMeterBank:
    """Every-step metric averages without a host sync per step: the sums
    stay on the device (one add a metric, queued behind the step like the
    step itself) and :meth:`fetch` copies the latest values and the sums to
    the host in one transfer, so ``avg`` is the mean over every step."""

    def __init__(self):
        self._sum: Optional[Dict[str, torch.Tensor]] = None
        self._last: Optional[Dict[str, torch.Tensor]] = None
        self.count = 0

    def update(self, metrics: Dict[str, torch.Tensor]) -> None:
        scalars = {k: v.detach().float() for k, v in metrics.items() if v.ndim == 0}
        self._last = scalars
        if self._sum is None:
            self._sum = {k: v.clone() for k, v in scalars.items()}
        else:
            for k, v in scalars.items():
                self._sum[k] += v
        self.count += 1

    def fetch(self) -> Dict[str, AverageMeter]:
        """One host sync: ``{key: AverageMeter}`` with ``val`` the latest
        step's value and ``avg`` the mean over every step recorded."""
        keys = list(self._last)
        host = torch.stack([self._last[k] for k in keys] + [self._sum[k] for k in keys]).tolist()
        out: Dict[str, AverageMeter] = {}
        for i, k in enumerate(keys):
            m = AverageMeter()
            m.val, m.sum, m.count = host[i], host[len(keys) + i], self.count
            out[k] = m
        return out


class Throughput:
    """samples/s and samples/s per card by the reference's formula
    (batch * world / batch_time, train.py:595-600)."""

    def __init__(self, batch_size: int, world_size: int = 1):
        self.batch_size = batch_size
        self.world_size = world_size
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self._last = time.time()

    def tick_data(self):
        self.data_time.update(time.time() - self._last)

    def tick_batch(self):
        now = time.time()
        self.batch_time.update(now - self._last)
        self._last = now

    @property
    def samples_per_second(self) -> float:
        return self.batch_size * self.world_size / max(self.batch_time.val, 1e-9)

    @property
    def samples_per_second_per_chip(self) -> float:
        return self.batch_size / max(self.batch_time.val, 1e-9)


def append_results_jsonl(path: str, record: Dict) -> None:
    """Append one line of eval metrics to results.jsonl (reference train.py:1488-1490)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
