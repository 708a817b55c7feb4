"""Helpers of the per-layer readers under ``metrics/``. Each reader is a
file ``metrics/<metric name>.py`` with ``read(records) -> float | None``;
it returns None where the run holds nothing for it to read."""
from __future__ import annotations

from statistics import mean
from typing import Optional

from benchmark.flops import PEAK_BF16_FLOPS


def host_mean_ms(rec: dict, kind: str, key: str) -> Optional[float]:
    """Mean of the harness's host-clock spans ``key`` a step or request, ms."""
    spans = rec.get("host", {}).get(key) if rec.get("kind") == kind else None
    return mean(spans) * 1e3 if spans else None


def mfu(rec: dict, kind: str) -> Optional[float]:
    """Model FLOPs of the window over its seconds, as % of the bf16 peak."""
    w = rec.get("window") if rec.get("kind") == kind else None
    if not w or not w["seconds"]:
        return None
    return 100.0 * w["flops"] / w["seconds"] / PEAK_BF16_FLOPS


def device_s(rec: dict, kind: str, device_kind: str) -> Optional[float]:
    """Device seconds of one kind of kernel in the traced steps."""
    t = rec.get("trace") if rec.get("kind") == kind else None
    if not t or not t["busy_s"]:
        return None
    return t["by_kind_s"].get(device_kind, 0.0)


def roofline(rec: dict, kind: str) -> Optional[float]:
    """The attention calls' bound over their kernels' device time, %."""
    spent = device_s(rec, kind, "attention")
    return 100.0 * rec["attention_bound_s"] / spent if spent else None


def idle(rec: dict, kind: str) -> Optional[float]:
    t = rec.get("trace") if rec.get("kind") == kind else None
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
