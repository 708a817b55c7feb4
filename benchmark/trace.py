"""Device time from a ``torch.profiler`` trace: the union of the device
intervals, their time by kind (``metrics/kernels.json``), the operations that
took most time, and the longest idle gaps named by what the host was doing.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_kinds() -> Dict[str, List[str]]:
    """Kind -> lower-case substrings of kernel names, first match wins; a
    kernel that matches none is elementwise ("other")."""
    with open(os.path.join(HERE, "metrics", "kernels.json")) as f:
        return json.load(f)


def kind_of(name: str, kinds: Dict[str, List[str]]) -> str:
    low = name.lower()
    for kind, pats in kinds.items():
        if any(p in low for p in pats):
            return kind
    return "other"


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Spans:
    """The harness's host spans, on the wall clock the profiler's trace
    starts from: ``with spans("data_wait"): ...``."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, start, time.time_ns()))


def profile(fn: Callable[[Spans], None], sync: Callable[[], None], cuda: bool) -> Dict:
    """Run ``fn(spans)`` then ``sync`` under the profiler, which records the
    device's activity only (recording every host operation too would slow
    the host several-fold and show idle time that a run without it does not
    have) -> busy and window seconds, device seconds by kind, the top device
    operations and the longest idle gaps, named by the harness span open
    at their middle (each list at most 10 entries)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    spans = Spans()
    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        with spans("traced"):
            fn(spans)
            with spans("sync"):
                sync()
        window_s = time.perf_counter() - t0
    origin = prof.profiler.kineto_results.trace_start_ns()
    # harness spans in the trace's microseconds, innermost (latest start) last
    host = sorted(((s - origin) / 1e3, (e - origin) / 1e3, n) for n, s, e in spans.items)
    kinds = kernel_kinds()
    dev = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
           if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)]
    by_kind: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        s = (b - a) / 1e6
        k = kind_of(name, kinds)
        by_kind[k] = by_kind.get(k, 0.0) + s
        by_name[name] = by_name.get(name, 0.0) + s
    busy = union([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = []
    if busy:
        start = min(a for a, _, _ in host) if host else busy[0][0]
        edges = [(start, busy[0][0])] + [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        gaps = sorted(edges, key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": busy_s, "window_s": window_s, "by_kind_s": by_kind,
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": [[_host_doing(host, a, b), (b - a) / 1e6] for a, b in gaps],
    }


def _host_doing(host, a: float, b: float) -> str:
    """The innermost harness span open at the gap's middle."""
    mid = (a + b) / 2
    inside = [n for s, e, n in host if s <= mid <= e]
    return inside[-1] if inside else "outside the traced steps"
