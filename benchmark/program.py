"""Helpers of the readers of the program's own spans and counters
(``latteclip_torch/obs/trace.py``), a traced step or request. The window's
spans are read from the recorder in this process after the traced run;
each helper returns None where the run holds nothing for it: a program
without the recorder, a run of another kind or one that traced no step, a
stream time on the CPU, a counter that did not move."""
from __future__ import annotations

from typing import List, Optional

# the outermost span of one step of each kind of cell
STEP = {"train": "train_step", "eval": "eval_step"}


def _recorder():
    try:
        from latteclip_torch.obs import trace
    except ImportError:
        return None
    return trace


def window(rec: dict, kind: str):
    """(the traced window's spans, its steps) of a traced run of ``kind``,
    or None."""
    t = _recorder() if rec.get("kind") == kind and rec.get("trace") else None
    if t is None:
        return None
    spans = t.recorded()
    steps = [s for s in spans if s["name"] == STEP[kind] and s["parent"] is None]
    return (spans, steps) if steps else None


def _within(spans: List[dict], s: dict, name: str) -> bool:
    """Whether ``s`` lies inside a span ``name``."""
    while s["parent"] is not None:
        s = spans[s["parent"]]
        if s["name"] == name:
            return True
    return False


def host_ms(rec: dict, kind: str, name: str) -> Optional[float]:
    """Host ms a step in the spans ``name``."""
    w = window(rec, kind)
    if w is None:
        return None
    spans, steps = w
    return sum(s["host_ms"] or 0.0 for s in spans if s["name"] == name) / len(steps)


def step_host_ms(rec: dict, kind: str) -> Optional[float]:
    """The step span's host ms a step, less its ``wait`` spans."""
    w = window(rec, kind)
    if w is None:
        return None
    spans, steps = w
    step = STEP[kind]
    waits = sum(s["host_ms"] or 0.0 for s in spans
                if s["name"] == "wait" and _within(spans, s, step))
    return (sum(s["host_ms"] or 0.0 for s in steps) - waits) / len(steps)


def stream_ms(rec: dict, kind: str, name: str) -> Optional[float]:
    """Device ms a step from the entry to the exit event of the spans
    ``name`` (None on the CPU, or where a span has no time)."""
    w = window(rec, kind)
    if w is None:
        return None
    spans, steps = w
    times = [s["stream_ms"] for s in spans if s["name"] == name]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / len(steps)


def fill(rec: dict, kind: str, used: str, slots: str) -> Optional[float]:
    """100 x the change of counter ``used`` over that of ``slots`` since the
    traced window began, %."""
    t = _recorder() if rec.get("kind") == kind and rec.get("trace") else None
    if t is None:
        return None
    counts = t.window_counters()
    total = counts.get(slots, 0)
    return 100.0 * counts.get(used, 0) / total if total else None
