"""Spans inside the program, recorded only while a ``torch.profiler``
records, and one snapshot of the program's counters.

    from latteclip_torch.obs.trace import span

    with span("train_step", step=True):
        with span("forward", stream=True):
            ...

There is no switch of its own: the benchmark's traced run
(``benchmark/trace.py::profile``) and the CLI's ``--profile``
(:class:`latteclip_torch.obs.profiler.StepTraceProfiler`) turn a profiler
on, and the spans with it. Whether one records is read from torch's
process-wide flag ``torch.autograd.profiler._is_profiler_enabled``, which
every profiler sets at its start and clears at its stop:
``torch.autograd._profiler_enabled()`` answers for the calling thread only,
and the prefetch thread, started before the profiler, would never see it.

With no profiler recording, :func:`span` makes that one check, notes that
any window has ended, and returns a shared no-op context: it allocates
nothing and touches no CUDA API. A window is thus known to have ended once
a span has run, or the spans have been read out, with no profiler
recording: every step before a traced one runs its spans.

While a profiler records, a span keeps its name, its parent span, its
thread, the index of the latest outermost step span (``step=True``) begun,
host start and end from ``time.time_ns()`` (the wall clock that a
profiler's ``trace_start_ns()`` counts from), a
``torch.profiler.record_function`` range of its name inside those two, so
that the profiler's own timeline shows it (a profiler records the ranges of
the threads it started on, and of every thread where it is asked to, as
``--profile`` asks), and, for a span opened with ``stream=True`` in a
process that has used CUDA, a pair of pooled timing events recorded on the
current stream at entry and exit. Only the phases whose stream time a
metric reads take events: a record costs the host tens of µs under the
profiler, which a closed loop, where the card idles between requests,
shows as idle time.

Spans stay in memory, at most :data:`MAX_SPANS` a window. The first span
of a window clears what the previous window left and returns its events to
the pool. :func:`recorded` reads the window out. A counter is a
module-level dict of ints made by :func:`counter_dict`, which registers it:
:func:`counters` is one snapshot of every registered dict (the kernels'
launches and forms, the packer's slots and tokens), read where they are,
and :func:`window_counters` their change since the window began. No span
or counter reads a device value back to the host.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 16

# "<module>.<dict>" -> a module's counter dict (counter_dict)
_COUNTERS: Dict[str, Dict[str, int]] = {}


def counter_dict(name: str, keys: Iterable[str]) -> Dict[str, int]:
    """A dict of int counters ``keys``, all 0, that :func:`counters` reads
    as ``<name>.<key>``; the module that counts keeps it at module level."""
    counts = dict.fromkeys(keys, 0)
    _COUNTERS[name] = counts
    return counts


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


class _Window:
    """The spans of the current profiling window and what they hold."""

    def __init__(self):
        self.lock = threading.Lock()
        self.live = False
        self.spans: List["_Span"] = []
        self.step = -1
        self.counters: Dict[str, int] = {}
        self.events: Dict[int, list] = {}  # device index -> free timing events
        self.local = threading.local()

    def begin(self) -> None:
        """The first span of a window: drop the previous window's spans and
        take the counters' snapshot the window's changes count from."""
        with self.lock:
            if self.live:
                return
            for s in self.spans:
                if s.ev is not None:
                    self.events.setdefault(s.ev[0], []).extend(s.ev[1:])
            self.spans = []
            self.step = -1
            self.counters = counters()
            self.live = True

    def add(self, s: "_Span") -> Optional[int]:
        """``s``'s index in the window, its step index taken (None when the
        window is full)."""
        with self.lock:
            if len(self.spans) >= MAX_SPANS:
                return None
            if s.is_step and s.parent is None:
                self.step += 1
            s.step = self.step
            self.spans.append(s)
            return len(self.spans) - 1

    def event_pair(self) -> list:
        """``[device index, entry event, exit event]`` from the pool."""
        dev = torch.cuda.current_device()
        with self.lock:
            free = self.events.setdefault(dev, [])
            pair = [free.pop() for _ in range(min(2, len(free)))]
        return [dev] + pair + [torch.cuda.Event(enable_timing=True) for _ in range(2 - len(pair))]


_W = _Window()


class _Span:
    __slots__ = ("name", "is_step", "stream", "parent", "thread", "step", "start", "end", "ev",
                 "rf")

    def __init__(self, name: str, is_step: bool, stream: bool):
        self.name, self.is_step, self.stream = name, is_step, stream

    def __enter__(self):
        w = _W
        if not w.live:
            w.begin()
        stack = getattr(w.local, "stack", None)
        if stack is None:
            stack = w.local.stack = []
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        self.start = self.end = self.ev = self.rf = None
        index = w.add(self)
        if index is None:
            return None
        stack.append(index)
        if self.stream and torch.cuda.is_initialized():
            self.ev = w.event_pair()
        self.rf = torch.profiler.record_function(self.name)
        self.start = time.time_ns()
        self.rf.__enter__()
        if self.ev is not None:
            self.ev[1].record()
        return None

    def __exit__(self, *exc):
        if self.rf is None:
            return False
        if self.ev is not None:
            self.ev[2].record()
        self.rf.__exit__(*exc)
        self.end = time.time_ns()
        _W.local.stack.pop()
        return False


def span(name: str, step: bool = False, stream: bool = False):
    """A context that records ``name`` while a profiler records (module
    docstring); ``step=True`` marks the outermost span of a train or eval
    step, which counts the step index; ``stream=True`` times the span on
    the device's stream too."""
    if not _autograd_profiler._is_profiler_enabled:
        _W.live = False
        return _NOOP
    return _Span(name, step, stream)


def _stream_ms(s: "_Span") -> Optional[float]:
    if s.ev is None or s.end is None or not s.ev[2].query():
        return None
    return s.ev[1].elapsed_time(s.ev[2])


def recorded() -> List[dict]:
    """The window's spans in the order they began: ``name``, ``parent``
    (index in this list, or None), ``thread``, ``step``, ``start_ns`` and
    ``end_ns`` (``time.time_ns()``), ``host_ms``, ``self_ms`` (host ms less
    the part its child spans cover) and ``stream_ms``: device ms from the
    entry event to the exit event on the span's stream, idle time inside
    the span included, once both have completed (None before that, on the
    CPU, and for a span still open). Read with no profiler recording, it
    ends the window: the next span to record starts a new one."""
    if not _autograd_profiler._is_profiler_enabled:
        _W.live = False
    out = []
    for s in list(_W.spans):
        host = (s.end - s.start) / 1e6 if s.end is not None and s.start is not None else None
        out.append({"name": s.name, "parent": s.parent, "thread": s.thread, "step": s.step,
                    "start_ns": s.start, "end_ns": s.end, "host_ms": host, "self_ms": host,
                    "stream_ms": _stream_ms(s)})
    for s in out:
        parent = out[s["parent"]] if s["parent"] is not None else None
        if parent is not None and parent["self_ms"] is not None and s["host_ms"] is not None:
            parent["self_ms"] -= s["host_ms"]
    return out


def counters() -> Dict[str, int]:
    """Every registered counter now, as ``<module>.<dict>.<key>``."""
    return {f"{name}.{key}": int(value)
            for name, counts in _COUNTERS.items() for key, value in counts.items()}


def window_counters() -> Dict[str, int]:
    """Each counter's change since the current (or last) window's first
    span: what the window's work and whatever ran on until the read counted."""
    start = _W.counters
    return {k: v - start.get(k, 0) for k, v in counters().items()}
