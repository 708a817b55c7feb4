"""The port's span recorder (``latteclip_torch/obs/trace.py``) on the CPU:

* with no profiler recording, ``span`` is the shared no-op and records nothing;
* under ``torch.profiler`` one v2 step of ViT-tiny-test records the span tree
  of the step, in order, with its parents, and the input path's spans;
* a span's ``time_ns`` start lies within 1 ms of its ``record_function``
  event in the profiler's own events, both from ``trace_start_ns()``;
* a second profiling window starts with an empty buffer;
* ``h2d`` and ``pack`` come from the prefetch thread;
* the packer's counters count its slots and real tokens, and ``counters``
  reads every dict made by ``counter_dict``, the kernels' too;
* ``--profile``'s Chrome trace holds the program's ``train_step`` and the
  prefetch thread's ``h2d`` and ``pack``.
"""
import contextlib
import json
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from latteclip_torch.config import get_model_config
from latteclip_torch.data import packing
from latteclip_torch.data import pipeline
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.obs import profiler as obs_profiler
from latteclip_torch.obs import trace
from latteclip_torch.train import state as St
from latteclip_torch.train import step as S

B, PACK, CLASSES = 4, 128, 5

# the v2 step's tree: (name, parent's name), in the order the spans begin
V2_TREE = [
    ("train_step", None), ("augment", "train_step"), ("wait", "augment"),
    ("forward", "train_step"), ("vision", "forward"), ("text", "forward"), ("loss", "forward"),
    ("backward", "train_step"), ("update", "train_step"), ("optimizer", "update"),
    ("bank", "update"), ("wait", "bank"),
]


@pytest.fixture(scope="module")
def v2():
    """A packed v2 step of ViT-tiny-test, its state and a batch maker."""
    torch.manual_seed(0)
    cfg = get_model_config("ViT-tiny-test")
    model = clip_mod.init_clip_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = get_tokenizer()
    classes = [f"class {i}" for i in range(CLASSES)]
    templates = [lambda c: f"a photo of a {c}."]
    table = St.build_template_table(tok, classes, templates)
    bank = St.init_memory_bank(model, tok, classes, templates)
    state = St.create_train_state(model, torch.optim.SGD(model.parameters(), lr=1e-3), bank)
    step = S.make_train_step(model, S.LatteHParams(text_packing=True), table,
                             template_packed=packing.pack_template_table(table, PACK))
    rng = np.random.default_rng(0)
    captions = tok([f"caption {i} of a few words" for i in range(B)])
    size = cfg.vision.image_size

    def batches():
        while True:
            b = {"images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
                 "zs_preds": rng.integers(0, CLASSES, B).astype(np.int32)}
            b.update(packing.pack_caption_batch(captions, captions, PACK, 8))
            yield b

    return types.SimpleNamespace(step=step, state=state, batches=batches)


def _run(v2, steps, gen_seed=0):
    """``steps`` v2 steps fed through ``prefetch``."""
    it = pipeline.prefetch(v2.batches(), size=2)
    for i in range(steps):
        v2.step(v2.state, next(it), torch.Generator().manual_seed(gen_seed + i))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_no_profiler_records_nothing(v2):
    _traced(lambda: _run(v2, 1))
    before = trace.recorded()
    assert trace.span("train_step", step=True) is trace.span("x") is trace._NOOP
    with trace.span("x") as inside:
        assert inside is None
    _run(v2, 1)
    assert trace.recorded() == before


def test_a_v2_step_records_its_span_tree(v2):
    _traced(lambda: _run(v2, 1))
    spans = trace.recorded()
    main = threading.get_ident()
    step = [s for s in spans if s["thread"] == main and s["name"] != "input_wait"]
    assert [(s["name"], spans[s["parent"]]["name"] if s["parent"] is not None else None)
            for s in step] == V2_TREE
    assert {s["step"] for s in step} == {0}
    waits = [s for s in spans if s["name"] == "input_wait"]
    assert len(waits) == 1 and waits[0]["parent"] is None and waits[0]["thread"] == main
    for s in spans:
        assert s["host_ms"] >= s["self_ms"] >= 0 and s["stream_ms"] is None
    root = step[0]
    assert root["start_ns"] <= min(s["start_ns"] for s in step[1:])
    assert root["end_ns"] >= max(s["end_ns"] for s in step[1:])


def test_span_starts_on_the_profilers_clock(v2):
    prof = _traced(lambda: _run(v2, 1))
    origin = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for ev in prof.events():
        events.setdefault(ev.name, []).append(ev.time_range.start)  # us from origin
    spans = [s for s in trace.recorded() if s["thread"] == threading.get_ident()]
    assert spans
    for s in spans:
        assert len(events.get(s["name"], [])) >= 1, s["name"]
        got = (s["start_ns"] - origin) / 1e3
        assert min(abs(got - t) for t in events[s["name"]]) < 1000.0, s["name"]


def test_a_second_window_starts_empty(v2):
    def steps():
        return [s["step"] for s in trace.recorded() if s["name"] == "train_step"]

    # a window ends where a span runs with no profiler recording ...
    _traced(lambda: _run(v2, 2))
    _run(v2, 1)
    _traced(lambda: _run(v2, 1, gen_seed=5))
    assert steps() == [0]
    # ... or where the spans are read out with none recording
    _traced(lambda: _run(v2, 2, gen_seed=7))
    assert steps() == [0, 1]
    _traced(lambda: _run(v2, 1, gen_seed=9))
    assert steps() == [0]


@pytest.fixture
def fake_cuda(monkeypatch):
    """A CUDA stream, event and stream context of no device, so that
    ``prefetch`` on "cuda" runs its copy (``h2d``) on the CPU: the copy
    passes non-array values through."""
    class Dummy:
        def __init__(self, *a, **k):
            pass

        def record(self, *a):
            pass

        def wait_event(self, *a):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", Dummy)
    monkeypatch.setattr(torch.cuda, "Event", Dummy)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Dummy())


def _packed_lists(count):
    """``count`` packed caption batches as lists, which the copy passes through."""
    tok = get_tokenizer()
    caps = tok(["a caption", "another caption of more words"])
    for _ in range(count):
        yield {"n": 1, **{k: v.tolist() for k, v in
                         packing.pack_caption_batch(caps, caps, PACK, 2).items()}}


def test_h2d_and_pack_come_from_the_prefetch_thread(fake_cuda):
    def consume():
        for _ in pipeline.prefetch(_packed_lists(3), size=1, device="cuda"):
            pass

    _traced(consume)
    spans = trace.recorded()
    main = threading.get_ident()
    threads = {s["name"]: set() for s in spans}
    for s in spans:
        threads[s["name"]].add(s["thread"])
    assert [s["name"] for s in spans].count("h2d") == 3
    assert [s["name"] for s in spans].count("pack") == 3
    assert threads["h2d"] == threads["pack"] and main not in threads["h2d"]
    assert threads["input_wait"] == {main}


def test_pack_counters_count_rows_slots_and_tokens():
    tok = get_tokenizer()
    per_image = tok(["a photo", "a longer caption of a photo of a dog", "x"])
    per_group = tok(["two words", "three more words", "and four more words"])
    lengths = packing.token_lengths(np.concatenate([per_image, per_group]))
    rows = packing.pack_rows_needed(lengths, 32) + 3
    before = trace.counters()
    packing.pack_caption_batch(per_image, per_group, 32, rows)
    after = trace.counters()
    change = {k: after[k] - before.get(k, 0) for k in after if k.startswith("packing.")}
    assert change == {"packing.pack_counts.pack_slots": rows * 32,
                      "packing.pack_counts.pack_tokens": int(lengths.sum())}
    assert all(isinstance(v, int) for v in after.values())


def test_counters_read_every_registered_dict():
    from latteclip_torch.kernels import attention as A, fused_ln_linear as FL, lab as LB

    snap = trace.counters()
    for name, counts in (("attention.launch_counts", A.launch_counts),
                         ("attention.fwd_form_counts", A.fwd_form_counts),
                         ("attention.bwd_form_counts", A.bwd_form_counts),
                         ("attention.short_fwd_form_counts", A.short_fwd_form_counts),
                         ("attention.short_bwd_form_counts", A.short_bwd_form_counts),
                         ("fused_ln_linear.launch_counts", FL.launch_counts),
                         ("lab.launch_counts", LB.launch_counts)):
        assert {k: snap[f"{name}.{k}"] for k in counts} == counts
    counts = trace.counter_dict("test_trace.new_counts", ("a", "b"))
    try:
        counts["b"] += 2
        assert {k: v for k, v in trace.counters().items() if k.startswith("test_trace.")} == {
            "test_trace.new_counts.a": 0, "test_trace.new_counts.b": 2}
    finally:
        del trace._COUNTERS["test_trace.new_counts"]


def test_the_profile_trace_holds_the_program_spans(v2, tmp_path):
    tracer = obs_profiler.StepTraceProfiler(str(tmp_path / "trace"), start_step=1, num_steps=1)
    it = pipeline.prefetch(v2.batches(), size=2)
    for i in range(3):
        tracer.on_step(i)
        v2.step(v2.state, next(it), torch.Generator().manual_seed(i))
    tracer.close()
    with open(tracer.path) as f:
        names = [ev.get("name") for ev in json.load(f)["traceEvents"]]
    assert names.count("train_step") == 1
    assert {"augment", "forward", "backward", "update", "input_wait", "pack"} <= set(names)


def test_the_profile_trace_holds_the_input_lane(fake_cuda, tmp_path):
    # the prefetch thread starts before the trace, as in the train loop; the
    # batch that step 3 takes is made after step 1 took its own: in the trace
    tracer = obs_profiler.StepTraceProfiler(str(tmp_path / "trace"), start_step=1, num_steps=3)
    it = pipeline.prefetch(_packed_lists(8), size=1, device="cuda")
    for i in range(5):
        tracer.on_step(i)
        next(it)
    tracer.close()
    with open(tracer.path) as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for ev in events:
        tids.setdefault(ev.get("name"), set()).add(ev.get("tid"))
    assert tids.get("h2d") and tids.get("pack") and tids.get("input_wait")
    assert tids["h2d"] == tids["pack"] and not tids["h2d"] & tids["input_wait"]
