"""Model profiler and step tracer (port of ``latteclip_tpu/obs/profiler.py``:
``count_params``, ``profile_model``, ``StepTraceProfiler``, ``main``).

:func:`profile_model` counts a model's parameters, whole and per tower, and
the FLOPs of one image and one text forward per sample with
``torch.utils.flop_counter.FlopCounterMode``, on the plain attention so that
its products are counted too. The counter counts the matrix products
(``2 m n k`` each: linear layers, the patch convolution, attention); JAX
reads XLA's cost analysis of the compiled forward, which also counts the
elementwise work (LayerNorm, softmax, GELU, the residual adds), a few
percent more at CLIP's widths. Output: one CSV line per model, the JAX
tool's columns.

:class:`StepTraceProfiler` records a ``torch.profiler`` trace of the train
loop's steps ``[start_step, start_step + num_steps)``, host and (on CUDA)
device activity, and writes it as a Chrome trace,
``<trace_dir>/steps_<start>-<stop>.pt.trace.json``, which Perfetto and
TensorBoard's profiler plugin read. Before the trace stops it calls
``sync`` (``torch.cuda.synchronize`` on the card), so that the traced
steps' kernels land inside the window.

Usage:
    python -m latteclip_torch.obs.profiler --model ViT-B-32 ViT-B-16 [--batch-size 1]
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import torch


def count_params(params) -> int:
    return sum(p.numel() for p in params)


def _flops(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def profile_model(name: str, batch_size: int = 1, device="cuda") -> Dict[str, float]:
    """Parameters (millions, whole and per tower) and GFLOPs per sample of
    the image and text forwards of config ``name`` at seed-0 weights."""
    from latteclip_torch.config import get_model_config
    from latteclip_torch.models import clip as clip_mod
    from latteclip_torch.train.optim import tower_parameters

    cfg = get_model_config(name)
    model = clip_mod.init_clip_params(torch.Generator().manual_seed(0), cfg, device=device)
    dev = model.logit_scale.device
    size = cfg.vision.image_size
    images = torch.zeros((batch_size, size, size, 3), dtype=torch.float32, device=dev)
    tokens = torch.zeros((batch_size, cfg.text.context_length), dtype=torch.long, device=dev)
    image_flops = _flops(lambda: clip_mod.encode_image(model, images, normalize=True,
                                                       attention="plain"))
    text_flops = _flops(lambda: clip_mod.encode_text(model, tokens, normalize=True,
                                                     attention="plain"))
    return {
        "model": name,
        "image_size": size,
        "image_width": cfg.vision.width,
        "text_width": cfg.text.width,
        "embed_dim": cfg.embed_dim,
        "mparams": round(count_params(model.parameters()) / 1e6, 2),
        "mparams_image": round(count_params(tower_parameters(model, "visual")) / 1e6, 2),
        "mparams_text": round(count_params(tower_parameters(model, "text")) / 1e6, 2),
        "image_gflops": round(image_flops / batch_size / 1e9, 2),
        "text_gflops": round(text_flops / batch_size / 1e9, 2),
        "gflops": round((image_flops + text_flops) / batch_size / 1e9, 2),
    }


class StepTraceProfiler:
    """A ``torch.profiler`` trace of steps ``[start_step, start_step +
    num_steps)`` (module docstring). Call :meth:`on_step` with each step's
    index before the step runs, and :meth:`close` when the loop ends: it
    stops a trace the run left open (a run shorter than ``start + num``)
    and is idempotent. ``sync`` blocks until the dispatched device work is
    done; it runs before the trace stops."""

    def __init__(self, trace_dir: str, start_step: int = 3, num_steps: int = 5):
        self.trace_dir = trace_dir
        self.start_step = max(int(start_step), 0)
        self.stop_step = self.start_step + max(int(num_steps), 1)
        self.path: Optional[str] = None
        self._prof = None
        self._last = -1
        self._done = False

    def on_step(self, step: int, sync: Optional[Callable[[], None]] = None) -> None:
        if self._done:
            return
        self._last = step
        if self._prof is None and step == self.start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            if sync is not None:
                sync()
            self._prof = profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and step >= self.stop_step:
            self._stop(sync, stop=step)

    def close(self, sync: Optional[Callable[[], None]] = None) -> None:
        if self._prof is not None:
            self._stop(sync, stop=self._last + 1)
        self._done = True

    def _stop(self, sync, stop: int) -> None:
        if sync is not None:
            sync()
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self.path = os.path.join(self.trace_dir,
                                 f"steps_{self.start_step}-{stop}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self._done = True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", nargs="+", required=True)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    rows = [profile_model(m, args.batch_size, device=args.device) for m in args.model]
    cols = sorted({k for r in rows for k in r})
    cols = ["model"] + [c for c in cols if c != "model"]
    print(",".join(cols))
    for r in rows:
        print(",".join(str(r.get(c, "")) for c in cols))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
