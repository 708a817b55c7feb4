"""Short-row attention probe: the bare head-summed Q K^T and P V products at
the text shape ``[1024, 77, 8 x 64]``, the ViT-B/32 train step's captions.

Port of ``tools/r4_transpose_probe.py::main``, which asked whether the TPU's
short-row products are bound by the relayout of one operand. On the card it
times the three lab product kernels of :mod:`latteclip_torch.kernels.lab`:

    python -m latteclip_torch.tools.r4_transpose_probe [--device cuda|cpu]
        [--batch 1024 --length 77 --heads 8 --head-dim 64] [--iters 20]

  natural  S = sum_h q_h . k_h^T, k as [B, L, HD]   (the flash kernels' product)
  pret     the same S with k given transposed, kT [B, HD, L], made by one
           copy outside the timed kernel, as XLA makes it in the JAX tool
  pv       O = sum_h p . v_h, one p [B, L, L] for every head

Each line gives ms and TF/s (2 B H L^2 D FLOP, the JAX tool's count) beside
``torch.bmm`` on the same operands, timed only: ``bmm(q, k^T)``,
``bmm(q, kT)`` (bf16 out) and ``bmm(p, v)`` (every head's product, without
the sum over heads). q, k, p and v are N(0, 1) bf16 from numpy seed 0. On
the card the times are CUDA-event medians with L2 flushed; ``--device cpu``
runs the plain versions on the host clock, which measures no device.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from latteclip_torch.device import resolve_device
from latteclip_torch.kernels import lab
from latteclip_torch.tools.attn_lab import draw, max_err
from latteclip_torch.tools.perf_lab import Timer


def run(device="cuda", B: int = 1024, L: int = 77, H: int = 8, D: int = 64, iters: int = 20) -> dict:
    """Print the probe's lines and return its numbers."""
    dev = resolve_device(device)
    HD = H * D
    flops = 2 * B * H * L * L * D
    rng = np.random.default_rng(0)
    q, k = draw(rng, (B, L, HD), dev), draw(rng, (B, L, HD), dev)
    p, v = draw(rng, (B, L, L), dev), draw(rng, (B, L, HD), dev)
    kt = k.transpose(1, 2).contiguous()
    timer = Timer(dev, iters)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"r4_transpose_probe: {name}, [{B},{L},{H}x{D}] bf16, times: {timer.clock()}, "
          f"median of {iters}", flush=True)
    pret_vs_natural = max_err(lab.qk_heads_pret(q, kt, H), lab.qk_heads_natural(q, k, H))
    print(f"pret vs natural: max|S| err = {pret_vs_natural:.6g}", flush=True)
    rows = [
        ("natural", lambda: lab.qk_heads_natural(q, k, H), lambda: torch.bmm(q, k.transpose(1, 2))),
        ("pret", lambda: lab.qk_heads_pret(q, kt, H), lambda: torch.bmm(q, kt)),
        ("pv", lambda: lab.pv_heads(p, v, H), lambda: torch.bmm(p, v)),
    ]
    ms, bmm_ms = {}, {}
    for key, fn, yardstick in rows:
        ms[key], bmm_ms[key] = timer(fn), timer(yardstick)
        print(f"{key:10s}: {ms[key]:9.4f} ms {flops / ms[key] / 1e9:7.2f} TF/s   "
              f"bmm {bmm_ms[key]:9.4f} ms {flops / bmm_ms[key] / 1e9:7.2f} TF/s", flush=True)
    return {"device": name, "shape": [B, L, H, D], "clock": timer.clock(),
            "pret_vs_natural": pret_vs_natural, "ms": ms, "bmm_ms": bmm_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--length", type=int, default=77)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args(argv)
    run(a.device, a.batch, a.length, a.heads, a.head_dim, a.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
