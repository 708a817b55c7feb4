"""Attention layout lab: is attention faster in the packed ``[B, L, H*D]``
layout or in ``[B, H, L, D]``, and what do the permutes between the two cost?

Port of ``tools/attn_lab.py::main`` at its shape, ViT-B/16 vision
``[512, 197, 12 x 64]``, with the lab kernels of
:mod:`latteclip_torch.kernels.lab`:

    python -m latteclip_torch.tools.attn_lab [--device cuda|cpu]
        [--batch 512 --length 197 --heads 12 --head-dim 64] [--iters 20]

It prints the lab forward packed (v1) against the lab forward in BHLD (v3)
on o and lse; v1 against the current whole-row route (K1 on
``torch.cat([q, k, v], -1)``, as ``flash_attention_packed`` runs it) on o and
on lse, with K1's base-2 lse2 taken to natural log as ``lse2 * ln 2``; then
the time and TF/s of the current route, v1 packed, the permute there and
back alone, v3 packed (with its permutes), v3 in BHLD, the current forward
and backward (``FlashAttention``), v3 forward and backward in BHLD
(``LabAttentionBHLD``), and SDPA forward and forward + backward in BHLD
as the library's yardstick. Inputs are N(0, 1) bf16 from numpy seed 0, as
the JAX tool draws them. On the card the times are CUDA-event medians with
L2 flushed; ``--device cpu`` runs the plain versions on the host clock,
which measures no device.
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from latteclip_torch.device import resolve_device
from latteclip_torch.kernels import attention as A
from latteclip_torch.kernels import lab
from latteclip_torch.tools.perf_lab import Timer

LN2 = math.log(2.0)


def draw(rng: np.random.Generator, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch.bfloat16)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def run(device="cuda", B: int = 512, L: int = 197, H: int = 12, D: int = 64, iters: int = 20) -> dict:
    """Print the lab's lines and return its numbers."""
    dev = resolve_device(device)
    HD = H * D
    n = B * H * L * L * D
    fwd_flops, bwd_flops = 4 * n, 11 * n  # the JAX tool's counts
    rng = np.random.default_rng(0)
    q, k, v = (draw(rng, (B, L, HD), dev) for _ in range(3))
    timer = Timer(dev, iters)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"attn_lab: {name}, [{B},{L},{H}x{D}] bf16, times: {timer.clock()}, median of {iters}",
          flush=True)

    o1, lse1 = lab.lab_fwd_packed(q, k, v, H)
    o3, lse3 = lab.lab_fwd_v3_packed(q, k, v, H)
    cur_o, cur_lse2 = A.flash_attention_qkv(torch.cat([q, k, v], -1), H)
    checks = {
        "v3_vs_v1": {"o": max_err(o3, o1), "lse": max_err(lse3.transpose(0, 1), lse1)},
        "current_vs_v1": {"o": max_err(cur_o, o1), "lse": max_err(cur_lse2 * LN2, lse1)},
    }
    del o1, lse1, o3, lse3, cur_o, cur_lse2
    for key, label in (("v3_vs_v1", "v3 vs v1"), ("current_vs_v1", "current (K1) vs v1")):
        print(f"{label}: max|o| err = {checks[key]['o']:.6g}  max|lse| err = {checks[key]['lse']:.6g}",
              flush=True)

    qb, kb, vb = (lab.to_bhld(x, H).contiguous() for x in (q, k, v))
    dob = qb.clone()  # the JAX tool's cotangent
    ones = torch.ones((B, L, HD), dtype=torch.bfloat16, device=dev)  # of sum(out)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    leaves_b = [x.detach().requires_grad_(True) for x in (qb, kb, vb)]

    def current_fb():
        out = A.FlashAttention.apply(torch.cat(leaves, -1), H, False)[0]
        return torch.autograd.grad(out, leaves, ones)

    def lab_fb():
        o = lab.LabAttentionBHLD.apply(*leaves_b)[0]
        return torch.autograd.grad(o, leaves_b, dob)

    def sdpa_fb():
        o = F.scaled_dot_product_attention(*leaves_b)
        return torch.autograd.grad(o, leaves_b, dob)

    rows = [
        # (key, label, fn, FLOP or None)
        ("current_fwd", "K1 fwd (current, cat + kernel)",
         lambda: A.flash_attention_qkv(torch.cat([q, k, v], -1), H), fwd_flops),
        ("v1_fwd", "lab v1 fwd (packed)", lambda: lab.lab_fwd_packed(q, k, v, H), fwd_flops),
        ("xpose", "xpose there+back", lambda: lab.from_bhld(lab.to_bhld(q, H).contiguous()), None),
        ("v3_fwd_packed", "lab v3 fwd (packed, permutes)", lambda: lab.lab_fwd_v3_packed(q, k, v, H),
         fwd_flops),
        ("v3_fwd_bhld", "lab v3 fwd (BHLD)", lambda: lab.lab_fwd_bhld(qb, kb, vb), fwd_flops),
        ("current_fb", "K1+K3 f+b (current)", current_fb, fwd_flops + bwd_flops),
        ("v3_fb_bhld", "lab v3 f+b (BHLD)", lab_fb, fwd_flops + bwd_flops),
        ("sdpa_fwd", "SDPA fwd (BHLD)", lambda: F.scaled_dot_product_attention(qb, kb, vb), fwd_flops),
        ("sdpa_fb", "SDPA f+b (BHLD)", sdpa_fb, fwd_flops + bwd_flops),
    ]
    ms, tflops = {}, {}
    for key, label, fn, flops in rows:
        ms[key] = timer(fn)
        rate = ""
        if flops is not None:
            tflops[key] = flops / ms[key] / 1e9
            rate = f"  {tflops[key]:7.2f} TF/s"
        print(f"{label + ':':32s} {ms[key]:9.4f} ms{rate}", flush=True)
    return {"device": name, "shape": [B, L, H, D], "clock": timer.clock(), "checks": checks,
            "ms": ms, "tflops": tflops}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--length", type=int, default=197)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args(argv)
    run(a.device, a.batch, a.length, a.heads, a.head_dim, a.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
