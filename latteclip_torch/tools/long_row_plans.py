"""Time the long-row forward kernel (rows of more than 128 tokens) under
launch plans other than its own, on the card:

    python -m latteclip_torch.tools.long_row_plans

For each shape, K1's entry point (``latteclip_flash_fwd``) runs non-causal
under every plan of ``--warps`` x ``--splits`` x form (resident, streamed)
that the kernel takes, each checked against the plain version (out and
lse2, as ``chip_smoke.py`` holds them) and timed with CUDA events, L2
flushed, median of ``--iters``. Prints one JSON line a shape: the plan that
``attention.long_row_plan`` picks, its time, and every plan's time, and
SDPA's on the same q, k, v. It answers how the plan's rules (warps a CTA,
splits, form) were chosen; the kernels and their wrappers never read it.
"""
from __future__ import annotations

import argparse
import itertools
import json

import torch
import torch.nn.functional as F

from latteclip_torch.kernels import attention as A
from latteclip_torch.tools.perf_lab import Timer

SHAPES = ((64, 197, 12, 64), (256, 197, 12, 64), (64, 197, 6, 128), (8, 577, 16, 64))
OUT_TOL, OUT_REL_TOL, LSE_TOL = 2e-2, 1e-2, 1e-3


def agrees(out, lse2, ref_out, ref_lse2) -> bool:
    d, r = out.float() - ref_out.float(), ref_out.float()
    return (bool((d.abs() <= OUT_TOL + OUT_TOL * r.abs()).all())
            and float(d.norm() / r.norm()) <= OUT_REL_TOL
            and float((lse2 - ref_lse2).abs().max()) <= LSE_TOL)


def sweep(B, L, H, D, warps_grid, splits_grid, timer, gen) -> dict:
    std = torch.tensor([0.3, 0.3, 1.0], device="cuda").repeat_interleave(H * D)
    qkv = (torch.randn((B, L, 3 * H * D), generator=gen, device="cuda") * std).to(torch.bfloat16)
    out = torch.empty(B, L, H * D, device="cuda", dtype=torch.bfloat16)
    lse2 = torch.empty(B, H, L, device="cuda")
    ref_out, ref_lse2 = A.flash_fwd_plain(qkv, H, False)
    kernel = A._kernel("latteclip_flash_fwd")
    stream = torch.cuda.current_stream().cuda_stream
    nblk = -(-L // 16)
    times = {}
    for warps, splits, resident in itertools.product(warps_grid, splits_grid, (True, False)):
        if (warps > nblk // splits or A.long_row_smem_bytes(L, D, warps, False, resident) > A.MAX_SMEM):
            continue
        call = lambda: kernel(qkv.data_ptr(), out.data_ptr(), lse2.data_ptr(), B, L, H, D, 0,  # noqa: E731
                              (D ** -0.5) * A.LOG2E, warps, splits, int(resident), stream)
        if call():
            raise RuntimeError(f"plan {warps, splits, resident} refused at {[B, L, H, D]}")
        torch.cuda.synchronize()
        if not agrees(out, lse2, ref_out, ref_lse2):
            raise RuntimeError(f"plan {warps, splits, resident} disagrees at {[B, L, H, D]}")
        form = "resident" if resident else "streamed"
        times[f"{form} w{warps} s{splits}"] = timer(call)
    plan = A.long_row_plan(B, L, H, D, False, torch.cuda.get_device_properties(0).multi_processor_count)
    q, k, v = qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
    own = f"{plan.form} w{plan.warps} s{plan.splits}"
    return {"shape": [B, L, H, D], "plan": own, "plan_ms": times.get(own),
            "best": min(times, key=times.get), "best_ms": min(times.values()),
            "sdpa_ms": timer(lambda: F.scaled_dot_product_attention(q, k, v)), "ms": times}


def run(shapes=SHAPES, warps_grid=(4, 5, 7, 8, 10, 13, 16), splits_grid=(1, 2, 3), iters=20):
    if not torch.cuda.is_available():
        raise RuntimeError("the long-row kernel runs on a CUDA device only")
    timer = Timer("cuda", iters=iters)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [sweep(*shape, warps_grid, splits_grid, timer, gen) for shape in shapes]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warps", type=int, nargs="+", default=[4, 5, 7, 8, 10, 13, 16])
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args()
    for rec in run(warps_grid=args.warps, splits_grid=args.splits, iters=args.iters):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
