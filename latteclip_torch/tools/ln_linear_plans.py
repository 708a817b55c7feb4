"""Time the fused LayerNorm -> linear kernel (K8) under launch plans other
than its own, on the card:

    python -m latteclip_torch.tools.ln_linear_plans

For each site (x [M, D] -> [M, O]: the padded ViT-B/32 train step's pairs,
the classifier build's and ViT-B/16 vision at batch 512), the entry point
``latteclip_ln_linear`` runs on the bf16 W under the plan that
``fused_ln_linear.ln_linear_plan`` picks and under others: fewer W stages,
other splits of a row tile's outputs, and 64-row tiles. Each is checked
against the plain version (bf16 out, as ``chip_smoke.py`` holds it) and
timed with CUDA events, L2 flushed, median of ``--iters``. Prints one JSON
line a site with every plan's time and the unfused route's,
``dense(layer_norm(x))``. It answers how the plan's rules were chosen; the
kernel and its wrapper never read it.
"""
from __future__ import annotations

import argparse
import json

import torch

from latteclip_torch.kernels import fused_ln_linear as FL
from latteclip_torch.tools.perf_lab import Timer

SITES = ((25600, 768, 2304), (25600, 768, 3072), (78848, 512, 1536), (78848, 512, 2048),
         (3619, 512, 1536), (3619, 512, 2048), (100864, 768, 3072))
OUT_TOL, OUT_REL_TOL = 2e-2, 1e-2


def agrees(y, ref) -> bool:
    d, r = y.float() - ref.float(), ref.float()
    return bool((d.abs() <= OUT_TOL + OUT_TOL * r.abs()).all()) and float(d.norm() / r.norm()) <= OUT_REL_TOL


def sweep(M, D, O, timer, gen, sms) -> dict:
    x = torch.randn((1, M, D), generator=gen, device="cuda").to(torch.bfloat16)
    ln_w = 1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    ln_b, wb = (0.1 * torch.randn(n, generator=gen, device="cuda") for n in (D, O))
    w = torch.randn((O, D), generator=gen, device="cuda") * D ** -0.5
    w16 = w.to(torch.bfloat16)
    ref = FL.fused_ln_linear_plain(x, ln_w, ln_b, w, wb)
    y = torch.empty(1, M, O, device="cuda", dtype=torch.bfloat16)
    kernel = FL._kernel()
    stream = torch.cuda.current_stream().cuda_stream
    plan = FL.ln_linear_plan(M, D, O, sms)
    plans = {(plan.bm, plan.bn, plan.n_splits, plan.stages)}
    plans |= {(plan.bm, plan.bn, plan.n_splits, st) for st in range(FL.LN_MIN_STAGES, plan.stages)}
    plans |= {(plan.bm, plan.bn, sp, plan.stages) for sp in (1, 2, 3, 4, 6) if sp <= -(-O // plan.bn)}
    if plan.bm == 128:  # the same splits at 64-row tiles, with as many stages as fit
        fixed = FL.ln_linear_smem_bytes(64, 128, D, 0)
        plans.add((64, 128, plan.n_splits,
                   min(FL.LN_MAX_STAGES, (FL.MAX_SMEM - fixed) // (128 * FL.LN_PANEL * 2 + 16))))
    times = {}
    for bm, bn, splits, stages in sorted(plans):
        call = lambda: kernel(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w16.data_ptr(),  # noqa: E731
                              wb.data_ptr(), y.data_ptr(), M, D, O, FL.LN_EPS, bm, bn, splits,
                              stages, stream)
        if call():
            raise RuntimeError(f"plan {bm, bn, splits, stages} refused at {[M, D, O]}")
        torch.cuda.synchronize()
        if not agrees(y, ref):
            raise RuntimeError(f"plan {bm, bn, splits, stages} disagrees at {[M, D, O]}")
        times[f"bm{bm} bn{bn} splits{splits} stages{stages}"] = timer(call)
    own = f"bm{plan.bm} bn{plan.bn} splits{plan.n_splits} stages{plan.stages}"
    unfused = timer(lambda: FL.dense(FL.layer_norm(x, ln_w, ln_b), w, wb, torch.bfloat16))
    return {"site": [M, D, O], "plan": own, "plan_ms": times[own],
            "best": min(times, key=times.get), "best_ms": min(times.values()),
            "unfused_ms": unfused, "ms": times}


def run(sites=SITES, iters=20):
    if not torch.cuda.is_available():
        raise RuntimeError("the fused LayerNorm -> linear kernel runs on a CUDA device only")
    timer = Timer("cuda", iters=iters)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return [sweep(*site, timer, gen, sms) for site in sites]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    for rec in run(iters=args.iters):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
