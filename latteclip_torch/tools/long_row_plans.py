"""Time the long-row attention kernels (rows of more than 128 tokens) under
launch plans other than their own, on the card:

    python -m latteclip_torch.tools.long_row_plans

For each shape, K1's entry point (``latteclip_flash_fwd``) runs non-causal
under every plan it takes: at head_dim 64 the rings (the row ring up to 272
tokens at one and two slots, the stream ring's 64- and 128-key chunks at
one, two and the most slots that fit; each on the plan's grid and on half
of it), and at every head width ``flash_fwd_long_kernel``'s plans of
``--warps`` x ``--splits`` x form (resident, streamed) that the kernel
takes. Each is checked against the plain version (out and lse2, as
``chip_smoke.py`` holds them) and timed with CUDA events, L2 flushed,
median of ``--iters``. Prints one JSON line a shape: the plan that
``attention.long_row_plan`` picks, its time, the device time of its kernel
(a torch.profiler trace, L2 not flushed), every plan's time, and SDPA's on
the same q, k, v. Then K3's entry point (``latteclip_flash_bwd``)
runs under every backward form it takes (the row kernel in padded rows, at
several warp counts, where the row fits a CTA; at head_dim 64 the streamed
pair on the plan's grid and on one CTA an SM; the tiled pair), each checked
against the plain backward (dq, dk, dv as ``chip_smoke.py`` holds them),
with one ``bwd`` JSON line a shape: the plan that
``attention.bwd_long_row_plan`` picks, every form's time, the device time
of each kernel the plan's form launches (a torch.profiler trace, L2 not
flushed), and SDPA's backward alone. It answers how the plans' rules were chosen; the kernels
and their wrappers never read it.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import re

import torch
import torch.nn.functional as F

from latteclip_torch.kernels import attention as A
from latteclip_torch.tools.perf_lab import Timer

SHAPES = ((64, 197, 12, 64), (256, 197, 12, 64), (64, 197, 6, 128), (8, 577, 16, 64),
          (256, 257, 16, 64), (64, 256, 8, 64), (16, 1024, 12, 64))
BWD_SHAPES = ((64, 197, 12, 64), (512, 197, 12, 64), (64, 197, 6, 128), (8, 577, 16, 64),
              (64, 257, 16, 64), (512, 257, 16, 64), (64, 256, 8, 64), (16, 1024, 12, 64))
OUT_TOL, OUT_REL_TOL, LSE_TOL = 2e-2, 1e-2, 1e-3
GRAD_REL_TOL, GRAD_MAX_TOL = 1e-2, 2e-2


def agrees(out, lse2, ref_out, ref_lse2, lse_tol: float = LSE_TOL) -> bool:
    d, r = out.float() - ref_out.float(), ref_out.float()
    return (bool((d.abs() <= OUT_TOL + OUT_TOL * r.abs()).all())
            and float(d.norm() / r.norm()) <= OUT_REL_TOL
            and float((lse2 - ref_lse2).abs().max()) <= lse_tol)


def grads_agree(dqkv, ref, H, D) -> bool:
    """dq, dk and dv each within chip_smoke.py's bounds of the plain backward."""
    for i in range(3):
        a = dqkv[..., i * H * D:(i + 1) * H * D].float()
        r = ref[..., i * H * D:(i + 1) * H * D].float()
        if (float((a - r).norm() / r.norm()) > GRAD_REL_TOL
                or float((a - r).abs().max() / r.abs().max()) > GRAD_MAX_TOL):
            return False
    return True


def kernel_split_ms(call, calls: int = 10) -> dict:
    """Device ms a call of each kernel that ``call`` launches, from a
    torch.profiler trace of ``calls`` calls after one untraced call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ms = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = re.search(r"(flash_(?:fwd|bwd)_\w+?)_kernel", ev.name)
            key = name.group(1) if name else ev.name[:40]
            ms[key] = ms.get(key, 0.0) + ev.time_range.elapsed_us() / 1e3 / calls
    return ms


def _qkv(B, L, H, D, gen):
    std = torch.tensor([0.3, 0.3, 1.0], device="cuda").repeat_interleave(H * D)
    return (torch.randn((B, L, 3 * H * D), generator=gen, device="cuda") * std).to(torch.bfloat16)


def plan_label(plan) -> str:
    """A forward plan's name in the sweep's lines."""
    if plan.form == "row_ring":
        return f"row_ring g{plan.grid} st{plan.stages}"
    if plan.form == "stream_ring":
        return f"stream_ring c{plan.chunk} g{plan.grid} st{plan.stages}"
    return f"{plan.form} w{plan.warps} s{plan.splits}"


def fwd_plans(B, L, H, D, warps_grid, splits_grid, sms) -> dict:
    """{label: the entry point's plan integers} of every forward plan swept
    at one shape (non-causal, no segment ids)."""
    plans = {}
    nblk = -(-L // 16)
    for warps, splits, resident in itertools.product(warps_grid, splits_grid, (True, False)):
        if warps <= nblk // splits and A.long_row_smem_bytes(L, D, warps, False, resident) <= A.MAX_SMEM:
            form = "resident" if resident else "streamed"
            plans[f"{form} w{warps} s{splits}"] = (warps, splits, A.FWD_FORMS[form])
    if D != 64:
        return plans
    rings = []
    if A.row_ring_keys(L):
        base = A.row_ring_plan(B, L, H, sms)
        rings += [dataclasses.replace(base, grid=g, stages=st)
                  for g in sorted({base.grid, max(1, base.grid // 2)}) for st in range(1, base.stages + 1)]
    for chunk in A.STREAM_RING_CHUNKS:
        base = A.stream_ring_plan(B, L, H, False, sms, chunk)
        rings += [dataclasses.replace(base, grid=g, stages=st)
                  for g in sorted({base.grid, max(1, base.grid // 2)}) for st in sorted({1, 2, base.stages})]
    return {**plans, **{plan_label(p): p.c_args() for p in rings}}


def sweep(B, L, H, D, warps_grid, splits_grid, timer, gen) -> dict:
    qkv = _qkv(B, L, H, D, gen)
    out = torch.empty(B, L, H * D, device="cuda", dtype=torch.bfloat16)
    lse2 = torch.empty(B, H, L, device="cuda")
    ref_out, ref_lse2 = A.flash_fwd_plain(qkv, H, False)
    kernel = A._kernel("latteclip_flash_fwd")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times, calls = {}, {}
    for label, args in fwd_plans(B, L, H, D, warps_grid, splits_grid, sms).items():
        calls[label] = call = lambda args=args: kernel(  # noqa: E731
            qkv.data_ptr(), out.data_ptr(), lse2.data_ptr(), B, L, H, D, 0, (D ** -0.5) * A.LOG2E, *args, stream)
        if call():
            raise RuntimeError(f"plan {label} refused at {[B, L, H, D]}")
        torch.cuda.synchronize()
        if not agrees(out, lse2, ref_out, ref_lse2):
            raise RuntimeError(f"plan {label} disagrees at {[B, L, H, D]}")
        times[label] = timer(call)
    own = plan_label(A.long_row_plan(B, L, H, D, False, sms))
    q, k, v = qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
    return {"shape": [B, L, H, D], "plan": own, "plan_ms": times.get(own),
            "plan_kernel_ms": kernel_split_ms(calls[own]) if own in calls else None,
            "best": min(times, key=times.get), "best_ms": min(times.values()),
            "sdpa_ms": timer(lambda: F.scaled_dot_product_attention(q, k, v)), "ms": times}


def sweep_bwd(B, L, H, D, timer, gen) -> dict:
    """Every backward form the entry point takes at one non-causal shape."""
    qkv = _qkv(B, L, H, D, gen)
    dout = torch.randn((B, L, H * D), generator=gen, device="cuda").to(torch.bfloat16)
    out, lse2 = A.flash_attention_qkv(qkv, H)
    ref = A.flash_bwd_plain(qkv, out, dout, lse2, H, False)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty(B, H, L, device="cuda")
    kernel = A._kernel("latteclip_flash_bwd")
    stream = torch.cuda.current_stream().cuda_stream
    nblk = -(-L // 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (label, the entry point's warps and resident)
    forms = [("tiled w4", 4, A.BWD_FORMS["tiled"])]
    if A.bwd_row_smem_bytes(L, D, False) <= A.MAX_SMEM:
        forms += [(f"resident w{w}", w, A.BWD_FORMS["resident"]) for w in (4, 8) if w <= nblk]
    if D == 64:
        grid = A.bwd_stream_plan(B, L, H, False, sms).grid
        forms += [(f"streamed g{g}", g, A.BWD_FORMS["streamed"]) for g in sorted({grid, min(grid, sms)})]

    def entry(warps, resident):
        return lambda: kernel(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse2.data_ptr(),
                              delta.data_ptr(), dqkv.data_ptr(), B, L, H, D, 0,
                              (D ** -0.5) * A.LOG2E, D ** -0.5, warps, resident, stream)

    times, calls = {}, {}
    for label, warps, resident in forms:
        calls[label] = call = entry(warps, resident)
        if call():
            raise RuntimeError(f"backward form {label} refused at {[B, L, H, D]}")
        torch.cuda.synchronize()
        if not grads_agree(dqkv, ref, H, D):
            raise RuntimeError(f"backward form {label} disagrees at {[B, L, H, D]}")
        times[label] = timer(call)
    plan = A.bwd_long_row_plan(B, L, H, D, False, sms)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4)]
    o = F.scaled_dot_product_attention(*leaves)
    do4 = dout.view(B, L, H, D).transpose(1, 2)
    sdpa = timer(lambda: torch.autograd.grad(o, leaves, do4, retain_graph=True))
    own = f"streamed g{plan.grid}" if plan.form == "streamed" else f"{plan.form} w{plan.warps}"
    return {"bwd": [B, L, H, D], "plan": own, "plan_ms": times.get(own),
            "plan_kernel_ms": kernel_split_ms(calls[own]) if own in calls else None,
            "best": min(times, key=times.get), "best_ms": min(times.values()),
            "sdpa_bwd_ms": sdpa, "ms": times}


def run(shapes=SHAPES, warps_grid=(4, 5, 7, 8, 10, 13, 16), splits_grid=(1, 2, 3), iters=20,
        bwd_shapes=BWD_SHAPES):
    if not torch.cuda.is_available():
        raise RuntimeError("the long-row kernel runs on a CUDA device only")
    timer = Timer("cuda", iters=iters)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return ([sweep(*shape, warps_grid, splits_grid, timer, gen) for shape in shapes]
            + [sweep_bwd(*shape, timer, gen) for shape in bwd_shapes])


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
