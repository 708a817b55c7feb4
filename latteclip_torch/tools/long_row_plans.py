"""Time the long-row attention kernels (rows of more than 128 tokens) under
launch plans other than their own, on the card:

    python -m latteclip_torch.tools.long_row_plans

For each shape, K1's entry point (``latteclip_flash_fwd``) runs non-causal
under every plan of ``--warps`` x ``--splits`` x form (resident, streamed)
that the kernel takes, each checked against the plain version (out and
lse2, as ``chip_smoke.py`` holds them) and timed with CUDA events, L2
flushed, median of ``--iters``. Prints one JSON line a shape: the plan that
``attention.long_row_plan`` picks, its time, and every plan's time, and
SDPA's on the same q, k, v. Then K3's entry point (``latteclip_flash_bwd``)
runs under every backward form it takes (the row kernel in padded rows or,
at head_dim 64, in unpadded swizzled rows two CTAs an SM, at several warp
counts; the tiled pair), each checked against the plain backward (dq, dk,
dv as ``chip_smoke.py`` holds them), with one ``bwd`` JSON line a shape:
the plan that ``attention.bwd_long_row_plan`` picks, every form's time, and
SDPA's backward alone. It answers how the plans' rules were chosen; the
kernels and their wrappers never read it.
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
BWD_SHAPES = ((64, 197, 12, 64), (512, 197, 12, 64), (64, 197, 6, 128), (8, 577, 16, 64))
OUT_TOL, OUT_REL_TOL, LSE_TOL = 2e-2, 1e-2, 1e-3
GRAD_REL_TOL, GRAD_MAX_TOL = 1e-2, 2e-2


def agrees(out, lse2, ref_out, ref_lse2) -> bool:
    d, r = out.float() - ref_out.float(), ref_out.float()
    return (bool((d.abs() <= OUT_TOL + OUT_TOL * r.abs()).all())
            and float(d.norm() / r.norm()) <= OUT_REL_TOL
            and float((lse2 - ref_lse2).abs().max()) <= LSE_TOL)


def grads_agree(dqkv, ref, H, D) -> bool:
    """dq, dk and dv each within chip_smoke.py's bounds of the plain backward."""
    for i in range(3):
        a = dqkv[..., i * H * D:(i + 1) * H * D].float()
        r = ref[..., i * H * D:(i + 1) * H * D].float()
        if (float((a - r).norm() / r.norm()) > GRAD_REL_TOL
                or float((a - r).abs().max() / r.abs().max()) > GRAD_MAX_TOL):
            return False
    return True


def _qkv(B, L, H, D, gen):
    std = torch.tensor([0.3, 0.3, 1.0], device="cuda").repeat_interleave(H * D)
    return (torch.randn((B, L, 3 * H * D), generator=gen, device="cuda") * std).to(torch.bfloat16)


def sweep(B, L, H, D, warps_grid, splits_grid, timer, gen) -> dict:
    qkv = _qkv(B, L, H, D, gen)
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
    forms = [("tiled", 4)]
    if A.bwd_row_smem_bytes(L, D, False) <= A.MAX_SMEM:
        forms += [("resident", w) for w in (4, 8) if w <= nblk]
    if D == 64 and A.bwd_row_smem_bytes(L, D, False, padded=False) <= A.BWD_PAIR_SMEM:
        forms += [("resident_pair", w) for w in (5, 7, 8) if w <= nblk]
    times = {}
    for form, warps in forms:
        call = lambda: kernel(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse2.data_ptr(),  # noqa: E731
                              delta.data_ptr(), dqkv.data_ptr(), B, L, H, D, 0,
                              (D ** -0.5) * A.LOG2E, D ** -0.5, warps, A.BWD_FORMS[form], stream)
        if call():
            raise RuntimeError(f"backward form {form, warps} refused at {[B, L, H, D]}")
        torch.cuda.synchronize()
        if not grads_agree(dqkv, ref, H, D):
            raise RuntimeError(f"backward form {form, warps} disagrees at {[B, L, H, D]}")
        times[f"{form} w{warps}"] = timer(call)
    plan = A.bwd_long_row_plan(B, L, H, D, False, torch.cuda.get_device_properties(0).multi_processor_count)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4)]
    o = F.scaled_dot_product_attention(*leaves)
    do4 = dout.view(B, L, H, D).transpose(1, 2)
    sdpa = timer(lambda: torch.autograd.grad(o, leaves, do4, retain_graph=True))
    own = f"{plan.form} w{plan.warps}"
    return {"bwd": [B, L, H, D], "plan": own, "plan_ms": times.get(own),
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
