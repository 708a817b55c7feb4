"""Time the short-row attention kernels (rows of at most 128 tokens) under
launch plans other than their own, on the card:

    python -m latteclip_torch.tools.short_row_plans

For each shape (the train step's, serving's, the classifier build's and
FLYP's templates'), the forward entry point (``latteclip_flash_fwd``, or
``latteclip_flash_fwd_seg`` where the shape has segment ids) runs under the
one-CTA-per-(row, head) form, under the warpgroup ring at every stage count
that fits, one to four CTAs an SM (one or two where a CTA has two
warpgroups), and under the warp ring (head_dim 64, 65..96 tokens) at every
CTA count an SM and stage count that fits, each checked against the plain
version (out and lse2, as ``chip_smoke.py`` holds them; causal lse2 to one
flip of a bf16 p, ``ONE_P_FLIP_LSE``), every warp-ring form also against the
one-CTA form's bits, and timed with CUDA events, L2 flushed, median of
``--iters``; then the backward entry point the same way (its one-CTA form
with the delta pre-pass; its warp ring at head_dim 64 at any length),
checked on dq, dk and dv. One JSON line a shape and
direction: the plan that ``attention.short_row_plan`` (or
``bwd_short_row_plan``) picks, its time, every form's time, and SDPA's
(forward, or backward alone) on the same q, k, v and mask. It answers how
the plans' rules were chosen; the kernels and their wrappers never read it.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from latteclip_torch.kernels import attention as A
from latteclip_torch.tools.long_row_plans import LSE_TOL, _qkv, agrees, grads_agree
from latteclip_torch.tools.perf_lab import Timer

# lse2 of causal rows near their start, which see few keys: one flip of a
# bf16 p (2^-8 of p), which the f32 summation order of the scores can cause,
# moves it by up to 2^-8 / (l ln 2), l >= 1 (tests/test_torch_kernels_gpu.py
# holds causal lse2 to the same bound); every warp-ring form is held besides
# to the one-CTA form's bits, whose products and sums it repeats in order
ONE_P_FLIP_LSE = 2 ** -8 / math.log(2)

# (B, L, H, D, causal, segments): "pairs" = two 50-token images a row,
# "packed" = runs of 6..40 tokens and a padding tail (at least 6 keys with p
# near 1 a row keep one flip of a bf16 p within lse2's 1e-3, as
# tests/test_torch_kernels_gpu.py::_long_segments sets out), None = whole rows
SHAPES = (
    (256, 100, 12, 64, False, "pairs"),   # ViT-B/32 train step, vision pairs
    (128, 100, 12, 64, False, "pairs"),   # ViT-B/32 eval, vision pairs
    (255, 50, 12, 64, False, None),       # ViT-B/32 odd eval batch
    (1000, 77, 8, 64, True, None),        # classifier build
    (1024, 77, 8, 64, True, None),        # padded captions
    (336, 128, 8, 64, True, "packed"),    # packed captions
    (8, 128, 8, 64, True, "packed"),      # packed templates
    (64, 100, 6, 128, False, "pairs"),    # head_dim 128
    (512, 80, 8, 64, False, None),        # the band's edges, 80 and 96 tokens
    (512, 96, 8, 64, False, None),
    (1000, 77, 10, 64, True, None),       # 640-wide text, classifier build
    (47, 77, 8, 64, True, None),          # FLYP's and the padded step's templates
    (64, 128, 8, 64, True, "packed"),     # few items a SM beyond 64 tokens
)


def segments(kind, B, L, rng) -> np.ndarray:
    if kind == "pairs":
        return np.tile(np.repeat(np.array([1, 2], np.int32), L // 2), (B, 1))
    seg = np.zeros((B, L), np.int32)
    for r in range(B):
        pos, sid = 0, 1
        while True:
            n = int(rng.integers(6, 41))
            if pos + n > L - 4:
                break
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


def forms(plan_of, B, L, H, D, segmented, sms, bwd):
    """{label: the entry point's plan integers} of every form the entry
    point takes here, and the label of the plan's own."""
    smem = A.bwd_short_row_smem_bytes if bwd else A.short_row_smem_bytes
    out = {"cta": A.CTA_PLAN.c_args(bwd)}

    def add(form, ctas, stages, smem_bytes, wg=0):
        budget = min(A.MAX_SMEM, A.SM_SMEM // ctas - A.CTA_RESERVED_SMEM)
        if smem_bytes <= budget:
            plan = A.ShortRowPlan(form, wg, ctas, stages, min(B * H, sms * ctas), smem_bytes)
            out[f"{form} c{ctas} s{stages}"] = plan.c_args(bwd)

    for ctas in ((1, 2, 3, 4) if A.ring_warpgroups(L) == 1 else (1, 2)):
        for stages in range(1, A.RING_MAX_STAGES + 1):
            add("ring", ctas, stages, smem(L, D, stages, segmented), A.ring_warpgroups(L))
    if D == 64 and (bwd or A.WARP_RING_MIN <= L <= A.WARP_RING_MAX):
        wr_smem = A.bwd_warp_ring_smem_bytes if bwd else A.warp_ring_smem_bytes
        for ctas in (1, 2, 3, 4):
            for stages in range(1, A.RING_MAX_STAGES + 1):
                add("warp_ring", ctas, stages, wr_smem(L, stages, segmented))
    plan = plan_of(B, L, H, D, segmented, sms)
    own = "cta" if plan.form == "cta" else f"{plan.form} c{plan.ctas_per_sm} s{plan.stages}"
    return out, own


def _mask(seg, causal, L):
    if seg is None:
        return None
    visible = seg[:, :, None] == seg[:, None, :]
    if causal:
        idx = torch.arange(L, device="cuda")
        visible = visible & (idx[None, :] <= idx[:, None])
    return visible[:, None]


def sweep(B, L, H, D, causal, kind, timer, gen, rng, sms) -> list:
    qkv = _qkv(B, L, H, D, gen)
    seg = None if kind is None else torch.from_numpy(segments(kind, B, L, rng)).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    c = int(causal)
    qscale = (D ** -0.5) * A.LOG2E
    shape = {"shape": [B, L, H, D], "causal": causal, "segments": kind}
    q, k, v = qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
    mask = _mask(seg, causal, L)
    sdpa = dict(attn_mask=mask, is_causal=causal and mask is None)

    # forward
    out = torch.empty(B, L, H * D, device="cuda", dtype=torch.bfloat16)
    lse2 = torch.empty(B, H, L, device="cuda")
    if seg is None:
        ref_out, ref_lse2 = A.flash_fwd_plain(qkv, H, causal)
        kernel = A._kernel("latteclip_flash_fwd")
        fwd = lambda args: kernel(qkv.data_ptr(), out.data_ptr(), lse2.data_ptr(), B, L, H, D, c,  # noqa: E731
                                  qscale, *args, stream)
    else:
        ref_out, ref_lse2 = A.flash_fwd_seg_plain(qkv, seg, H, causal)
        kernel = A._kernel("latteclip_flash_fwd_seg")
        fwd = lambda args: kernel(qkv.data_ptr(), seg.data_ptr(), out.data_ptr(), lse2.data_ptr(),  # noqa: E731
                                  B, L, H, D, c, qscale, *args, stream)
    plans, own = forms(A.short_row_plan, B, L, H, D, seg is not None, sms, False)
    times, cta = {}, None
    for label, args in plans.items():
        if fwd(args):
            raise RuntimeError(f"forward form {label} refused at {shape}")
        torch.cuda.synchronize()
        if not agrees(out, lse2, ref_out, ref_lse2, ONE_P_FLIP_LSE if causal else LSE_TOL):
            raise RuntimeError(f"forward form {label} disagrees at {shape}")
        if label == "cta":
            cta = out.clone(), lse2.clone()
        elif label.startswith("warp_ring") and not (torch.equal(out, cta[0]) and torch.equal(lse2, cta[1])):
            raise RuntimeError(f"forward form {label} differs from the one-CTA form's bits at {shape}")
        times[label] = timer(lambda: fwd(args))
    records = [{**shape, "plan": own, "plan_ms": times[own], "best": min(times, key=times.get),
                "best_ms": min(times.values()),
                "sdpa_ms": timer(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa)), "ms": times}]

    # backward, from the forward's residuals and an N(0, 1) cotangent
    out, lse2 = (A.flash_attention_qkv(qkv, H, causal) if seg is None
                 else A.flash_attention_qkv_segmented(qkv, H, seg, causal))
    dout = torch.randn((B, L, H * D), generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty(B, H, L, device="cuda")
    if seg is None:
        ref = A.flash_bwd_plain(qkv, out, dout, lse2, H, causal)
        kernel = A._kernel("latteclip_flash_bwd")
        bwd = lambda args: kernel(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse2.data_ptr(),  # noqa: E731
                                  delta.data_ptr(), dqkv.data_ptr(), B, L, H, D, c, qscale,
                                  D ** -0.5, *args, stream)
    else:
        ref = A.flash_bwd_seg_plain(qkv, seg, out, dout, lse2, H, causal)
        kernel = A._kernel("latteclip_flash_bwd_seg")
        bwd = lambda args: kernel(qkv.data_ptr(), seg.data_ptr(), out.data_ptr(), dout.data_ptr(),  # noqa: E731
                                  lse2.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), B, L, H, D,
                                  c, qscale, D ** -0.5, *args, stream)
    plans, own = forms(A.bwd_short_row_plan, B, L, H, D, seg is not None, sms, True)
    times = {}
    for label, args in plans.items():
        if bwd(args):
            raise RuntimeError(f"backward form {label} refused at {shape}")
        torch.cuda.synchronize()
        if not grads_agree(dqkv, ref, H, D):
            raise RuntimeError(f"backward form {label} disagrees at {shape}")
        if label == "cta":
            cta = dqkv.clone()
        elif label.startswith("warp_ring") and not torch.equal(dqkv, cta):
            raise RuntimeError(f"backward form {label} differs from the one-CTA form's bits at {shape}")
        times[label] = timer(lambda: bwd(args))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, **sdpa)
    do4 = dout.view(B, L, H, D).transpose(1, 2)
    sdpa_bwd = timer(lambda: torch.autograd.grad(o, leaves, do4, retain_graph=True))
    records.append({"bwd": [B, L, H, D], "causal": causal, "segments": kind, "plan": own,
                    "plan_ms": times[own], "best": min(times, key=times.get),
                    "best_ms": min(times.values()), "sdpa_bwd_ms": sdpa_bwd, "ms": times})
    return records


def run(shapes=SHAPES, iters=20):
    if not torch.cuda.is_available():
        raise RuntimeError("the short-row kernels run on a CUDA device only")
    timer = Timer("cuda", iters=iters)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in shapes:
        yield from sweep(*shape, timer, gen, rng, sms)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    for rec in run(iters=args.iters):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
