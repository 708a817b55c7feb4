#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (latteclip_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each raising on failure:

1. device: require CUDA; print the card, the device count and nvidia-smi's
   name and power limit;
2. build: compile every kernel source with nvcc, in parallel, and print the
   build seconds and each kernel's registers and spills (-Xptxas -v);
3. kernels: each Hopper kernel against its plain PyTorch version on the card,
   in bf16, at the shapes the serving and train paths give it, with q and k
   drawn from N(0, 0.3^2) and v (and the backward's cotangent) from
   N(0, 1). Forward: out elementwise atol = rtol = 2e-2 and
   ||out - plain|| / ||plain|| <= 1e-2, lse2 atol 1e-3. Backward, on dq, dk
   and dv each: ||d - plain|| / ||plain|| <= 1e-2 and max|d - plain| <=
   2e-2 * max|plain|. As a control, each check must reject the plain version
   run with the values of one 16-key block zeroed. Each case prints the
   kernel's time, the plain version's, a library yardstick
   (F.scaled_dot_product_attention, its forward or its backward alone, timed
   only) and the bound max(FLOP / 989e12, bytes / 3.35e12). Besides the
   serving and synthetic shapes, the cases take the train phase's own segment
   ids (packed captions and templates) and batch shapes, and K1 and K5 the
   ViT-B/16 eval's [256, 197, 12 x 3 x 64] and K3 ViT-B/16 training's
   [512, 197, 12 x 3 x 64]; forward cases of more than 128 tokens name the
   long-row kernel's form (resident or streamed), CTAs per (row, head) and
   warps a CTA, backward ones the backward plan's form (resident_pair,
   resident or tiled) and warps; cases of at most 128 tokens name the
   short-row plan's form (ring or cta) and, for the ring, its warpgroups a
   CTA, CTAs an SM, stages and grid. Then the short-row plan sweep
   (latteclip_torch.tools.short_row_plans: every form of the short-row
   forward and backward at the train, serving and classifier-build shapes,
   each checked against its plain version, with SDPA) prints one
   short_row_plan line a shape and direction. Every K3/K4 case also checks and times the tiled kernel pair
   (flash_bwd.cu built a second time with -DLATTECLIP_BWD_SHORT_ROW=0, which
   sends every row there) beside the kernel its plan runs, in the order
   kernel, tiled, tiled, kernel (`design`). The head-split forward and
   backward (K5, K6) and the block-diagonal forward (K7) take the whole-row
   cases of at most 197 (K7: 128) tokens; K6 writes its gradient in the
   layout of qkv (a tree whose K6 writes [3, B, L, H*D] gets the re-merge
   copy timed as merge_ms). The fused LayerNorm -> linear kernel (K8) takes
   the padded train step's LN -> projection pairs and the classifier
   build's, held as bf16 out is, on the bf16 copy of W that its Function
   makes once a forward (that copy's time is cast_ms); its control zeroes
   one 16-output block of W, its yardstick is the port's unfused route,
   dense(layer_norm(x)) on the f32 W, and it names its launch plan;
4. lab: the attention lab's kernels (csrc/lab.cu) against their plain
   versions at the lab tools' shapes ([512, 197, 12 x 64] for the lab
   forward, packed and BHLD, and the lab backward; [1024, 77, 8 x 64] for
   the head-summed Q K^T, natural and pret, and P V) and at one small shape
   each. Attention: q, k ~ N(0, 0.3^2), v and the cotangent ~ N(0, 1), out
   and the gradients held as above, lse (natural) atol 1e-3, control one
   16-key block of v zeroed, yardstick SDPA (forward, or backward alone).
   Products: N(0, 1) bf16, f32 out held by ||S - plain|| / ||plain|| and
   max|S - plain| / max|plain| <= 1e-4, control one 16-column block of k or
   v zeroed, yardstick torch.bmm on the same operands (Q K^T), or for P V
   torch.einsum("blm,bmhd->bld"), the one call that sums the heads, with
   torch.bmm(p, v), which keeps every head's product, timed beside it
   (bmm_ms). Then both lab tools'
   run at their default shapes (latteclip_torch.tools.attn_lab and
   .r4_transpose_probe), printing their lines, with the launch counters set
   to 0 just before and read just after: every lab kernel must have
   launched, the packed and BHLD forwards must agree bit for bit, and so
   must the natural and pret products. Every lab case names its launch
   plan (form "ring", persistent CTAs fed by TMA, with its warpgroups a CTA,
   CTAs an SM, stages (the backward's resident items) and grid; or "cta",
   one CTA per (b, h) or batch row); where the plan takes the ring, the
   one-CTA form is checked against the same plain result and timed beside
   it, in the order kernel, cta, cta, kernel (`design`);
5. slice: ViT-B/32 zero-shot classification at full width from seeded random
   weights: the 1000-class ImageNet template classifier, run_zero_shot_eval
   over four batches of 256 images and one of 255, and the prototype
   classifier from a seeded bank; the launch counters are reset just before
   and read just after, and every forward kernel of the path must have
   launched. The same requests then run with the plain attention forced;
   image features and classifier columns must agree with cosine >= 0.999 and
   prototype top-1 on >= 99% of rows. A torch.profiler trace of the
   classifier build and of the eval gives each one's device busy time and
   idle share, and its device time by kind. The classifier build then runs
   on each other route, head-split attention with the fused LayerNorm ->
   linear (K5, K8) and block-diagonal attention (K7), counted, and its
   columns must agree with the plain build's at cosine >= 0.999;
5b. slice_b16: ViT-B/16 zero-shot classification at full width and depth
   (L=197, heads 64 wide), the same requests from seeded random weights; no
   batch pair-packs at 197 tokens, so every vision layer runs K1 on the
   long-row kernel. The counters are set to 0 just before the requests and
   read just after (one flash_fwd launch a layer: the classifier build's text,
   five eval batches, the prototype batch; nothing else), and again around
   the eval alone (12 a batch). Features and classifier columns must agree
   with the plain route at cosine >= 0.999, prototype top-1 on >= 99% of
   rows; a torch.profiler trace of the eval gives its device busy ms, idle
   share and device ms by kind, printed with images/s and peak memory on one
   slice_b16 JSON line;
6. train: the LatteCLIP v2 train step at ViT-B/32 full width and depth,
   batch 512, 47 classes (DTD's count), AdamW with a constant schedule, the
   colour augment on: warm-up and 10 timed steps with the captions and
   templates packed at 128 (K2/K4 at every attention site), then warm-up and
   10 timed steps with text_packing off (K1/K3 on the text at L=77). The
   launch counters are set to 0 just before each route's timed steps and read
   just after; each route must launch exactly the kernels of its attention
   sites, once a layer and step: packed K2 = K4 = 12 + 2 x 12 a step and no
   K1/K3; padded K1 = K3 = 2 x 12 and K2 = K4 = 12 (vision pairs). Two more
   padded routes follow: padded_hs (attention="headsplit",
   ln_linear="fused"), K5 = K6 = 2 x 12, K2 = K4 = 12, K8 = 2 x 36 and no
   K1/K3/K7, and padded_bd (attention="blockdiag"), K7 = K3 = 2 x 12,
   K2 = K4 = 12 and no K1/K5/K6/K8. Every loss
   must be finite, logit_scale in [0, ln 100] and the bank rows unit-norm.
   10 steps with the plain attention forced give its rate and must launch
   nothing. From one copied state and one batch with augment off, the kernel
   and plain routes must agree, and each of padded_hs and padded_bd with the
   padded route: loss within 1e-2 relative, the flattened
   gradient with cosine >= 0.99, the updated bank row by row with cosine >=
   0.999. A torch.profiler trace of one step of each route gives its device
   busy time, idle share and device time by kind, attention forward and
   backward apart;
6b. train_b16: the same step at ViT-B/16 (L=197 vision, heads 64 wide),
   batch TRAIN_BATCH_B16, captions and templates packed at 128: warm-up and
   10 timed steps, counters set to 0 just before and read just after: no
   vision pair packs at 197 tokens, so exactly 120 flash_fwd and 120
   flash_bwd (K1/K3 at [batch, 197, 12 x 3 x 64], the backward's
   resident_pair form) and 240 flash_fwd_seg and 240 flash_bwd_seg (text), nothing
   else; losses finite, logit_scale in [0, ln 100], bank rows unit-norm; a
   profiled step; kernel and plain routes from one copied state on one
   64-image batch with augment off: loss within 1e-2 relative, gradient
   cosine >= 0.99, bank rows cosine >= 0.999; a train_b16 JSON line with
   images/s, device busy ms per step and by kind, and peak memory;
   then packed_b16_remat, the same step with both towers rematerialised,
   from fresh seed-0 weights: from one batch and one generator its first
   loss must equal the step's without remat (1e-6 relative) and the
   gradients agree at cosine >= 0.9999; its 10 counted steps must launch
   exactly what packed_b16's launched (no attention forward runs again in
   the backward) and peak below packed_b16's memory; a train_b16_remat line
   with both peaks and both device busy ms per step. Phase 6 also runs two
   more routes at ViT-B/32: packed_crop (the packed step fed 256-pixel
   canvases and crop boxes, so the on-device crop runs in the step; launches
   as packed; the crop alone timed by CUDA events, its share of the step's
   device busy time, and the kernel route against the plain route on the
   crop's images) and padded_fused_text (fuse_text_fwd: the templates and
   both caption streams in one padded forward, K1 = K3 = 12 a step, and the
   padded route's agreement bounds against padded);
7. cli: the training entry point, latteclip_torch.train.main.main, in
   process on the card at ViT-B/32, batch 512, captions packed at 128, on
   the synthetic fixture its --dataset-type synthetic writes (1024 train and
   32 val images at 224 px): (a) 2 epochs of 2 steps with an eval and a
   checkpoint each; every step must launch exactly 36 flash_fwd_seg and 36
   flash_bwd_seg, every eval 12 flash_fwd_seg (one batch of 64, in pairs),
   the bank init 12 flash_fwd; losses finite, epoch_1.pt and epoch_2.pt
   written; the traced second epoch's host-to-device copies are reported
   (pinned or pageable, overlap with kernels); (b) --resume latest for epoch 3: it must start at epoch
   2, step 4, log the schedule's LR at step 4 first, and restore the
   optimizer entry that (a) saved bit for bit; (c) --lock-image
   --accum-freq 2 --grad-clip-norm 1.0 for one epoch: 2 calls and 1
   update, every visual.* parameter bit-equal to its seed-0 start and the
   text parameters moved. A cli JSON line gives the images/s and data-wait
   share of the loop's last log line, the traced epoch's Memcpy HtoD ms,
   pinned flag and overlap with kernels, peak memory, checkpoint bytes and
   write seconds, eval top-1 and launches per step;
8. report: one JSON line of kernels, nvidia-smi's line, and the final line
   {"ok": true, "device": {...}}.

Exits non-zero without a result when CUDA is absent or the package is missing.
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
import importlib.util
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
OUT_TOL = 2e-2             # bf16 out, elementwise atol = rtol (tests/test_kernels.py)
OUT_REL_TOL = 1e-2         # ||out - plain|| / ||plain||: bf16 rounding gives < 2^-8
LSE_TOL = 1e-3             # base-2 lse (see tests/test_torch_attention.py)
GRAD_REL_TOL = 1e-2        # ||d - plain|| / ||plain|| for dq, dk, dv each
GRAD_MAX_TOL = 2e-2        # max|d - plain| / max|plain| (tests/test_torch_kernels_gpu.py)
# q and k entries ~ N(0, 0.3^2), as the JAX kernel tests draw them, so that
# rows stay flat enough for LSE_TOL; v does not enter lse2 and is N(0, 1)
QK_STD = 0.3
SOURCES = {
    "flash_fwd": "latteclip_torch/kernels/csrc/flash_fwd.cu",
    "flash_fwd_seg": "latteclip_torch/kernels/csrc/flash_fwd.cu",
    "flash_bwd": "latteclip_torch/kernels/csrc/flash_bwd.cu",
    "flash_bwd_seg": "latteclip_torch/kernels/csrc/flash_bwd.cu",
    "flash_fwd_hs": "latteclip_torch/kernels/csrc/flash_fwd.cu",
    "flash_bwd_hs": "latteclip_torch/kernels/csrc/flash_bwd.cu",
    "flash_fwd_bd": "latteclip_torch/kernels/csrc/flash_fwd.cu",
    "ln_linear": "latteclip_torch/kernels/csrc/ln_linear.cu",
    "lab_fwd": "latteclip_torch/kernels/csrc/lab.cu",
    "lab_bwd": "latteclip_torch/kernels/csrc/lab.cu",
    "lab_qk": "latteclip_torch/kernels/csrc/lab.cu",
    "lab_pv": "latteclip_torch/kernels/csrc/lab.cu",
}
REPLACES = {
    "flash_fwd": "latteclip_tpu/kernels/attention.py:318",      # _fwd_kernel
    "flash_fwd_seg": "latteclip_tpu/kernels/attention.py:415",  # _fwd_kernel_seg
    "flash_bwd": "latteclip_tpu/kernels/attention.py:340",      # _bwd_kernel
    "flash_bwd_seg": "latteclip_tpu/kernels/attention.py:435",  # _bwd_kernel_seg
    "flash_fwd_hs": "latteclip_tpu/kernels/attention.py:235",   # _fwd_kernel_hs
    "flash_bwd_hs": "latteclip_tpu/kernels/attention.py:264",   # _bwd_kernel_hs
    "flash_fwd_bd": "latteclip_tpu/kernels/attention.py:617",   # _fwd_kernel_bd
    "ln_linear": "latteclip_tpu/kernels/fused_ln_linear.py:32",  # _kernel
    "lab_fwd": "tools/attn_lab.py:37",          # _fwd_kernel_v1 (and _fwd_kernel_v3 :76)
    "lab_bwd": "tools/attn_lab.py:122",         # _bwd_kernel_v3
    "lab_qk": "tools/r4_transpose_probe.py:44",  # _kern_natural (and _kern_pret :54)
    "lab_pv": "tools/r4_transpose_probe.py:63",  # _kern_pv
}
LOG100 = 4.6051702  # ln(100), the logit-scale clamp
ROW_MAX = 128        # flash_bwd.cu: longest row of the one-CTA-per-(row, head) kernel
TRAIN_BATCH, PACK_LEN, TRAIN_STEPS = 512, 128, 10
TRAIN_BATCH_B16, AGREE_BATCH_B16 = 512, 64  # ViT-B/16 train batch; its agreement batch
CANVAS = 256         # the pipeline's on-device crop canvas (PipelineConfig.canvas_size)
EVAL_BATCH = 256     # the serving phases' eval batch (four of 256 and one of 255)
# the lab tools' shapes (B, L, H, D) and one small shape of each
LAB_ATTN, LAB_ATTN_SMALL = (512, 197, 12, 64), (4, 50, 2, 64)
LAB_PRODUCTS, LAB_PRODUCTS_SMALL = (1024, 77, 8, 64), (4, 77, 2, 64)
# head-summed products, f32 out: ||S - plain|| / ||plain|| and max|S - plain| /
# max|plain|; both sides multiply the same bf16 operands exactly in f32 and
# differ only in the order of the f32 sums (~1e-7)
F32_REL_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions -----------------------------

def random_segments(rng: np.random.Generator, rows: int, length: int) -> np.ndarray:
    """Packed-text seg ids: runs of 5..40 tokens numbered 1, 2, ..., then a
    seg-0 padding tail."""
    seg = np.zeros((rows, length), np.int32)
    for r in range(rows):
        pos, sid = 0, 1
        while True:
            n = int(rng.integers(5, 41))
            if pos + n > length - 4:
                break
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


def draw_qkv(gen, B, L, H, D) -> torch.Tensor:
    std = torch.tensor([QK_STD, QK_STD, 1.0], device="cuda").repeat_interleave(H * D)
    return (torch.randn((B, L, 3 * H * D), generator=gen, device="cuda") * std).to(torch.bfloat16)


def out_check(out, ref):
    """(agrees, ||out - ref|| / ||ref||) for two bf16 attention outputs."""
    d, r = out.float() - ref.float(), ref.float()
    rel = float(d.norm() / r.norm())
    return bool((d.abs() <= OUT_TOL + OUT_TOL * r.abs()).all()) and rel <= OUT_REL_TOL, rel


def visibility(B, L, causal, seg):
    """(visible (query, key) pairs over the batch, SDPA mask or None)."""
    idx = torch.arange(L, device="cuda")
    if seg is None:
        visible = (idx[None, :] <= idx[:, None]) if causal else torch.ones(L, L, dtype=torch.bool, device="cuda")
        return int(visible.sum()) * B, None
    visible = seg[:, :, None] == seg[:, None, :]
    if causal:
        visible = visible & (idx[None, :] <= idx[:, None])
    return int(visible.sum()), visible[:, None]


def bound(flops, nbytes):
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_flops, t_bytes), "operations" if t_flops > t_bytes else "bytes"


def long_row_fields(B, L, H, D, segmented) -> dict:
    """The form ("resident" or "streamed"), CTAs per (row, head) and warps a
    CTA of a row of more than 128 tokens on this card, from the wrappers'
    launch plan; nothing for shorter rows, or for a tree whose forward has
    no long-row plan (so that this script also measures such a tree)."""
    from latteclip_torch.kernels import attention as A

    plan_of = getattr(A, "long_row_plan", None)
    if L <= ROW_MAX or plan_of is None:
        return {}
    plan = plan_of(B, L, H, D, segmented, torch.cuda.get_device_properties(0).multi_processor_count)
    return {"form": plan.form, "ctas_per_bh": plan.splits, "warps": plan.warps}


def short_row_fields(B, L, H, D, segmented, bwd=False, blockdiag=False) -> dict:
    """The short-row plan of a row of at most 128 tokens on this card: its
    form ("ring" or "cta"), and for the ring its consumer warpgroups a CTA,
    CTAs an SM, stages and grid (the block-diagonal forward always takes
    "cta"); nothing for longer rows, or for a tree without short-row plans
    (so that this script also measures such a tree)."""
    from latteclip_torch.kernels import attention as A

    plan_of = getattr(A, "bwd_short_row_plan" if bwd else "short_row_plan", None)
    if L > ROW_MAX or plan_of is None:
        return {}
    if blockdiag:
        return {"form": "cta"}
    p = plan_of(B, L, H, D, segmented, torch.cuda.get_device_properties(0).multi_processor_count)
    return {"form": p.form, **({"warpgroups": p.warpgroups, "ctas_per_sm": p.ctas_per_sm,
                               "stages": p.stages, "grid": p.grid} if p.form == "ring" else {})}


def bwd_plan_fields(B, L, H, D, segmented) -> dict:
    """The backward plan's form ("resident_pair", "resident" or "tiled") and
    warps a CTA of a row of more than 128 tokens on this card; nothing for
    shorter rows, or for a tree whose backward has no plan."""
    from latteclip_torch.kernels import attention as A

    plan_of = getattr(A, "bwd_long_row_plan", None)
    if L <= ROW_MAX or plan_of is None:
        return {}
    plan = plan_of(B, L, H, D, segmented, torch.cuda.get_device_properties(0).multi_processor_count)
    return {"form": plan.form, "warps": plan.warps}


def kernel_case(name, B, L, H, D, causal, seg_np, timer, gen):
    from latteclip_torch.kernels import attention as A

    qkv = draw_qkv(gen, B, L, H, D)
    seg = None if seg_np is None else torch.from_numpy(seg_np).cuda()
    if seg is None:
        wrapper, plain_fn = {
            "flash_fwd": (A.flash_attention_qkv, A.flash_fwd_plain),
            "flash_fwd_hs": (A.flash_attention_qkv_hs, A.flash_fwd_hs_plain),
            "flash_fwd_bd": (A.flash_attention_qkv_bd, A.flash_fwd_bd_plain),
        }[name]
        kernel = lambda: wrapper(qkv, H, causal)  # noqa: E731
        plain_of = lambda x: plain_fn(x, H, causal)  # noqa: E731
    else:
        kernel = lambda: A.flash_attention_qkv_segmented(qkv, H, seg, causal)  # noqa: E731
        plain_of = lambda x: A.flash_fwd_seg_plain(x, seg, H, causal)  # noqa: E731
    pairs, mask = visibility(B, L, causal, seg)
    plain = lambda: plain_of(qkv)  # noqa: E731
    out, lse2 = kernel()
    ref_out, ref_lse2 = plain()
    torch.cuda.synchronize()
    err_out = float((out.float() - ref_out.float()).abs().max())
    err_lse = float((lse2 - ref_lse2).abs().max())
    out_ok, rel_out = out_check(out, ref_out)
    ok = out_ok and err_lse <= LSE_TOL
    if not (torch.isfinite(out.float()).all() and torch.isfinite(lse2).all()):
        ok = False
    # control: the out check must see the values of one 16-key block dropped
    dropped = qkv.clone()
    dropped[:, L // 2:L // 2 + 16, 2 * H * D:] = 0
    control_ok, rel_dropped = out_check(plain_of(dropped)[0], ref_out)
    control_rejected = not control_ok

    q, k, v = qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, is_causal=causal and mask is None)
    ms, plain_ms, library_ms = timer(kernel), timer(plain), timer(library)
    flops = 4 * D * H * pairs
    nbytes = qkv.numel() * 2 + out.numel() * 2 + lse2.numel() * 4 + (0 if seg is None else seg.numel() * 4)
    bound_ms, bound_by = bound(flops, nbytes)
    rec = {
        "name": name, "shape": [B, L, 3 * H * D], "heads": H, "head_dim": D, "causal": causal,
        "max_abs_err": err_out, "out_rel_err": rel_out, "max_abs_err_lse2": err_lse, "ok": ok,
        "control_rel_err": rel_dropped, "control_rejected": control_rejected,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        **long_row_fields(B, L, H, D, seg is not None),
        **short_row_fields(B, L, H, D, seg is not None, blockdiag=name == "flash_fwd_bd"),
    }
    rec["bound_share"] = rec["bound_ms"] / ms
    log("kernel_case " + json.dumps(rec))
    return rec


def grad_check(ours, ref, H, D):
    """(agrees, {dq|dk|dv: [||d - ref|| / ||ref||, max|d - ref| / max|ref|]})."""
    errs, ok = {}, True
    for i, part in enumerate(("dq", "dk", "dv")):
        a = ours[..., i * H * D:(i + 1) * H * D].float()
        r = ref[..., i * H * D:(i + 1) * H * D].float()
        rel = float((a - r).norm() / r.norm())
        worst = float((a - r).abs().max() / r.abs().max())
        errs[part] = [rel, worst]
        ok = ok and rel <= GRAD_REL_TOL and worst <= GRAD_MAX_TOL
    return ok, errs


def tiled_bwd(lib, qkv, seg, out, dout, lse2, H, causal):
    """dqkv from the tiled-only build of flash_bwd.cu, called as the wrapper
    calls the kernel (with an empty plan where the entry point takes one:
    that build ignores it). Not counted: it is no part of any path."""
    from latteclip_torch.kernels import attention as A

    B, L, _ = qkv.shape
    D = qkv.shape[-1] // (3 * H)
    name = "latteclip_flash_bwd" if seg is None else "latteclip_flash_bwd_seg"
    fn = getattr(lib, name)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fn.argtypes, fn.restype = [kinds[c] for c in A._SIGNATURES[name]], ctypes.c_int
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B, H, L), dtype=torch.float32, device="cuda")
    tensors = [qkv, *([] if seg is None else [seg]), out, dout, lse2, delta, dqkv]
    plan = (0, 0) if A._SIGNATURES[name].endswith("iip") else ()
    err = fn(*(t.data_ptr() for t in tensors), B, L, H, D, int(causal), (D ** -0.5) * A.LOG2E,
             D ** -0.5, *plan, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tiled {name} launch failed with CUDA error {err}")
    return dqkv


def bwd_case(name, B, L, H, D, causal, seg_np, timer, gen, tiled_lib):
    """A backward kernel against its plain version, from the forward
    kernel's residuals and an N(0, 1) cotangent; for K3 and K4 also the
    tiled pair against the same plain result, timed beside the kernel."""
    from latteclip_torch.kernels import attention as A

    qkv = draw_qkv(gen, B, L, H, D)
    dout = torch.randn((B, L, H * D), generator=gen, device="cuda").to(torch.bfloat16)
    seg = None if seg_np is None else torch.from_numpy(seg_np).cuda()
    # the gradient in the layout of qkv: a tree whose K6 (and its plain
    # version) give dqkv3 [3, B, L, H*D] gets it re-merged for the checks
    as_qkv = lambda d: d if d.shape == qkv.shape else A.merge_dqkv(d)  # noqa: E731
    if name == "flash_bwd_hs":
        out, lse2 = A.flash_attention_qkv_hs(qkv, H, causal)
        kernel = lambda: A.flash_attention_qkv_hs_bwd(qkv, out, dout, lse2, H, causal)  # noqa: E731
        plain_of = lambda x: A.flash_bwd_hs_plain(x, out, dout, lse2, H, causal)  # noqa: E731
    elif seg is None:
        out, lse2 = A.flash_attention_qkv(qkv, H, causal)
        kernel = lambda: A.flash_attention_qkv_bwd(qkv, out, dout, lse2, H, causal)  # noqa: E731
        plain_of = lambda x: A.flash_bwd_plain(x, out, dout, lse2, H, causal)  # noqa: E731
    else:
        out, lse2 = A.flash_attention_qkv_segmented(qkv, H, seg, causal)
        kernel = lambda: A.flash_attention_qkv_segmented_bwd(  # noqa: E731
            qkv, seg, out, dout, lse2, H, causal)
        plain_of = lambda x: A.flash_bwd_seg_plain(x, seg, out, dout, lse2, H, causal)  # noqa: E731
    pairs, mask = visibility(B, L, causal, seg)
    plain = lambda: plain_of(qkv)  # noqa: E731
    ours3, ref3 = kernel(), plain()
    ours, ref = as_qkv(ours3), as_qkv(ref3)
    torch.cuda.synchronize()
    ok, errs = grad_check(ours, ref, H, D)
    ok = ok and bool(torch.isfinite(ours.float()).all())
    # control: the check must see the values of one 16-key block dropped
    dropped = qkv.clone()
    dropped[:, L // 2:L // 2 + 16, 2 * H * D:] = 0
    control_ok, control_errs = grad_check(as_qkv(plain_of(dropped)), ref, H, D)

    # library yardstick: SDPA's backward alone, same mask, timed only
    q, k, v = (t.detach().clone().requires_grad_(True)
               for t in qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=causal and mask is None)
    do4 = dout.view(B, L, H, D).transpose(1, 2)
    library = lambda: torch.autograd.grad(o, (q, k, v), do4, retain_graph=True)  # noqa: E731
    ms, plain_ms, library_ms = timer(kernel), timer(plain), timer(library)
    del o, q, k, v
    design = None
    # a head-split gradient given as dqkv3 needs a re-merge copy into the layout of qkv
    merge_ms = timer(lambda: A.merge_dqkv(ours3)) if ours3.shape != qkv.shape else None
    if name in ("flash_bwd", "flash_bwd_seg"):
        tiled = lambda: tiled_bwd(tiled_lib, qkv, seg, out, dout, lse2, H, causal)  # noqa: E731
        tiled_ok, tiled_errs = grad_check(tiled(), ref, H, D)
        ok = ok and tiled_ok
        tiled_ms = [timer(tiled), timer(tiled)]
        design = {"kernel_ms": [ms, timer(kernel)], "tiled_ms": tiled_ms,
                  "tiled_grad_err": tiled_errs, "tiled_ok": tiled_ok}
    flops = 10 * D * H * pairs
    nbytes = 2 * B * L * 8 * H * D + 4 * B * H * L + (0 if seg is None else 4 * B * L)
    bound_ms, bound_by = bound(flops, nbytes)
    rec = {
        "name": name, "shape": [B, L, 3 * H * D], "heads": H, "head_dim": D, "causal": causal,
        "max_abs_err": float((ours.float() - ref.float()).abs().max()), "grad_err": errs, "ok": ok,
        "control_grad_err": control_errs, "control_rejected": not control_ok, "design": design,
        "merge_ms": merge_ms,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        **bwd_plan_fields(B, L, H, D, seg is not None),
        **short_row_fields(B, L, H, D, seg is not None, bwd=True),
    }
    rec["bound_share"] = rec["bound_ms"] / ms
    log("kernel_case " + json.dumps(rec))
    return rec


def ln_case(name, B, L, D, O, timer, gen):
    """The fused LayerNorm -> linear kernel against its plain version on
    x [B, L, D] ~ N(0, 1), W [O, D] ~ N(0, 1/D), LayerNorm scale ~ 1 +
    N(0, 0.1^2), biases ~ N(0, 0.1^2); yardstick the unfused route. The
    kernel reads the bf16 copy of W that FusedLnLinear makes once a forward
    (a tree whose kernel reads the f32 W takes that)."""
    from latteclip_torch.kernels import fused_ln_linear as FL

    x = torch.randn((B, L, D), generator=gen, device="cuda").to(torch.bfloat16)
    ln_w = 1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    ln_b, wb = (0.1 * torch.randn(n, generator=gen, device="cuda") for n in (D, O))
    w = torch.randn((O, D), generator=gen, device="cuda") * D ** -0.5
    plan_of = getattr(FL, "ln_linear_plan", None)
    w_in = w if plan_of is None else w.to(torch.bfloat16)
    kernel = lambda: FL.fused_ln_linear(x, ln_w, ln_b, w_in, wb)  # noqa: E731
    plain = lambda: FL.fused_ln_linear_plain(x, ln_w, ln_b, w, wb)  # noqa: E731
    library = lambda: FL.dense(FL.layer_norm(x, ln_w, ln_b), w, wb, torch.bfloat16)  # noqa: E731
    y, ref = kernel(), plain()
    torch.cuda.synchronize()
    ok, rel = out_check(y, ref)
    ok = ok and bool(torch.isfinite(y.float()).all())
    dropped = w.clone()  # control: one 16-output block of W zeroed
    dropped[O // 2:O // 2 + 16] = 0
    control_ok, rel_dropped = out_check(FL.fused_ln_linear_plain(x, ln_w, ln_b, dropped, wb), ref)
    ms, plain_ms, library_ms = timer(kernel), timer(plain), timer(library)
    cast_ms = None if w_in is w else timer(lambda: w.to(torch.bfloat16))
    M = B * L
    flops = 2 * M * D * O
    nbytes = M * D * 2 + O * D * w_in.element_size() + M * O * 2 + (2 * D + O) * 4
    bound_ms, bound_by = bound(flops, nbytes)
    plan = {}
    if plan_of is not None:
        p = plan_of(M, D, O, torch.cuda.get_device_properties(0).multi_processor_count)
        plan = {"plan": {"bm": p.bm, "bn": p.bn, "n_splits": p.n_splits, "stages": p.stages}}
    rec = {
        "name": "ln_linear", "site": name, "shape": [B, L, D], "outputs": O, "cast_ms": cast_ms, **plan,
        "max_abs_err": float((y.float() - ref.float()).abs().max()), "out_rel_err": rel, "ok": ok,
        "control_rel_err": rel_dropped, "control_rejected": not control_ok,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
    }
    rec["bound_share"] = rec["bound_ms"] / ms
    log("kernel_case " + json.dumps(rec))
    return rec


def phase_kernels(train, tiled_lib):
    from latteclip_torch.tools.perf_lab import Timer

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rng = np.random.default_rng(1234)
    timer = Timer("cuda")
    pair = np.repeat(np.array([1, 2], np.int32), 50)
    # the train step's own attention calls: its text and vision head counts,
    # the packed caption rows of its first batch and the packed templates
    text, vision = train["cfg"].text, train["cfg"].vision
    Ht, Dt, Hv, Dv = text.heads, text.width // text.heads, vision.heads, vision.head_width
    cap_seg = train["batches"][0]["cap_seg_ids"].cpu().numpy()
    tpl_seg = train["tpl"].seg_ids
    n_cls = len(train["classes"])
    train_pairs = np.tile(pair, (TRAIN_BATCH // 2, 1))
    train_cases = [
        ("flash_fwd", n_cls, 77, Ht, Dt, True, None),                        # templates, padded
        ("flash_fwd_seg", TRAIN_BATCH // 2, 100, Hv, Dv, False, train_pairs),  # vision pairs
        ("flash_fwd_seg", len(cap_seg), PACK_LEN, Ht, Dt, True, cap_seg),    # captions, packed
        ("flash_fwd_seg", len(tpl_seg), PACK_LEN, Ht, Dt, True, tpl_seg),    # templates, packed
    ]
    cases = [
        # (kernel, B, L, H, D, causal, seg ids or None); the first of each
        # kernel is the one the report line carries
        ("flash_fwd", 1000, 77, 8, 64, True, None),        # text classifier build
        ("flash_fwd", 255, 50, 12, 64, False, None),       # odd vision batch
        ("flash_fwd", 64, 197, 12, 64, False, None),       # ViT-B/16 vision
        ("flash_fwd", 8, 577, 16, 64, False, None),        # 336 px vision
        ("flash_fwd", 64, 197, 6, 128, False, None),       # head_dim 128
        ("flash_fwd", EVAL_BATCH, 197, 12, 64, False, None),  # the ViT-B/16 eval's batch
        ("flash_fwd_seg", 128, 100, 12, 64, False, np.tile(pair, (128, 1))),  # vision pairs
        ("flash_fwd_seg", 64, 128, 8, 64, True, random_segments(rng, 64, 128)),  # packed text
        ("flash_fwd_seg", 64, 100, 6, 128, False, np.tile(pair, (64, 1))),      # head_dim 128
    ] + train_cases
    bwd_cases = [
        ("flash_bwd", 2 * TRAIN_BATCH, 77, Ht, Dt, True, None),  # train captions, padded
        ("flash_bwd", 255, 50, 12, 64, False, None),       # odd vision batch
        ("flash_bwd", 64, 197, 12, 64, False, None),       # ViT-B/16 vision
        ("flash_bwd", 8, 577, 16, 64, False, None),        # 336 px vision
        ("flash_bwd", 64, 197, 6, 128, False, None),       # head_dim 128
        ("flash_bwd", TRAIN_BATCH_B16, 197, 12, 64, False, None),  # ViT-B/16 training's batch
    ] + [("flash_bwd" + n[len("flash_fwd"):], *rest) for n, *rest in train_cases] + [
        ("flash_bwd_seg", 64, 128, 8, 64, True, random_segments(rng, 64, 128)),  # packed text
        ("flash_bwd_seg", 64, 100, 6, 128, False, np.tile(pair, (64, 1))),      # head_dim 128
    ]
    # the head-split and block-diagonal routes at K1/K3's whole-row cases
    whole_rows = [
        (1000, 77, 8, 64, True, None),                  # text classifier build
        (2 * TRAIN_BATCH, 77, Ht, Dt, True, None),      # train captions, padded
        (n_cls, 77, Ht, Dt, True, None),                # train templates, padded
        (255, 50, 12, 64, False, None),                 # odd vision batch
        (64, 197, 12, 64, False, None),                 # ViT-B/16 vision
        (64, 197, 6, 128, False, None),                 # head_dim 128
    ]
    cases += [("flash_fwd_hs", *c) for c in whole_rows]
    cases += [("flash_fwd_hs", 8, 577, 16, 64, False, None),          # 336 px vision
              ("flash_fwd_hs", EVAL_BATCH, 197, 12, 64, False, None)]  # the ViT-B/16 eval's batch
    cases += [("flash_fwd_bd", *c) for c in whole_rows if c[1] <= ROW_MAX]
    bwd_cases += [("flash_bwd_hs", *c) for c in [whole_rows[1], whole_rows[0], *whole_rows[2:]]]
    # the padded train step's LN -> projection pairs, then the classifier build's
    mlp_v, mlp_t = int(vision.width * vision.mlp_ratio), int(text.width * text.mlp_ratio)
    ln_cases = [
        ("vision in_proj", TRAIN_BATCH // 2, 100, vision.width, 3 * vision.width),
        ("vision c_fc", TRAIN_BATCH // 2, 100, vision.width, mlp_v),
        ("captions in_proj", 2 * TRAIN_BATCH, 77, text.width, 3 * text.width),
        ("captions c_fc", 2 * TRAIN_BATCH, 77, text.width, mlp_t),
        ("templates in_proj", n_cls, 77, text.width, 3 * text.width),
        ("templates c_fc", n_cls, 77, text.width, mlp_t),
        ("classifier in_proj", 1000, 77, text.width, 3 * text.width),
        ("classifier c_fc", 1000, 77, text.width, mlp_t),
    ]
    records = [kernel_case(n, B, L, H, D, c, s, timer, gen) for n, B, L, H, D, c, s in cases]
    records += [bwd_case(n, B, L, H, D, c, s, timer, gen, tiled_lib)
                for n, B, L, H, D, c, s in bwd_cases]
    records += [ln_case(n, B, L, D, O, timer, gen) for n, B, L, D, O in ln_cases]
    del timer
    torch.cuda.empty_cache()
    bad = [(r["name"], r["shape"], r["max_abs_err"], r.get("out_rel_err"), r.get("max_abs_err_lse2"),
            r.get("grad_err"), r.get("design")) for r in records if not r["ok"]]
    if bad:
        raise RuntimeError("kernels disagree with their plain versions "
                           f"(name, shape, max |d|, rel dout, |dlse2|, grad errors): {bad}")
    blind = [(r["name"], r["shape"], r.get("control_rel_err"), r.get("control_grad_err"))
             for r in records if not r["control_rejected"]]
    if blind:
        raise RuntimeError(f"a check missed a dropped value or weight block (name, shape, errors): {blind}")
    if importlib.util.find_spec("latteclip_torch.tools.short_row_plans") is not None:
        from latteclip_torch.tools import short_row_plans

        for rec in short_row_plans.run():  # raises where a form disagrees with the plain version
            log("short_row_plan " + json.dumps(rec))
        torch.cuda.empty_cache()
    return records


# -- phase 4: the attention lab's kernels and tools ----------------------------

def lab_draw(gen, shape, std=1.0) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(torch.bfloat16)


def lab_record(name, entry, shape, ok, errs, control_rejected, control_errs, kernel, plain,
               library, flops, nbytes, timer, max_abs_err, cta=None, yardsticks=None):
    """Time the kernel, its plain version and the library yardstick (and the
    other ``yardsticks``, {key: call}, each timed into its key), and log one
    kernel_case line. ``cta`` = (call, agrees, errors) of the one-CTA form
    of a kernel whose plan picks the ring: it is checked and timed beside the
    kernel, in the order kernel, cta, cta, kernel (``design``)."""
    ms, plain_ms, library_ms = timer(kernel), timer(plain), timer(library)
    others = {key: timer(call) for key, call in (yardsticks or {}).items()}
    bound_ms, bound_by = bound(flops, nbytes)
    design = None
    if cta is not None:
        cta_call, cta_ok, cta_errs = cta
        cta_ms = [timer(cta_call), timer(cta_call)]
        design = {"kernel_ms": [ms, timer(kernel)], "cta_ms": cta_ms, "cta_errors": cta_errs,
                  "cta_ok": cta_ok}
        ok = ok and cta_ok
    rec = {
        "name": name, "entry": entry, "shape": list(shape), "max_abs_err": max_abs_err,
        "errors": errs, "ok": ok, "control_errors": control_errs,
        "control_rejected": control_rejected,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **others,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        **lab_plan_fields(name, shape), "design": design,
    }
    rec["bound_share"] = bound_ms / ms
    log("kernel_case " + json.dumps(rec))
    return rec


def lab_plan_of(name, shape):
    """The launch plan of a lab case on this card, or None for a tree whose
    lab kernel has no plan (so that this script also measures such a
    tree)."""
    from latteclip_torch.kernels import lab

    B, L, H, D = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if name == "lab_fwd" and hasattr(lab, "lab_fwd_plan"):
        return lab.lab_fwd_plan(B, L, H, D, sms)
    if name == "lab_bwd" and hasattr(lab, "lab_bwd_plan"):
        return lab.lab_bwd_plan(B, L, H, D, sms)
    if name == "lab_qk" and hasattr(lab, "lab_qk_plan"):
        return lab.lab_qk_plan(B, L, H * D, sms)
    if name == "lab_pv" and hasattr(lab, "lab_pv_plan"):
        return lab.lab_pv_plan(B, L, H, D, sms)
    return None


def lab_plan_fields(name, shape) -> dict:
    """The plan's form ("ring" or "cta") and, for the ring, its consumer
    warpgroups a CTA, CTAs an SM, stages and grid."""
    p = lab_plan_of(name, shape)
    if p is None:
        return {}
    return {"plan": {"form": p.form, **({"warpgroups": p.warpgroups, "ctas_per_sm": p.ctas_per_sm,
                                         "stages": p.stages, "grid": p.grid} if p.form == "ring" else {})}}


def lab_cta_call(entry, tensors, out_shapes, ints, scale=None):
    """A call of the lab C entry point ``entry`` with the plan of the one-CTA
    form (grid 0): it is no part of any path, so it is not counted. Returns
    the outputs."""
    from latteclip_torch.kernels import lab

    outs = [torch.empty(shape, dtype=dt, device="cuda") for shape, dt in out_shapes]
    fn = lab._kernel(entry)
    err = fn(*(t.data_ptr() for t in (*tensors, *outs)), *ints, *([] if scale is None else [scale]), 0, 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the one-CTA form of {entry} failed with CUDA error {err}")
    return outs


def lab_fwd_case(entry, B, L, H, D, timer, gen):
    """The lab forward (packed or BHLD) against its plain version; q, k ~
    N(0, 0.3^2), v ~ N(0, 1); control: one 16-key block of v zeroed;
    yardstick SDPA's forward on the same q, k, v."""
    from latteclip_torch.kernels import lab

    q, k = (lab_draw(gen, (B, L, H * D), QK_STD) for _ in range(2))
    v = lab_draw(gen, (B, L, H * D))
    if entry == "bhld":
        q, k, v = (lab.to_bhld(x, H).contiguous() for x in (q, k, v))
        kernel = lambda: lab.lab_fwd_bhld(q, k, v)  # noqa: E731
        plain_of = lambda v_: lab.lab_fwd_bhld_plain(q, k, v_)  # noqa: E731
        heads = lambda x: x  # noqa: E731
    else:
        kernel = lambda: lab.lab_fwd_packed(q, k, v, H)  # noqa: E731
        plain_of = lambda v_: lab.lab_fwd_packed_plain(q, k, v_, H)  # noqa: E731
        heads = lambda x: lab.to_bhld(x, H)  # noqa: E731
    (o, lse), (ref_o, ref_lse) = kernel(), plain_of(v)
    torch.cuda.synchronize()
    ok, rel = out_check(o, ref_o)
    err_lse = float((lse - ref_lse).abs().max())
    ok = ok and err_lse <= LSE_TOL and bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
    dropped = v.clone()
    dropped[..., L // 2:L // 2 + 16, :] = 0
    control_ok, rel_dropped = out_check(plain_of(dropped)[0], ref_o)
    library = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v))  # noqa: E731
    cta = None
    plan = lab_plan_of("lab_fwd", (B, L, H, D))
    if plan is not None and plan.form == "ring":
        cta_call = lambda: lab_cta_call(  # noqa: E731
            f"latteclip_lab_fwd_{entry}", (q, k, v), [(o.shape, o.dtype), (lse.shape, lse.dtype)], (B, L, H, D),
            D ** -0.5)
        co, cl = cta_call()
        torch.cuda.synchronize()
        cta_ok, cta_rel = out_check(co, ref_o)
        cta_lse = float((cl - ref_lse).abs().max())
        cta = (cta_call, cta_ok and cta_lse <= LSE_TOL, {"out_rel": cta_rel, "lse_max": cta_lse})
    return lab_record(
        "lab_fwd", entry, (B, L, H, D), ok, {"out_rel": rel, "lse_max": err_lse}, not control_ok,
        {"out_rel": rel_dropped}, kernel, lambda: plain_of(v), library,
        4 * B * H * L * L * D, 4 * B * L * H * D * 2 + B * H * L * 4, timer,
        float((o.float() - ref_o.float()).abs().max()), cta)


def lab_grad_check(ours, ref):
    """(agrees, {dq|dk|dv: [||d - ref|| / ||ref||, max|d - ref| / max|ref|]})."""
    errs, ok = {}, True
    for part, a, r in zip(("dq", "dk", "dv"), ours, ref):
        a, r = a.float(), r.float()
        rel = float((a - r).norm() / r.norm())
        worst = float((a - r).abs().max() / r.abs().max())
        errs[part] = [rel, worst]
        ok = ok and rel <= GRAD_REL_TOL and worst <= GRAD_MAX_TOL and bool(torch.isfinite(a).all())
    return ok, errs


def lab_bwd_case(B, L, H, D, timer, gen):
    """The lab backward against its plain version from the lab forward's
    lse and an N(0, 1) cotangent; control: one 16-key block of v zeroed;
    yardstick SDPA's backward alone."""
    from latteclip_torch.kernels import lab

    q, k = (lab_draw(gen, (B, H, L, D), QK_STD) for _ in range(2))
    v, do = (lab_draw(gen, (B, H, L, D)) for _ in range(2))
    _, lse = lab.lab_fwd_bhld(q, k, v)
    kernel = lambda: lab.lab_bwd_bhld(q, k, v, do, lse)  # noqa: E731
    plain_of = lambda v_: lab.lab_bwd_bhld_plain(q, k, v_, do, lse)  # noqa: E731
    ours, ref = kernel(), plain_of(v)
    torch.cuda.synchronize()
    ok, errs = lab_grad_check(ours, ref)
    dropped = v.clone()
    dropped[:, :, L // 2:L // 2 + 16] = 0
    control_ok, control_errs = lab_grad_check(plain_of(dropped), ref)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves)
    library = lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)  # noqa: E731
    cta = None
    plan = lab_plan_of("lab_bwd", (B, L, H, D))
    if plan is not None and plan.form == "ring":
        cta_call = lambda: lab_cta_call(  # noqa: E731
            "latteclip_lab_bwd_bhld", (q, k, v, do, lse), [(q.shape, q.dtype)] * 3, (B, L, H, D), D ** -0.5)
        cta_out = cta_call()
        torch.cuda.synchronize()
        cta = (cta_call, *lab_grad_check(cta_out, ref))
    rec = lab_record(
        "lab_bwd", "bhld", (B, L, H, D), ok, errs, not control_ok, control_errs, kernel,
        lambda: plain_of(v), library, 10 * B * H * L * L * D, 7 * B * L * H * D * 2 + B * H * L * 4,
        timer, max(float((a.float() - r.float()).abs().max()) for a, r in zip(ours, ref)), cta)
    del o, leaves
    return rec


def f32_check(out, ref):
    """(agrees, [||out - ref|| / ||ref||, max|out - ref| / max|ref|]) of f32 products."""
    d = out - ref
    errs = [float(d.norm() / ref.norm()), float(d.abs().max() / ref.abs().max())]
    return max(errs) <= F32_REL_TOL and bool(torch.isfinite(out).all()), errs


def lab_product_case(entry, B, L, H, D, timer, gen):
    """A head-summed product (natural or pret Q K^T, or P V) against its
    plain version on N(0, 1) bf16 operands; control: one 16-column block of
    k (Q K^T) or v (P V) zeroed; yardstick torch.bmm on the same operands,
    which computes the head-summed Q K^T, or for P V torch.einsum, which
    sums the heads as the kernel does (bmm, which keeps every head's
    product, timed beside it)."""
    from latteclip_torch.kernels import lab

    HD = H * D
    a = lab_draw(gen, (B, L, HD) if entry != "pv" else (B, L, L))
    b = lab_draw(gen, (B, L, HD))
    if entry == "pret":
        b = b.transpose(1, 2).contiguous()  # kT [B, HD, L], made outside the timed kernel
        wrapper, plain_fn, library = lab.qk_heads_pret, lab.qk_heads_pret_plain, lambda: torch.bmm(a, b)
    elif entry == "natural":
        wrapper, plain_fn = lab.qk_heads_natural, lab.qk_heads_natural_plain
        library = lambda: torch.bmm(a, b.transpose(1, 2))  # noqa: E731
    else:
        wrapper, plain_fn = lab.pv_heads, lab.pv_heads_plain
        vh = b.view(B, L, H, D)
        library = lambda: torch.einsum("blm,bmhd->bld", a, vh)  # noqa: E731
    kernel = lambda: wrapper(a, b, H)  # noqa: E731
    out, ref = kernel(), plain_fn(a, b, H)
    torch.cuda.synchronize()
    ok, errs = f32_check(out, ref)
    dropped = b.clone()
    if entry == "pret":
        dropped[:, HD // 2:HD // 2 + 16] = 0
    else:
        dropped[:, :, HD // 2:HD // 2 + 16] = 0
    control_ok, control_errs = f32_check(plain_fn(a, dropped, H), ref)
    out_bytes = B * L * (L if entry != "pv" else D) * 4
    name = "lab_pv" if entry == "pv" else "lab_qk"
    cta = None
    plan = lab_plan_of(name, (B, L, H, D))
    if plan is not None and plan.form == "ring":
        if entry == "pv":
            cta_call = lambda: lab_cta_call(  # noqa: E731
                "latteclip_lab_pv", (a, b), [((B, L, D), torch.float32)], (B, L, H, D))[0]
        else:
            cta_call = lambda: lab_cta_call(  # noqa: E731
                f"latteclip_lab_qk_{entry}", (a, b), [((B, L, L), torch.float32)], (B, L, HD))[0]
        cta_out = cta_call()
        torch.cuda.synchronize()
        cta = (cta_call, *f32_check(cta_out, ref))
    return lab_record(
        name, entry, (B, L, H, D), ok, errs, not control_ok,
        control_errs, kernel, lambda: plain_fn(a, b, H), library, 2 * B * H * L * L * D,
        a.numel() * 2 + b.numel() * 2 + out_bytes, timer, float((out - ref).abs().max()), cta,
        {"bmm_ms": lambda: torch.bmm(a, b)} if entry == "pv" else None)


def phase_lab(smi: str):
    """The lab kernels against their plain versions at the lab tools' shapes
    and one small shape each, then both lab tools' main at their default
    shapes with the launch counters set to 0 just before and read just after.
    Returns (records, launches)."""
    from latteclip_torch.kernels import lab
    from latteclip_torch.tools import attn_lab, r4_transpose_probe
    from latteclip_torch.tools.perf_lab import Timer

    if torch.backends.cuda.matmul.allow_tf32:  # the plain versions' f32 products
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be False")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    timer = Timer("cuda")
    records = []
    for shape in (LAB_ATTN, LAB_ATTN_SMALL):
        records += [lab_fwd_case(entry, *shape, timer, gen) for entry in ("packed", "bhld")]
        records.append(lab_bwd_case(*shape, timer, gen))
    for shape in (LAB_PRODUCTS, LAB_PRODUCTS_SMALL):
        records += [lab_product_case(entry, *shape, timer, gen) for entry in ("natural", "pret", "pv")]
    del timer
    torch.cuda.empty_cache()
    bad = [(r["name"], r["entry"], r["shape"], r["errors"], r["design"]) for r in records if not r["ok"]]
    if bad:
        raise RuntimeError("lab kernels disagree with their plain versions (name, entry, shape, errors, "
                           f"design): {bad}")
    blind = [(r["name"], r["entry"], r["shape"], r["control_errors"]) for r in records
             if not r["control_rejected"]]
    if blind:
        raise RuntimeError(f"a lab check missed a zeroed block (name, entry, shape, errors): {blind}")

    reset_counts()
    tools = {"attn_lab": attn_lab.run("cuda"), "r4_transpose_probe": r4_transpose_probe.run("cuda")}
    torch.cuda.synchronize()
    launches = read_counts()
    torch.cuda.empty_cache()
    log(f"lab kernels: {json.dumps(launches)}")
    log("lab " + json.dumps({**tools, "card": smi}))
    missing = [name for name in lab.launch_counts if launches[name] <= 0]
    if missing:
        raise RuntimeError(f"lab kernels never launched by the lab tools: {missing}")
    numbers = [x for t in tools.values() for x in t["ms"].values()] + \
        [x for c in tools["attn_lab"]["checks"].values() for x in c.values()]
    if not all(np.isfinite(numbers)) or tools["r4_transpose_probe"]["pret_vs_natural"] != 0.0:
        raise RuntimeError(f"lab tools gave bad numbers: {tools}")
    if max(tools["attn_lab"]["checks"]["v3_vs_v1"].values()) != 0.0:
        raise RuntimeError("the lab forward's packed and BHLD entry points disagree: "
                           f"{tools['attn_lab']['checks']['v3_vs_v1']}")
    return records, launches


# -- phase 5: the ViT-B/32 zero-shot slice -----------------------------------

def exemplar_images(rng: np.random.Generator, n: int, image_size: int) -> np.ndarray:
    """One seeded uint8 image per class: an 8 x 8 grid of random colours.
    (Images of i.i.d. pixel noise all look alike to a network and give
    features too close together for any top-1 to mean anything.)"""
    cells = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
    rep = -(-image_size // 8)
    return cells.repeat(rep, axis=1).repeat(rep, axis=2)[:, :image_size, :image_size]


def seeded_batches(rng: np.random.Generator, exemplars: np.ndarray, sizes):
    """Batches of (ids, uint8 images, labels, valid): image i is exemplar
    i mod C with +-8 levels of pixel noise, labelled i mod C."""
    batches, start = [], 0
    for b in sizes:
        ids = np.arange(start, start + b)
        labels = ids % len(exemplars)
        noise = rng.integers(-8, 9, exemplars[labels].shape)
        images = np.clip(exemplars[labels].astype(np.int16) + noise, 0, 255).astype(np.uint8)
        batches.append((ids, images, labels, b))
        start += b
    return batches


def run_requests(model, tok, classnames, templates, batches, bank, attention):
    """The serving requests: template classifier, eval, prototype classify."""
    from latteclip_torch.eval import zero_shot as zs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf = zs.build_zero_shot_classifier(model, tok, classnames, templates,
                                        chunk_classes=len(classnames), attention=attention)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics = zs.run_zero_shot_eval(model, clf, batches, attention=attention)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    proto = zs.prototype_classifier(bank)
    proto_logits = zs.make_eval_step(model, proto, attention=attention)(batches[0][1])
    torch.cuda.synchronize()
    n_images = sum(b[3] for b in batches)
    return {
        "classifier": clf, "metrics": metrics, "proto_logits": proto_logits,
        "classifier_build_s": t1 - t0,
        "images_per_s": n_images / (t2 - t1),
    }


def device_profile(fn) -> dict:
    """Host-clock time of fn() and the device's busy time within it, from a
    torch.profiler trace: the union of the device intervals, their sum by
    kind, and the five longest kernels. Device fields read None when the
    trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_kind, by_name = [], {}, {}
    for ev in prof.events():
        # user annotations (record_function ranges such as Optimizer.step)
        # appear on the device track too and would count their kernels twice
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        name = ev.name.lower()
        kind = ("attention fwd" if "flash_fwd" in name else
                "attention bwd" if "flash_bwd" in name else
                "ln_linear" if "ln_linear" in name else
                "memcpy" if "memcpy" in name or "memset" in name else
                "gemm" if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")) else "other")
        us = ev.time_range.elapsed_us()
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us / 1e3
    busy_us, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_us, end = busy_us + (b - a), b
        elif b > end:
            busy_us, end = busy_us + (b - end), b
    busy_ms = busy_us / 1e3 if spans else None
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ms_by_kind": by_kind,
        "top_kernels_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:5],
    }


def serving_inputs(name: str) -> dict:
    """A serving phase's model (full width and depth, random weights from
    seed 0), tokenizer, the ImageNet classes and templates, the seeded eval
    batches (4 x 256 + 255 images) and memory bank, after a warm-up of both
    routes (cuBLAS heuristics, allocator), neither timed nor counted."""
    from latteclip_torch.config import get_model_config
    from latteclip_torch.data import transforms as T
    from latteclip_torch.data.eval_dataset import get_templates, imagenet_classnames
    from latteclip_torch.models import clip as clip_mod
    from latteclip_torch.models.tokenizer import get_tokenizer

    cfg = get_model_config(name)
    model = clip_mod.init_clip_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    tok = get_tokenizer()
    classnames, templates = imagenet_classnames(), get_templates("imagenet")
    rng = np.random.default_rng(0)
    exemplars = exemplar_images(rng, len(classnames), cfg.vision.image_size)
    batches = seeded_batches(rng, exemplars, (EVAL_BATCH,) * 4 + (EVAL_BATCH - 1,))
    mean, std = T.model_mean_std(cfg)
    # the seeded memory bank [1000, embed]: class prototypes are the exemplars'
    # features (plain route), as LatteCLIP's bank holds image features per class
    with torch.no_grad():
        bank = torch.cat([
            clip_mod.encode_image(model, T.normalize_images(torch.from_numpy(e).cuda(), mean, std),
                                  attention="plain")
            for e in np.array_split(exemplars, 4)])
    for attention in ("kernel", "plain"):
        run_requests(model, tok, classnames, templates, [batches[0], batches[-1]], bank, attention)
    return {"cfg": cfg, "model": model, "tok": tok, "classnames": classnames,
            "templates": templates, "batches": batches, "mean": mean, "std": std, "bank": bank}


def phase_slice(smi: str):
    from latteclip_torch.data import transforms as T
    from latteclip_torch.eval import zero_shot as zs
    from latteclip_torch.models import clip as clip_mod

    inputs = serving_inputs("ViT-B-32")
    cfg, model, tok, batches, bank = (inputs[k] for k in ("cfg", "model", "tok", "batches", "bank"))
    classnames, templates, mean, std = (inputs[k] for k in ("classnames", "templates", "mean", "std"))

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fast = run_requests(model, tok, classnames, templates, batches, bank, "kernel")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"slice kernels: {json.dumps(launches)}")
    for name in ("flash_fwd", "flash_fwd_seg"):  # serving runs no backward
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never launched on the ViT-B/32 path")

    reset_counts()
    slow = run_requests(model, tok, classnames, templates, batches, bank, "plain")
    if any(read_counts().values()):
        raise RuntimeError(f"plain run launched kernels: {read_counts()}")

    # where the time of each request goes, kernel route (not counted)
    for request, fn in (
        ("classifier_build", lambda: zs.build_zero_shot_classifier(
            model, tok, classnames, templates, chunk_classes=len(classnames))),
        ("eval", lambda: zs.run_zero_shot_eval(model, fast["classifier"], batches)),
    ):
        log(f"profile {request} " + json.dumps(device_profile(fn)))

    # Agreement of the kernel route with the plain one. Image features are
    # held row by row, the template classifier column by column, and top-1 on
    # the prototype classifier. With random weights the text tower maps the
    # 1000 prompts to nearly parallel features, so template top-1 is decided
    # by margins at the level of bf16 rounding: it is reported beside a
    # control, the plain bf16 route against the same model in float32, not
    # held.
    model32 = copy.copy(model)  # shares the weights; only the compute dtype differs
    model32.cfg = dataclasses.replace(cfg, compute_dtype="float32")
    clf32 = zs.build_zero_shot_classifier(model32, tok, classnames, templates,
                                          chunk_classes=len(classnames), attention="plain")
    proto = zs.prototype_classifier(bank)
    cos_min, agree, agree_tpl, agree_f32, rows, correct = 1.0, 0, 0, 0, 0, 0
    margins = {"template": [], "prototype": []}
    with torch.no_grad():
        for _ids, images, labels, valid in batches:
            x = T.normalize_images(torch.from_numpy(images).cuda(), mean, std)
            fk = clip_mod.encode_image(model, x, normalize=True, attention="kernel")[:valid]
            fp = clip_mod.encode_image(model, x, normalize=True, attention="plain")[:valid]
            f32 = clip_mod.encode_image(model32, x, normalize=True, attention="plain")[:valid]
            if fk.shape != (valid, cfg.embed_dim) or not torch.isfinite(fk).all():
                raise RuntimeError(f"bad image features {tuple(fk.shape)}")
            cos_min = min(cos_min, float(F.cosine_similarity(fk, fp, dim=-1).min()))
            lk, lp = fk @ proto, fp @ proto
            agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
            correct += int((lk.argmax(-1).cpu().numpy() == labels[:valid]).sum())
            tk, tp = fk @ fast["classifier"], fp @ slow["classifier"]
            agree_tpl += int((tk.argmax(-1) == tp.argmax(-1)).sum())
            agree_f32 += int(((f32 @ clf32).argmax(-1) == tp.argmax(-1)).sum())
            for key, logits in (("prototype", lk), ("template", tk)):
                top2 = (100.0 * logits).topk(2, dim=-1).values
                margins[key].append(top2[:, 0] - top2[:, 1])
            rows += valid
    clf = fast["classifier"]
    if clf.shape != (cfg.embed_dim, len(classnames)) or not torch.isfinite(clf).all():
        raise RuntimeError(f"bad classifier {tuple(clf.shape)}")
    if float((clf.norm(dim=0) - 1).abs().max()) > 1e-3:
        raise RuntimeError("classifier columns are not unit-norm")
    clf_cos = float(F.cosine_similarity(clf, slow["classifier"], dim=0).min())
    proto_same = float((fast["proto_logits"].argmax(-1) == slow["proto_logits"].argmax(-1)).float().mean())
    builds = route_builds(model, tok, classnames, templates, slow["classifier"], cfg.text.layers)
    for build in builds.values():
        for name, n in build["launches"].items():
            launches[name] += n
    m = fast["metrics"]
    if m["n"] != sum(b[3] for b in batches) or not all(0.0 <= m[k] <= 1.0 for k in ("top1", "top5", "top10")):
        raise RuntimeError(f"bad eval metrics {m}")
    report = {
        "model": cfg.name, "rows": rows, "feature_cos_min": cos_min, "classifier_cos_min": clf_cos,
        "top1_agree_prototype": agree / rows, "top1_agree_template": agree_tpl / rows,
        "top1_agree_template_plain_bf16_vs_f32": agree_f32 / rows,
        "top1_agree_prototype_request": proto_same, "prototype_top1_accuracy": correct / rows,
        "median_top1_margin": {k: float(torch.cat(v).median()) for k, v in margins.items()},
        "metrics": m, "metrics_plain": slow["metrics"],
        "classifier_build_s": fast["classifier_build_s"],
        "classifier_build_s_plain": slow["classifier_build_s"],
        "eval_images_per_s": fast["images_per_s"], "eval_images_per_s_plain": slow["images_per_s"],
        "route_builds": builds, "max_memory_allocated": peak, "card": smi,
    }
    log("slice " + json.dumps(report))
    if cos_min < 0.999 or clf_cos < 0.999:
        raise RuntimeError(f"features disagree: min cosine {cos_min} (images), {clf_cos} (classifier)")
    bad = {k: b["classifier_cos_min"] for k, b in builds.items() if b["classifier_cos_min"] < 0.999}
    if bad:
        raise RuntimeError(f"route classifier builds disagree with the plain build: {bad}")
    if agree / rows < 0.99:
        raise RuntimeError(f"top-1 agrees on only {agree / rows:.4f} of rows")
    return launches


# (route, attention, ln_linear, launches per text layer of one padded build)
BUILD_ROUTES = (
    ("headsplit_fused", "headsplit", "fused", {"flash_fwd_hs": 1, "ln_linear": 2}),
    ("blockdiag", "blockdiag", "unfused", {"flash_fwd_bd": 1}),
)


def route_builds(model, tok, classnames, templates, plain_classifier, text_layers):
    """The 1000-class classifier build on each other route: seconds,
    launches (exactly the route's kernels, once a text layer) and the
    minimum column cosine against the plain build."""
    from latteclip_torch.eval import zero_shot as zs

    builds = {}
    for route, attention, ln_linear, per_layer in BUILD_ROUTES:
        kwargs = {"chunk_classes": len(classnames), "attention": attention, "ln_linear": ln_linear}
        zs.build_zero_shot_classifier(model, tok, classnames, templates, **kwargs)  # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf = zs.build_zero_shot_classifier(model, tok, classnames, templates, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        want = {**dict.fromkeys(launches, 0), **{k: n * text_layers for k, n in per_layer.items()}}
        if launches != want:
            raise RuntimeError(f"{route} classifier build launched {launches}, expected {want}")
        builds[route] = {
            "attention": attention, "ln_linear": ln_linear, "classifier_build_s": seconds,
            "launches": launches,
            "classifier_cos_min": float(F.cosine_similarity(clf, plain_classifier, dim=0).min()),
        }
    return builds


# -- phase 5b: ViT-B/16 zero-shot serving ---------------------------------------

def phase_slice_b16(smi: str):
    """ViT-B/16 serving at full width and depth (vision 12 x 768 at 224 px /
    patch 16, L=197, heads 64 wide): the same requests as the ViT-B/32 slice.
    No batch pair-packs at 197 tokens (that needs 2L <= 128), so every vision
    layer runs K1 on the long-row kernel at [256, 197, 12 x 3 x 64]. The
    counters are set to 0 just before the requests and read just after
    (exactly one flash_fwd launch a layer: the classifier build's text tower
    at L=77, then the vision tower on five eval batches and the prototype
    request's batch), and again around the eval alone (12 a batch, all at
    L=197, no flash_fwd_seg)."""
    from latteclip_torch.data import transforms as T
    from latteclip_torch.eval import zero_shot as zs
    from latteclip_torch.models import clip as clip_mod

    inputs = serving_inputs("ViT-B-16")
    cfg, model, tok, batches, bank = (inputs[k] for k in ("cfg", "model", "tok", "batches", "bank"))
    classnames, templates, mean, std = (inputs[k] for k in ("classnames", "templates", "mean", "std"))
    if cfg.vision.seq_len != 197:
        raise RuntimeError(f"ViT-B/16 vision rows of {cfg.vision.seq_len} tokens, expected 197")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fast = run_requests(model, tok, classnames, templates, batches, bank, "kernel")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    zs.run_zero_shot_eval(model, fast["classifier"], batches)
    eval_launches = read_counts()
    log(f"slice_b16 kernels: {json.dumps(launches)}; eval alone: {json.dumps(eval_launches)}")
    vision_runs = len(batches) + 1  # the eval's batches, then the prototype request's
    for window, got, n in (("requests", launches, cfg.text.layers + cfg.vision.layers * vision_runs),
                           ("eval", eval_launches, cfg.vision.layers * len(batches))):
        want = {**dict.fromkeys(got, 0), "flash_fwd": n}
        if got != want:
            raise RuntimeError(f"ViT-B/16 {window} launched {got}, expected {want}")

    reset_counts()
    slow = run_requests(model, tok, classnames, templates, batches, bank, "plain")
    if any(read_counts().values()):
        raise RuntimeError(f"plain run launched kernels: {read_counts()}")
    profile = device_profile(lambda: zs.run_zero_shot_eval(model, fast["classifier"], batches))
    log("profile eval_b16 " + json.dumps(profile))

    # agreement of the kernel route with the plain one, as the ViT-B/32 slice holds it
    proto = zs.prototype_classifier(bank)
    cos_min, agree, rows = 1.0, 0, 0
    with torch.no_grad():
        for _ids, images, _labels, valid in batches:
            x = T.normalize_images(torch.from_numpy(images).cuda(), mean, std)
            fk = clip_mod.encode_image(model, x, normalize=True, attention="kernel")[:valid]
            fp = clip_mod.encode_image(model, x, normalize=True, attention="plain")[:valid]
            if fk.shape != (valid, cfg.embed_dim) or not torch.isfinite(fk).all():
                raise RuntimeError(f"bad image features {tuple(fk.shape)}")
            cos_min = min(cos_min, float(F.cosine_similarity(fk, fp, dim=-1).min()))
            agree += int(((fk @ proto).argmax(-1) == (fp @ proto).argmax(-1)).sum())
            rows += valid
    clf = fast["classifier"]
    if clf.shape != (cfg.embed_dim, len(classnames)) or not torch.isfinite(clf).all():
        raise RuntimeError(f"bad classifier {tuple(clf.shape)}")
    clf_cos = float(F.cosine_similarity(clf, slow["classifier"], dim=0).min())
    m = fast["metrics"]
    if m["n"] != rows or not all(0.0 <= m[k] <= 1.0 for k in ("top1", "top5", "top10")):
        raise RuntimeError(f"bad eval metrics {m}")
    report = {
        "model": cfg.name, "rows": rows, "feature_cos_min": cos_min, "classifier_cos_min": clf_cos,
        "top1_agree_prototype": agree / rows,
        "top1_agree_prototype_request": float(
            (fast["proto_logits"].argmax(-1) == slow["proto_logits"].argmax(-1)).float().mean()),
        "metrics": m, "metrics_plain": slow["metrics"],
        "eval_images_per_s": fast["images_per_s"], "eval_images_per_s_plain": slow["images_per_s"],
        "classifier_build_s": fast["classifier_build_s"],
        "eval_device_busy_ms": profile["device_busy_ms"],
        "eval_device_idle_share": profile["device_idle_share"],
        "eval_device_ms_by_kind": profile["device_ms_by_kind"],
        "launches": launches, "eval_launches": eval_launches,
        "max_memory_allocated": peak, "card": smi,
    }
    log("slice_b16 " + json.dumps(report))
    if cos_min < 0.999 or clf_cos < 0.999:
        raise RuntimeError(f"ViT-B/16 features disagree: min cosine {cos_min} (images), "
                           f"{clf_cos} (classifier)")
    if agree / rows < 0.99:
        raise RuntimeError(f"ViT-B/16 prototype top-1 agrees on only {agree / rows:.4f} of rows")
    return launches


# -- phase 6: the ViT-B/32 train step ------------------------------------------

def caption_lengths(rng: np.random.Generator, n: int, clip_max: int = 77) -> np.ndarray:
    """LLaVA-caption-like BPE lengths: lognormal, median ~30, long tail,
    clipped to 8..77 (the generator of bench.py's packed run)."""
    ln = rng.lognormal(mean=np.log(30.0), sigma=0.35, size=n)
    return np.clip(np.round(ln).astype(np.int64) + 2, 8, clip_max)


def caption_rows(rng: np.random.Generator, lengths: np.ndarray, eot_id: int) -> np.ndarray:
    rows = np.zeros((len(lengths), 77), np.int32)
    for i, ln in enumerate(lengths):
        rows[i, :ln - 1] = rng.integers(1, 40000, size=ln - 1)
        rows[i, ln - 1] = eot_id
    return rows


def train_batch(rng, batch, image_size, num_classes, eot_id, bucket, pack_len):
    """Seeded uint8 images, zero-shot pseudo-labels and both caption streams,
    padded and packed."""
    from latteclip_torch.data.packing import pack_caption_batch, pack_rows_needed, token_lengths

    b = {
        "images": rng.integers(0, 256, (batch, image_size, image_size, 3), dtype=np.uint8),
        "per_image_tokens": caption_rows(rng, caption_lengths(rng, batch), eot_id),
        "per_group_tokens": caption_rows(rng, caption_lengths(rng, batch), eot_id),
        "zs_preds": rng.integers(0, num_classes, batch).astype(np.int32),
    }
    lengths = token_lengths(np.concatenate([b["per_image_tokens"], b["per_group_tokens"]]))
    rows = bucket.rows_for(pack_rows_needed(lengths, pack_len))
    b.update(pack_caption_batch(b["per_image_tokens"], b["per_group_tokens"], pack_len, rows))
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def crop_batches(rng, batches):
    """The train batches with their images replaced by seeded CANVAS-pixel
    canvases and torchvision crop boxes (scale 0.9-1.0), as the pipeline's
    on-device crop path ships them."""
    from latteclip_torch.data import transforms as T

    out = []
    for b in batches:
        n = b["images"].shape[0]
        canvases = rng.integers(0, 256, (n, CANVAS, CANVAS, 3), dtype=np.uint8)
        boxes = np.asarray([T.random_crop_box(CANVAS, CANVAS, rng) for _ in range(n)], np.float32)
        out.append({**b, "images": torch.from_numpy(canvases).cuda(),
                    "crop_boxes": torch.from_numpy(boxes).cuda()})
    return out


def event_ms(fn, iters=5) -> float:
    """Mean device ms of fn() by CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def agree(a, b) -> dict:
    """Loss, gradient and bank agreement of two route_gradients results."""
    (loss_a, grad_a, bank_a), (loss_b, grad_b, bank_b) = a, b
    return {"loss": loss_a, "loss_ref": loss_b, "loss_rel_diff": abs(loss_a - loss_b) / abs(loss_b),
            "grad_cos": float(F.cosine_similarity(grad_a, grad_b, dim=0)),
            "bank_row_cos_min": float(F.cosine_similarity(bank_a, bank_b, dim=1).min())}


def timed_steps(step_fn, state, batches, gen, n):
    """n steps; (images/s on the host clock around synchronised steps, losses)."""
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        losses.append(step_fn(state, batches[i % len(batches)], gen)["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return n * batches[0]["images"].shape[0] / dt, [float(x) for x in losses]


def check_state(state, losses, where):
    bad = [x for x in losses if not np.isfinite(x)]
    scale = float(state.model.logit_scale.detach())
    norms = state.memory_bank.norm(dim=1)
    if bad or not 0.0 <= scale <= LOG100 or float((norms - 1).abs().max()) > 1e-3:
        raise RuntimeError(f"{where}: losses {losses}, logit_scale {scale}, "
                           f"bank row norms {float(norms.min())}..{float(norms.max())}")


def route_gradients(model, hp, batch, images, state, table, packed, attention, ln_linear="unfused"):
    """(loss, flattened gradient, updated bank) of one forward and backward."""
    from latteclip_torch.train import step as S

    model.zero_grad(set_to_none=True)
    loss, aux = S.latteclip_loss_fn(model, hp, batch, images, state.memory_bank, state.prototypes,
                                    table, packed, attention=attention, ln_linear=ln_linear)
    loss.backward()
    grad = torch.cat([p.grad.flatten().float() for p in model.parameters()])
    bank = S.update_memory_bank(state.memory_bank, aux["preds"], aux["zs_preds"],
                                aux["text_final"], aux["text_final_zs"])
    return float(loss.detach()), grad, bank


def train_inputs() -> dict:
    """The train phase's config, tokenizer, class list, template table
    (padded and packed) and two seeded batches on the card. The kernel phase
    checks the kernels on the same segment ids."""
    from latteclip_torch.config import get_model_config
    from latteclip_torch.data.packing import PackRowBucketer, pack_template_table
    from latteclip_torch.models.tokenizer import get_tokenizer
    from latteclip_torch.train import state as St

    cfg = get_model_config("ViT-B-32")
    classes = [f"class {i}" for i in range(47)]   # DTD-sized class list
    templates = [lambda c: f"a photo of a {c}."]
    tok = get_tokenizer()
    table = St.build_template_table(tok, classes, templates)
    rng = np.random.default_rng(0)
    bucket = PackRowBucketer(multiple=8)
    batches = [train_batch(rng, TRAIN_BATCH, cfg.vision.image_size, len(classes),
                           tok.eot_token_id, bucket, PACK_LEN) for _ in range(2)]
    return {"cfg": cfg, "tok": tok, "classes": classes, "templates": templates, "table": table,
            "tpl": pack_template_table(table, PACK_LEN), "batches": batches}


def reset_counts() -> None:
    from latteclip_torch.kernels import attention as A, fused_ln_linear as FL, lab

    A.reset_launch_counts()
    FL.reset_launch_counts()
    lab.reset_launch_counts()


def read_counts() -> dict:
    from latteclip_torch.kernels import attention as A, fused_ln_linear as FL, lab

    return {**A.launch_counts, **FL.launch_counts, **lab.launch_counts}


def counted_steps(step_fn, state, batches, gen, n):
    """n timed steps with the launch counters set to 0 just before and read
    just after: (images/s, losses, launches)."""
    reset_counts()
    ips, losses = timed_steps(step_fn, state, batches, gen, n)
    return ips, losses, read_counts()


def phase_train(smi: str, train: dict):
    from latteclip_torch.data import transforms as T
    from latteclip_torch.models import clip as clip_mod
    from latteclip_torch.train import optim, state as St, step as S

    cfg, tok, classes, templates = train["cfg"], train["tok"], train["classes"], train["templates"]
    table, tpl, batches = train["table"], train["tpl"], train["batches"]
    model = clip_mod.init_clip_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = TRAIN_STEPS
    # each attention site launches its forward and backward kernel once a
    # layer, and each of its two LN -> projection pairs its fused kernel
    text_sites, vision_sites = 2 * cfg.text.layers, cfg.vision.layers  # captions + templates
    segmented = {"flash_fwd_seg": n * vision_sites, "flash_bwd_seg": n * vision_sites}
    expected = {
        "packed": {"flash_fwd_seg": n * (vision_sites + text_sites),
                   "flash_bwd_seg": n * (vision_sites + text_sites)},
        "padded": {"flash_fwd": n * text_sites, "flash_bwd": n * text_sites, **segmented},
        "padded_hs": {"flash_fwd_hs": n * text_sites, "flash_bwd_hs": n * text_sites, **segmented,
                      "ln_linear": 2 * n * (vision_sites + text_sites)},
        "padded_bd": {"flash_fwd_bd": n * text_sites, "flash_bwd": n * text_sites, **segmented},
        "plain": {},
        # the crop changes the images only; the fused text forward runs the
        # templates and both caption streams in one forward: one K1 and one
        # K3 a text layer
        "packed_crop": {"flash_fwd_seg": n * (vision_sites + text_sites),
                        "flash_bwd_seg": n * (vision_sites + text_sites)},
        "padded_fused_text": {"flash_fwd": n * cfg.text.layers, "flash_bwd": n * cfg.text.layers,
                              **segmented},
    }

    bank = St.init_memory_bank(model, tok, classes, templates)
    state = St.create_train_state(
        model, optim.make_optimizer(model, optim.make_schedule("const", 1e-5, warmup=0)), bank)
    packed_step = S.make_train_step(model, S.LatteHParams(text_packing=True), table,
                                    T.AugConfig(), template_packed=tpl)
    padded = S.LatteHParams(text_packing=False)
    padded_step = S.make_train_step(model, padded, table, T.AugConfig())
    padded_routes = {"padded": ("kernel", "unfused"), "padded_hs": ("headsplit", "fused"),
                     "padded_bd": ("blockdiag", "unfused")}
    hs_step = S.make_train_step(model, padded, table, T.AugConfig(), attention="headsplit",
                                ln_linear="fused")
    bd_step = S.make_train_step(model, padded, table, T.AugConfig(), attention="blockdiag")
    plain_step = S.make_train_step(model, S.LatteHParams(text_packing=True), table, T.AugConfig(),
                                   template_packed=tpl, attention="plain")
    fused = S.LatteHParams(text_packing=False, fuse_text_fwd=True)
    fused_step = S.make_train_step(model, fused, table, T.AugConfig())
    canvas_batches = crop_batches(np.random.default_rng(256), batches)
    steps = (("packed", packed_step, 3, batches), ("padded", padded_step, 1, batches),
             ("padded_hs", hs_step, 1, batches), ("padded_bd", bd_step, 1, batches),
             ("plain", plain_step, 1, batches), ("packed_crop", packed_step, 1, canvas_batches),
             ("padded_fused_text", fused_step, 1, batches))
    routes = {}
    for route, step_fn, warm, route_batches in steps:
        _, warm_losses = timed_steps(step_fn, state, route_batches, gen, warm)
        torch.cuda.reset_peak_memory_stats()
        ips, losses, launches = counted_steps(step_fn, state, route_batches, gen, n)
        routes[route] = {"images_per_s": ips, "losses": losses, "launches": launches,
                         "max_memory_allocated": torch.cuda.max_memory_allocated()}
        log(f"train kernels {route}: {json.dumps(launches)}")
        want = {**dict.fromkeys(launches, 0), **expected[route]}
        if launches != want:
            raise RuntimeError(f"{route} steps launched {launches}, expected {want}")
        check_state(state, warm_losses + losses, f"{route} route")

    for route, step_fn, _, route_batches in steps:
        profile = device_profile(lambda: step_fn(state, route_batches[0], gen))
        routes[route]["device_busy_ms_per_step"] = profile["device_busy_ms"]
        log(f"profile train_step_{route} " + json.dumps(profile))
    # the crop's share of the packed_crop step: its weight build and two
    # batched matmuls, timed alone on the same canvases and boxes
    crop = canvas_batches[0]
    crop_ms = event_ms(lambda: T.device_random_resized_crop(crop["images"], crop["crop_boxes"],
                                                            cfg.vision.image_size))
    routes["packed_crop"]["crop_ms"] = crop_ms
    routes["packed_crop"]["crop_share"] = crop_ms / routes["packed_crop"]["device_busy_ms_per_step"]

    # kernel route against plain route from one copied state, augment off
    hp = S.LatteHParams(augment=False, text_packing=True)
    batch = batches[1]
    images = T.normalize_images(batch["images"], *T.model_mean_std(cfg))
    table_t = torch.from_numpy(table).cuda()
    tpl_t = tuple(torch.from_numpy(a).cuda() for a in tpl)
    loss_k, grad_k, bank_k = route_gradients(copy.deepcopy(model), hp, batch, images, state,
                                             table_t, tpl_t, "kernel")
    loss_p, grad_p, bank_p = route_gradients(copy.deepcopy(model), hp, batch, images, state,
                                             table_t, tpl_t, "plain")
    agreement = {
        "loss_kernel": loss_k, "loss_plain": loss_p,
        "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
        "grad_cos": float(F.cosine_similarity(grad_k, grad_p, dim=0)),
        "grad_norm_kernel": float(grad_k.norm()), "grad_norm_plain": float(grad_p.norm()),
        "bank_row_cos_min": float(F.cosine_similarity(bank_k, bank_p, dim=1).min()),
    }
    # each other padded route against the padded route, same state and batch
    hp_padded = S.LatteHParams(augment=False, text_packing=False)
    hp_fused = S.LatteHParams(augment=False, text_packing=False, fuse_text_fwd=True)
    padded_runs = {route: route_gradients(copy.deepcopy(model), hp_padded, batch, images, state,
                                          table_t, None, attention, ln_linear)
                   for route, (attention, ln_linear) in padded_routes.items()}
    padded_runs["padded_fused_text"] = route_gradients(copy.deepcopy(model), hp_fused, batch,
                                                       images, state, table_t, None, "kernel")
    route_agreement = {route: agree(run, padded_runs["padded"])
                       for route, run in padded_runs.items() if route != "padded"}
    del padded_runs
    # the packed step on the crop's images, kernel against plain attention
    crop_images = T.train_augment_normalize(
        crop["images"], None, T.AugConfig(color_jitter_prob=0.0, gray_scale_prob=0.0),
        *T.model_mean_std(cfg), boxes=crop["crop_boxes"], size=cfg.vision.image_size)
    route_agreement["packed_crop"] = agree(*(
        route_gradients(copy.deepcopy(model), hp, crop, crop_images, state, table_t, tpl_t, att)
        for att in ("kernel", "plain")))
    report = {
        "model": cfg.name, "batch": TRAIN_BATCH, "classes": len(classes), "steps_per_route": n,
        "caption_rows_per_batch": [int(b["cap_tokens"].shape[0]) for b in batches],
        "template_rows_packed": int(tpl.tokens.shape[0]),
        "routes": routes, "logit_scale": float(state.model.logit_scale.detach()),
        "agreement": agreement, "route_agreement": route_agreement, "card": smi,
    }
    log("train " + json.dumps(report))
    for name, a in {"kernel and plain routes": agreement, **{
            f"{route} and its reference route": a for route, a in route_agreement.items()}}.items():
        if a["loss_rel_diff"] > 1e-2 or a["grad_cos"] < 0.99 or a["bank_row_cos_min"] < 0.999:
            raise RuntimeError(f"{name} disagree: {a}")
    return {k: sum(r["launches"][k] for r in routes.values()) for k in routes["packed"]["launches"]}


# -- phase 6b: the ViT-B/16 train step -----------------------------------------

def phase_train_b16(smi: str, train: dict):
    """The LatteCLIP v2 step at ViT-B/16 (vision 12 x 768 at 224 px / patch
    16, L=197), packed text at 128: no vision pair packs at 197 tokens, so
    every vision layer runs K1 and K3 on whole rows of 197 tokens, the
    backward in its resident_pair long-row form. The counters are set to 0 just
    before the 10 timed steps and read just after; exactly one flash_fwd and
    one flash_bwd a vision layer and step, one flash_fwd_seg and one
    flash_bwd_seg a text layer, stream (captions, templates) and step."""
    from latteclip_torch.config import get_model_config
    from latteclip_torch.data import transforms as T
    from latteclip_torch.data.packing import PackRowBucketer
    from latteclip_torch.models import clip as clip_mod
    from latteclip_torch.train import optim, state as St, step as S

    cfg = get_model_config("ViT-B-16")
    if cfg.vision.seq_len != 197:
        raise RuntimeError(f"ViT-B/16 vision rows of {cfg.vision.seq_len} tokens, expected 197")
    tok, classes, templates = train["tok"], train["classes"], train["templates"]
    table, tpl = train["table"], train["tpl"]
    rng = np.random.default_rng(16)
    bucket = PackRowBucketer(multiple=8)
    batches = [train_batch(rng, TRAIN_BATCH_B16, cfg.vision.image_size, len(classes),
                           tok.eot_token_id, bucket, PACK_LEN) for _ in range(2)]
    model = clip_mod.init_clip_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bank = St.init_memory_bank(model, tok, classes, templates)
    state = St.create_train_state(
        model, optim.make_optimizer(model, optim.make_schedule("const", 1e-5, warmup=0)), bank)
    step_fn = S.make_train_step(model, S.LatteHParams(text_packing=True), table, T.AugConfig(),
                                template_packed=tpl)
    n, vision_sites, text_sites = TRAIN_STEPS, cfg.vision.layers, 2 * cfg.text.layers
    _, warm_losses = timed_steps(step_fn, state, batches, gen, 1)
    torch.cuda.reset_peak_memory_stats()
    ips, losses, launches = counted_steps(step_fn, state, batches, gen, n)
    peak = torch.cuda.max_memory_allocated()
    log(f"train kernels packed_b16: {json.dumps(launches)}")
    want = {**dict.fromkeys(launches, 0), "flash_fwd": n * vision_sites, "flash_bwd": n * vision_sites,
            "flash_fwd_seg": n * text_sites, "flash_bwd_seg": n * text_sites}
    if launches != want:
        raise RuntimeError(f"packed_b16 steps launched {launches}, expected {want}")
    check_state(state, warm_losses + losses, "packed_b16 route")
    profile = device_profile(lambda: step_fn(state, batches[0], gen))
    log("profile train_step_packed_b16 " + json.dumps(profile))

    # kernel route against plain route from one copied state, augment off
    del batches
    hp = S.LatteHParams(augment=False, text_packing=True)
    batch = train_batch(rng, AGREE_BATCH_B16, cfg.vision.image_size, len(classes), tok.eot_token_id,
                        bucket, PACK_LEN)
    images = T.normalize_images(batch["images"], *T.model_mean_std(cfg))
    table_t = torch.from_numpy(table).cuda()
    tpl_t = tuple(torch.from_numpy(a).cuda() for a in tpl)
    loss_k, grad_k, bank_k = route_gradients(copy.deepcopy(model), hp, batch, images, state,
                                             table_t, tpl_t, "kernel")
    loss_p, grad_p, bank_p = route_gradients(copy.deepcopy(model), hp, batch, images, state,
                                             table_t, tpl_t, "plain")
    agreement = {
        "batch": AGREE_BATCH_B16, "loss_kernel": loss_k, "loss_plain": loss_p,
        "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
        "grad_cos": float(F.cosine_similarity(grad_k, grad_p, dim=0)),
        "bank_row_cos_min": float(F.cosine_similarity(bank_k, bank_p, dim=1).min()),
    }
    report = {
        "model": cfg.name, "batch": TRAIN_BATCH_B16, "classes": len(classes), "steps": n,
        "images_per_s": ips, "losses": losses, "launches": launches,
        "max_memory_allocated": peak, "device_busy_ms_per_step": profile["device_busy_ms"],
        "device_idle_share": profile["device_idle_share"],
        "device_ms_by_kind": profile["device_ms_by_kind"],
        "logit_scale": float(state.model.logit_scale.detach()), "agreement": agreement, "card": smi,
    }
    log("train_b16 " + json.dumps(report))
    if (agreement["loss_rel_diff"] > 1e-2 or agreement["grad_cos"] < 0.99
            or agreement["bank_row_cos_min"] < 0.999):
        raise RuntimeError(f"ViT-B/16 kernel and plain routes disagree: {agreement}")
    del model, state, step_fn
    torch.cuda.empty_cache()
    remat_launches = phase_train_b16_remat(smi, train, cfg, launches, peak,
                                           profile["device_busy_ms"])
    return {k: launches[k] + remat_launches[k] for k in launches}


def phase_train_b16_remat(smi: str, train: dict, cfg, packed_launches: dict, packed_peak: int,
                          packed_busy_ms: float):
    """packed_b16_remat: the ViT-B/16 step with both towers rematerialised,
    from fresh seed-0 weights. Its 10 counted steps must launch exactly what
    packed_b16's did (no attention forward runs again in the backward) and
    peak below its memory; from one batch and one generator, the first step's
    loss equals the step's without remat and the gradients agree at cosine
    >= 0.9999."""
    from latteclip_torch.data import transforms as T
    from latteclip_torch.data.packing import PackRowBucketer
    from latteclip_torch.models import clip as clip_mod
    from latteclip_torch.train import optim, state as St, step as S

    tok, classes, templates = train["tok"], train["classes"], train["templates"]
    table, tpl = train["table"], train["tpl"]
    rng = np.random.default_rng(16)
    bucket = PackRowBucketer(multiple=8)
    batches = [train_batch(rng, TRAIN_BATCH_B16, cfg.vision.image_size, len(classes),
                           tok.eot_token_id, bucket, PACK_LEN) for _ in range(2)]
    model = clip_mod.init_clip_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    bank = St.init_memory_bank(model, tok, classes, templates)
    table_t = torch.from_numpy(table).cuda()
    tpl_t = tuple(torch.from_numpy(a).cuda() for a in tpl)
    images = T.train_augment_normalize(batches[0]["images"],
                                       torch.Generator(device="cuda").manual_seed(0),
                                       T.AugConfig(), *T.model_mean_std(cfg))
    state = St.create_train_state(
        model, optim.make_optimizer(model, optim.make_schedule("const", 1e-5, warmup=0)), bank)
    first = {remat: route_gradients(model, S.LatteHParams(text_packing=True, remat=remat),
                                    batches[0], images, state, table_t, tpl_t, "kernel")
             for remat in (False, True)}
    first_step = agree(first[True], first[False])
    first_step_equal = first[True][0] == first[False][0]
    del images, first
    model.zero_grad(set_to_none=True)
    step_fn = S.make_train_step(model, S.LatteHParams(text_packing=True, remat=True), table,
                                T.AugConfig(), template_packed=tpl)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, warm_losses = timed_steps(step_fn, state, batches, gen, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ips, losses, launches = counted_steps(step_fn, state, batches, gen, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    log(f"train kernels packed_b16_remat: {json.dumps(launches)}")
    check_state(state, warm_losses + losses, "packed_b16_remat route")
    profile = device_profile(lambda: step_fn(state, batches[0], gen))
    log("profile train_step_packed_b16_remat " + json.dumps(profile))
    report = {
        "model": cfg.name, "batch": TRAIN_BATCH_B16, "steps": TRAIN_STEPS, "remat": "both towers",
        "images_per_s": ips, "losses": losses, "launches": launches,
        "max_memory_allocated": peak, "max_memory_allocated_packed_b16": packed_peak,
        "device_busy_ms_per_step": profile["device_busy_ms"],
        "device_busy_ms_per_step_packed_b16": packed_busy_ms,
        "device_idle_share": profile["device_idle_share"],
        "device_ms_by_kind": profile["device_ms_by_kind"],
        "first_step": first_step, "first_step_loss_equal": first_step_equal,
        "card": smi,
    }
    log("train_b16_remat " + json.dumps(report))
    if launches != packed_launches:
        raise RuntimeError(f"packed_b16_remat launched {launches}, packed_b16 {packed_launches}")
    if peak >= packed_peak:
        raise RuntimeError(f"packed_b16_remat peaked at {peak} bytes, packed_b16 at {packed_peak}")
    if first_step["loss_rel_diff"] > 1e-6 or first_step["grad_cos"] < 0.9999:
        raise RuntimeError(f"remat and no remat disagree on the first step: {first_step}")
    return launches


# -- phase 7: the training entry point -----------------------------------------

CLI_MODEL, CLI_BATCH = "ViT-B-32", 512
CLI_ARGS = ["--dataset-type", "synthetic", "--model", CLI_MODEL, "--batch-size", str(CLI_BATCH),
            "--lr", "1e-5", "--warmup", "1", "--save-frequency", "1", "--zeroshot-frequency", "1",
            "--no-save-most-recent", "--name", "cli"]
_TRAIN_LINE = re.compile(r"Train Epoch: (\d+) \[\s*(\d+)/\d+\] Data \(t\): ([0-9.]+) "
                         r"Batch \(t\): ([0-9.]+), ([0-9.e+]+)/s.*?LR: ([0-9.]+) .*?"
                         r"Loss: ([0-9.e+-]+|nan|inf)")
_RESUMED = re.compile(r"resumed from .* \(epoch (\d+), step (\d+)\)")


class _Messages(logging.Handler):
    """Collects the formatted messages of the port's logger."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _patch(obj, name, make):
    """Replace obj.name by make(original); returns the undo."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    return lambda: setattr(obj, name, orig)


def htod_profile(prof) -> dict:
    """Memcpy HtoD of a torch.profiler trace: ms, whether every copy came
    from pinned memory, and the share of copy time that overlapped a kernel."""
    from torch.autograd import DeviceType

    copies, kernels = [], []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        span = (ev.time_range.start, ev.time_range.end)
        if "memcpy htod" in ev.name.lower():
            copies.append((span, ev.name))
        elif "memcpy" not in ev.name.lower() and "memset" not in ev.name.lower():
            kernels.append(span)
    overlap = 0
    for (a, b), _ in copies:
        covered = sorted((max(a, c), min(b, d)) for c, d in kernels if c < b and d > a)
        end = a
        for c, d in covered:
            overlap += max(0, d - max(c, end))
            end = max(end, d)
    total = sum(b - a for (a, b), _ in copies)
    by_name = {}
    for (a, b), name in copies:
        n, ms = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, ms + (b - a) / 1e3)
    longest = sorted(((b - a) / 1e3, name) for (a, b), name in copies)[-4:]
    return {"htod_ms": total / 1e3, "htod_copies": len(copies), "htod_by_name": by_name,
            "htod_longest": longest,
            # the batch's arrays are the long copies; a few small constants
            # (mean, std) go from pageable memory
            "htod_pinned": bool(copies) and "pinned" in longest[-1][1].lower(),
            "htod_overlap_share": overlap / total if total else None}


def run_cli(argv, step_launches, eval_launches, init_launches, timings, profile_epoch=None):
    """latteclip_torch.train.main.main(argv) with the launches of every
    step, eval and bank init recorded, the checkpoint writes timed, and, for
    ``profile_epoch``, that epoch's steps and copies traced."""
    from torch.profiler import ProfilerActivity, profile

    from latteclip_torch.train import loop as L, main as M

    def counted(fn, out):
        def wrapper(*args, **kwargs):
            before = read_counts()
            result = fn(*args, **kwargs)
            after = read_counts()
            out.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
            return result
        return wrapper

    def train(orig):
        return lambda state, step_fn, *a, **k: orig(state, counted(step_fn, step_launches), *a, **k)

    def timed(orig):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            orig(*args, **kwargs)
            timings.append(time.perf_counter() - t0)
        return wrapper

    epochs_seen = []

    def traced_prefetch(orig):
        def wrapper(*args, **kwargs):
            epochs_seen.append(None)
            if len(epochs_seen) - 1 != profile_epoch:
                return orig(*args, **kwargs)

            def gen():
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    yield from orig(*args, **kwargs)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                timings.append({"profile": prof, "wall_ms": wall})
            return gen()
        return wrapper

    undo = [_patch(L, "train", train),
            _patch(L, "evaluate_zero_shot", lambda f: counted(f, eval_launches)),
            _patch(M, "init_memory_bank", lambda f: counted(f, init_launches)),
            _patch(L, "save_epoch_checkpoint", timed),
            _patch(L, "prefetch", traced_prefetch)]
    try:
        if M.main(argv) != 0:
            raise RuntimeError(f"main({argv}) returned non-zero")
    finally:
        for u in undo:
            u()


def phase_cli(smi: str):
    """The training entry point at ViT-B/32, batch 512, on the card
    (python -m latteclip_torch.train.main, called in process): (a) 2 epochs
    of 2 steps on the synthetic fixture (1024 train and 32 val images at 224
    px, written by the port's data/synthetic.py), captions packed at 128, the
    crop on the device; (b) --resume latest for a third epoch; (c)
    --lock-image --accum-freq 2 --grad-clip-norm 1.0 for one epoch."""
    import tempfile

    from latteclip_torch import checkpoint as ckpt
    from latteclip_torch.config import get_model_config
    from latteclip_torch.models import clip as clip_mod
    from latteclip_torch.train import optim

    messages = _Messages()
    logging.getLogger("latteclip_torch").addHandler(messages)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    old_tempdir, tempfile.tempdir = tempfile.tempdir, workdir
    layers = get_model_config(CLI_MODEL).text.layers
    totals = dict.fromkeys(read_counts(), 0)
    try:
        logs = os.path.join(workdir, "logs")
        ckpt_dir = os.path.join(logs, "cli", "checkpoints")

        # (a) two epochs, traced second epoch
        steps, evals, inits, timings = [], [], [], []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        run_cli([*CLI_ARGS, "--text-packing", "128", "--epochs", "2", "--logs", logs],
                steps, evals, inits, timings, profile_epoch=1)
        counts_a = read_counts()
        peak = torch.cuda.max_memory_allocated()
        lines = [m for m in (_TRAIN_LINE.search(x) for x in messages.lines) if m]
        losses = [float(m.group(7)) for m in lines]
        per_step = {"flash_fwd_seg": 3 * layers, "flash_bwd_seg": 3 * layers}
        want_eval = {"flash_fwd_seg": layers}   # one eval batch of 64 (32 images padded), in pairs
        trace = next(t for t in timings if isinstance(t, dict))
        writes = [t for t in timings if not isinstance(t, dict)]
        htod = htod_profile(trace["profile"])
        with open(os.path.join(ckpt_dir, "results.jsonl")) as f:
            results = [json.loads(x) for x in f]
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, "epoch_2.pt"))
        saved = torch.load(os.path.join(ckpt_dir, "epoch_2.pt"), map_location="cpu",
                           weights_only=True)["optimizer"]
        report = {
            "model": CLI_MODEL, "batch": CLI_BATCH, "steps": len(steps), "evals": len(evals),
            "images_per_s": float(lines[-1].group(5)),
            "data_wait_share": float(lines[-1].group(3)) / float(lines[-1].group(4)),
            "losses": losses, "launches_per_step": steps, "eval_launches": evals,
            "bank_init_launches": inits, "max_memory_allocated": peak,
            "profiled_epoch": {"steps": 2, "wall_ms": trace["wall_ms"], **htod},
            "checkpoint_bytes": ckpt_bytes, "checkpoint_write_s": writes,
            "eval_top1": results[-1]["top1"], "results": results,
        }
        bad = []
        if len(steps) != 4 or any(d != per_step for d in steps):
            bad.append(f"step launches {steps}, expected 4 x {per_step}")
        if len(evals) != 2 or any(d != want_eval for d in evals):
            bad.append(f"eval launches {evals}, expected 2 x {want_eval}")
        if inits != [{"flash_fwd": layers}]:
            bad.append(f"bank init launches {inits}, expected [{{'flash_fwd': {layers}}}]")
        if len(losses) != 4 or not all(np.isfinite(losses)):
            bad.append(f"losses {losses}")
        for name in ("epoch_1.pt", "epoch_2.pt"):
            if not os.path.exists(os.path.join(ckpt_dir, name)):
                bad.append(f"{name} missing")

        # (b) resume the latest checkpoint for a third epoch
        messages.lines.clear()
        restored = []

        def checked_restore(orig):
            def wrapper(model, optimizer, saved_entry, accum=None):
                orig(model, optimizer, saved_entry, accum)
                again = ckpt.optimizer_state(model, optimizer, accum)
                restored.append(sorted(again) == sorted(saved_entry) and all(
                    torch.equal(again[k], saved_entry[k]) for k in saved_entry))
            return wrapper

        undo = _patch(ckpt, "restore_optimizer_state", checked_restore)
        steps_b, evals_b, inits_b = [], [], []
        reset_counts()
        try:
            run_cli([*CLI_ARGS, "--text-packing", "128", "--epochs", "3", "--logs", logs,
                     "--resume", "latest"], steps_b, evals_b, inits_b, [])
        finally:
            undo()
        counts_b = read_counts()
        resumed = next(m for m in (_RESUMED.search(x) for x in messages.lines) if m)
        lines_b = [m for m in (_TRAIN_LINE.search(x) for x in messages.lines) if m]
        want_lr = "%f" % optim.make_schedule("cosine", 1e-5, 1, 6)(4)
        report["resume"] = {"epoch": int(resumed.group(1)), "step": int(resumed.group(2)),
                            "first_lr": lines_b[0].group(6), "schedule_lr_at_4": want_lr,
                            "moments_restored": restored,
                            "optimizer_leaves": len(saved),
                            "losses": [float(m.group(7)) for m in lines_b]}
        if (int(resumed.group(1)), int(resumed.group(2))) != (2, 4):
            bad.append(f"resumed at {resumed.group(0)}, expected epoch 2, step 4")
        if lines_b[0].group(6) != want_lr or int(lines_b[0].group(1)) != 2:
            bad.append(f"first resumed line {lines_b[0].group(0)}, expected LR {want_lr}")
        if restored != [True]:
            bad.append(f"moments not restored as saved: {restored}")
        if len(steps_b) != 2 or any(d != per_step for d in steps_b):
            bad.append(f"resumed step launches {steps_b}")

        # (c) locked image tower, accumulation over 2 calls, clipping
        messages.lines.clear()
        logs_c = os.path.join(workdir, "logs_c")
        steps_c, evals_c, inits_c = [], [], []
        reset_counts()
        run_cli([*CLI_ARGS, "--text-packing", "128", "--epochs", "1", "--logs", logs_c,
                 "--lock-image", "--accum-freq", "2", "--grad-clip-norm", "1.0"],
                steps_c, evals_c, inits_c, [])
        counts_c = read_counts()
        obj = torch.load(os.path.join(logs_c, "cli", "checkpoints", "epoch_1.pt"),
                         map_location="cpu", weights_only=True)
        start = clip_mod.init_clip_params(torch.Generator().manual_seed(0),
                                          get_model_config(CLI_MODEL), device="cpu")
        visual_equal = all(torch.equal(obj["state_dict"][n], p.detach())
                           for n, p in start.named_parameters() if n.startswith("visual."))
        text_moved = [n for n, p in start.named_parameters()
                      if not n.startswith("visual.") and n != "logit_scale"
                      and not torch.equal(obj["state_dict"][n], p.detach())]
        opt = obj["optimizer"]
        report["locked"] = {"step": obj["step"], "visual_bit_equal": visual_equal,
                            "text_params_moved": len(text_moved),
                            "mini_step": int(opt[".mini_step"]),
                            "gradient_step": int(opt[".gradient_step"]),
                            "schedule_count": int(opt[".inner_opt_state[1][0][2].count"])}
        if not visual_equal or not text_moved:
            bad.append(f"locked run: visual bit-equal {visual_equal}, text moved {len(text_moved)}")
        if (obj["step"], report["locked"]["gradient_step"], report["locked"]["schedule_count"]) \
                != (2, 1, 1):
            bad.append(f"locked run: {report['locked']}, expected 2 calls and 1 update")
        report["card"] = smi
        log("cli " + json.dumps(report))
        if bad:
            raise RuntimeError("training entry point: " + "; ".join(bad))
        for counts in (counts_a, counts_b, counts_c):
            for k in totals:
                totals[k] += counts[k]
        return totals
    finally:
        tempfile.tempdir = old_tempdir
        logging.getLogger("latteclip_torch").removeHandler(messages)
        shutil.rmtree(workdir, ignore_errors=True)


def ptxas_warnings(lines) -> list:
    """ptxas's warnings and advisories (a setmaxnreg ignored) and its
    performance notes and wgmma notes (a wgmma serialised, or a
    warpgroup.arrive it injected, which it reports as info, numbered C75xx)."""
    return [ln for ln in lines
            if any(w in ln.lower() for w in ("warning", "advisory", "performance loss", "(c75"))]


def ptxas_usage(lines) -> dict:
    """{kernel<template args>: "N registers, S bytes spilled"} from -Xptxas -v."""
    usage, kernel = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '\S*?\d((?:flash|ln|lab)_[a-z_]+?_kernel)(I(?:L[ib]\d+E)+)?",
                      line)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
            kernel = m.group(1) + (f"<{','.join(args)}>" if args else "")
            usage[kernel] = ""
        elif kernel and "spill stores" in line:
            usage[kernel] = line.split(",")[1].strip().replace(" stores", "")
        elif kernel and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            usage[kernel] = f"{regs} registers, {usage[kernel]}"
    return usage


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from latteclip_torch.kernels import build

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    # flash_bwd.cu once more with every row sent to the tiled pair, for the
    # design comparison of the kernel phase; it builds beside the others
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tiled_path = build.BUILD_DIR / "flash_bwd_tiled_only.so"
    tiled_nvcc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-DLATTECLIP_BWD_SHORT_ROW=0", "-o", str(tiled_path),
         str(build.SOURCES["flash_bwd"])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        build.load_all()
    finally:
        tiled_out, _ = tiled_nvcc.communicate()
    if tiled_nvcc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the tiled-only flash_bwd.cu:\n{tiled_out}")
    tiled_lib = ctypes.CDLL(str(tiled_path))
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, rec in build.build_log.items():
        log(f"  {name}.cu: nvcc {rec['seconds']:.1f} s")
        for kernel, usage in ptxas_usage(rec["ptxas"]).items():
            log(f"    {kernel}: {usage}")
        for line in ptxas_warnings(rec["ptxas"]):
            log(f"    ptxas: {line}")

    train = train_inputs()
    records = phase_kernels(train, tiled_lib)
    lab_records, lab_launches = phase_lab(smi)
    records += lab_records
    slice_launches = phase_slice(smi)
    b16_launches = phase_slice_b16(smi)
    train_launches = phase_train(smi, train)
    torch.cuda.empty_cache()
    b16_train_launches = phase_train_b16(smi, train)
    torch.cuda.empty_cache()
    cli_launches = phase_cli(smi)

    kernels = []
    for name in SOURCES:
        rec = next(r for r in records if r["name"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(w.get(name, 0) for w in (slice_launches, b16_launches, train_launches,
                                                     b16_train_launches, lab_launches,
                                                     cli_launches)),
            "max_abs_err": max(r["max_abs_err"] for r in records if r["name"] == name),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
