#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (latteclip_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each raising on failure:

1. device: require CUDA; print the card, the device count and nvidia-smi's
   name and power limit;
2. build: compile the kernel source with nvcc and print the build seconds
   and the -Xptxas -v lines;
3. kernels: each Hopper kernel against its plain PyTorch version on the card,
   in bf16, at the shapes the serving path gives it, with q and k drawn from
   N(0, 0.3^2) and v from N(0, 1) (tolerances: out elementwise
   atol = rtol = 2e-2 and ||out - plain|| / ||plain|| <= 1e-2, lse2 atol
   1e-3); as a control, the out check must reject the plain version run with
   the values of one 16-key block zeroed. Each case prints the kernel's time,
   the plain version's, a library yardstick (F.scaled_dot_product_attention,
   timed only) and the bound max(FLOP / 989e12, bytes / 3.35e12);
4. slice: ViT-B/32 zero-shot classification at full width from seeded random
   weights: the 1000-class ImageNet template classifier, run_zero_shot_eval
   over four batches of 256 images and one of 255, and the prototype
   classifier from a seeded bank; the launch counters are reset just before
   and read just after, and every kernel of the path must have launched.
   The same requests then run with the plain attention forced; image
   features and classifier columns must agree with cosine >= 0.999 and
   prototype top-1 on >= 99% of rows. A torch.profiler trace of the
   classifier build and of the eval gives each one's device busy time and
   idle share, and its device time by kind (attention, GEMM, copies, other);
5. report: one JSON line of kernels, nvidia-smi's line, and the final line
   {"ok": true, "device": {...}}.

Exits non-zero without a result when CUDA is absent or the package is missing.
"""
from __future__ import annotations

import copy
import dataclasses
import json
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
# q and k entries ~ N(0, 0.3^2), as the JAX kernel tests draw them, so that
# rows stay flat enough for LSE_TOL; v does not enter lse2 and is N(0, 1)
QK_STD = 0.3
SOURCE = "latteclip_torch/kernels/csrc/flash_fwd.cu"
REPLACES = {
    "flash_fwd": "latteclip_tpu/kernels/attention.py:318",      # _fwd_kernel
    "flash_fwd_seg": "latteclip_tpu/kernels/attention.py:415",  # _fwd_kernel_seg
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions -----------------------------

class Timer:
    """Median CUDA-event time of one call, with L2 flushed before each call."""

    def __init__(self, iters: int = 20):
        self.iters = iters
        self.flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(self.iters)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in ev]))


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


def kernel_case(name, B, L, H, D, causal, seg_np, timer, gen):
    from latteclip_torch.kernels import attention as A

    qkv = draw_qkv(gen, B, L, H, D)
    if seg_np is None:
        kernel = lambda: A.flash_attention_qkv(qkv, H, causal)  # noqa: E731
        plain_of = lambda x: A.flash_fwd_plain(x, H, causal)  # noqa: E731
        seg = None
        idx = torch.arange(L, device="cuda")
        visible = (idx[None, :] <= idx[:, None]) if causal else torch.ones(L, L, dtype=torch.bool, device="cuda")
        pairs = int(visible.sum()) * B
        mask = None
    else:
        seg = torch.from_numpy(seg_np).cuda()
        kernel = lambda: A.flash_attention_qkv_segmented(qkv, H, seg, causal)  # noqa: E731
        plain_of = lambda x: A.flash_fwd_seg_plain(x, seg, H, causal)  # noqa: E731
        visible = seg[:, :, None] == seg[:, None, :]
        if causal:
            idx = torch.arange(L, device="cuda")
            visible = visible & (idx[None, :] <= idx[:, None])
        pairs = int(visible.sum())
        mask = visible[:, None]
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
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    rec = {
        "name": name, "shape": [B, L, 3 * H * D], "heads": H, "head_dim": D, "causal": causal,
        "max_abs_err": err_out, "out_rel_err": rel_out, "max_abs_err_lse2": err_lse, "ok": ok,
        "control_rel_err": rel_dropped, "control_rejected": control_rejected,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_flops, t_bytes), "bound_by": "operations" if t_flops > t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    rec["bound_share"] = rec["bound_ms"] / ms
    log("kernel_case " + json.dumps(rec))
    return rec


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rng = np.random.default_rng(1234)
    timer = Timer()
    pair = np.repeat(np.array([1, 2], np.int32), 50)
    cases = [
        # (kernel, B, L, H, D, causal, seg ids or None); the first of each
        # kernel is the one the report line carries
        ("flash_fwd", 1000, 77, 8, 64, True, None),        # text classifier build
        ("flash_fwd", 255, 50, 12, 64, False, None),       # odd vision batch
        ("flash_fwd", 64, 197, 12, 64, False, None),       # ViT-B/16 vision
        ("flash_fwd", 8, 577, 16, 64, False, None),        # 336 px vision
        ("flash_fwd", 64, 197, 6, 128, False, None),       # head_dim 128
        ("flash_fwd_seg", 128, 100, 12, 64, False, np.tile(pair, (128, 1))),  # vision pairs
        ("flash_fwd_seg", 64, 128, 8, 64, True, random_segments(rng, 64, 128)),  # packed text
        ("flash_fwd_seg", 64, 100, 6, 128, False, np.tile(pair, (64, 1))),      # head_dim 128
    ]
    records = [kernel_case(n, B, L, H, D, c, s, timer, gen) for n, B, L, H, D, c, s in cases]
    del timer
    torch.cuda.empty_cache()
    bad = [(r["name"], r["shape"], r["max_abs_err"], r["out_rel_err"], r["max_abs_err_lse2"])
           for r in records if not r["ok"]]
    if bad:
        raise RuntimeError("kernels disagree with their plain versions "
                           f"(name, shape, |dout|, rel dout, |dlse2|): {bad}")
    blind = [(r["name"], r["shape"], r["control_rel_err"]) for r in records if not r["control_rejected"]]
    if blind:
        raise RuntimeError(f"the out check missed a dropped value block (name, shape, rel dout): {blind}")
    return records


# -- phase 4: the ViT-B/32 zero-shot slice -----------------------------------

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
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        name = ev.name.lower()
        kind = ("attention" if "flash_fwd" in name else
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


def phase_slice(smi: str):
    from latteclip_torch.config import get_model_config
    from latteclip_torch.data import transforms as T
    from latteclip_torch.data.eval_dataset import get_templates, imagenet_classnames
    from latteclip_torch.eval import zero_shot as zs
    from latteclip_torch.kernels import attention as A
    from latteclip_torch.models import clip as clip_mod
    from latteclip_torch.models.tokenizer import get_tokenizer

    cfg = get_model_config("ViT-B-32")
    model = clip_mod.init_clip_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    tok = get_tokenizer()
    classnames, templates = imagenet_classnames(), get_templates("imagenet")
    rng = np.random.default_rng(0)
    exemplars = exemplar_images(rng, len(classnames), cfg.vision.image_size)
    batches = seeded_batches(rng, exemplars, (256, 256, 256, 256, 255))
    mean, std = T.model_mean_std(cfg)
    # the seeded memory bank [1000, 512]: class prototypes are the exemplars'
    # features (plain route), as LatteCLIP's bank holds image features per class
    with torch.no_grad():
        bank = torch.cat([
            clip_mod.encode_image(model, T.normalize_images(torch.from_numpy(e).cuda(), mean, std),
                                  attention="plain")
            for e in np.array_split(exemplars, 4)])

    # warm-up of both routes (cuBLAS heuristics, allocator), neither timed nor counted
    for attention in ("kernel", "plain"):
        run_requests(model, tok, classnames, templates, [batches[0], batches[-1]], bank, attention)

    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    fast = run_requests(model, tok, classnames, templates, batches, bank, "kernel")
    launches = dict(A.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    log(f"slice kernels: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} never launched on the ViT-B/32 path")

    A.reset_launch_counts()
    slow = run_requests(model, tok, classnames, templates, batches, bank, "plain")
    if any(A.launch_counts.values()):
        raise RuntimeError(f"plain run launched kernels: {A.launch_counts}")

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
        "max_memory_allocated": peak, "card": smi,
    }
    log("slice " + json.dumps(report))
    if cos_min < 0.999 or clf_cos < 0.999:
        raise RuntimeError(f"features disagree: min cosine {cos_min} (images), {clf_cos} (classifier)")
    if agree / rows < 0.99:
        raise RuntimeError(f"top-1 agrees on only {agree / rows:.4f} of rows")
    return launches


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
    build.load()
    log(f"build {build.SOURCE.name}: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_log['seconds']:.1f} s)")
    for line in build.build_log["ptxas"]:
        log(f"  {line}")

    records = phase_kernels()
    launches = phase_slice(smi)

    kernels = []
    for name in ("flash_fwd", "flash_fwd_seg"):
        rec = next(r for r in records if r["name"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name],
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
