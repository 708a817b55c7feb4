"""A zero-shot serving cell: the port's classifier from
``eval/zero_shot.py::build_zero_shot_classifier`` (set-up), then requests of
``request_images`` images in a closed loop with one client, each through
``eval/zero_shot.py::on_device`` (pinned memory, copied a request ahead on a
side stream) into ``make_eval_step``, its logits brought to the host as
``run_zero_shot_eval`` does. A request's latency runs from when the client
asks for its batch to when its logits are on the host.
"""
from __future__ import annotations

import gc
import sys
import threading
import time

import numpy as np
import torch

from benchmark import flops, trace, traffic
from benchmark import reference as R


def compare(prog: np.ndarray, ref: np.ndarray) -> dict:
    """The largest logit error over the images checked. The widest gap by
    which the reference's logit of the class the program ranks first lies
    below the reference's best goes to standard error: the fp8 control
    reads 0 there on some seeds, so no limit on it holds."""
    rows = np.arange(len(ref))
    top1_gap = float((ref.max(axis=1) - ref[rows, prog.argmax(axis=1)]).max())
    print(f"top1_gap {top1_gap}", file=sys.stderr)
    return {"logit_err": float(np.abs(prog - ref).max())}


def class_table(ctx):
    """(classnames, templates, tokenizer) of the mix: the first ``classes``
    ImageNet class names and the mix's templates."""
    from latteclip_torch.eval.imagenet_metadata import imagenet_classnames

    mix = ctx.mix
    classnames = list(imagenet_classnames()[:mix["classes"]])
    templates = [t.format for t in mix["templates"]]
    tok = traffic.SeededTokenizer(ctx.seed, ctx.dims.ctx, *mix["template_len"])
    return classnames, templates, tok


def reference_table(ctx) -> np.ndarray:
    """[C x T, ctx] class-major: every class's prompts, tokenized by the
    benchmark."""
    classnames, _, tok = class_table(ctx)
    return tok([t.format(c) for c in classnames for t in ctx.mix["templates"]])


def reference_logits(ctx, images: np.ndarray, ar=None) -> np.ndarray:
    R.strict_float32()
    d, dev = ctx.dims, ctx.dev
    weights = R.make_weights(d, ctx.seed, dev)
    return R.zero_shot_logits(weights, d, torch.from_numpy(reference_table(ctx)).to(dev),
                              torch.from_numpy(images).to(dev), ar or R.Arith(),
                              templates=len(ctx.mix["templates"])).cpu().numpy()


def run(ctx) -> dict:
    from latteclip_torch.eval import zero_shot as zs

    mix, d, dev, seed = ctx.mix, ctx.dims, ctx.dev, ctx.seed
    N, C = mix["request_images"], mix["classes"]
    model = ctx.load_model(R.make_weights(d, seed, dev))
    ctx.mark("weights_model")
    classnames, templates, tok = class_table(ctx)
    classifier = zs.build_zero_shot_classifier(model, tok, classnames, templates, chunk_classes=C)
    step = zs.make_eval_step(model, classifier)
    ctx.mark("classifier")
    pool = traffic.eval_pool(mix, seed, d.image, dev, pinned=ctx.cuda)
    ctx.mark("pool")
    stop = threading.Event()

    def feed():
        i = 0
        while not stop.is_set():
            b = pool[i % len(pool)]
            yield i % len(pool), b["images"], b["labels"], N
            i += 1

    requests = zs.on_device(feed(), dev)

    def request():
        slot, images, _, valid = next(requests)
        a = time.perf_counter()
        logits = step(images)
        b = time.perf_counter()
        return slot, logits[:valid].cpu(), b - a

    for _ in range(mix["warm_requests"]):
        request()
    ctx.sync()
    ctx.mark("warmup")

    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    served, latency, dispatch = [], [], []
    while True:
        a = time.perf_counter()
        slot, logits, disp = request()
        b = time.perf_counter()
        served.append((slot, logits))
        latency.append(b - a)
        dispatch.append(disp)
        if b - t_start >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_start
    n = len(served)
    failed = sum(int(not torch.isfinite(lg).all()) for _, lg in served)
    records = {"kind": "eval", "window": {
        "seconds": window_s, "steps": n, "images": n * N, "flops": n * flops.eval_request(d, N, C)},
        "host": {"dispatch_s": dispatch}}
    if ctx.trace:
        count = mix["trace_requests"]

        def traced(spans):
            for _ in range(count):
                with spans("request"):
                    request()

        records["trace"] = trace.profile(traced, ctx.sync, ctx.cuda)
        records["traced"] = count
        records["attention_bound_s"] = count * flops.attention_bound_s(d, N, [], backward=False)
    peak = torch.cuda.max_memory_allocated(dev) if ctx.cuda else 0
    stop.set()
    for _ in requests:
        pass
    del model, classifier, step
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()

    # a sample of the window's requests drawn from the seed, against the reference
    picks = sorted(traffic.rng(seed, 9).choice(n, min(n, mix["check_requests"]), replace=False))
    prog = np.concatenate([served[i][1].numpy() for i in picks])
    images = np.concatenate([pool[served[i][0]]["images"] for i in picks])
    numbers = compare(prog, reference_logits(ctx, images))
    checks = {k: {"value": v, "limit": ctx.limits.get(k)} for k, v in numbers.items()}
    return {"end_to_end": {"eval_images_per_s": n * N / window_s,
                           "eval_request_ms_p95": float(np.percentile(np.array(latency) * 1e3, 95)),
                           "setup_s": setup_s},
            "records": records, "attempted": n, "failed": failed, "memory_peak_bytes": peak,
            "checks": checks}
