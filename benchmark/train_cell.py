"""A fine-tune cell: the port's LatteCLIP v2 step (``train/step.py::
make_train_step``) at the mix's batch, fed as ``train/loop.py`` feeds it.

Set-up: the seed's weights loaded into the port, the seeded template table
and memory bank, the optimizer, a pool of host batches in pinned memory, and
the feed: each batch packed by ``data/packing.py`` on the thread of
``data/pipeline.py::prefetch``, which copies it to the card on a side
stream. The first ``pool_batches`` steps go through that feed and that step
as set-up, each batch of the pool once, so that every shape is warmed; the
first ``check_steps`` of them are the ones the reference follows. The window
dispatches steps ahead and syncs once at its end.
"""
from __future__ import annotations

import gc
import statistics
import sys
import threading
import time

import numpy as np
import torch

from benchmark import flops, trace, traffic
from benchmark import reference as R


def worst_leaf(prog: dict, ref: dict, leaves, med=None) -> float:
    """The largest gap of a leaf's norm between the program and the
    reference, over the larger of the reference's norm of that leaf and of
    the median leaf (of ``leaves``, unless ``med`` is given). The worst leaf
    goes to standard error."""
    med = statistics.median(ref[k] for k in leaves) if med is None else med
    gap = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}
    worst = max(gap, key=gap.get)
    top = sorted(gap, key=gap.get)[-3:]
    print(f"worst leaf {worst}: program {prog[worst]} reference {ref[worst]} median {med}; "
          f"median leaf gap {statistics.median(gap.values())}; top {[(k, gap[k]) for k in top]}",
          file=sys.stderr)
    return gap[worst]


def bank_gaps(prog: dict, ref: dict, step: str = "bank1"):
    """By class row of the memory bank: the distance between the program's
    bank and the reference's after the checked steps (rows of unit norm),
    and the distance between their changes over the first step (``step``),
    over the larger of the reference's change of that row and the median
    change of the rows it moves. The second covers the rows that either side
    moves: a row that no sample's class names stays as it was (at the
    cells' batch every class is named)."""
    rows = (prog["bank"] - ref["bank"]).norm(dim=1)
    moved = (ref[step] - ref["bank0"]).norm(dim=1)
    scale = moved[moved > 0].median() if bool((moved > 0).any()) else torch.tensor(1.0)
    changes = ((prog[step] - prog["bank0"]) - (ref[step] - ref["bank0"])).norm(dim=1)
    named = (moved > 0) | ((prog[step] - prog["bank0"]).norm(dim=1) > 0)
    return rows, (changes / moved.clamp_min(scale))[named]


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: each step's loss, the change of the parameters
    after the checked steps by leaf, and the memory bank: its worst class
    row after those steps, and the 90th percentile over class rows of its
    change over the first step (the update moves a row by about ``alpha``,
    well under the bank's rounding, so only the change shows rows that the
    update skips). Not the worst row of the change: a pseudo-label that
    flips at a tie moves a sample between two rows, and a row of a few
    samples then reads as far as under the fp8 control.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's move under Adam by round-off alone: they are left out of the
    change. The first gradient's norms by leaf, and the bank's change over
    all the checked steps, go to standard error only: the pseudo-labels'
    argmax ties on some seeds (95 of 512 samples within 0.1 of a logit), the
    program and the reference then train on other labels from the second
    step on, and sound runs read as far as the fp8 control does."""
    print(f"losses: program {prog['losses']} reference {ref['losses']}", file=sys.stderr)
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    leaves = sorted(ref["grads"])
    med = statistics.median(ref["grads"][k] for k in leaves)
    moved = [k for k in leaves if ref["grads"][k] >= 1e-3 * med]
    tensors = [k for k in leaves if ref["sizes"][k] > 1]
    for tower in ([k for k in tensors if k.startswith("visual.")],
                  [k for k in tensors if not k.startswith("visual.")]):
        worst_leaf(prog["grads"], ref["grads"], tower, med)
    rows, changes = bank_gaps(prog, ref)
    every = bank_gaps(prog, ref, "bank")[1]
    for name, v in (("bank rows", rows), ("bank changes, first step", changes),
                    ("bank changes, all steps", every)):
        q = torch.quantile(v, torch.tensor([0.5, 0.9, 1.0])).tolist()
        print(f"{name}: median {q[0]} p90 {q[1]} worst {q[2]} ({len(v)} rows)", file=sys.stderr)
    return {"loss_gap": loss_gap, "update_gap": worst_leaf(prog["updates"], ref["updates"], moved),
            "bank_gap": float(rows.max()), "bank_update_gap": float(torch.quantile(changes, 0.9))}


def class_prompts(mix):
    """The mix's class names, its one template, and every class's prompt."""
    classes = [f"class {i}" for i in range(mix["classes"])]
    return classes, [mix["template"].format], [mix["template"].format(c) for c in classes]


def reference_table(ctx) -> np.ndarray:
    """The template rows, tokenized by the benchmark from the mix's prompts."""
    tok = traffic.SeededTokenizer(ctx.seed, ctx.dims.ctx, *ctx.mix["template_len"])
    return tok(class_prompts(ctx.mix)[2])


def step_generator(dev, seed: int, i: int) -> torch.Generator:
    """The augment's draws of the run's step ``i``."""
    return torch.Generator(device=dev).manual_seed(traffic.torch_seed(seed, 100, i))


def reference_readings(ctx, pool, ar=None, keep=None) -> dict:
    """The reference's losses, first gradient's norms, change after the
    checked steps and memory bank, from the seed's weights and the
    benchmark's template rows on the pool's first batches."""
    mix, d, dev = ctx.mix, ctx.dims, ctx.dev
    R.strict_float32()
    weights = R.make_weights(d, ctx.seed, dev)
    ref = R.TrainReference(d, weights, torch.from_numpy(reference_table(ctx)).to(dev), mix["lr"],
                           mix["alpha"], ar=ar, keep=keep)
    bank0 = ref.bank.cpu()
    ref.opt.b1, ref.opt.b2 = mix["betas"]
    ref.opt.eps, ref.opt.wd = mix["eps"], mix["weight_decay"]
    losses, grads, bank1 = [], None, None
    for i in range(mix["check_steps"]):
        batch = {k: torch.from_numpy(np.asarray(pool[i][k])).to(dev)
                 for k in ("images", "zs_preds", "per_image_tokens", "per_group_tokens")}
        loss, g = ref.step(batch, step_generator(dev, ctx.seed, i))
        print(f"reference step {i}: pseudo-labels {ref.ties}", file=sys.stderr)
        losses.append(loss)
        if grads is None:
            grads, bank1 = g, ref.bank.cpu()
    with torch.no_grad():
        updates = {k: float((ref.P[k] - weights[k]).norm()) for k in weights}
    return {"losses": losses, "grads": grads, "updates": updates,
            "sizes": {k: w.numel() for k, w in weights.items()}, "bank": ref.bank.cpu(),
            "bank0": bank0, "bank1": bank1}


def run(ctx) -> dict:
    from latteclip_torch.data import packing
    from latteclip_torch.data import transforms as T
    from latteclip_torch.data.pipeline import prefetch
    from latteclip_torch.train import optim
    from latteclip_torch.train import state as St
    from latteclip_torch.train import step as S

    mix, d, dev, seed = ctx.mix, ctx.dims, ctx.dev, ctx.seed
    B, pack, K = mix["batch"], mix["text_packing"], mix["check_steps"]
    model = ctx.load_model(R.make_weights(d, seed, dev))
    ctx.mark("weights_model")
    tok = traffic.SeededTokenizer(seed, d.ctx, *mix["template_len"])
    classes, templates, _ = class_prompts(mix)
    table = St.build_template_table(tok, classes, templates)
    ctx.mark("template_table")
    bank = St.init_memory_bank(model, tok, classes, templates)
    prog = {"losses": [], "bank0": torch.as_tensor(bank).detach().float().cpu().clone()}
    ctx.mark("bank")
    b1, b2 = mix["betas"]
    opt = optim.make_optimizer(model, optim.make_schedule("const", mix["lr"], 0), beta1=b1,
                               beta2=b2, eps=mix["eps"], weight_decay=mix["weight_decay"])
    ctx.mark("optimizer")
    state = St.create_train_state(model, opt, bank)
    tpl = packing.pack_template_table(table, pack) if pack else None
    step_fn = S.make_train_step(model, S.LatteHParams(alpha=mix["alpha"], text_packing=bool(pack)),
                                table, T.AugConfig(), template_packed=tpl)
    ctx.mark("state_step")
    pool = traffic.train_pool(mix, seed, d.image, d.ctx, dev, pinned=ctx.cuda)
    P = len(pool)

    # the packer's row count only grows: give it every batch's need first,
    # as a long run would have, so that every batch ships one shape
    bucket = packing.PackRowBucketer(multiple=mix["pack_multiple"])
    captions = [np.concatenate([b["per_image_tokens"], b["per_group_tokens"]]) for b in pool]
    if pack:
        needs = [packing.pack_rows_needed(packing.token_lengths(c), pack) for c in captions]
        for n in needs:
            bucket.rows_for(n)
    seg_ids = {}
    stop = threading.Event()

    def feed():
        i = 0
        while not stop.is_set():
            b = pool[i % P]
            out = {"images": b["images"], "zs_preds": b["zs_preds"]}
            if pack:
                out.update(packing.pack_caption_batch(b["per_image_tokens"], b["per_group_tokens"],
                                                      pack, bucket.rows_for(needs[i % P])))
                seg_ids.setdefault(i % P, out["cap_seg_ids"])
            else:
                out.update(per_image_tokens=b["per_image_tokens"], per_group_tokens=b["per_group_tokens"])
            i += 1
            yield out

    batches = prefetch(feed(), size=2, device=dev if ctx.cuda else None)

    ctx.mark("pool")
    # set-up: each pool batch once through the window's feed and step
    for i in range(P):
        metrics = step_fn(state, next(batches), step_generator(dev, seed, i))
        if i < K:
            prog["losses"].append(float(metrics["loss"]))
        if i == 0:  # AdamW's first moment after one step is (1 - beta1) g
            prog["grads"] = {n: float(opt.state[p]["exp_avg"].norm()) / (1 - b1)
                             for n, p in model.named_parameters()}
            prog["bank1"] = state.memory_bank.float().cpu().clone()
        if i == K - 1:
            w0 = R.make_weights(d, seed, dev)
            with torch.no_grad():
                prog["updates"] = {n: float((p - w0[n]).norm()) for n, p in model.named_parameters()}
            prog["bank"] = state.memory_bank.float().cpu()
            del w0
    ctx.sync()
    ctx.mark("warmup")

    # the window: steps dispatched ahead, one sync at its end
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    waits, dispatch, losses = [], [], []
    n = 0
    while True:
        a = time.perf_counter()
        batch = next(batches)
        b = time.perf_counter()
        losses.append(step_fn(state, batch, step_generator(dev, seed, P + n))["loss"])
        c = time.perf_counter()
        waits.append(b - a)
        dispatch.append(c - b)
        n += 1
        if c - t_start >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t_start
    failed = int((~torch.isfinite(torch.stack(losses))).sum())

    ref_table = reference_table(ctx)
    tpl_lengths = flops.lengths_of(ref_table)
    step_flops = [flops.train_step(d, B, flops.lengths_of(c), tpl_lengths, len(classes))
                  for c in captions]
    records = {"kind": "train", "window": {
        "seconds": window_s, "steps": n, "images": n * B,
        "flops": sum(step_flops[(P + j) % P] for j in range(n))},
        "host": {"data_wait_s": waits, "dispatch_s": dispatch}}
    if ctx.trace:
        first = P + n
        count = mix["trace_steps"]

        def traced(spans):
            for j in range(count):
                with spans("data_wait"):
                    batch = next(batches)
                with spans("dispatch"):
                    step_fn(state, batch, step_generator(dev, seed, first + j))

        records["trace"] = trace.profile(traced, ctx.sync, ctx.cuda)
        records["traced"] = count

        def text_calls(slot):
            if pack:
                return [flops.packed_call(seg_ids[slot]), flops.packed_call(np.asarray(tpl.seg_ids))]
            return [flops.padded_call(captions[slot]), flops.padded_call(ref_table)]

        records["attention_bound_s"] = sum(
            flops.attention_bound_s(d, B, text_calls((first + j) % P), backward=True)
            for j in range(count))
    peak = torch.cuda.max_memory_allocated(dev) if ctx.cuda else 0
    stop.set()
    for _ in batches:
        pass
    del state, model, opt, step_fn, bank, batch, losses, metrics
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()

    ref = reference_readings(ctx, pool)
    numbers = compare(prog, ref)
    checks = {k: {"value": v, "limit": ctx.limits.get(k)} for k, v in numbers.items()}
    return {"end_to_end": {"train_images_per_s": n * B / window_s, "setup_s": setup_s},
            "records": records, "attempted": n, "failed": failed, "memory_peak_bytes": peak,
            "checks": checks}
