"""Readings that the limits of ``limits/<workload>.json`` are set from, beyond
the benchmark's own runs (which print the program's readings on every run):

* ``control`` (train cells): the precision below the program's, the
  reference computed in fp8 (``reference.Arith("fp8")``) put in the
  program's place.
* ``half`` (train cells): a train step that leaves half of the batch out
  and takes the mean over the rest, planted in the reference put in the
  program's place.
* ``fp8`` (the eval cell's control): the reference computed in fp8 in the
  program's place.
* ``alter`` (eval cells): an eval step that alters an answer where it is
  produced (each request's first row of logits negated), in the program.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --faults control,half

Each reading prints as one JSON line. The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run  # noqa: E402  (sets the cache directories first)


def train_readings(ctx, fault: str) -> dict:
    """compare(faulty or lower-precision reference, float32 reference)."""
    from benchmark import reference as R
    from benchmark import traffic
    from benchmark import train_cell as TC

    mix, d = ctx.mix, ctx.dims
    pool = traffic.train_pool(mix, ctx.seed, d.image, d.ctx, ctx.dev, pinned=False)
    ref = TC.reference_readings(ctx, pool)
    if fault == "control":
        other = TC.reference_readings(ctx, pool, ar=R.Arith("fp8"))
    elif fault == "half":
        other = TC.reference_readings(ctx, pool, keep=mix["batch"] // 2)
    else:
        raise ValueError(f"a train cell takes control or half, not {fault}")
    return TC.compare(other, ref)


def eval_fp8_readings(ctx) -> dict:
    """compare(fp8 reference, float32 reference) on the images of as many
    requests as a run checks."""
    from benchmark import eval_cell as EC
    from benchmark import reference as R
    from benchmark import traffic

    mix, d = ctx.mix, ctx.dims
    pool = traffic.eval_pool(mix, ctx.seed, d.image, ctx.dev, pinned=False)
    images = np.concatenate([b["images"] for b in pool[:mix["check_requests"]]])
    return EC.compare(EC.reference_logits(ctx, images, R.Arith("fp8")),
                      EC.reference_logits(ctx, images))


def patch_eval(fault: str):
    """Alter the program's answers; returns the function that undoes it."""
    import torch

    from latteclip_torch.eval import zero_shot as zs

    if fault == "alter":
        make = zs.make_eval_step

        def altered(*a, **k):
            step = make(*a, **k)

            def serve(images):
                logits = step(images)
                return torch.cat([-logits[:1], logits[1:]])

            return serve

        zs.make_eval_step = altered
        return lambda: setattr(zs, "make_eval_step", make)
    raise ValueError(f"an eval cell takes fp8 or alter, not {fault}")


def main(argv=None, device=None, root=run.ROOT) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="control")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    m = run.manifest(root)
    wl, raw, mix = run.find_cell(m, args.workload, root)
    for fault in args.faults.split(","):
        undo = patch_eval(fault) if mix["kind"] == "eval" and fault != "fp8" else (lambda: None)
        for seed in (int(s) for s in args.seeds.split(",")):
            cell = ["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds)]
            ctx = run.Ctx(run.parse(cell), wl, raw, mix, device or "cuda", run.T0, root)
            if mix["kind"] == "train":
                numbers = train_readings(ctx, fault)
            elif fault == "fp8":
                numbers = eval_fp8_readings(ctx)
            else:
                numbers = {"harness_exit": run.main(cell + ["--trace", "0"], device=device, root=root)}
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault, **numbers}),
                  flush=True)
        undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
