"""Multi-process data- and tensor-parallel smoke (port of
``tools/multihost_smoke.py``): N real ranks, each its own process, run the
LatteCLIP v2 step over the data group's global batch, then the loop's
multi-rank contract: eval on every rank, the checkpoint gathered on every
rank and written by rank 0, a resume from it on every rank, and one more
step that must equal the continuation.

    python -m latteclip_torch.tools.multihost_smoke [--world 2] [--tp 1 2]
        [--model ViT-tiny-test] [--batch-size 4] [--steps 2] [--device cpu|cuda]
        [--backend gloo|nccl] [--shared-device] [--text-packing 0|128]
        [--stage all_gather ...] [--ln-linear unfused|fused] [--fp32] [--out DIR]

Each rank draws its local batch from seed ``100 + data index`` (the ranks
of one model group read one batch). The launcher checks that the ranks
agree bit for bit on the losses, the parameter and bank checksums and the
eval, that the resumed step's loss equals the continuation's, and, where
``--tp`` exceeds 1, that each rank holds 1/K of every sharded ``c_fc``.
Then it runs one process on the concatenated global batch from the same
seeded start and holds the ranks' first step against it: in float32
(``--fp32``) loss within 1e-5 relative, the gradient's cosine >= 0.99999,
the bank within 1e-5; in bfloat16 the bounds of the train phase of
``chip_smoke.py`` (loss 1e-2 relative, gradient cosine >= 0.99, bank rows
cosine >= 0.999) and under ``--tp`` JAX's tensor-parallel ones
(``tests/test_sharding.py``: loss within 5e-3, bank 1e-3, every parameter
after the step within 2e-4, twice the learning rate). Last, the checkpoint
reloads into that one process, whose image features must equal rank 0's.

Without ``--device`` the ranks run on the CPU under gloo. On one card,
ranks share ``cuda:0`` only under gloo (``--backend gloo --shared-device``;
NCCL refuses two ranks on one device), and a collective that gloo refuses
on CUDA tensors runs through host memory where ``--stage`` names it
(:func:`probe_gloo_cuda` says which). Times are the ranks' own host clocks
around their synchronised steps, printed in seconds: ranks that share a
card share its time. Every join has a timeout and a rank that fails or
hangs fails the run, its processes killed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import socket
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from latteclip_torch import mesh as mesh_mod
from latteclip_torch.device import resolve_device

STEP_LR = 1e-4


def free_port() -> int:
    """A localhost TCP port that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, device: str, backend: Optional[str],
               shared_device: bool, queue, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * world)))
    try:
        dev = mesh_mod.initialize_distributed(device, backend, shared_device=shared_device,
                                              timeout_s=120.0)
        queue.put((rank, True, fn(rank, world, dev, *args)))
    except BaseException:  # noqa: B036 - reported to the launcher, which fails the run
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world: int, *args, device: str = "cpu", backend: Optional[str] = None,
           shared_device: bool = False, timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks
    joined in one process group (localhost, a free port) and return their
    results in rank order. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function). A rank that raises, exits early or outlasts
    ``timeout_s`` fails the call with ``RuntimeError`` or ``TimeoutError``,
    and every rank still running is killed."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, port, device, backend, shared_device, queue, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world - len(results)} of {world} ranks did not finish "
                                   f"within {timeout_s:.0f} s")
            try:
                rank, ok, value = queue.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and queue.empty():
                    raise RuntimeError(f"a rank exited with code {dead[0]} without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        queue.close()
    return [results[r] for r in range(world)]


# -- which collectives gloo takes on CUDA tensors -------------------------------

def _probe_rank(rank: int, world: int, dev: torch.device, name: str) -> bool:
    """One ``name`` collective of :data:`mesh.COLLECTIVES` on CUDA tensors:
    whether every rank holds the right values after it."""
    t = torch.full((4,), float(rank + 1), device=dev)
    if name == "all_reduce":
        dist.all_reduce(t)
        got, want = t, torch.full_like(t, world * (world + 1) / 2)
    elif name == "all_gather":
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t)
        got = torch.stack(out)
        want = torch.arange(1, world + 1, device=dev, dtype=t.dtype)[:, None].expand(-1, 4)
    elif name == "broadcast":
        dist.broadcast(t, 0)
        got, want = t, torch.ones_like(t)
    else:
        got = torch.empty_like(t)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, (rank + 1) % world),
                                           dist.P2POp(dist.irecv, got, (rank - 1) % world)]):
            req.wait()
        want = torch.full_like(t, float((rank - 1) % world + 1))
    torch.cuda.synchronize(dev)
    return bool(torch.equal(got, want))


def probe_gloo_cuda(world: int = 2, timeout_s: float = 60.0) -> Dict[str, str]:
    """{collective: "ok", "wrong values" or its error} for gloo on CUDA
    tensors, ``world`` ranks sharing ``cuda:0``, each collective in a group
    of its own (a refused one can leave its group unusable); those not "ok"
    are what ``--stage`` needs."""
    out = {}
    for name in mesh_mod.COLLECTIVES:
        try:
            ok = launch(_probe_rank, world, name, device="cuda", backend="gloo",
                        shared_device=True, timeout_s=timeout_s)
            out[name] = "ok" if all(ok) else "wrong values"
        except (RuntimeError, TimeoutError) as e:
            out[name] = " ".join(str(e).split())[-200:]
    return out


# -- the smoke ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SmokeConfig:
    model: str = "ViT-tiny-test"
    batch_size: int = 4          # per data rank
    steps: int = 2
    tp: int = 1
    classes: int = 16
    text_packing: int = 0        # 0: padded captions; else the packed row length
    ln_linear: str = "unfused"   # the LayerNorm -> projection route ("fused": K8)
    resume: bool = True          # the checkpoint, its resume and its reload
    fp32: bool = False
    stage: tuple = ()
    out: str = ""


def model_config(cfg: SmokeConfig):
    from latteclip_torch.config import get_model_config

    mcfg = get_model_config(cfg.model)
    return dataclasses.replace(mcfg, compute_dtype="float32") if cfg.fp32 else mcfg


def class_names(n: int) -> List[str]:
    return [f"class {i}" for i in range(n)]


def captions(rng: np.random.Generator, n: int, eot: int) -> np.ndarray:
    """[n, 77] seeded caption rows of 8 to 77 tokens."""
    rows = np.zeros((n, 77), np.int32)
    for i, ln in enumerate(rng.integers(8, 78, n)):
        rows[i, :ln - 1] = rng.integers(1, 40000, ln - 1)
        rows[i, ln - 1] = eot
    return rows


def data_batch(cfg: SmokeConfig, image_size: int, eot: int, data_index: int) -> Dict[str, np.ndarray]:
    """The local batch of data rank ``data_index`` (seed ``100 + data_index``)."""
    rng = np.random.default_rng(100 + data_index)
    n = cfg.batch_size
    return {"images": rng.integers(0, 256, (n, image_size, image_size, 3), dtype=np.uint8),
            "per_image_tokens": captions(rng, n, eot), "per_group_tokens": captions(rng, n, eot),
            "zs_preds": rng.integers(0, cfg.classes, n).astype(np.int32)}


def packed(cfg: SmokeConfig, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``batch`` with its captions packed at ``cfg.text_packing`` (rows a
    multiple of 8), or as it is when packing is off."""
    if not cfg.text_packing:
        return batch
    from latteclip_torch.data.packing import pack_caption_batch, pack_rows_needed, token_lengths

    lengths = token_lengths(np.concatenate([batch["per_image_tokens"], batch["per_group_tokens"]]))
    rows = -(-pack_rows_needed(lengths, cfg.text_packing) // 8) * 8
    return {**batch, **pack_caption_batch(batch["per_image_tokens"], batch["per_group_tokens"],
                                          cfg.text_packing, rows)}


def build(cfg: SmokeConfig, dev: torch.device, model=None, bank=None):
    """(state, step_fn, table, tokenizer): the v2 step, augment off, AdamW
    at a constant ``STEP_LR``, from ``model`` or seed 0 and the templates'
    bank or ``bank``."""
    from latteclip_torch.data.packing import pack_template_table
    from latteclip_torch.models import clip as clip_mod
    from latteclip_torch.models.tokenizer import get_tokenizer
    from latteclip_torch.train import optim, state as St, step as S

    mcfg = model_config(cfg)
    tok = get_tokenizer()
    names = class_names(cfg.classes)
    templates = [lambda c: f"a photo of a {c}."]
    if model is None:
        model = clip_mod.init_clip_params(torch.Generator().manual_seed(0), mcfg, device=dev)
    if bank is None:
        bank = St.init_memory_bank(model, tok, names, templates)
    table = St.build_template_table(tok, names, templates)
    optimizer = optim.make_optimizer(model, optim.make_schedule("const", STEP_LR, warmup=1))
    state = St.create_train_state(model, optimizer, bank)
    tpl = pack_template_table(table, cfg.text_packing) if cfg.text_packing else None
    hp = S.LatteHParams(augment=False, text_packing=bool(cfg.text_packing))
    return state, S.make_train_step(model, hp, table, template_packed=tpl,
                                    ln_linear=cfg.ln_linear), tok


def full_tensors(state, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``tensors`` (one a parameter, in ``model.parameters()`` order) with
    the model-sharded ones all-gathered along their split dim."""
    out = []
    for (name, _), t in zip(state.model.named_parameters(), tensors):
        dim = state.tp_dims.get(name)
        if dim is not None:
            t = torch.cat(state.mesh.all_gather(t, state.mesh.model_group), dim=dim)
        out.append(t)
    return out


def checksum(tensors) -> float:
    return float(sum(t.detach().double().abs().sum().item() for t in tensors))


def probe_images(image_size: int) -> np.ndarray:
    return np.random.default_rng(7).integers(0, 256, (8, image_size, image_size, 3), np.uint8)


def image_features(model, images: np.ndarray) -> torch.Tensor:
    from latteclip_torch.data import transforms as T
    from latteclip_torch.models import clip as clip_mod

    dev = next(model.parameters()).device
    with torch.no_grad():
        x = T.normalize_images(torch.from_numpy(images).to(dev), *T.model_mean_std(model.cfg))
        return clip_mod.encode_image(model, x, normalize=True).float().cpu()


def _launches() -> Dict[str, int]:
    from latteclip_torch.kernels import attention as A, fused_ln_linear as FL

    return {k: v for k, v in {**A.launch_counts, **FL.launch_counts}.items() if v}


def smoke_rank(rank: int, world: int, dev: torch.device, cfg: SmokeConfig) -> dict:
    """One rank of the smoke: steps, eval, checkpoint, continuation and
    resume; rank 0 also writes its first step and its gathered features to
    ``cfg.out`` for the launcher's reference."""
    from latteclip_torch import checkpoint as ckpt
    from latteclip_torch.eval.zero_shot import prototype_classifier, run_zero_shot_eval
    from latteclip_torch.kernels import attention as A, fused_ln_linear as FL
    from latteclip_torch.train import loop, optim, state as St

    t0 = time.perf_counter()
    seconds = {}

    def lap(name):
        nonlocal t0
        sync()
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = mesh_mod.make_mesh(cfg.tp, stage=cfg.stage)
    state, step_fn, tok = build(cfg, dev)
    mesh_mod.shard_train_state(state, mesh)
    image_size = state.model.cfg.vision.image_size
    batch = packed(cfg, data_batch(cfg, image_size, tok.eot_token_id, mesh.data_index))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    fc = next(p for n, p in state.model.named_parameters() if n.endswith("mlp.c_fc.weight"))
    out = {"rank": rank, "data_index": mesh.data_index, "model_index": mesh.model_index,
           "c_fc_rows": int(fc.shape[0]), "losses": [], "step_seconds": [], "seconds": seconds}
    lap("setup")

    A.reset_launch_counts()
    FL.reset_launch_counts()
    for i in range(cfg.steps):
        sync()
        t0 = time.perf_counter()
        loss = float(step_fn(state, batch)["loss"])
        sync()
        out["step_seconds"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        if i == 0:
            grads = full_tensors(state, [p.grad for p in state.model.parameters()])
            params = full_tensors(state, [p.data for p in state.model.parameters()])
            if rank == 0:
                torch.save({"loss": loss, "grad": torch.cat([g.flatten() for g in grads]).cpu(),
                            "params": torch.cat([p.flatten() for p in params]).cpu(),
                            "bank": state.memory_bank.cpu()},
                           os.path.join(cfg.out, "rank0_step1.pt"))
            del grads, params
    out["launches"] = _launches()
    lap("steps")
    out["param_checksum"] = checksum(full_tensors(state, [p.data for p in state.model.parameters()]))
    out["bank_checksum"] = checksum([state.memory_bank])

    eval_rng = np.random.default_rng(7)
    batches = [([""] * 8, eval_rng.integers(0, 256, (8, image_size, image_size, 3), np.uint8),
                eval_rng.integers(0, cfg.classes, 8), 8) for _ in range(2)]
    with mesh_mod.gathered(state, moments=False):
        out["eval"] = run_zero_shot_eval(state.model, prototype_classifier(state.memory_bank),
                                         batches)
        if rank == 0 and cfg.resume:
            torch.save(image_features(state.model, probe_images(image_size)),
                       os.path.join(cfg.out, "rank0_features.pt"))
    lap("eval")
    if not cfg.resume:
        return out

    names = class_names(cfg.classes)
    ckpt_dir = os.path.join(cfg.out, "checkpoints")
    loop_cfg = loop.LoopConfig(epochs=1, checkpoint_dir=ckpt_dir, name="smoke",
                               save_most_recent=False)
    with mesh_mod.gathered(state):
        if rank == 0:
            loop.save_epoch_checkpoint(state, names, loop_cfg, epoch=1)
    dist.barrier()
    lap("checkpoint")

    prototypes = state.prototypes.clone()
    out["cont_loss"] = float(step_fn(state, batch)["loss"])
    del state, step_fn
    r_model, r_bank, r_names, meta = ckpt.load_clip_pt(os.path.join(ckpt_dir, "epoch_1.pt"),
                                                       model_config(cfg), device=dev)
    r_state, r_step, _ = build(cfg, dev, model=r_model, bank=r_bank)
    r_state.step = int(meta["step"])
    ckpt.restore_optimizer_state(r_model, r_state.optimizer, meta["optimizer"], r_state.accum)
    r_state.prototypes = prototypes
    mesh_mod.shard_train_state(r_state, mesh)
    out["resume_loss"] = float(r_step(r_state, batch)["loss"])
    lap("resume")
    return out


def reference(cfg: SmokeConfig, dev: torch.device, data_size: int) -> dict:
    """One process, the global batch, the same start: its first step held
    against rank 0's, and rank 0's checkpoint reloaded here against rank
    0's features."""
    from latteclip_torch import checkpoint as ckpt

    state, step_fn, tok = build(cfg, dev)
    image_size = state.model.cfg.vision.image_size
    parts = [data_batch(cfg, image_size, tok.eot_token_id, d) for d in range(data_size)]
    batch = packed(cfg, {k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    loss = float(step_fn(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})["loss"])
    ours = torch.load(os.path.join(cfg.out, "rank0_step1.pt"))
    grad = torch.cat([p.grad.flatten() for p in state.model.parameters()]).cpu()
    params = torch.cat([p.data.flatten() for p in state.model.parameters()]).cpu()
    bank = state.memory_bank.cpu()
    del state
    out = {}
    if cfg.resume:
        model = ckpt.load_clip_pt(os.path.join(cfg.out, "checkpoints", "epoch_1.pt"),
                                  model_config(cfg), device=dev)[0]
        feats = image_features(model, probe_images(image_size))
        rank0_feats = torch.load(os.path.join(cfg.out, "rank0_features.pt"))
        out["reload_features_max_abs_diff"] = float((feats - rank0_feats).abs().max())
    return {**out,
        "loss": ours["loss"], "loss_ref": loss, "loss_rel_diff": abs(ours["loss"] - loss) / abs(loss),
        "loss_abs_diff": abs(ours["loss"] - loss),
        "grad_cos": float(F.cosine_similarity(ours["grad"].double(), grad.double(), dim=0)),
        "grad_rel_diff": float((ours["grad"] - grad).norm() / grad.norm()),
        "bank_max_abs_diff": float((ours["bank"] - bank).abs().max()),
        "bank_row_cos_min": float(F.cosine_similarity(ours["bank"], bank, dim=1).min()),
        "params_max_abs_diff": float((ours["params"] - params).abs().max()),
    }


def check(cfg: SmokeConfig, ranks: List[dict], ref: dict) -> List[str]:
    """The smoke's failures (empty when it passes)."""
    bad = []
    for key in ("losses", "param_checksum", "bank_checksum", "eval"):
        if any(r[key] != ranks[0][key] for r in ranks):
            bad.append(f"ranks disagree on {key}: {[r[key] for r in ranks]}")
    for r in ranks if cfg.resume else ():
        if abs(r["cont_loss"] - r["resume_loss"]) > 1e-6 * max(1.0, abs(r["cont_loss"])):
            bad.append(f"rank {r['rank']}: resume {r['resume_loss']} != continuation "
                       f"{r['cont_loss']}")
    if cfg.tp > 1:
        hidden = ranks[0]["c_fc_rows"] * cfg.tp
        if any(r["c_fc_rows"] * cfg.tp != hidden for r in ranks):
            bad.append(f"c_fc rows per rank {[r['c_fc_rows'] for r in ranks]} are not 1/{cfg.tp}")
    if cfg.fp32:
        bounds = {"loss_rel_diff": 1e-5, "bank_max_abs_diff": 1e-5,
                  "reload_features_max_abs_diff": 1e-5}
        if ref["grad_cos"] < 0.99999:
            bad.append(f"gradient cosine {ref['grad_cos']} < 0.99999")
    else:
        bounds = {"loss_rel_diff": 1e-2, "reload_features_max_abs_diff": 1e-3}
        if cfg.tp > 1:
            bounds.update(loss_abs_diff=5e-3, bank_max_abs_diff=1e-3,
                          params_max_abs_diff=2 * STEP_LR)
        if ref["grad_cos"] < 0.99 or ref["bank_row_cos_min"] < 0.999:
            bad.append(f"gradient cosine {ref['grad_cos']} < 0.99 or bank row cosine "
                       f"{ref['bank_row_cos_min']} < 0.999")
    bad += [f"{k} {ref[k]} > {v}" for k, v in bounds.items()
            if k in ref and not ref[k] <= v]
    return bad


def run(cfg: SmokeConfig, world: int, device: str = "cpu", backend: Optional[str] = None,
        shared_device: bool = False, timeout_s: float = 120.0) -> dict:
    """Launch the ranks, then the one-process reference; the report, with
    ``failures`` empty when every check holds."""
    own = not cfg.out
    out = cfg.out or tempfile.mkdtemp(prefix="multihost_smoke_")
    cfg = dataclasses.replace(cfg, out=out)
    t0 = time.perf_counter()
    try:
        ranks = launch(smoke_rank, world, cfg, device=device, backend=backend,
                       shared_device=shared_device, timeout_s=timeout_s)
        ranks_s = time.perf_counter() - t0
        ref = reference(cfg, resolve_device(device), world // cfg.tp)
        ref_s = time.perf_counter() - t0 - ranks_s
        return {"tp": cfg.tp, "world": world, "model": cfg.model, "batch_per_rank": cfg.batch_size,
                "text_packing": cfg.text_packing, "staged": sorted(cfg.stage), "ranks": ranks,
                "reference": ref, "ranks_seconds": ranks_s, "reference_seconds": ref_s,
                "seconds": time.perf_counter() - t0, "failures": check(cfg, ranks, ref)}
    finally:
        shutil.rmtree(out if own else os.path.join(out, "checkpoints"), ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--tp", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--model", default="ViT-tiny-test")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--text-packing", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--shared-device", action="store_true")
    ap.add_argument("--stage", nargs="*", default=[], choices=mesh_mod.COLLECTIVES)
    ap.add_argument("--ln-linear", default="unfused", choices=("unfused", "fused"))
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--no-resume", dest="resume", action="store_false",
                    help="skip the checkpoint, its resume and its reload")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    failed = False
    for tp in args.tp:
        out = os.path.join(args.out, f"tp{tp}") if args.out else ""
        if out:
            os.makedirs(out, exist_ok=True)
        cfg = SmokeConfig(model=args.model, batch_size=args.batch_size, steps=args.steps, tp=tp,
                          classes=args.classes, text_packing=args.text_packing,
                          ln_linear=args.ln_linear, resume=args.resume, fp32=args.fp32,
                          stage=tuple(args.stage), out=out)
        report = run(cfg, args.world, args.device, args.backend, args.shared_device, args.timeout)
        print("multihost_smoke " + json.dumps(report), flush=True)
        failed |= bool(report["failures"])
        print(f"MULTIHOST SMOKE (tp={tp}): " + ("FAILED " + "; ".join(report["failures"])
                                                if report["failures"] else "OK"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
