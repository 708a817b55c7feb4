"""Training orchestration: epochs, eval, checkpointing, resume (port of
``latteclip_tpu/train/loop.py``: ``find_latest_checkpoint``, ``LoopConfig``,
``evaluate_zero_shot``, ``save_epoch_checkpoint`` and ``train``).

Per epoch, as the reference's ``main.py`` loop (``src/training/main.py:
480-551``) and the JAX loop run it: snapshot the prototypes, run
``steps_per_epoch`` steps over the pipeline's batches (copied to the card a
batch ahead by :func:`latteclip_torch.data.pipeline.prefetch`), log in the
JAX package's format, evaluate zero-shot (with, where given, the validation
loss and retrieval over (image, caption) pairs, ``--val-data``, and the
ImageNet eval with the 80-template classifier of the current text tower,
``--imagenet-val``, under the keys ``imagenet-zeroshot-val-*``), append
``results.jsonl`` and save an OpenCLIP-layout ``epoch_<n>.pt`` (plus
``epoch_latest.pt``). The logged steps' metrics and each eval's go to the
``--report-to`` writers, and ``--profile`` traces a window of steps
(:class:`latteclip_torch.obs.profiler.StepTraceProfiler`), counted over the
run as JAX counts them.

Each step's augment draws from a ``torch.Generator`` on the model's device
seeded with ``(seed << 32) + epoch * 100003 + i``: the number the JAX loop
folds into ``PRNGKey(seed)``, combined with the seed; a rank at data index
``d`` of a mesh adds ``d << 56``, so the ranks of one model group draw
alike and the data ranks differently.

On a mesh (``state.mesh``) every rank runs the steps, eval and the
checkpoint's gather, in one order (JAX loop.py:87-127, :225-262): eval and
the checkpoint run on the gathered parameters
(:func:`latteclip_torch.mesh.gathered`) on every rank, and only rank 0 logs,
writes ``results.jsonl``, the writers' events, the trace and the
checkpoint files. Throughput counts the global batch (batch times the data
size).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Dict, Optional, Sequence

import torch

from latteclip_torch import mesh as mesh_mod
from latteclip_torch.checkpoint import optimizer_state, save_clip_pt
from latteclip_torch.data.eval_dataset import FlatFileDataset, iter_batches
from latteclip_torch.data.pipeline import TrainPipeline, prefetch
from latteclip_torch.eval import imagenet_metadata
from latteclip_torch.eval.retrieval import evaluate_val_pairs
from latteclip_torch.eval.zero_shot import (
    build_zero_shot_classifier,
    prototype_classifier,
    run_zero_shot_eval,
)
from latteclip_torch.obs.meters import DeviceMeterBank, Throughput, append_results_jsonl
from latteclip_torch.obs.profiler import StepTraceProfiler
from latteclip_torch.train.state import TrainState

logger = logging.getLogger("latteclip_torch")

_EPOCH_RE = re.compile(r"epoch_(\d+)\.pt$")


def find_latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """``epoch_latest.pt`` if present, else the highest ``epoch_<n>.pt``."""
    if not os.path.isdir(checkpoint_dir):
        return None
    latest = os.path.join(checkpoint_dir, "epoch_latest.pt")
    if os.path.exists(latest):
        return latest
    epochs = []
    for f in os.listdir(checkpoint_dir):
        m = _EPOCH_RE.search(f)
        if m:
            epochs.append((int(m.group(1)), os.path.join(checkpoint_dir, f)))
    return max(epochs)[1] if epochs else None


@dataclasses.dataclass
class LoopConfig:
    epochs: int
    checkpoint_dir: str
    name: str = "run"
    log_every_n_steps: int = 10
    zeroshot_frequency: int = 1
    val_frequency: int = 1              # the --val-data branch, every N epochs
    save_frequency: int = 1
    save_most_recent: bool = True       # epoch_latest.pt (reference main.py:546)
    delete_previous_checkpoint: bool = False
    eval_batch_size: int = 64
    method: str = "ours"                # eval classifier, reference zero_shot.py:117-145
    lr_schedule: Optional[object] = None  # schedule(step) -> lr, for the "LR:" field
    # --profile: a torch.profiler trace of the loop's steps [start, start + num)
    profile_dir: Optional[str] = None
    profile_start_step: int = 3
    profile_num_steps: int = 5
    text_packing: int = 0               # packed templates in a template classifier build
    attention: str = "kernel"           # the towers' kernel routes
    ln_linear: str = "unfused"


def evaluate_zero_shot(state: TrainState, val_dataset: FlatFileDataset, batch_size: int, *,
                       method: str = "ours", tokenizer=None,
                       classnames: Optional[Sequence[str]] = None, templates=None,
                       packing: int = 0, attention: str = "kernel",
                       ln_linear: str = "unfused") -> Dict[str, float]:
    """Zero-shot eval with the reference's classifier: the memory bank for
    ``ours`` (zero_shot.py:139-145), the template classifier of the current
    text tower for ``flyp``/``flyp_gt`` (zero_shot.py:117-137)."""
    routes = {"attention": attention, "ln_linear": ln_linear}
    if method in ("flyp", "flyp_gt"):
        classifier = build_zero_shot_classifier(state.model, tokenizer, classnames, templates,
                                                packing=packing, **routes)
    else:
        classifier = prototype_classifier(state.memory_bank)
    return run_zero_shot_eval(state.model, classifier,
                              iter_batches(val_dataset, batch_size, pad_final=True), **routes)


def evaluate_imagenet(state: TrainState, dataset, batch_size: int, tokenizer, *,
                      packing: int = 0, attention: str = "kernel",
                      ln_linear: str = "unfused") -> Dict[str, float]:
    """The reference zero_shot_eval's ImageNet branch (zero_shot.py:117-137):
    the 1000-class classifier of the 80 OpenAI templates, built from the
    current text tower, over ``dataset``; keys ``imagenet-zeroshot-val-*``."""
    routes = {"attention": attention, "ln_linear": ln_linear}
    classifier = build_zero_shot_classifier(
        state.model, tokenizer, imagenet_metadata.imagenet_classnames(),
        imagenet_metadata.openai_imagenet_templates(), packing=packing, **routes)
    metrics = run_zero_shot_eval(state.model, classifier,
                                 iter_batches(dataset, batch_size, pad_final=True), **routes)
    return {f"imagenet-zeroshot-val-{k}": v for k, v in metrics.items()}


def save_epoch_checkpoint(state: TrainState, classnames: Sequence[str], loop_cfg: LoopConfig,
                          epoch: int) -> None:
    """``epoch_<epoch>.pt`` (and ``epoch_latest.pt``) with the bank, the
    optimizer state under the JAX package's keys and the step."""
    os.makedirs(loop_cfg.checkpoint_dir, exist_ok=True)
    extra = dict(epoch=epoch, name=loop_cfg.name, memory_bank=state.memory_bank,
                 classnames=list(classnames),
                 optimizer=optimizer_state(state.model, state.optimizer, state.accum),
                 step=state.step)
    save_clip_pt(os.path.join(loop_cfg.checkpoint_dir, f"epoch_{epoch}.pt"), state.model, **extra)
    if loop_cfg.delete_previous_checkpoint:
        prev = os.path.join(loop_cfg.checkpoint_dir, f"epoch_{epoch - 1}.pt")
        if os.path.exists(prev):
            os.remove(prev)
    if loop_cfg.save_most_recent:
        save_clip_pt(os.path.join(loop_cfg.checkpoint_dir, "epoch_latest.pt"), state.model,
                     **extra)


def step_generator(device: torch.device, seed: int, epoch: int, i: int,
                   data_index: int = 0) -> torch.Generator:
    """The augment's generator of step ``i`` of ``epoch`` at ``data_index``
    (module docstring)."""
    return torch.Generator(device=device).manual_seed(
        (seed << 32) + epoch * 100003 + i + (data_index << 56))


def train(state: TrainState, step_fn, pipeline: TrainPipeline, loop_cfg: LoopConfig,
          classnames: Sequence[str], val_dataset: Optional[FlatFileDataset] = None,
          start_epoch: int = 0, seed: int = 0, tokenizer=None, templates=None,
          val_pairs_dataset=None, imagenet_val_dataset=None, writers=()) -> TrainState:
    """Run the epochs from ``start_epoch``; returns the final state.
    ``writers`` (:func:`latteclip_torch.obs.tensorboard.make_writers`) take
    every logged step's metrics as ``train/<key>`` plus the data and batch
    times and samples/s, and each eval's metrics as ``val/<key>``."""
    device = next(state.model.parameters()).device
    results_path = os.path.join(loop_cfg.checkpoint_dir, "results.jsonl")
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    mesh, master = state.mesh, mesh_mod.is_master(state)
    data_size, data_index = (mesh.data_size, mesh.data_index) if mesh is not None else (1, 0)
    tracer = None
    if loop_cfg.profile_dir and master:
        tracer = StepTraceProfiler(loop_cfg.profile_dir, start_step=loop_cfg.profile_start_step,
                                   num_steps=loop_cfg.profile_num_steps)
    global_step = 0
    for epoch in range(start_epoch, loop_cfg.epochs):
        state.start_epoch()
        meters = DeviceMeterBank()
        thr = Throughput(pipeline.cfg.batch_size, data_size)
        batches = prefetch(pipeline.epoch(epoch), size=pipeline.cfg.prefetch_batches,
                           device=device)
        for i, batch in enumerate(batches):
            thr.tick_data()
            if tracer is not None:
                tracer.on_step(global_step, sync=sync)
            metrics = step_fn(state, batch, step_generator(device, seed, epoch, i, data_index))
            meters.update(metrics)
            thr.tick_batch()
            global_step += 1
            if master and (i % loop_cfg.log_every_n_steps == 0
                           or i == pipeline.steps_per_epoch - 1):
                fetched = meters.fetch()
                lr_str = (" LR: %f" % float(loop_cfg.lr_schedule(state.step - 1))
                          if loop_cfg.lr_schedule is not None else "")
                logger.info(
                    "Train Epoch: %d [%d/%d] Data (t): %.3f Batch (t): %.3f, %#g/s, %#g/s/chip%s "
                    "Logit Scale: %.3f Loss: %.5g (%.5g)",
                    epoch, (i + 1) * pipeline.cfg.batch_size, pipeline.num_samples,
                    thr.data_time.avg, thr.batch_time.avg, thr.samples_per_second,
                    thr.samples_per_second_per_chip, lr_str, fetched["logit_scale"].val,
                    fetched["loss"].val, fetched["loss"].avg)
                gstep = epoch * pipeline.steps_per_epoch + i
                for w in writers:
                    for k, m in fetched.items():
                        w.add_scalar(f"train/{k}", m.val, gstep)
                    w.add_scalar("train/data_time", thr.data_time.avg, gstep)
                    w.add_scalar("train/batch_time", thr.batch_time.avg, gstep)
                    w.add_scalar("train/samples_per_second", thr.samples_per_second, gstep)
                    w.flush()

        completed = epoch + 1
        if (val_dataset is not None and loop_cfg.zeroshot_frequency
                and (completed % loop_cfg.zeroshot_frequency == 0
                     or completed == loop_cfg.epochs)):
            routes = {"attention": loop_cfg.attention, "ln_linear": loop_cfg.ln_linear}
            with mesh_mod.gathered(state, moments=False):
                eval_metrics = evaluate_zero_shot(
                    state, val_dataset, loop_cfg.eval_batch_size, method=loop_cfg.method,
                    tokenizer=tokenizer, classnames=classnames, templates=templates,
                    packing=loop_cfg.text_packing, **routes)
                if (val_pairs_dataset is not None and loop_cfg.val_frequency
                        and (completed % loop_cfg.val_frequency == 0
                             or completed == loop_cfg.epochs)):
                    eval_metrics.update(evaluate_val_pairs(
                        state.model, val_pairs_dataset, batch_size=loop_cfg.eval_batch_size,
                        tokenizer=tokenizer, **routes))
                if imagenet_val_dataset is not None and tokenizer is not None:
                    eval_metrics.update(evaluate_imagenet(
                        state, imagenet_val_dataset, loop_cfg.eval_batch_size, tokenizer,
                        packing=loop_cfg.text_packing, **routes))
            if master:
                logger.info("Eval Epoch: %d %s", completed,
                            {k: round(v, 4) for k, v in eval_metrics.items()})
                append_results_jsonl(results_path, {"epoch": completed, **eval_metrics})
                for w in writers:
                    for k, v in eval_metrics.items():
                        w.add_scalar(f"val/{k}", float(v), completed)
                    w.flush()
        if loop_cfg.save_frequency and (completed % loop_cfg.save_frequency == 0
                                        or completed == loop_cfg.epochs):
            with mesh_mod.gathered(state):
                if master:
                    save_epoch_checkpoint(state, classnames, loop_cfg, completed)
    if tracer is not None:
        tracer.close(sync=sync)
    return state
