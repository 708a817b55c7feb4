"""Entry point: ``python -m latteclip_torch.train.main`` (port of
``latteclip_tpu/train/main.py::main``).

Wires the pieces as the JAX package does (reference ``src/training/
main.py:72-551``): the eval dataset and its templates, the model (seeded or
``--pretrained``), the memory bank (from the checkpoint or the templates),
optimizer and schedule, the train pipeline, then the epoch loop with
zero-shot eval and checkpoints; ``--resume latest|path`` restores the
weights, the bank, the step, the AdamW moments and the schedule, from a
checkpoint of either package. Without train data it evaluates once and
exits. ``--dataset-type synthetic`` writes the synthetic fixture to a
temporary directory and trains on it.

The model runs on ``--device`` (``cuda`` by default: the Hopper kernels; it
raises without a CUDA device). The JAX package's kernel switches
``LATTECLIP_ATTN_HEADSPLIT``, ``LATTECLIP_ATTN_BLOCKDIAG`` and
``LATTECLIP_FUSED_LN`` select the same routes here (``attention=`` and
``ln_linear=``). Flags whose feature the port does not have yet are refused
with a ``SystemExit`` that names the ROADMAP item; the GPU/infra flags the
JAX package ignores with a warning are ignored with the same warning.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import sys
import tempfile
from typing import List, Optional

import torch

from latteclip_torch import checkpoint as ckpt
from latteclip_torch.config import get_model_config
from latteclip_torch.data import synthetic
from latteclip_torch.data.eval_dataset import FlatFileDataset
from latteclip_torch.data.packing import pack_template_table
from latteclip_torch.data.pipeline import (
    PipelineConfig,
    TrainPipeline,
    apply_context_cap,
    build_train_data,
)
from latteclip_torch.data.tar_reader import expand_shard_pattern
from latteclip_torch.data.transforms import AugConfig
from latteclip_torch.device import resolve_device
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models.tokenizer import get_tokenizer
from latteclip_torch.obs.meters import append_results_jsonl
from latteclip_torch.train import loop as loop_mod
from latteclip_torch.train.optim import make_optimizer, make_schedule
from latteclip_torch.train.params import parse_args
from latteclip_torch.train.state import (
    build_template_table,
    create_train_state,
    init_memory_bank,
)
from latteclip_torch.train.step import LatteHParams, make_train_step

logger = logging.getLogger("latteclip_torch")

_ITEM_5 = "ROADMAP.md, section 1, item 5 (multi-GPU data parallel)"
_ITEM_6 = "ROADMAP.md, section 1, item 6 (the rest)"

_WARN_IGNORED_FLAGS = (
    # GPU/infra flags accepted for reference-script compat (params.py)
    "torchscript", "torchcompile", "trace", "horovod", "ddp_static_graph",
    "no_set_device_rank", "use_bnb_linear", "dist_url", "dist_backend",
    "debug", "copy_codebase", "log_local", "pretrained_image",
)


def setup_logging(log_path: Optional[str] = None):
    handlers = [logging.StreamHandler(sys.stderr)]
    if log_path:
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        handlers.append(logging.FileHandler(log_path))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)s | %(message)s",
                        datefmt="%Y-%m-%d,%H:%M:%S", handlers=handlers, force=True)


def refuse_unported(args) -> None:
    """SystemExit for every flag whose feature the port does not have yet."""
    refused = {
        "--method " + args.method: args.method != "ours",
        "--gamma": bool(args.gamma),
        "--tta": args.tta,
        "--extract-features-path": args.extract_features_path is not None,
        "--extract-group-weight-path": args.extract_group_weight_path is not None,
        "--siglip": args.siglip,
        "--distill-model/--distill-pretrained": (args.distill_model is not None
                                                 or args.distill_pretrained is not None),
        "--imagenet-val": args.imagenet_val is not None,
        "--imagenet-v2": args.imagenet_v2 is not None,
        "--val-data": args.val_data is not None,
        "--report-to": bool(args.report_to),
        "--remote-sync": args.remote_sync is not None,
        "--profile": args.profile,
        "--use-native-jpeg": args.use_native_jpeg,
        "--eval-config-path": args.eval_config_path is not None,
        "--force-image-size": args.force_image_size is not None,
        "--force-patch-dropout": args.force_patch_dropout is not None,
        "--image-resize-mode": args.image_resize_mode not in (None, "shortest"),
    }
    bad = [flag for flag, on in refused.items() if on]
    if bad:
        raise SystemExit(f"{', '.join(bad)}: not ported to latteclip_torch yet ({_ITEM_6})")
    if args.model_parallelism > 1:
        raise SystemExit(f"--model-parallelism {args.model_parallelism}: not ported to "
                         f"latteclip_torch yet ({_ITEM_5})")


def kernel_routes() -> dict:
    """The towers' routes from the JAX package's environment switches."""
    on = {k: os.environ.get(k, "0") == "1"
          for k in ("LATTECLIP_ATTN_HEADSPLIT", "LATTECLIP_ATTN_BLOCKDIAG", "LATTECLIP_FUSED_LN")}
    if on["LATTECLIP_ATTN_HEADSPLIT"] and on["LATTECLIP_ATTN_BLOCKDIAG"]:
        raise SystemExit("LATTECLIP_ATTN_HEADSPLIT=1 with LATTECLIP_ATTN_BLOCKDIAG=1: the JAX "
                         "package's backward breaks on that pair (ROADMAP.md, section 3); "
                         "set one of them")
    attention = ("headsplit" if on["LATTECLIP_ATTN_HEADSPLIT"] else
                 "blockdiag" if on["LATTECLIP_ATTN_BLOCKDIAG"] else "kernel")
    return {"attention": attention,
            "ln_linear": "fused" if on["LATTECLIP_FUSED_LN"] else "unfused"}


def build_model(args, device):
    """``(cfg, model, bank_by_class)``: the config with the CLI's overrides,
    and the model seeded from ``--seed`` or loaded from ``--pretrained``."""
    try:
        cfg = get_model_config(args.model)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"--model {args.model}: {e} ({_ITEM_6})") from e
    changes = {}
    if args.precision == "fp32":
        changes["compute_dtype"] = "float32"
    if args.force_quick_gelu:
        changes["quick_gelu"] = True
    if args.image_mean:
        changes["image_mean"] = tuple(args.image_mean)
    if args.image_std:
        changes["image_std"] = tuple(args.image_std)
    cfg = dataclasses.replace(cfg, **changes)
    if args.pretrained:
        if not os.path.exists(args.pretrained):
            raise SystemExit(f"--pretrained {args.pretrained}: no such file; pretrained tags "
                             f"are not ported to latteclip_torch yet ({_ITEM_6})")
        model, bank, names, _meta = ckpt.load_clip_pt(args.pretrained, cfg, device=device)
        logger.info("loaded pretrained weights from %s", args.pretrained)
        return cfg, model, dict(zip(names, bank)) if bank is not None else {}
    model = clip_mod.init_clip_params(torch.Generator().manual_seed(args.seed), cfg,
                                      device=device)
    return cfg, model, {}


def synthetic_root(args, cfg) -> str:
    """The synthetic fixture in a new temporary directory, as the JAX
    package's ``_synthetic_root`` writes it."""
    root = tempfile.mkdtemp(prefix="latteclip_synth_")
    synthetic.make_full_fixture(root, num_train=max(args.batch_size * 2, 64), num_val=32,
                                image_size=cfg.vision.image_size)
    return root


def build_aug_config(aug_cfg: dict) -> AugConfig:
    """--aug-cfg key=value overrides -> AugConfig (unknown keys warn)."""
    kw = {}
    for key, value in (aug_cfg or {}).items():
        if key == "scale":
            kw["scale_min"], kw["scale_max"] = float(value[0]), float(value[1])
        elif key == "color_jitter":
            kw["color_jitter"] = tuple(float(v) for v in value)
        elif key in ("color_jitter_prob", "gray_scale_prob"):
            kw[key] = float(value)
        else:
            logger.warning("ignoring unsupported --aug-cfg key: %s", key)
    return AugConfig(**kw)


def parse_upsampling(args) -> Optional[List[float]]:
    """--train-data-upsampling-factors: per-``::``-source weights expanded
    to per-shard weights (reference data.py:542-551)."""
    if not args.train_data_upsampling_factors:
        return None
    if not args.dataset_resampled:
        raise SystemExit("--train-data-upsampling-factors is only supported when sampling "
                         "with replacement (--dataset-resampled), like the reference")
    factors = [float(v) for v in args.train_data_upsampling_factors.split("::")]
    sources = (args.train_data or "").split("::")
    if len(factors) != len(sources):
        raise SystemExit(f"--train-data-upsampling-factors has {len(factors)} entries for "
                         f"{len(sources)} ::-separated --train-data sources")
    weights: List[float] = []
    for src, w in zip(sources, factors):
        weights += [w] * len(expand_shard_pattern(src))
    return weights


def _bank_for(classnames, bank_by_class) -> Optional[torch.Tensor]:
    if bank_by_class and all(c in bank_by_class for c in classnames):
        return torch.stack([bank_by_class[c] for c in classnames])
    return None


def main(argv=None) -> int:
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    routes = kernel_routes()

    name = args.name or f"{args.model}_lr{args.lr}_b{args.batch_size}"
    log_dir = os.path.join(args.logs, name)
    checkpoint_dir = os.path.join(log_dir, "checkpoints")
    setup_logging(os.path.join(log_dir, "out.log"))
    logger.info("device: %s (%s)", device, torch.cuda.get_device_name(device)
                if device.type == "cuda" else "host CPU")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "params.txt"), "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k}: {getattr(args, k)}\n")
    ignored = [f for f in _WARN_IGNORED_FLAGS if getattr(args, f, None)]
    if ignored:
        logger.warning("ignoring GPU/infra flags with no counterpart here: %s",
                       ", ".join("--" + f.replace("_", "-") for f in ignored))
    if args.image_interpolation and args.image_interpolation != "bicubic":
        logger.warning("--image-interpolation %s is not implemented (bicubic/Keys-cubic "
                       "only); using bicubic", args.image_interpolation)
    if args.lock_text_unlocked_layers:
        args.lock_text_unlocked_groups = max(args.lock_text_unlocked_groups,
                                             args.lock_text_unlocked_layers)

    cfg, model, bank_by_class = build_model(args, device)
    tokenizer = get_tokenizer()
    synthetic_mode = args.dataset_type == "synthetic"
    if synthetic_mode:
        preprocess_path, dataset_name = synthetic_root(args, cfg), "dtd"
    else:
        preprocess_path = args.eval_preprocess_path
        if not preprocess_path:
            data_dir = args.data_dir or os.environ.get("LATTECLIP_DATA_DIR")
            if not data_dir or not args.zeroshot_eval_data:
                raise SystemExit("need --eval-preprocess-path, or --zeroshot-eval-data with "
                                 "--data-dir / $LATTECLIP_DATA_DIR")
            preprocess_path = os.path.join(data_dir, f"{args.zeroshot_eval_data}_preprocess")
        dataset_name = args.zeroshot_eval_data or "default"
    val_dataset = FlatFileDataset(preprocess_path, train=False, image_size=cfg.vision.image_size,
                                  dataset_name=dataset_name)
    classnames = val_dataset.display_class_names
    templates = val_dataset.templates

    bank = _bank_for(classnames, bank_by_class)
    if bank is not None:
        logger.info("restored memory bank from checkpoint (%d classes)", len(classnames))
    else:
        bank = init_memory_bank(model, tokenizer, classnames, templates, **routes)
        logger.info("initialized memory bank from templates (%d classes)", len(classnames))

    # ---- eval-only mode: no train data -> evaluate once and exit ----------
    if not args.train_data and not synthetic_mode:
        if not args.zeroshot_eval_data:
            raise SystemExit("At least one train or eval dataset must be specified.")
        start_epoch = 0
        if args.resume and args.resume != "latest" and not args.pretrained:
            model, r_bank, r_names, r_meta = ckpt.load_clip_pt(args.resume, cfg, device=device)
            start_epoch = int(r_meta.get("epoch", 0))
            r_bank = _bank_for(classnames, dict(zip(r_names, r_bank)) if r_bank is not None
                               else {})
            if r_bank is not None:
                bank = r_bank
            logger.info("loaded eval checkpoint %s (epoch %d)", args.resume, start_epoch)
        state = create_train_state(model, make_optimizer(model, make_schedule("const", 0.0, 0)),
                                   bank)
        metrics = loop_mod.evaluate_zero_shot(
            state, val_dataset, args.eval_batch_size, method=args.method, tokenizer=tokenizer,
            classnames=classnames, templates=templates, **routes)
        logger.info("Eval Epoch: %d %s", start_epoch,
                    {k: round(float(v), 4) for k, v in metrics.items()})
        append_results_jsonl(os.path.join(checkpoint_dir, "results.jsonl"),
                             {"epoch": start_epoch, **{k: float(v) for k, v in metrics.items()}})
        return 0

    # ---- data --------------------------------------------------------------
    if synthetic_mode:
        train_shards = os.path.join(preprocess_path, "webdataset", "train_tars")
        clip_pred = os.path.join(preprocess_path, "clip_features_train.pkl")
        caption_dirs = [os.path.join(preprocess_path, "captions_per_image")]
        common_dirs = [os.path.join(preprocess_path, "captions_per_group")]
        num_samples = args.train_num_samples or args.batch_size * 2
    else:
        if not (args.train_data and args.clip_prediction_path):
            raise SystemExit("--train-data and --clip-prediction-path are required")
        train_shards, clip_pred = args.train_data, args.clip_prediction_path
        caption_dirs = args.generated_captions_path or []
        common_dirs = args.generated_common_captions_path or []
        num_samples = args.train_num_samples
        if not num_samples:
            raise SystemExit("--train-num-samples is required for webdataset training")
    data = build_train_data(train_shards, clip_pred, caption_dirs, common_dirs, classnames,
                            tokenizer)
    table = build_template_table(tokenizer, classnames, templates)
    if args.text_context_cap:
        data, table, eff, truncated = apply_context_cap(data, args.text_context_cap,
                                                        tokenizer.eot_token_id, table)
        logger.info("text context cap: %s -> %d columns (%d caption rows truncated with "
                    "forced EOT)", args.text_context_cap, eff, truncated)

    aug = build_aug_config(args.aug_cfg)
    pipeline = TrainPipeline(data, PipelineConfig(
        batch_size=args.batch_size, image_size=cfg.vision.image_size, seed=args.seed,
        num_threads=args.workers, raw_cache_bytes=args.raw_cache_mb * 1024**2,
        train_with_gt_text=args.train_with_gt_text, ondevice_resize=args.ondevice_resize,
        crop_scale=(aug.scale_min, aug.scale_max), resampled=args.dataset_resampled,
        upsampling_factors=parse_upsampling(args), text_packing_len=args.text_packing,
        text_packing_rows=args.text_packing_rows,
        pin_memory=device.type == "cuda"), num_samples)
    total_steps = pipeline.steps_per_epoch * args.epochs

    # ---- optimizer + step ----------------------------------------------------
    if args.skip_scheduler:
        schedule = make_schedule("const", args.lr, 0, total_steps)
    else:
        cooldown = (pipeline.steps_per_epoch * args.epochs_cooldown
                    if args.epochs_cooldown else 0)
        schedule = make_schedule(args.lr_scheduler, args.lr, args.warmup, total_steps,
                                 cooldown_steps=cooldown, cooldown_power=args.lr_cooldown_power,
                                 cooldown_end_lr=args.lr_cooldown_end)
    optimizer = make_optimizer(
        model, schedule, beta1=args.beta1, beta2=args.beta2, eps=args.eps,
        weight_decay=args.wd, grad_clip_norm=args.grad_clip_norm, accum_steps=args.accum_freq,
        lock_image=args.lock_image, lock_text=args.lock_text,
        lock_image_unlocked_groups=args.lock_image_unlocked_groups,
        lock_text_unlocked_groups=args.lock_text_unlocked_groups)
    hp = LatteHParams(
        alpha=args.alpha, use_template_caption=args.use_template_caption,
        use_image_caption=args.use_image_caption, use_batch_caption=args.use_batch_caption,
        use_zeroshot_pseudolabel=args.use_zeroshot_pseudolabel,
        use_finetune_pseudolabel=args.use_finetune_pseudolabel,
        remat=args.grad_checkpointing, remat_text=args.grad_checkpointing_text,
        remat_vision=args.grad_checkpointing_vision, bug_compat=args.fusion_bug_compat,
        fuse_text_fwd=args.fuse_text_forward and not args.text_packing,
        text_packing=bool(args.text_packing))
    template_packed = None
    if args.text_packing:
        template_packed = pack_template_table(table, args.text_packing)
        logger.info("text packing: captions -> [R, %d] segment-masked rows; templates packed "
                    "to [%d, %d] (from [%d, %d])", args.text_packing,
                    template_packed.tokens.shape[0], args.text_packing, *table.shape)
    step_fn = make_train_step(model, hp, table, aug=aug, template_packed=template_packed,
                              **routes)
    state = create_train_state(model, optimizer, bank)

    # ---- resume --------------------------------------------------------------
    start_epoch = 0
    if args.resume:
        path = (loop_mod.find_latest_checkpoint(checkpoint_dir) if args.resume == "latest"
                else args.resume)
        if path:
            r_model, r_bank, r_names, r_meta = ckpt.load_clip_pt(path, cfg, device=device)
            with torch.no_grad():
                for p, q in zip(model.parameters(), r_model.parameters()):
                    p.copy_(q)
            r_bank = _bank_for(classnames, dict(zip(r_names, r_bank)) if r_bank is not None
                               else {})
            if r_bank is not None:
                state.memory_bank = r_bank.to(device)
                state.prototypes = state.memory_bank.clone()
            start_epoch = int(r_meta.get("epoch", 0))
            state.step = int(r_meta.get("step", start_epoch * pipeline.steps_per_epoch))
            if "optimizer" in r_meta:
                ckpt.restore_optimizer_state(model, optimizer, r_meta["optimizer"], state.accum)
                logger.info("resumed optimizer state (%d leaves)", len(r_meta["optimizer"]))
            else:
                logger.warning("checkpoint has no optimizer state; AdamW moments and the LR "
                               "schedule restart from step 0")
            logger.info("resumed from %s (epoch %d, step %d)", path, start_epoch, state.step)
        else:
            logger.info("no checkpoint to resume from in %s", checkpoint_dir)

    loop_cfg = loop_mod.LoopConfig(
        epochs=args.epochs, checkpoint_dir=checkpoint_dir, name=name,
        log_every_n_steps=args.log_every_n_steps, zeroshot_frequency=args.zeroshot_frequency,
        save_frequency=args.save_frequency, save_most_recent=args.save_most_recent,
        delete_previous_checkpoint=args.delete_previous_checkpoint,
        eval_batch_size=args.eval_batch_size, method=args.method, lr_schedule=schedule,
        text_packing=args.text_packing, **routes)
    loop_mod.train(state, step_fn, pipeline, loop_cfg, classnames, val_dataset=val_dataset,
                   start_epoch=start_epoch, seed=args.seed, tokenizer=tokenizer,
                   templates=templates)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
