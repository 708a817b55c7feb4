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
temporary directory and trains on it. ``--val-data`` (a CSV of image-caption
pairs) and ``--imagenet-val`` (an ImageNet folder) join the epoch's eval.

The offline and eval jobs run instead of training and exit, as in the JAX
package: ``--extract-features-path`` writes the pseudo-label pickle
(``clip_features_<split>.pkl``) that ``--clip-prediction-path`` reads;
``--tta`` or ``--method tpt|rlcf`` runs test-time adaptation on the eval
split (RLCF's reward model from ``--reward-model``/``--reward-pretrained``,
seeded from ``torch.Generator`` seed 1 without a checkpoint);
``--extract-group-weight-path`` writes the fusion-weight analysis.
``--eval-config-path`` resolves the eval split from a YAML task registry.

Each trainer of the JAX CLI trains here: ``--method ours`` the LatteCLIP v2
step, with ``--gamma`` the legacy v1 step, ``--method flyp|flyp_gt`` the FLYP
step on the pseudo-labels or the ground-truth labels, with ``--siglip`` the
sigmoid loss (a plain CLIP gets a trainable ``logit_bias`` of -10, also on
a resume) and ``--distill-model`` with ``--distill-pretrained`` a frozen
teacher. The pipeline packs captions (``--text-packing``) for the v2 step
only. ``--report-to tensorboard|wandb`` logs the steps and evals,
``--profile`` traces a window of steps, ``--remote-sync`` mirrors the run's
directory, and ``--resume`` reads an ``s3://`` path through it. A CoCa model
(``--model coca_*``) trains with the v2 step, its caption decoder kept as
it was, or with FLYP on CoCaLoss (``--coca-caption-loss-weight``,
``--coca-contrastive-loss-weight``); an HF text tower trains as any text
tower, from HF-tokenized ids (its tokenizer files must be on disk).

The model runs on ``--device`` (``cuda`` by default: the Hopper kernels; it
raises without a CUDA device). The JAX package's kernel switches
``LATTECLIP_ATTN_HEADSPLIT``, ``LATTECLIP_ATTN_BLOCKDIAG`` and
``LATTECLIP_FUSED_LN`` select the same routes here (``attention=`` and
``ln_linear=``), and ``LATTECLIP_TEXT_XLA_ATTN=1`` sends whole rows under
128 tokens to the plain attention (:mod:`latteclip_torch.kernels`).
``--use-native-jpeg --host-resize`` decodes train JPEGs with the C decoder
of :mod:`latteclip_torch.native` (the build logged once at start; PIL where
it does not build, and under the default on-device resize, as in JAX; the
decode counts logged at the end). The flags JAX refuses are refused with
its messages
(``--text-packing`` with an HF or class-token text tower, ``--gamma``,
``--siglip`` or a teacher with CoCa among them); the GPU/infra flags the JAX
package ignores with a warning are ignored with the same warning.

Across ranks: ``torchrun --nproc_per_node N -m latteclip_torch.train.main
...`` (NCCL, one card a rank; gloo on the CPU), with ``--model-parallelism
K`` for K-way tensor parallelism of the block MLPs (K divides N). Each
rank's ``--batch-size`` is its local batch, the global batch is the data
ranks' batches together (:mod:`latteclip_torch.mesh`); the pipeline gives
data rank ``d`` of ``N / K`` its share of the shards (``host_index`` and
``host_count``), packed caption rows round to ``lcm(8, N / K)`` and
``--text-packing`` needs ``--text-packing-rows``. Only rank 0 logs to the
file, writes ``params.txt``, the results, the writers' events and the
checkpoints; the offline and eval-only jobs run on rank 0 alone.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import sys
import tempfile
from typing import List, Optional

import torch
import torch.distributed as dist

from latteclip_torch import checkpoint as ckpt
from latteclip_torch import mesh as mesh_mod
from latteclip_torch import pretrained
from latteclip_torch.config import CoCaConfig, get_model_config
from latteclip_torch.data import synthetic
from latteclip_torch.data.eval_dataset import FlatFileDataset
from latteclip_torch.data.folder_dataset import CsvDataset, ImageFolderDataset
from latteclip_torch.data.packing import pack_template_table
from latteclip_torch.data.pipeline import (
    PipelineConfig,
    TrainPipeline,
    apply_context_cap,
    build_train_data,
)
from latteclip_torch.data.tar_reader import expand_shard_pattern
from latteclip_torch.data.transforms import AugConfig
from latteclip_torch.eval.features import extract_features
from latteclip_torch.eval.group_weights import extract_group_weights
from latteclip_torch.eval.tta import TTAConfig, evaluate_tta
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models.hf_text import HFTextConfig
from latteclip_torch.models.tokenizer import get_tokenizer_for_config
from latteclip_torch.obs.file_sync import RemoteSync, pt_load_path
from latteclip_torch.obs.meters import append_results_jsonl
from latteclip_torch.obs.tensorboard import make_writers
from latteclip_torch.train import loop as loop_mod
from latteclip_torch.train.optim import make_optimizer, make_schedule
from latteclip_torch.train.params import parse_args
from latteclip_torch.train.state import (
    build_template_table,
    create_train_state,
    init_memory_bank,
)
from latteclip_torch.train.step import (
    DEFAULT_LOGIT_BIAS,
    LatteHParams,
    make_flyp_step,
    make_train_step,
    make_v1_step,
)

logger = logging.getLogger("latteclip_torch")

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


def model_config(flag: str, name: str):
    """The named config; a ``SystemExit`` naming ``flag`` for one not ported."""
    try:
        return get_model_config(name)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"{flag} {name}: {e}") from e


def build_model(args, device):
    """``(cfg, model, bank_by_class)``: the config with the CLI's overrides,
    and the model seeded from ``--seed`` or loaded from ``--pretrained`` (a
    file, or a tag of the pretrained registry resolved in the cache, whose
    QuickGELU and preprocessing apply as in JAX's ``build_model``); then the
    overrides JAX applies after building (``--image-mean``/``--image-std``,
    ``--image-resize-mode``, ``--force-patch-dropout``)."""
    cfg = model_config("--model", args.model)
    changes = {}
    if args.precision == "fp32":
        changes["compute_dtype"] = "float32"
    if args.force_quick_gelu:
        changes["quick_gelu"] = True
    if args.force_image_size:
        # the loader resizes a checkpoint's positional embedding to the new grid;
        # the towers without patches (ModifiedResNet, ConvNeXt, ...) take any size
        patch = getattr(cfg.vision, "patch_size", None)
        if patch and args.force_image_size % patch != 0:
            raise SystemExit(f"--force-image-size {args.force_image_size} must be a multiple "
                             f"of the model's patch size ({patch})")
        changes["vision"] = dataclasses.replace(cfg.vision, image_size=args.force_image_size)
    cfg = dataclasses.replace(cfg, **changes)
    bank_by_class = {}
    if args.pretrained:
        path = args.pretrained
        if not os.path.exists(path):
            cfg = pretrained_tag_overrides(cfg, args.model, path)
            path = pretrained.resolve_pretrained(args.model, args.pretrained)
        model, bank, names, _meta = ckpt.load_clip_pt(path, cfg, device=device)
        cfg = model.cfg
        logger.info("loaded pretrained weights from %s", path)
        if bank is not None:
            bank_by_class = dict(zip(names, bank))
    else:
        model = clip_mod.init_clip_params(torch.Generator().manual_seed(args.seed), cfg,
                                          device=device)
    changes = {}
    if args.image_mean:
        changes["image_mean"] = tuple(args.image_mean)
    if args.image_std:
        changes["image_std"] = tuple(args.image_std)
    if args.image_resize_mode:
        changes["resize_mode"] = args.image_resize_mode
    if args.force_patch_dropout is not None:
        changes["vision"] = dataclasses.replace(cfg.vision,
                                                patch_dropout=float(args.force_patch_dropout))
    cfg = dataclasses.replace(cfg, **changes)
    model.cfg, model.visual.cfg = cfg, cfg.vision
    return cfg, model, bank_by_class


def pretrained_tag_overrides(cfg, model_name: str, tag: str):
    """A registry tag's QuickGELU and preprocessing (mean, std, resize
    mode) where the config leaves them at their defaults (JAX
    ``build_model``)."""
    pcfg = pretrained.get_pretrained_cfg(model_name, tag)
    if pcfg.get("quick_gelu") and not cfg.quick_gelu:
        cfg = dataclasses.replace(cfg, quick_gelu=True)
        logger.info("pretrained tag implies QuickGELU; enabled")
    overrides = {}
    if pcfg.get("mean") and not cfg.image_mean:
        overrides["image_mean"] = tuple(pcfg["mean"])
    if pcfg.get("std") and not cfg.image_std:
        overrides["image_std"] = tuple(pcfg["std"])
    if pcfg.get("resize_mode") and cfg.resize_mode == "shortest":
        overrides["resize_mode"] = pcfg["resize_mode"]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
        logger.info("pretrained tag preprocessing: %s", overrides)
    return cfg


def resolve_preprocess_path(args) -> str:
    """The eval dataset's directory: the ``--eval-config-path`` task
    ``<zeroshot-eval-data>_val_zeroshot_classification`` when it has one,
    else ``--eval-preprocess-path``, else ``<data dir>/<name>_preprocess``."""
    if args.eval_config_path and args.zeroshot_eval_data:
        from latteclip_torch.data.eval_config import expand_env, load_eval_config

        tasks = load_eval_config(args.eval_config_path)
        key = f"{args.zeroshot_eval_data}_val_zeroshot_classification"
        if key in tasks:
            return expand_env(str(tasks[key]["dataset_specific_kwargs"]["preprocess_path"]))
    if args.eval_preprocess_path:
        return args.eval_preprocess_path
    data_dir = args.data_dir or os.environ.get("LATTECLIP_DATA_DIR")
    if not data_dir or not args.zeroshot_eval_data:
        raise SystemExit("need --eval-preprocess-path, or --zeroshot-eval-data with "
                         "--data-dir / $LATTECLIP_DATA_DIR")
    return os.path.join(data_dir, f"{args.zeroshot_eval_data}_preprocess")


def run_tta(args, model, tokenizer, dataset, device, routes) -> None:
    """``--tta`` / ``--method tpt|rlcf``: test-time adaptation over
    ``dataset``, logged as ``TTA eval: {...}``."""
    if not hasattr(model, "token_embedding"):
        raise SystemExit(f"--model {args.model}: test-time prompt tuning needs the native CLIP "
                         "text tower (the JAX package's prompt path fails on an HF tower and "
                         "drops CoCa's class token; ROADMAP.md, section 3)")
    tta_cfg = TTAConfig(n_views=args.tta_n_views, selection_p=args.selection_p,
                        tta_steps=args.tta_step, lr=args.lr)
    reward_model = None
    if args.method == "rlcf":
        name = args.reward_model or args.model
        reward_cfg = model_config("--reward-model", name)
        if args.reward_pretrained:
            reward_model = ckpt.load_clip_pt(args.reward_pretrained, reward_cfg, device=device)[0]
        else:
            reward_model = clip_mod.init_clip_params(torch.Generator().manual_seed(1), reward_cfg,
                                                     device=device)
    metrics = evaluate_tta(model, tokenizer, dataset, tta_cfg,
                           method="rlcf" if args.method == "rlcf" else "tpt",
                           reward_model=reward_model, max_samples=args.tta_max_samples,
                           seed=args.seed, **routes)
    logger.info("TTA eval: %s", {k: round(float(v), 4) for k, v in metrics.items()})


def synthetic_root(args, cfg, data_size: int = 1) -> str:
    """The synthetic fixture in a new temporary directory, as the JAX
    package's ``_synthetic_root`` writes it: two global batches of train
    images (at least 64), so that each of ``data_size`` ranks gets a shard
    of 100 where the global batch allows."""
    root = tempfile.mkdtemp(prefix="latteclip_synth_")
    synthetic.make_full_fixture(root, num_train=max(args.batch_size * data_size * 2, 64),
                                num_val=32, image_size=cfg.vision.image_size)
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


def refuse_text_packing(args, cfg) -> None:
    """JAX's refusal of ``--text-packing`` for a text tower the packer cannot
    serve (an HF tower, a pool other than the EOT's, CoCa's class token)."""
    if args.text_packing and (isinstance(cfg.text, HFTextConfig)
                              or cfg.text.pool_type != "argmax" or cfg.text.embed_cls):
        raise SystemExit("--text-packing supports the native argmax-pool CLIP text tower only "
                         "(HF towers and cls-token pooling pack differently)")


def refuse_trainer_flags(args, cfg) -> None:
    """The trainer flags JAX's CLI refuses, with its messages: ``--gamma``
    with CoCa, ``--siglip`` with the LatteCLIP step (v2 or v1), one of the
    two distill flags without the other on the FLYP step, and ``--siglip``
    or a teacher with CoCa."""
    coca = isinstance(cfg, CoCaConfig)
    if coca and args.gamma:
        raise SystemExit("--gamma (legacy v1 trainer) does not support CoCa models; use "
                         "--method ours or flyp")
    if args.method == "ours":
        if args.siglip:
            raise SystemExit("--siglip applies to the contrastive baseline paths (--method "
                             "flyp/flyp_gt), matching the reference's create_loss wiring")
    elif (args.distill_model is None) != (args.distill_pretrained is None):
        raise SystemExit("--distill-model and --distill-pretrained must be given together "
                         "(reference main.py:213-219)")
    elif coca and (args.siglip or args.distill_model is not None):
        raise SystemExit("--siglip / --distill-model do not compose with CoCa models (reference "
                         "create_loss dispatches CoCa first, factory.py:325-341)")


def load_teacher(args, device) -> Optional[clip_mod.CLIP]:
    """The FLYP step's frozen teacher: ``--distill-model``'s config as the
    registry gives it, loaded from ``--distill-pretrained``; None without
    the flags or with the LatteCLIP step, as in JAX."""
    if args.method == "ours" or args.distill_model is None:
        return None
    teacher_cfg = model_config("--distill-model", args.distill_model)
    teacher = ckpt.load_clip_pt(args.distill_pretrained, teacher_cfg, device=device)[0]
    logger.info("distilling from %s (%s)", args.distill_model, args.distill_pretrained)
    return teacher


def make_step(args, model, hp: LatteHParams, table, aug: AugConfig, teacher, routes: dict):
    """The step of the trainer the flags select (JAX main's dispatch): the
    v1 step for ``ours`` with ``--gamma``, the v2 step for ``ours`` (a CoCa
    decoder's parameters kept), else the FLYP step (CoCaLoss on CoCa)."""
    coca = isinstance(model.cfg, CoCaConfig)
    if args.method == "ours" and args.gamma:
        logger.info("gamma=%g: using the legacy v1 momentum-prototype trainer (reference "
                    "train_one_epoch; detached text anchor, EMA bank mix of image features)",
                    args.gamma)
        return make_v1_step(model, hp, table, gamma=args.gamma, aug=aug, **routes)
    if args.method == "ours":
        template_packed = None
        if hp.text_packing:
            template_packed = pack_template_table(table, args.text_packing)
            logger.info("text packing: captions -> [R, %d] segment-masked rows; templates "
                        "packed to [%d, %d] (from [%d, %d])", args.text_packing,
                        template_packed.tokens.shape[0], args.text_packing, *table.shape)
        # the v2 objective never touches CoCa's caption decoder
        return make_train_step(model, hp, table, aug=aug, template_packed=template_packed,
                               zero_update_subtrees=("text_decoder",) if coca else (), **routes)
    coca_weights = None
    if coca:
        coca_weights = (args.coca_caption_loss_weight, args.coca_contrastive_loss_weight)
        logger.info("CoCa fine-tune: CoCaLoss caption_w=%g clip_w=%g", *coca_weights)
    return make_flyp_step(model, hp, table, use_gt=args.method == "flyp_gt", aug=aug,
                          use_siglip=args.siglip, teacher=teacher, coca_weights=coca_weights,
                          **routes)


@torch.no_grad()
def load_resumed_weights(model, r_model, args) -> None:
    """Copy the resumed checkpoint's weights into ``model`` by name. Under
    ``--siglip`` a checkpoint without ``logit_bias`` (a plain CLIP) gets it
    again at -10, as JAX re-injects it; any other parameter the checkpoint
    lacks raises ``KeyError``."""
    saved = dict(r_model.named_parameters())
    for name, p in model.named_parameters():
        if name in saved:
            p.copy_(saved[name])
        elif name == "logit_bias" and args.siglip:
            p.fill_(DEFAULT_LOGIT_BIAS)
        else:
            raise KeyError(f"the resumed checkpoint has no {name}")


def main(argv=None) -> int:
    """Parse ``argv``, join torchrun's process group where its environment
    names one (:func:`latteclip_torch.mesh.initialize_distributed`), run,
    and leave the group this call joined."""
    args = parse_args(argv)
    owned = not dist.is_initialized()
    device = mesh_mod.initialize_distributed(args.device)
    try:
        return run(args, device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def run(args, device: torch.device) -> int:
    routes = kernel_routes()
    mesh = None
    if dist.is_initialized():
        mesh = mesh_mod.make_mesh(args.model_parallelism)
    elif args.model_parallelism > 1:
        raise SystemExit(f"--model-parallelism {args.model_parallelism} needs that many ranks "
                         f"or a multiple: launch with torchrun --nproc_per_node N")
    master = mesh_mod.is_master(mesh)
    dp_size = mesh.data_size if mesh is not None else 1

    name = args.name or f"{args.model}_lr{args.lr}_b{args.batch_size}"
    log_dir = os.path.join(args.logs, name)
    checkpoint_dir = os.path.join(log_dir, "checkpoints")
    setup_logging(os.path.join(log_dir, "out.log") if master else None)
    logger.info("device: %s (%s)%s", device, torch.cuda.get_device_name(device)
                if device.type == "cuda" else "host CPU",
                f"; rank {mesh.rank} of {mesh.world_size}, mesh {mesh.shape}, "
                f"{dist.get_backend()}" if mesh is not None else "")
    if master:  # config dump, reference main.py:311-316
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
    if args.imagenet_v2:
        raise SystemExit("--imagenet-v2 needs the imagenetv2_pytorch dataset package "
                         "(reference data.py:142-186), which is not installed in this "
                         "environment")

    cfg, model, bank_by_class = build_model(args, device)
    tokenizer = get_tokenizer_for_config(cfg)
    synthetic_mode = args.dataset_type == "synthetic"
    if synthetic_mode:
        preprocess_path, dataset_name = synthetic_root(args, cfg, dp_size), "dtd"
    else:
        preprocess_path = resolve_preprocess_path(args)
        dataset_name = args.zeroshot_eval_data or "default"

    offline = (args.extract_features_path or args.tta or args.method in ("tpt", "rlcf")
               or args.extract_group_weight_path or not (args.train_data or synthetic_mode))
    if offline and not master:  # the offline and eval-only jobs run on rank 0
        return 0

    # ---- feature-extraction mode: the pseudo-label pickle, then exit ------
    if args.extract_features_path:
        split = args.extract_features_split
        split_ds = FlatFileDataset(preprocess_path, train=(split == "train"),
                                   image_size=cfg.vision.image_size, dataset_name=dataset_name,
                                   resize_mode=cfg.resize_mode)
        extract_features(model, tokenizer, split_ds, args.extract_features_path, split,
                         batch_size=args.batch_size, **routes)
        return 0

    val_dataset = FlatFileDataset(preprocess_path, train=False, image_size=cfg.vision.image_size,
                                  dataset_name=dataset_name, resize_mode=cfg.resize_mode)
    classnames = val_dataset.display_class_names
    templates = val_dataset.templates

    # ---- test-time adaptation on the eval split, then exit -----------------
    if args.tta or args.method in ("tpt", "rlcf"):
        run_tta(args, model, tokenizer, val_dataset, device, routes)
        return 0

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
            model, r_bank, r_names, r_meta = ckpt.load_clip_pt(pt_load_path(args.resume), cfg,
                                                               device=device)
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

    # ---- fusion-weight analysis mode, then exit -----------------------------
    if args.extract_group_weight_path:
        extract_group_weights(model, data, bank, templates, tokenizer,
                              args.extract_group_weight_path, batch_size=args.batch_size,
                              image_size=cfg.vision.image_size, **routes)
        logger.info("group weights written to %s", args.extract_group_weight_path)
        return 0

    refuse_text_packing(args, cfg)
    v2 = args.method == "ours" and not args.gamma
    if args.text_packing and not v2:
        logger.info("--text-packing with method=%s/gamma=%s: the trainer has no caption streams "
                    "to pack; packing the eval classifier template encodes only", args.method,
                    args.gamma)
    aug = build_aug_config(args.aug_cfg)
    if args.use_native_jpeg:
        from latteclip_torch.native import build_status

        st = build_status()
        logger.info("--use-native-jpeg: %s", f"fastjpeg loaded from {st['path']} in "
                    f"{st['seconds']:.2f} s" if st["loaded"] else
                    f"fastjpeg did not build ({st['error']}): JPEGs decode with PIL")
        if args.ondevice_resize:  # the JAX pipeline's precedence
            logger.info("--use-native-jpeg with the on-device resize: the canvases decode "
                        "with PIL, as in the JAX package; --host-resize takes the native decode")
    pipeline = TrainPipeline(data, PipelineConfig(
        batch_size=args.batch_size, image_size=cfg.vision.image_size, seed=args.seed,
        host_index=mesh.data_index if mesh is not None else 0, host_count=dp_size,
        num_threads=args.workers, raw_cache_bytes=args.raw_cache_mb * 1024**2,
        train_with_gt_text=args.train_with_gt_text, ondevice_resize=args.ondevice_resize,
        crop_scale=(aug.scale_min, aug.scale_max), resampled=args.dataset_resampled,
        upsampling_factors=parse_upsampling(args),
        text_packing_len=args.text_packing if v2 else 0,
        text_packing_multiple=8 * dp_size // math.gcd(8, dp_size),
        text_packing_rows=args.text_packing_rows,
        use_native_jpeg=args.use_native_jpeg, pin_memory=device.type == "cuda"), num_samples)
    total_steps = pipeline.steps_per_epoch * args.epochs

    # ---- the trainer's parameters: the resumed weights, logit_bias, teacher --
    refuse_trainer_flags(args, cfg)
    resumed = None
    if args.resume:
        path = (loop_mod.find_latest_checkpoint(checkpoint_dir) if args.resume == "latest"
                else args.resume)
        if path:
            resumed = (path, *ckpt.load_clip_pt(pt_load_path(path), cfg, device=device))
        else:
            logger.info("no checkpoint to resume from in %s", checkpoint_dir)
    if not hasattr(model, "logit_bias") and (
            args.siglip or (resumed is not None and hasattr(resumed[1], "logit_bias"))):
        # a plain CLIP under the SigLIP loss, or resuming a run that had one
        clip_mod.add_logit_bias(model, DEFAULT_LOGIT_BIAS)
    teacher = load_teacher(args, device)

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
        text_packing=bool(args.text_packing) and v2)
    step_fn = make_step(args, model, hp, table, aug, teacher, routes)
    state = create_train_state(model, optimizer, bank)

    # ---- resume --------------------------------------------------------------
    start_epoch = 0
    if resumed is not None:
        path, r_model, r_bank, r_names, r_meta = resumed
        resumed = None
        load_resumed_weights(model, r_model, args)
        del r_model
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
    if mesh is not None:
        mesh_mod.shard_train_state(state, mesh)
        if args.model_parallelism > 1:
            logger.info("model_parallelism=%d across %d ranks: %d MLP leaves sharded; eval and "
                        "checkpoint all-gather them each epoch", args.model_parallelism,
                        mesh.world_size, len(state.tp_dims))

    loop_cfg = loop_mod.LoopConfig(
        epochs=args.epochs, checkpoint_dir=checkpoint_dir, name=name,
        log_every_n_steps=args.log_every_n_steps, zeroshot_frequency=args.zeroshot_frequency,
        val_frequency=args.val_frequency, save_frequency=args.save_frequency,
        save_most_recent=args.save_most_recent,
        delete_previous_checkpoint=args.delete_previous_checkpoint,
        eval_batch_size=args.eval_batch_size, method=args.method, lr_schedule=schedule,
        text_packing=args.text_packing,
        profile_dir=os.path.join(log_dir, "trace") if args.profile else None,
        profile_start_step=args.profile_start_step, profile_num_steps=args.profile_num_steps,
        **routes)
    imagenet_val_dataset = val_pairs_dataset = None
    if args.imagenet_val:
        imagenet_val_dataset = ImageFolderDataset(args.imagenet_val,
                                                  image_size=cfg.vision.image_size,
                                                  dataset_name="imagenet")
    if args.val_data:
        val_pairs_dataset = CsvDataset(args.val_data, img_key=args.csv_img_key,
                                       caption_key=args.csv_caption_key, sep=args.csv_separator,
                                       image_size=cfg.vision.image_size)
    writers = make_writers(args.report_to, args.logs, name, master,
                           wandb_project=args.wandb_project_name, wandb_notes=args.wandb_notes,
                           # reference main.py:451: resume='auto' when resuming from latest
                           wandb_resume="auto" if args.resume == "latest" else None,
                           config=vars(args))
    remote_sync = None
    if args.remote_sync and master:
        remote_sync = RemoteSync(log_dir, os.path.join(args.remote_sync, name),
                                 frequency_s=args.remote_sync_frequency,
                                 protocol=args.remote_sync_protocol).start()
        logger.info("remote sync -> %s every %ds", args.remote_sync, args.remote_sync_frequency)
    loop_mod.train(state, step_fn, pipeline, loop_cfg, classnames, val_dataset=val_dataset,
                   start_epoch=start_epoch, seed=args.seed, tokenizer=tokenizer,
                   templates=templates, val_pairs_dataset=val_pairs_dataset,
                   imagenet_val_dataset=imagenet_val_dataset, writers=writers)
    logger.info("train decodes: %s", json.dumps(pipeline.decode_counts))
    for w in writers:
        w.close()
    if remote_sync is not None:
        remote_sync.final_sync()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
