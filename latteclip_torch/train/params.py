"""CLI argument surface of ``python -m latteclip_torch.train.main``: the
port's copy of ``latteclip_tpu/train/params.py::parse_args``, with the same
flags, ``dest``s, types and defaults, plus the port's ``--device`` (``cuda``
by default; ``cpu`` runs the plain versions of the kernels).

Flags whose feature the port does not have yet stay accepted here;
``train.main`` refuses them with a ``SystemExit`` that names the ROADMAP
item. The help texts are the JAX package's, so they speak of its design.
"""
from __future__ import annotations

import argparse
import ast


class ParseKwargs(argparse.Action):
    """``--aug-cfg key=value ...`` parser (reference params.py:14-24)."""

    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, value = value.split("=")
            try:
                kw[key] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                kw[key] = str(value)
        setattr(namespace, self.dest, kw)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("latteclip_torch.train")

    # data
    p.add_argument("--train-data", type=str, default=None,
                   help="tar shard pattern, e.g. .../train_tar/{00000..00039}.tar")
    p.add_argument("--dataset-type", choices=["webdataset", "synthetic"], default="webdataset")
    p.add_argument("--train-num-samples", type=int, default=None)
    p.add_argument("--clip-prediction-path", type=str, default=None,
                   help="clip_features_train.pkl from the feature-extraction job")
    p.add_argument("--generated-captions-path", type=str, action="append", default=None)
    p.add_argument("--generated-common-captions-path", type=str, action="append", default=None)
    p.add_argument("--val-data", type=str, default=None,
                   help="CSV of (filepath, caption) pairs for val contrastive "
                        "loss + retrieval R@k (reference train.py:1399-1471)")
    p.add_argument("--csv-img-key", type=str, default="filepath")
    p.add_argument("--csv-caption-key", type=str, default="title")
    p.add_argument("--csv-separator", type=str, default="\t")
    p.add_argument("--imagenet-val", type=str, default=None,
                   help="ImageFolder root for ImageNet zero-shot eval "
                        "(reference data.py:886-916)")
    p.add_argument("--zeroshot-eval-data", type=str, default=None,
                   help="dataset key (dtd, eurosat, ...); resolves templates + classnames")
    p.add_argument("--data-dir", type=str, default=None,
                   help="root holding <ds>_preprocess dirs (defaults to $LATTECLIP_DATA_DIR)")
    p.add_argument("--eval-preprocess-path", type=str, default=None,
                   help="explicit preprocess dir (overrides --data-dir/<ds>_preprocess)")
    p.add_argument("--eval-config-path", type=str, default=None,
                   help="YAML task registry (reference eval.yaml format)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--class-per-image", type=int, default=5,
                   help="accepted no-op: in the reference it sizes the k-entry "
                        "'text'/'zeroshot_classnames' webdataset fields "
                        "(data.py:415-449) which the reachable v2/FLYP "
                        "trainers ignore beyond index 0 (v1's squeeze(1) only "
                        "type-checks at k=1); trajectory oracles pass "
                        "without it")
    p.add_argument("--extract-features-path", type=str, default=None,
                   help="run the pseudo-label extraction job into this dir and exit")
    p.add_argument("--extract-features-split", type=str, default="train")

    # model
    p.add_argument("--model", type=str, default="ViT-B-32")
    p.add_argument("--pretrained", type=str, default=None,
                   help="path to an OpenCLIP .pt state dict / checkpoint")
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["bf16", "fp32"], help="compute dtype policy")
    p.add_argument("--grad-checkpointing", action="store_true")
    p.add_argument("--fuse-text-forward",
                   type=lambda s: s.lower() in ("1", "true", "yes"),
                   default=False, metavar="BOOL",
                   help="encode templates + both caption streams in ONE "
                        "[C+2B,77] text forward (value/grad-identical; "
                        "tools/r3_levers.py measures whether it wins)")
    p.add_argument("--grad-checkpointing-text", type=lambda s: s.lower() in ("1", "true", "yes"),
                   default=None, metavar="BOOL",
                   help="per-tower override: rematerialize the TEXT tower "
                        "independently of --grad-checkpointing (unset: follow it)")
    p.add_argument("--grad-checkpointing-vision", type=lambda s: s.lower() in ("1", "true", "yes"),
                   default=None, metavar="BOOL",
                   help="per-tower override: rematerialize the VISION tower "
                        "independently of --grad-checkpointing (unset: follow "
                        "it); vision residuals are small at B/32 (L=50), so "
                        "false can trade HBM for recompute there")
    p.add_argument("--force-quick-gelu", action="store_true")
    p.add_argument("--force-image-size", type=int, default=None,
                   help="override the config's vision image size (reference "
                        "params.py:569 / factory.py:225-227); pretrained pos "
                        "embeds are bicubic-resized at load")

    # optimization (ViT defaults, reference params.py:5-11)
    p.add_argument("--lr", type=float, default=5.0e-4)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.98)
    p.add_argument("--eps", type=float, default=1.0e-6)
    p.add_argument("--wd", type=float, default=0.2)
    p.add_argument("--warmup", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=32)
    p.add_argument("--lr-scheduler", type=str, default="cosine",
                   choices=["cosine", "const", "const-cooldown"])
    p.add_argument("--epochs-cooldown", type=int, default=None)
    p.add_argument("--lr-cooldown-end", type=float, default=0.0)
    p.add_argument("--lr-cooldown-power", type=float, default=1.0)
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--accum-freq", type=int, default=1,
                   help="gradient accumulation steps (optax.MultiSteps)")
    # LiT-style tower locking (reference params.py --lock-image/--lock-text,
    # main.py:294-305). unlocked-groups counts from the output end: 1 =
    # post-norm/proj only, 2 = + last block, ... (transformer.py:435-466).
    p.add_argument("--lock-image", action="store_true", default=False)
    p.add_argument("--lock-image-unlocked-groups", type=int, default=0)
    p.add_argument("--lock-text", action="store_true", default=False)
    p.add_argument("--lock-text-unlocked-groups", type=int, default=0)

    p.add_argument("--extract-group-weight-path", type=str, default=None,
                   help="write per-image fusion-weight pkls and exit "
                        "(reference params.py:247-251, main.py:467-468)")
    p.add_argument("--train-with-gt-text", action="store_true", default=False,
                   help="replace the per-image caption with the lowercased "
                        "gt classname (reference data.py:476-477; debugging)")
    p.add_argument("--ondevice-resize", dest="ondevice_resize",
                   action="store_true", default=True,
                   help="run RandomResizedCrop on device over cached uint8 "
                        "canvases (host only decodes each image once); "
                        "removes the PIL-resize host bottleneck. DEFAULT on "
                        "TPU (1.85x the host path on few-core hosts)")
    p.add_argument("--host-resize", dest="ondevice_resize",
                   action="store_false",
                   help="PIL bicubic RandomResizedCrop on the host — the "
                        "reference's exact pixel geometry (parity escape; "
                        "the crop-box sampling is identical either way)")
    p.add_argument("--raw-cache-mb", type=int, default=2048,
                   help="in-memory raw tar-record cache budget (MB): epochs "
                        "after the first replay parsed shard records instead "
                        "of re-reading tars (tar parsing measured 82%% of the "
                        "warm producer epoch on a 1-core host); 0 disables")
    p.add_argument("--use-native-jpeg", action="store_true", default=False,
                   help="native fused JPEG decode+crop+resize for train "
                        "augmentation (latteclip_tpu/native)")
    p.add_argument("--remote-sync", type=str, default=None,
                   help="remote dir (s3:// or mounted path) to mirror the "
                        "run dir into (reference file_utils.py:54-61)")
    p.add_argument("--remote-sync-frequency", type=int, default=300)
    p.add_argument("--aug-cfg", nargs="*", default={}, action=ParseKwargs,
                   help="augmentation overrides as key=value pairs "
                        "(reference params.py:549): scale=(0.9,1.0), "
                        "color_jitter=(0.5,0.5,0.5,0.1), color_jitter_prob, "
                        "gray_scale_prob")
    p.add_argument("--distill-model", type=str, default=None,
                   help="teacher architecture for distillation (reference "
                        "params.py --distill-model; applies to flyp/flyp_gt)")
    p.add_argument("--distill-pretrained", type=str, default=None,
                   help="teacher checkpoint path (reference --distill-pretrained)")
    p.add_argument("--report-to", type=str, default="",
                   help="comma-separated metric sinks: tensorboard and/or "
                        "wandb (reference params.py / main.py:434-457); "
                        "tensorboard uses the stdlib event writer in "
                        "obs/tensorboard.py")
    # ---- reference-compat surface (reference params.py) --------------------
    # wired semantics
    p.add_argument("--skip-scheduler", action="store_true", default=False,
                   help="constant lr (the scheduler is never stepped — "
                        "reference train.py:363)")
    p.add_argument("--val-frequency", type=int, default=1,
                   help="run the --val-data loss/retrieval branch every N "
                        "epochs (reference train.py:1400-1401)")
    p.add_argument("--save-most-recent", dest="save_most_recent",
                   action="store_true", default=True,
                   help="keep an atomic epoch_latest.pt (reference "
                        "main.py:546-551). We default ON — resume-latest is "
                        "the common path and the atomic write is free; "
                        "--no-save-most-recent restores the reference's "
                        "default-off")
    p.add_argument("--no-save-most-recent", dest="save_most_recent",
                   action="store_false")
    p.add_argument("--image-mean", type=float, nargs="+", default=None,
                   help="override the model's image mean (reference "
                        "main.py:251)")
    p.add_argument("--image-std", type=float, nargs="+", default=None)
    p.add_argument("--image-interpolation", default=None,
                   choices=("bicubic", "bilinear", "random"),
                   help="only bicubic is implemented on the TPU resize path "
                        "(PIL-parity); other values warn and fall back")
    p.add_argument("--image-resize-mode", default=None,
                   choices=("shortest", "longest", "squash"),
                   help="override eval resize geometry (reference "
                        "transform.py:378-425)")
    p.add_argument("--force-patch-dropout", type=float, default=None,
                   help="override the model config's patch dropout "
                        "(reference main.py:249)")
    p.add_argument("--remote-sync-protocol", choices=("s3", "fsspec"),
                   default="s3",
                   help="s3: aws-s3-sync for s3:// urls; fsspec: recursive "
                        "copy (reference file_utils.py:20-61)")
    p.add_argument("--dataset-resampled", action="store_true", default=False,
                   help="sample shards WITH replacement per epoch (reference "
                        "ResampledShards2, data.py:311-365,520)")
    p.add_argument("--train-data-upsampling-factors", type=str, default=None,
                   help="per-::-source sampling weights; requires "
                        "--dataset-resampled (reference data.py:542-551)")
    p.add_argument("--lock-text-unlocked-layers", type=int, default=0,
                   help="reference spelling; alias of "
                        "--lock-text-unlocked-groups")
    p.add_argument("--val-num-samples", type=int, default=None,
                   help="accepted for reference-script compat (the reference "
                        "only prints it, train.py:1376)")
    p.add_argument("--coca-caption-loss-weight", type=float, default=2.0)
    p.add_argument("--coca-contrastive-loss-weight", type=float, default=1.0)
    # no-ops whose behavior is the TPU design's default — accepted so
    # reference invocations run unchanged, documented here:
    #   --local-loss / --gather-with-grad: the GSPMD full-matrix InfoNCE is
    #     math-identical to local-loss + differentiable gather (XLA inserts
    #     and differentiates the all-gather);
    #   --force-custom-text: towers are separate pure functions already;
    #   --lock-image-freeze-bn-stats / --use-bn-sync: BN statistics are
    #     frozen plain params by construction (models/resnet.py);
    #   --lock-text-freeze-layer-norm: locking freezes whole groups
    #     including their LNs.
    for flag in ("--local-loss", "--gather-with-grad", "--force-custom-text",
                 "--lock-image-freeze-bn-stats", "--lock-text-freeze-layer-norm",
                 "--use-bn-sync"):
        p.add_argument(flag, action="store_true", default=False,
                       help="accepted for reference compat; behavior is the "
                            "TPU design's default (see params.py comment)")
    # GPU/infra flags with no TPU counterpart: accepted and warn-ignored so
    # reference scripts run; torch-runtime (torchscript/compile/trace,
    # bitsandbytes), NCCL/launcher (dist-url/backend, horovod, DDP knobs),
    # and debug conveniences
    for flag, kw in (
        ("--torchscript", {}), ("--torchcompile", {}), ("--trace", {}),
        ("--horovod", {}), ("--ddp-static-graph", {}),
        ("--no-set-device-rank", {}), ("--use-bnb-linear", dict(type=str)),
        ("--dist-url", dict(type=str)), ("--dist-backend", dict(type=str)),
        ("--debug", {}), ("--copy-codebase", {}), ("--log-local", {}),
        ("--pretrained-image", {}),
    ):
        kwargs = dict(kw) if kw else dict(action="store_true", default=False)
        if "type" in kwargs:
            kwargs["default"] = None
        p.add_argument(flag, help="GPU/infra flag with no TPU counterpart; "
                                  "accepted and warn-ignored", **kwargs)
    # vestigial reference flags: accepted by the reference but never consumed
    # by any reachable code path there either (legacy v1 trainer / dead code)
    for flag, kw in (
        ("--subsample-ratio", dict(type=float, default=1.0)),
        ("--visual-adapter-ratio", dict(type=float, default=0.0)),
        ("--text-adapter-ratio", dict(type=float, default=0.0)),
        ("--abo-zeroshot-eval", dict(action="store_true", default=False)),
        ("--caltech101-zeroshot-eval", dict(action="store_true", default=False)),
        ("--flower102-zeroshot-eval", dict(action="store_true", default=False)),
        ("--multiclass-loss", dict(action="store_true", default=False)),
        ("--n-images", dict(type=int, default=4)),
        ("--hard-mining-captions-path", dict(type=str, default=None)),
        ("--hard-mining-loss-weight", dict(type=float, default=0.0)),
        ("--gen-text-label-weight", dict(type=float, default=1.0)),
        ("--similar-images-path", dict(type=str, default=None)),
        ("--mllm-pred-path", dict(type=str, default=None)),
        ("--num-hard-mining-samples", dict(type=int, default=0)),
        ("--distill-weight", dict(type=float, default=1.0)),
        ("--preprocess-path", dict(type=str, default=None)),
    ):
        p.add_argument(flag, help="vestigial reference flag (unused by the "
                                  "reference's reachable paths); accepted "
                                  "for CLI compat", **kw)
    p.add_argument("--imagenet-v2", type=str, default=None,
                   help="ImageNet-V2 eval root (reference data.py:142-186 "
                        "via the imagenetv2_pytorch package — absent in this "
                        "environment; setting it raises with the reason)")
    p.add_argument("--text-context-cap", type=str, default="",
                   help="cap caption/template text encodes to a shorter "
                        "static context ('auto' = dataset max EOT rounded to "
                        "a multiple of 8, or an int; default off = the "
                        "reference's full 77 columns). EXACT when every text "
                        "fits: causal masking + EOT pooling make positions "
                        "past the longest EOT invisible — only the wasted "
                        "attention/GEMM columns are removed (TPU-native "
                        "optimization, no reference counterpart)")
    p.add_argument("--text-packing", type=int, default=0,
                   help="variable-length sequence packing for the caption "
                        "text forwards: pack real-length token runs end to "
                        "end into rows of THIS many columns (128 recommended; "
                        "0 = off) with segment-masked attention; templates "
                        "pack statically. EXACT vs the reference's pad-to-77 "
                        "(tokenizer.py:250-258) for the native argmax-pool "
                        "CLIP text tower; the tower runs on ~sum(len) tokens "
                        "(TPU-native optimization, no reference counterpart). "
                        "With --method flyp/flyp_gt or --gamma the trainer "
                        "has no caption streams; packing then applies to the "
                        "eval classifier template encodes only")
    p.add_argument("--text-packing-rows", type=int, default=None,
                   help="pin the packed row count per batch (static jit "
                        "shape). Default: adaptive monotonic bucketing; "
                        "REQUIRED for multi-host --text-packing runs")
    p.add_argument("--wandb-notes", default="", type=str,
                   help="Notes if logging with wandb (reference params.py:634)")
    p.add_argument("--wandb-project-name", type=str, default="open-clip",
                   help="wandb project name (reference params.py:637-640)")
    p.add_argument("--siglip", action="store_true", default=False,
                   help="train the flyp/flyp_gt path with the SigLIP sigmoid "
                        "loss (reference factory.py:337-341, loss.py:365-560)")
    # LatteCLIP objective / eval method
    p.add_argument("--method", type=str, default="ours",
                   choices=["ours", "flyp", "flyp_gt", "tpt", "rlcf"])
    # test-time adaptation (reference params.py:31-35,454-459,78-83)
    p.add_argument("--tta", action="store_true", help="run TTA evaluation and exit")
    p.add_argument("--tta-step", type=int, default=1)
    p.add_argument("--selection-p", "--selection_p", dest="selection_p", type=float, default=0.1)
    p.add_argument("--tta-n-views", type=int, default=63)
    p.add_argument("--tta-max-samples", type=int, default=None)
    p.add_argument("--reward-model", type=str, default=None, help="RLCF reward model config name")
    p.add_argument("--reward-pretrained", type=str, default=None)
    p.add_argument("--alpha", type=float, default=0.01)
    p.add_argument("--beta", type=float, default=0.01,
                   help="accepted no-op: declared by the reference's params.py "
                        "but never read anywhere in its source (grep: zero "
                        "args.beta uses)")
    p.add_argument("--gamma", type=float, default=0.0,
                   help="momentum weight of image features in the prototype "
                        "EMA update; non-zero selects the reference's legacy "
                        "v1 trainer (train.py:811-1126, mix at :953)")
    p.add_argument("--use-template-caption", type=float, default=1.0)
    p.add_argument("--use-image-caption", type=float, default=1.0)
    p.add_argument("--use-batch-caption", type=float, default=1.0)
    p.add_argument("--use-zeroshot-pseudolabel", type=float, default=1.0)
    p.add_argument("--use-finetune-pseudolabel", type=float, default=1.0)
    p.add_argument(
        "--fusion-bug-compat", action="store_true", default=False,
        help="replay the reference's two latent fusion bugs bit-for-bit "
        "(requires batch == embed_dim; see train/step.py::fuse_text_streams)",
    )
    p.add_argument("--text-type", type=str, default="concat",
                   help="accepted no-op: shapes the reference's 'text' "
                        "webdataset field (data.py:431-438), which the "
                        "reachable v2/FLYP trainers never consume (they read "
                        "per_image/per_group/label_text); the trajectory "
                        "oracle vs the real v2 passes without it")

    # profiling (TPU counterpart of the reference's --trace / --torchcompile /
    # profiler.py tooling: model.py:762-775, main.py:463-465, profiler.py:82-122)
    p.add_argument("--profile", action="store_true", default=False,
                   help="capture a torch.profiler trace (host and device) of a "
                        "few warm train steps into <logs>/<name>/trace as a "
                        "Chrome trace (view with Perfetto or TensorBoard's "
                        "profile plugin)")
    p.add_argument("--profile-start-step", type=int, default=3,
                   help="first global step inside the trace window (after "
                        "compile + pipeline warmup)")
    p.add_argument("--profile-num-steps", type=int, default=5,
                   help="number of steps the trace window covers")

    # bookkeeping
    p.add_argument("--logs", type=str, default="./logs/")
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", type=str, default=None, help="'latest' or a checkpoint path")
    p.add_argument("--zeroshot-frequency", type=int, default=1)
    p.add_argument("--save-frequency", type=int, default=1)
    p.add_argument("--delete-previous-checkpoint", action="store_true")
    p.add_argument("--log-every-n-steps", type=int, default=10)
    p.add_argument("--eval-batch-size", type=int, default=64)

    # parallelism
    p.add_argument("--model-parallelism", type=int, default=1)

    # the port's own: where the model runs (device.resolve_device)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a CUDA device) or cpu "
                        "(the kernels' plain versions)")

    return p.parse_args(argv)
