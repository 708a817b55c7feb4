"""LatteCLIP training input pipeline: tar shards -> batches on the device
(port of ``latteclip_tpu/data/pipeline.py``: ``load_caption_tokens``,
``apply_context_cap``, ``build_train_data``, ``PipelineConfig``,
``TrainPipeline`` and ``prefetch``).

The semantics are the JAX package's, which reproduce the reference
webdataset pipeline (``src/training/data.py:514-777``): captions and
templates tokenized once at construction; the caption join by ``__key__``
with a random caption directory and a random same-pseudo-class donor for the
group caption; the epoch-seeded shard shuffle and the bounded shuffle buffer;
``steps_per_epoch = ceil(num_samples / batch)`` with wraparound. Every sample
draws from its own seed, taken in stream order, so batches do not depend on
the decode threads' timing. The raw-record cache replays parsed shard records
after the first epoch, the decode cache keeps decoded images (or, on the
on-device crop path, ``cfg.canvas_size`` canvases edge-replicated past the
image, with the crop box drawn in the original image's coordinates), and the
caption packer runs on the producer.

The host-to-device copy: with ``cfg.pin_memory`` each batch is assembled in
pinned host buffers, and :func:`prefetch` with a CUDA ``device`` issues the
copies ``non_blocking`` on a side stream from its thread; the consumer's
stream waits on that copy's event, and ``record_stream`` keeps the caching
allocator from handing a buffer to the side stream while the step still
reads it. Errors on the prefetch thread are raised in the consumer.

Batch dict fields (numpy, or tensors on the device after :func:`prefetch`):
  ``images``      uint8  [B, S, S, 3] random-resized-crop output, or
                  [B, CV, CV, 3] canvases with ``crop_boxes`` float32 [B, 4]
  ``per_image_tokens`` int32 [B, 77], ``per_group_tokens`` int32 [B, 77]
  ``zs_preds``    int32  [B] pseudo-label class ids (pkl top-1)
  ``gt_labels``   int32  [B] ground-truth ids (diagnostics)
  ``cap_*``       the packed caption arrays under ``text_packing_len``

With ``use_native_jpeg`` a JPEG sample is decoded, cropped and resized in
one pass by :mod:`latteclip_torch.native` (its crop box drawn as PIL's;
no decode cache), as JAX does; where the decoder does not build, or fails
on a file, the sample takes the PIL decode. ``TrainPipeline.decode_counts``
counts the native decodes, the PIL decodes and the decode-cache hits, so a
run can tell which decoder it used.
"""
from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import pickle
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from collections import deque
from concurrent.futures import Future
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from latteclip_torch.data import transforms as T
from latteclip_torch.data.packing import (
    PackRowBucketer,
    pack_caption_batch,
    pack_rows_needed,
    token_lengths,
)
from latteclip_torch.data.tar_reader import (
    ShuffleBuffer,
    expand_shard_pattern,
    iter_shards_samples,
    iter_tar_samples,
    resampled_shards,
    shuffled_shards,
    split_shards,
)
from latteclip_torch.models.tokenizer import ClipTokenizer
from latteclip_torch.obs.trace import span

logger = logging.getLogger(__name__)


def load_caption_tokens(
    caption_dir: str, tokenizer: ClipTokenizer
) -> Dict[str, np.ndarray]:
    """{image_id: int32 [77]} from a dir of {image_id}.txt (first line only,
    matching what the v2 trainer consumes — reference data.py:441-442)."""
    out: Dict[str, np.ndarray] = {}
    files = [f for f in os.listdir(caption_dir) if f.endswith(".txt")]
    texts, ids = [], []
    for fname in files:
        image_id = os.path.splitext(fname)[0]
        with open(os.path.join(caption_dir, fname)) as f:
            first_line = f.read().strip().split("\n")[0]
        ids.append(image_id)
        texts.append(first_line)
    if ids:
        tokens = tokenizer(texts)
        out = {i: tokens[n] for n, i in enumerate(ids)}
    return out


def _max_context(arrs, eot_id: int) -> int:
    """max(eot position) + 1 over int32 [.., ctx] token arrays."""
    best = 0
    for a in arrs:
        if a is None or a.size == 0:
            continue
        best = max(best, int(np.argmax(np.atleast_2d(a) == eot_id, axis=-1).max()) + 1)
    return best


def _truncate_tokens(a: np.ndarray, cap: int, eot_id: int) -> np.ndarray:
    """Slice token rows to ``cap`` columns with the tokenizer's forced-EOT
    truncation rule (reference tokenizer.py:254-256) for any row whose EOT
    lies beyond the cap."""
    out = np.ascontiguousarray(np.atleast_2d(a)[:, :cap]).copy()
    lost = ~(out == eot_id).any(axis=-1)
    out[lost, -1] = eot_id
    return out.reshape(a.shape[:-1] + (cap,)), int(lost.sum())


def apply_context_cap(
    data: "LatteCLIPTrainData",
    cap,
    eot_id: int,
    template_table: Optional[np.ndarray] = None,
):
    """Cap every pre-tokenized text to a shorter static context length.

    EXACT-SEMANTICS optimization: CLIP text features are read at the EOT
    position of a causally-masked tower, so positions past the longest EOT
    are invisible to every output — truncating them changes nothing but the
    (quadratic-in-ctx attention + linear GEMM) compute. ``cap='auto'``
    computes the dataset maximum from the already-loaded token tables and
    rounds up to a multiple of 8 (sublane-friendly); an int cap below the
    dataset max falls back to the tokenizer's own forced-EOT truncation
    rule for the overlong rows (logged — that is the only case where
    results can differ from the uncapped run). The reference always
    computes the full 77 columns (tokenizer.py:23); cap=0/None disables.

    Returns ``(data, template_table, effective_cap, truncated_rows)``.
    """
    all_arrs = [t for d in data.per_image_tokens for t in d.values()]
    all_arrs += list(data.group_tokens.values())
    if data.gt_text_tokens is not None:
        all_arrs.append(data.gt_text_tokens)
    if template_table is not None:
        all_arrs.append(np.asarray(template_table))
    full = max((a.shape[-1] for a in all_arrs), default=77)
    needed = _max_context(all_arrs, eot_id)
    if cap in (None, 0, "0", ""):
        return data, template_table, full, 0
    effective = needed if cap == "auto" else int(cap)
    effective = min(full, max(16, -(-effective // 8) * 8))

    truncated = 0

    def cap_dict(d):
        nonlocal truncated
        out = {}
        for k, v in d.items():
            out[k], lost = _truncate_tokens(v, effective, eot_id)
            truncated += lost
        return out

    data = dataclasses.replace(
        data,
        per_image_tokens=[cap_dict(d) for d in data.per_image_tokens],
        group_tokens=cap_dict(data.group_tokens),
    )
    if data.gt_text_tokens is not None:
        gt, lost = _truncate_tokens(data.gt_text_tokens, effective, eot_id)
        truncated += lost
        data = dataclasses.replace(data, gt_text_tokens=gt)
    if template_table is not None:
        template_table, lost = _truncate_tokens(
            np.asarray(template_table), effective, eot_id)
        truncated += lost
    return data, template_table, effective, truncated


@dataclasses.dataclass
class LatteCLIPTrainData:
    """Join tables + shard list for the unsupervised fine-tune pipeline."""

    shards: List[str]
    class_names: List[str]                    # lowercased display names, id order
    zs_top1: Dict[str, int]                   # image_id -> pseudo-label class id
    per_image_tokens: List[Dict[str, np.ndarray]]  # one dict per caption dir
    group_tokens: Dict[str, np.ndarray]       # image_id -> group caption tokens
    class_to_image_ids: Dict[int, List[str]]  # pseudo-class id -> donor ids
    gt_label: Dict[str, int]                  # image_id -> gt id (from metadata)
    gt_text_tokens: Optional[np.ndarray] = None  # [C, ctx] tokenized classnames

    @property
    def name_to_id(self) -> Dict[str, int]:
        if not hasattr(self, "_name_to_id"):
            object.__setattr__(self, "_name_to_id",
                               {c: i for i, c in enumerate(self.class_names)})
        return self._name_to_id


def build_train_data(
    train_shards: str,
    clip_prediction_path: str,
    caption_dirs: Sequence[str],
    common_caption_dirs: Sequence[str],
    class_names: Sequence[str],
    tokenizer: ClipTokenizer,
) -> LatteCLIPTrainData:
    """Load pseudo-labels + pre-tokenize captions (pipeline-build time)."""
    shards = expand_shard_pattern(train_shards)
    with open(clip_prediction_path, "rb") as f:
        predictions = pickle.load(f)

    name_to_id = {c: i for i, c in enumerate(class_names)}
    zs_top1: Dict[str, int] = {}
    class_to_image_ids: Dict[int, List[str]] = {}
    for image_id, rec in predictions.items():
        top1_name = rec["class_names"][0]
        cid = name_to_id[top1_name]
        zs_top1[image_id] = cid
        class_to_image_ids.setdefault(cid, []).append(image_id)

    per_image = [load_caption_tokens(d, tokenizer) for d in caption_dirs]
    gt_text_tokens = tokenizer([c.lower() for c in class_names])
    group: Dict[str, np.ndarray] = {}
    if common_caption_dirs:
        # reference uses the first common-caption dir only (data.py:424)
        group = load_caption_tokens(common_caption_dirs[0], tokenizer)

    return LatteCLIPTrainData(
        shards=shards,
        class_names=list(class_names),
        zs_top1=zs_top1,
        per_image_tokens=per_image,
        group_tokens=group,
        class_to_image_ids=class_to_image_ids,
        gt_text_tokens=gt_text_tokens,
        gt_label={},
    )


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int = 512
    image_size: int = 224
    seed: int = 0
    shuffle_buffer: int = 5000
    num_threads: int = 8
    host_index: int = 0
    host_count: int = 1
    prefetch_batches: int = 2
    # Decoded-image cache: LatteCLIP datasets are small (3.9k-70k images) and
    # run for 15-100 epochs; caching the decoded RGB arrays makes epochs 2+
    # skip JPEG decode entirely (the host-side bottleneck). Capped in bytes;
    # 0 disables.
    decode_cache_bytes: int = 4 * 1024**3
    # JPEGs through the native fused decode + crop + resize (latteclip_torch.native)
    use_native_jpeg: bool = False
    # --dataset-resampled: per-epoch shard sampling WITH replacement
    # (reference ResampledShards2, data.py:311-365,520); optional per-shard
    # weights expanded from --train-data-upsampling-factors
    resampled: bool = False
    upsampling_factors: Optional[Sequence[float]] = None
    # Replace the per-image caption with the lowercased ground-truth
    # classname (reference --train-with-gt-text, data.py:476-477; debugging)
    train_with_gt_text: bool = False
    # On-device RandomResizedCrop: the host only decodes + downsizes each
    # image ONCE to a fixed uint8 canvas (cached), samples the torchvision
    # crop box in original coordinates, and ships (canvas, box); the batched
    # antialiased bicubic crop+resize runs inside the jitted train step
    # (transforms.device_random_resized_crop). Removes the per-epoch PIL
    # resize that host-binds the loop on few-core machines.
    ondevice_resize: bool = False
    canvas_size: int = 256
    # RandomResizedCrop area-scale range (--aug-cfg scale=..., reference
    # AugmentationCfg; LatteCLIP forces (0.9, 1.0), main.py:233-235)
    crop_scale: tuple = (0.9, 1.0)
    # steps_per_epoch rounding: reference get_wds_dataset(floor=False) uses
    # math.ceil(num_samples / global_batch) (data.py:727-729); floor=True is
    # the reference's unused escape hatch, kept for completeness.
    floor: bool = False
    # Raw-record shard cache: after the first full read of a shard, keep its
    # parsed sample records in memory so later epochs skip tarfile parsing
    # entirely (measured 82% of the warm-cache producer epoch on a 1-core
    # host — Python tar header/pax parsing, not disk IO). Image payloads are
    # dropped from cached records once their decode lands in the decode
    # cache, so the steady-state footprint is keys+json only. Capped in
    # bytes; 0 disables. The reference's DataLoader re-parses every epoch
    # and hides it behind multi-worker processes (data.py:751-757).
    raw_cache_bytes: int = 2 * 1024**3
    # --text-packing: pack both caption streams' real-length token runs into
    # [R, text_packing_len] rows (data/packing.py) and add cap_* arrays to
    # every batch. 0 disables. ``text_packing_multiple`` rounds the monotonic
    # row bucket (set to lcm(8, data-parallel size) so rows shard);
    # ``text_packing_rows`` pins R outright (required multi-host — adaptive
    # per-host buckets would disagree on the global shape).
    text_packing_len: int = 0
    text_packing_multiple: int = 8
    text_packing_rows: Optional[int] = None
    # assemble batches in pinned host memory, for prefetch's non_blocking copy
    pin_memory: bool = False


class TrainPipeline:
    """Epoch-aware iterator over device-ready batches.

    One instance per host; shards are split across hosts round-robin
    (split_by_node semantics). Decode + crop runs on a thread pool; the
    Python-side join is array gathers over the pre-tokenized tables.
    """

    def __init__(self, data: LatteCLIPTrainData, cfg: PipelineConfig, num_samples: int):
        self.data = data
        self.cfg = cfg
        self.num_samples = num_samples
        global_batch = cfg.batch_size * cfg.host_count
        round_fn = (lambda a, b: a // b) if cfg.floor else (lambda a, b: -(-a // b))
        self.steps_per_epoch = max(1, round_fn(num_samples, global_batch))
        self._shard_weights = None
        if cfg.upsampling_factors is not None:
            assert cfg.resampled, "--train-data-upsampling-factors needs --dataset-resampled"
            weights = list(cfg.upsampling_factors)
            assert len(weights) == len(data.shards), (
                f"per-shard upsampling weights ({len(weights)}) must match "
                f"the shard count ({len(data.shards)})")
            self._shard_weights = weights
        self._tok_dim = (
            next(iter(data.group_tokens.values())).shape[0]
            if data.group_tokens
            else next(iter(data.per_image_tokens[0].values())).shape[0]
            if data.per_image_tokens and data.per_image_tokens[0]
            else 77
        )
        self._epoch_rngs: Dict[int, np.random.Generator] = {}
        self._decode_cache: Dict[str, np.ndarray] = {}
        self._decode_cache_used = 0
        self._shard_cache: Dict[str, List[dict]] = {}
        self._shard_cache_used = 0
        self.decode_counts = {"native": 0, "pil": 0, "cached": 0}
        self._count_lock = threading.Lock()
        self._pack_bucketer = None
        if cfg.text_packing_len:
            if cfg.host_count > 1 and cfg.text_packing_rows is None:
                raise ValueError(
                    "--text-packing in a multi-host job needs an explicit "
                    "--text-packing-rows: adaptive per-host row buckets would "
                    "disagree on the global packed-array shape"
                )
            if cfg.text_packing_len < self._tok_dim:
                raise ValueError(
                    f"--text-packing {cfg.text_packing_len} < token context "
                    f"{self._tok_dim}: a full-length caption would not fit in "
                    "one packed row (use >= the context, e.g. 128)"
                )
            self._pack_bucketer = PackRowBucketer(
                multiple=cfg.text_packing_multiple, fixed=cfg.text_packing_rows
            )

    # -- shard-level record cache --------------------------------------------
    _IMG_EXTS = ("jpg", "jpeg", "png", "webp")

    def _iter_shards(self, shards: Sequence[str]) -> Iterator[Dict[str, bytes]]:
        """``iter_shards_samples`` with the raw-record cache: the first full
        read of a shard keeps its parsed records (``cfg.raw_cache_bytes``
        budget); later epochs replay from memory instead of re-parsing the
        tar. Image payloads are dropped from cached records once the decode
        cache owns the pixels (``_assemble`` checks the decode cache before
        requiring bytes), so steady state holds keys+json only."""
        for shard in shards:
            recs = self._shard_cache.get(shard)
            if recs is not None:
                for r in recs:
                    if r["__key__"] in self._decode_cache:
                        for ext in self._IMG_EXTS:
                            b = r.pop(ext, None)
                            if b is not None:
                                self._shard_cache_used -= len(b)
                    yield r
                continue
            if not self.cfg.raw_cache_bytes:
                yield from iter_tar_samples(shard)
                continue
            recs, nbytes = [], 0
            for raw in iter_tar_samples(shard):
                recs.append(raw)
                nbytes += sum(len(v) for v in raw.values()
                              if isinstance(v, (bytes, bytearray)))
                yield raw
            if self._shard_cache_used + nbytes <= self.cfg.raw_cache_bytes:
                self._shard_cache[shard] = recs
                self._shard_cache_used += nbytes

    # -- sample-level assembly ---------------------------------------------
    def _assemble(self, raw: Dict[str, bytes], rng: np.random.Generator) -> Optional[dict]:
        image_id = raw["__key__"]
        if image_id not in self.data.zs_top1:
            return None  # no pseudo-label -> reference pipeline would KeyError; we skip
        img_bytes = raw.get("jpg") or raw.get("jpeg") or raw.get("png") or raw.get("webp")
        if img_bytes is None and image_id not in self._decode_cache:
            return None
        if self.cfg.ondevice_resize:
            return self._assemble_ondevice(raw, image_id, img_bytes, rng)
        if self.cfg.use_native_jpeg and img_bytes and ("jpg" in raw or "jpeg" in raw):
            from latteclip_torch.native import load_fastjpeg

            fj = load_fastjpeg()
            if fj is not None:
                try:
                    w, h = fj.probe(img_bytes)
                    left, top, cw, ch = T.random_crop_box(w, h, rng, self.cfg.crop_scale)
                    out = fj.decode_crop_resize(img_bytes, left, top, cw, ch, self.cfg.image_size)
                    arr = np.frombuffer(out, np.uint8).reshape(
                        self.cfg.image_size, self.cfg.image_size, 3)
                    self._count("native")
                    return self._finish_sample(raw, image_id, arr, rng)
                except ValueError as e:
                    logger.warning("native decode failed for %s: %s", image_id, e)
        try:
            cached = self._decode_cache.get(image_id)
            if cached is not None:
                img = Image.fromarray(cached)
                self._count("cached")
            else:
                img = T.load_rgb(io.BytesIO(img_bytes))
                self._count("pil")
                if self.cfg.decode_cache_bytes:
                    arr_full = np.asarray(img, dtype=np.uint8)
                    if self._decode_cache_used + arr_full.nbytes <= self.cfg.decode_cache_bytes:
                        # benign under threads: worst case a duplicate store
                        self._decode_cache[image_id] = arr_full
                        self._decode_cache_used += arr_full.nbytes
            arr = T.random_resized_crop(img, self.cfg.image_size, rng, self.cfg.crop_scale)
        except Exception as e:  # tolerant decode, reference data.py:208-211
            logger.warning("decode failed for %s: %s", image_id, e)
            return None
        return self._finish_sample(raw, image_id, arr, rng)

    def _count(self, kind: str) -> None:
        with self._count_lock:
            self.decode_counts[kind] += 1

    def _assemble_ondevice(self, raw, image_id, img_bytes, rng) -> Optional[dict]:
        """Canvas + crop-box sample for the on-device resize path."""
        CV = self.cfg.canvas_size
        try:
            entry = self._decode_cache.get(image_id)
            if entry is None:
                img = T.load_rgb(io.BytesIO(img_bytes))
                self._count("pil")
                w, h = img.size
                f = min(1.0, CV / max(w, h))
                sw, sh = max(1, round(w * f)), max(1, round(h * f))
                if (sw, sh) != (w, h):
                    img = img.resize((sw, sh), Image.BICUBIC)
                content = np.asarray(img, dtype=np.uint8)
                # edge-replicate into the padding: the device resampler's
                # antialias tails read past the crop edge, and PIL clamps at
                # the image border — zero padding would darken border rows of
                # every non-square image (measured ~4% on constant images)
                canvas = np.empty((CV, CV, 3), np.uint8)
                canvas[:sh, :sw] = content
                canvas[:sh, sw:] = content[:, -1:]
                canvas[sh:, :sw] = content[-1:, :]
                canvas[sh:, sw:] = content[-1:, -1:]
                entry = (canvas, sw, sh, w, h)
                if (
                    self.cfg.decode_cache_bytes
                    and self._decode_cache_used + canvas.nbytes <= self.cfg.decode_cache_bytes
                ):
                    self._decode_cache[image_id] = entry
                    self._decode_cache_used += canvas.nbytes
            else:
                self._count("cached")
            canvas, sw, sh, w, h = entry
        except Exception as e:  # tolerant decode, reference data.py:208-211
            logger.warning("decode failed for %s: %s", image_id, e)
            return None
        # torchvision box in ORIGINAL coordinates (exact reference
        # semantics), mapped into the downsized canvas
        left, top, cw, ch = T.random_crop_box(w, h, rng, self.cfg.crop_scale)
        fx, fy = sw / w, sh / h
        box = np.asarray([left * fx, top * fy, cw * fx, ch * fy], dtype=np.float32)
        sample = self._finish_sample(raw, image_id, canvas, rng)
        if sample is not None:
            sample["crop_box"] = box
        return sample

    def _finish_sample(self, raw: Dict[str, bytes], image_id: str, arr: np.ndarray,
                       rng: np.random.Generator) -> Optional[dict]:
        zs_pred = self.data.zs_top1[image_id]
        zeros = np.zeros(self._tok_dim, dtype=np.int32)

        if self.data.per_image_tokens:
            dir_idx = int(rng.integers(len(self.data.per_image_tokens)))
            per_image = self.data.per_image_tokens[dir_idx].get(image_id, zeros)
        else:
            per_image = zeros

        donors = self.data.class_to_image_ids.get(zs_pred, [image_id])
        donor = donors[int(rng.integers(len(donors)))]
        per_group = self.data.group_tokens.get(donor, zeros)

        meta = raw.get("json")
        gt = -1
        if meta is not None:
            try:
                gt_name = json.loads(meta)["class_name"].lower().replace("_", " ")
                gt = self.data.name_to_id.get(gt_name, -1)
            except Exception:
                gt = -1
        if self.cfg.train_with_gt_text and gt >= 0 and self.data.gt_text_tokens is not None:
            # reference --train-with-gt-text: the caption becomes the
            # lowercased gt classname (data.py:476-477)
            per_image = self.data.gt_text_tokens[gt]
        return {
            "image": arr,
            "per_image_tokens": per_image,
            "per_group_tokens": per_group,
            "zs_pred": zs_pred,
            "gt": gt,
        }

    # -- epoch iteration -----------------------------------------------------
    def _sample_stream(self, epoch: int) -> Iterator[dict]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1000003 + epoch * 97 + cfg.host_index)
        wrap = 0
        while True:  # wraparound so steps_per_epoch full batches always exist
            # the wraparound pass reshuffles (epoch, wrap) so repeated passes
            # within one epoch don't replay the identical sample order
            # (detshuffle2 similarly advances its counter per re-iteration)
            if cfg.resampled:
                shards = resampled_shards(
                    self.data.shards, cfg.seed, epoch * 1000 + wrap,
                    weights=self._shard_weights)
            else:
                shards = shuffled_shards(self.data.shards, cfg.seed, epoch * 1000 + wrap)
            shards = split_shards(shards, cfg.host_index, cfg.host_count)
            shuffle = ShuffleBuffer(cfg.shuffle_buffer, seed=cfg.seed + epoch * 1000 + wrap)
            raw_stream = shuffle(self._iter_shards(shards))

            def job(raw, seed):
                return self._assemble(raw, np.random.default_rng(seed))

            # bounded-inflight map: Executor.map would consume the stream
            # eagerly; keep at most 2*threads decode jobs outstanding.
            # Decode-cache hits on the on-device-resize path skip the pool
            # (the warm assemble is dict lookups and a crop box); results
            # stay in submission order either way, so sample order and rng
            # draws are identical to the pooled path.
            yielded = 0
            with ThreadPoolExecutor(max_workers=cfg.num_threads) as pool:
                inflight: "deque" = deque()
                exhausted = False
                raw_it = iter(raw_stream)
                inline_ok = cfg.ondevice_resize
                while True:
                    while not exhausted and len(inflight) < 2 * cfg.num_threads:
                        try:
                            raw = next(raw_it)
                        except StopIteration:
                            exhausted = True
                            break
                        seed = int(rng.integers(2**63))
                        if inline_ok and raw["__key__"] in self._decode_cache:
                            inflight.append(job(raw, seed))
                        else:
                            inflight.append(pool.submit(job, raw, seed))
                    if not inflight:
                        break
                    item = inflight.popleft()
                    sample = item.result() if isinstance(item, Future) else item
                    if sample is not None:
                        yielded += 1
                        yield sample
            if yielded == 0:
                # bad --train-data path, pseudo-label/shard key mismatch, or
                # more hosts than shards: an error beats a silent busy-hang
                raise RuntimeError(
                    f"train pipeline produced ZERO samples for host "
                    f"{cfg.host_index}/{cfg.host_count} (epoch {epoch}): check "
                    "--train-data, --clip-prediction-path key overlap, and the "
                    "shard count vs host count"
                )
            wrap += 1

    def _empty(self, shape, dtype) -> np.ndarray:
        if not self.cfg.pin_memory:
            return np.empty(shape, dtype)
        return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                           pin_memory=True).numpy()

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield exactly ``steps_per_epoch`` batches for this epoch, each
        assembled sample by sample into buffers allocated up front (pinned
        under ``cfg.pin_memory``)."""
        stream = self._sample_stream(epoch)
        B = self.cfg.batch_size
        first = next(stream)  # peek: image shape differs per mode (canvas/crop)
        img_shape = first["image"].shape
        for _ in range(self.steps_per_epoch):
            batch = {
                "images": self._empty((B,) + img_shape, np.uint8),
                "per_image_tokens": self._empty((B, self._tok_dim), np.int32),
                "per_group_tokens": self._empty((B, self._tok_dim), np.int32),
                "zs_preds": self._empty((B,), np.int32),
                "gt_labels": self._empty((B,), np.int32),
            }
            if self.cfg.ondevice_resize:
                batch["crop_boxes"] = self._empty((B, 4), np.float32)
            for i in range(B):
                s = first if first is not None else next(stream)
                first = None
                batch["images"][i] = s["image"]
                batch["per_image_tokens"][i] = s["per_image_tokens"]
                batch["per_group_tokens"][i] = s["per_group_tokens"]
                batch["zs_preds"][i] = s["zs_pred"]
                batch["gt_labels"][i] = s["gt"]
                if self.cfg.ondevice_resize:
                    batch["crop_boxes"][i] = s["crop_box"]
            if self._pack_bucketer is not None:
                lengths = np.concatenate([
                    token_lengths(batch["per_image_tokens"]),
                    token_lengths(batch["per_group_tokens"]),
                ])
                P = self.cfg.text_packing_len
                rows = self._pack_bucketer.rows_for(pack_rows_needed(lengths, P))
                batch.update(pack_caption_batch(
                    batch["per_image_tokens"], batch["per_group_tokens"], P, rows,
                ))
            yield batch


def _copy_to(batch: Dict[str, np.ndarray], device: torch.device,
             stream: "torch.cuda.Stream") -> Dict[str, torch.Tensor]:
    """The batch's numpy arrays on ``device``, copied ``non_blocking`` from
    pinned memory on ``stream`` (arrays not yet pinned are pinned first);
    other values pass through."""
    out = {}
    with torch.cuda.stream(stream), span("h2d"):
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                out[k] = v
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if not t.is_pinned():
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
    return out


def prefetch(iterator: Iterator, size: int = 2, device=None) -> Iterator:
    """Background-thread prefetch so host assembly overlaps device compute.

    With a CUDA ``device`` the thread also issues each batch's copy to the
    device on a side stream; the consumer's current stream waits on the
    copy's event before the batch is yielded, and every tensor is marked as
    used on that stream (``record_stream``). Exceptions inside the producer
    are raised again in the consumer: a swallowed error would look like a
    clean, short end of the epoch."""
    device = torch.device(device) if device is not None else None
    on_cuda = device is not None and device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    error: list = []

    def worker():
        try:
            stream = torch.cuda.Stream(device) if on_cuda else None
            for item in iterator:
                if on_cuda:
                    item = _copy_to(item, device, stream)
                    event = torch.cuda.Event()
                    event.record(stream)
                    item = (item, event)
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — transported to the consumer
            error.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        with span("input_wait"):
            item = q.get()
            if item is not sentinel and on_cuda:
                item, event = item
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
        if item is sentinel:
            if error:
                raise error[0]
            return
        if on_cuda:
            for v in item.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
        yield item
