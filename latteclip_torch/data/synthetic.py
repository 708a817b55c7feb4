"""Synthetic dataset fixtures: the CI / smoke-train backend (the port's copy
of ``latteclip_tpu/data/synthetic.py``, so that the CLI and chip_smoke.py
build a fixture without JAX; it writes byte-identical image, json, text and
pickle files).

Replaces the reference's ``SyntheticDataset`` (black images + dummy captions,
``src/training/data.py:812-862``) with a generator that writes a complete
miniature LatteCLIP data layout to disk — flat eval files, webdataset tar
shards, a ``clip_features_train.pkl`` pseudo-label file and caption
directories — so every pipeline stage (eval reader, tar reader, caption
join, train loop) can run hermetically in tests and smoke runs.
"""
from __future__ import annotations

import json
import os
import pickle
import tarfile
from typing import Dict, List, Sequence

import numpy as np
from PIL import Image

DEFAULT_CLASSES = ("banded", "dotted", "striped", "zigzagged")


def _class_image(rng: np.random.Generator, class_id: int, size: int = 64) -> Image.Image:
    """A learnable class-dependent pattern + noise (not plain black, so smoke
    training can actually reduce the loss)."""
    base = np.zeros((size, size, 3), dtype=np.float32)
    xx, yy = np.meshgrid(np.arange(size), np.arange(size))
    phase = (class_id + 1) * 2.0
    base[..., 0] = 0.5 + 0.5 * np.sin(xx / phase)
    base[..., 1] = 0.5 + 0.5 * np.cos(yy / phase)
    base[..., 2] = (class_id + 1) / 8.0
    noisy = np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1)
    return Image.fromarray((noisy * 255).astype(np.uint8))


def make_flat_dataset(
    root: str,
    *,
    num_train: int = 32,
    num_val: int = 16,
    classes: Sequence[str] = DEFAULT_CLASSES,
    image_size: int = 64,
    seed: int = 0,
) -> Dict[str, List[str]]:
    """Write the flat-file layout the eval reader consumes; returns ids per split."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "id_to_class.json"), "w") as f:
        json.dump({str(i): c for i, c in enumerate(classes)}, f)
    with open(os.path.join(root, "class_to_id.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(classes)}, f)

    ids: Dict[str, List[str]] = {}
    for split, count in (("train", num_train), ("val", num_val)):
        split_dir = os.path.join(root, "webdataset", split)
        os.makedirs(split_dir, exist_ok=True)
        ids[split] = []
        for i in range(count):
            class_id = i % len(classes)
            image_id = f"{split}_{i:05d}"
            img = _class_image(rng, class_id, image_size)
            img.save(os.path.join(split_dir, image_id + ".jpg"), quality=95)
            with open(os.path.join(split_dir, image_id + ".json"), "w") as f:
                json.dump({"image_id": image_id, "class_name": classes[class_id]}, f)
            with open(os.path.join(split_dir, image_id + ".txt"), "w") as f:
                f.write(f"a synthetic {classes[class_id]} pattern")
            ids[split].append(image_id)
    return ids


def make_tar_shards(root: str, split: str = "train", items_per_tar: int = 100) -> List[str]:
    """Pack the flat split into webdataset-style NNNNN.tar shards (parity with
    reference preprocess/create_tarfiles.py:20-40)."""
    split_dir = os.path.join(root, "webdataset", split)
    tar_dir = os.path.join(root, "webdataset", f"{split}_tars")
    os.makedirs(tar_dir, exist_ok=True)
    image_ids = sorted({os.path.splitext(f)[0] for f in os.listdir(split_dir)})
    shards = []
    for shard_idx in range(0, len(image_ids), items_per_tar):
        shard_ids = image_ids[shard_idx : shard_idx + items_per_tar]
        path = os.path.join(tar_dir, f"{shard_idx // items_per_tar:05d}.tar")
        with tarfile.open(path, "w") as tf:
            for image_id in shard_ids:
                for ext in (".json", ".txt", ".jpg"):
                    tf.add(os.path.join(split_dir, image_id + ext), arcname=image_id + ext)
        shards.append(path)
    return shards


def make_pseudo_labels(
    root: str,
    split: str = "train",
    *,
    classes: Sequence[str] = DEFAULT_CLASSES,
    topk: int = 10,
    noise_rate: float = 0.25,
    embed_dim: int = 32,
    seed: int = 0,
) -> str:
    """Write a clip_features_<split>.pkl with the reference's record format
    (train.py:1365-1374); pseudo-labels equal GT except a noise fraction."""
    rng = np.random.default_rng(seed)
    split_dir = os.path.join(root, "webdataset", split)
    image_ids = sorted({os.path.splitext(f)[0] for f in os.listdir(split_dir)})
    lowered = [c.lower().replace("_", " ") for c in classes]
    features = {}
    for image_id in image_ids:
        with open(os.path.join(split_dir, image_id + ".json")) as f:
            gt_name = json.load(f)["class_name"]
        gt_id = list(classes).index(gt_name)
        pred = gt_id if rng.random() > noise_rate else int(rng.integers(len(classes)))
        order = [pred] + [i for i in rng.permutation(len(classes)) if i != pred]
        order = (order * ((topk // len(order)) + 1))[:topk]
        features[image_id] = {
            "image": rng.normal(size=(embed_dim,)).astype(np.float32),
            "top_class_ids": np.asarray(order),
            "class_names": [lowered[i] for i in order],
            "top_logit": np.linspace(30, 10, topk).astype(np.float32),
            "gt_classname": lowered[gt_id],
            "gt_class_id": gt_id,
        }
    path = os.path.join(root, f"clip_features_{split}.pkl")
    with open(path, "wb") as f:
        pickle.dump(features, f)
    return path


def make_caption_dirs(
    root: str,
    split: str = "train",
    *,
    kinds: Sequence[str] = ("per_image", "per_group"),
    seed: int = 0,
) -> Dict[str, str]:
    """Write caption directories ({image_id}.txt, reference data.py:372-380)."""
    rng = np.random.default_rng(seed)
    split_dir = os.path.join(root, "webdataset", split)
    image_ids = sorted({os.path.splitext(f)[0] for f in os.listdir(split_dir)})
    out = {}
    for kind in kinds:
        cap_dir = os.path.join(root, f"captions_{kind}")
        os.makedirs(cap_dir, exist_ok=True)
        for image_id in image_ids:
            with open(os.path.join(split_dir, image_id + ".json")) as f:
                cls = json.load(f)["class_name"]
            lines = [
                f"a {kind.replace('_', ' ')} caption about {cls} number {rng.integers(100)}",
            ]
            with open(os.path.join(cap_dir, image_id + ".txt"), "w") as f:
                f.write("\n".join(lines))
        out[kind] = cap_dir
    return out


def make_full_fixture(root: str, **kwargs) -> Dict[str, object]:
    """One call: flat files + tars + pseudo-labels + captions."""
    ids = make_flat_dataset(root, **kwargs)
    shards = make_tar_shards(root, "train")
    pkl = make_pseudo_labels(root, "train", classes=kwargs.get("classes", DEFAULT_CLASSES))
    captions = make_caption_dirs(root, "train")
    return {"ids": ids, "shards": shards, "pkl": pkl, "captions": captions}
