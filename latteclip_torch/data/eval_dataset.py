"""Flat-file classification datasets, per-dataset prompt templates and the
ImageNet class names (port of ``latteclip_tpu/data/eval_dataset.py``:
``DATASET_TEMPLATES``, ``get_templates``, ``FlatFileDataset``,
``iter_batches``, and of
``latteclip_tpu/eval/imagenet_metadata.py::imagenet_classnames``).

A ``preprocess_path`` holds ``webdataset/{train,val}/`` with ``{id}.jpg`` and
``{id}.json`` flat files and ``id_to_class.json``/``class_to_id.json`` at the
root; samples are ``(image_id, uint8 image, class_id)``, decoded on a thread
pool with the eval geometry of :func:`transforms.eval_resize_crop`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

from latteclip_torch.data import transforms as T

TemplateFn = Callable[[str], str]

_ASSET_DIR = Path(__file__).resolve().parents[1] / "assets"

# dataset key -> prompt template(s)
DATASET_TEMPLATES: Dict[str, List[TemplateFn]] = {
    "default": [lambda c: f"a photo of a {c}."],
    "dtd": [lambda c: f"{c} texture."],
    "eurosat": [lambda c: f"a photo of a {c}."],
    "sun397": [lambda c: f"a photo of a {c}."],
    "caltech101": [lambda c: f"a photo of a {c}."],
    "flower102": [lambda c: f"a photo of a {c}, a type of flower."],
    "oxford_pets": [lambda c: f"a photo of a {c}."],
    "fgvc_aircraft": [lambda c: f"a photo of a {c}, a type of aircraft."],
    "stanford_cars": [lambda c: f"a photo of a {c}."],
    "ucf101": [lambda c: f"a photo of a person doing {c}"],
    "food101": [lambda c: f"a photo of a {c}, a type of food."],
    "inat": [lambda c: f"a photo of a {c}."],
    "ifood2019": [lambda c: f"a photo of a {c}, a type of food."],
    "abo": [lambda c: f"a photo of a {c}."],
    "imagenet": [lambda c: f"a photo of a {c}."],
}


def get_templates(dataset: str) -> List[TemplateFn]:
    return DATASET_TEMPLATES.get(dataset, DATASET_TEMPLATES["default"])


def imagenet_classnames() -> List[str]:
    with open(_ASSET_DIR / "imagenet_classnames.json") as f:
        return json.load(f)


@dataclasses.dataclass
class FlatFileDataset:
    """Reference-layout classification dataset (see the module docstring)."""

    preprocess_path: str
    train: bool = False
    image_size: int = 224
    dataset_name: str = "default"
    id_to_class_file: str = "id_to_class.json"
    class_to_id_file: str = "class_to_id.json"
    class_name_field: str = "class_name"
    resize_mode: str = "shortest"

    def __post_init__(self):
        split = "train" if self.train else "val"
        self.split_path = os.path.join(self.preprocess_path, "webdataset", split)
        self.image_ids = sorted({os.path.splitext(f)[0] for f in os.listdir(self.split_path)})
        with open(os.path.join(self.preprocess_path, self.id_to_class_file)) as f:
            id_to_class = json.load(f)
        with open(os.path.join(self.preprocess_path, self.class_to_id_file)) as f:
            self.class_to_id = json.load(f)
        self.class_names: List[str] = [""] * (max(int(k) for k in id_to_class) + 1)
        for i, name in id_to_class.items():
            self.class_names[int(i)] = name
        self.templates = get_templates(self.dataset_name)

    def __len__(self) -> int:
        return len(self.image_ids)

    def label_of(self, image_id: str) -> int:
        with open(os.path.join(self.split_path, image_id + ".json")) as f:
            meta = json.load(f)
        return int(self.class_to_id[meta[self.class_name_field]])

    def load_sample(self, index: int) -> Tuple[str, np.ndarray, int]:
        image_id = self.image_ids[index]
        img = T.load_rgb(os.path.join(self.split_path, image_id + ".jpg"))
        arr = T.eval_resize_crop(img, self.image_size, self.resize_mode)
        return image_id, arr, self.label_of(image_id)

    @property
    def display_class_names(self) -> List[str]:
        """Lowercased, underscore-free names fed to the prompts."""
        return [c.lower().replace("_", " ") for c in self.class_names]


def iter_batches(dataset: FlatFileDataset, batch_size: int, *, num_threads: int = 8,
                 drop_last: bool = False, pad_final: bool = False
                 ) -> Iterator[Tuple[List[str], np.ndarray, np.ndarray, int]]:
    """Yield ``(image_ids, uint8 images [B, S, S, 3], labels [B], valid)``.
    With ``pad_final`` the last short batch repeats its first sample up to
    ``batch_size`` and ``valid`` counts its real rows. At most
    ``4 * num_threads`` decodes are in flight."""
    n = len(dataset)
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        inflight: deque = deque()
        idx = 0
        ids: List[str] = []
        imgs: List[np.ndarray] = []
        labels: List[int] = []
        while idx < n or inflight:
            while idx < n and len(inflight) < 4 * num_threads:
                inflight.append(pool.submit(dataset.load_sample, idx))
                idx += 1
            image_id, arr, label = inflight.popleft().result()
            ids.append(image_id)
            imgs.append(arr)
            labels.append(label)
            if len(ids) == batch_size:
                yield ids, np.stack(imgs), np.asarray(labels, np.int32), batch_size
                ids, imgs, labels = [], [], []
        if ids and not drop_last:
            valid = len(ids)
            if pad_final:
                pad = batch_size - valid
                ids, imgs, labels = ids + ids[:1] * pad, imgs + imgs[:1] * pad, labels + labels[:1] * pad
            yield ids, np.stack(imgs), np.asarray(labels, np.int32), valid
