"""Class-subdirectory (ImageFolder) and CSV datasets (port of
``latteclip_tpu/data/folder_dataset.py``).

``ImageFolderDataset`` reads the torchvision ImageFolder layout (the
reference's ImageNet eval path, ``src/training/data.py:142-186``) with the
sample interface of :class:`latteclip_torch.data.eval_dataset.FlatFileDataset`,
``(image_id, uint8 image, class_id)``, so the zero-shot eval reads it
unchanged; ``k_shot`` keeps at most k files a class, drawn without
replacement from a ``np.random.default_rng(seed)`` in class order.

``CsvDataset`` reads a filepath/caption CSV (reference ``data.py:50-70``)
into ``(uint8 image, caption)`` pairs for the validation loss.
"""
from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from latteclip_torch.data import transforms as T
from latteclip_torch.data.eval_dataset import get_templates


class ImageFolderDataset:
    """``root/<classname>/<image>`` -> an eval dataset."""

    IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")

    def __init__(self, root: str, image_size: int = 224, dataset_name: str = "imagenet",
                 k_shot: Optional[int] = None, seed: int = 0):
        self.root = root
        self.image_size = image_size
        self.class_names = sorted(d for d in os.listdir(root)
                                  if os.path.isdir(os.path.join(root, d)))
        self.class_to_id = {c: i for i, c in enumerate(self.class_names)}
        rng = np.random.default_rng(seed)
        self.samples: List[Tuple[str, int]] = []
        for cls in self.class_names:
            files = sorted(f for f in os.listdir(os.path.join(root, cls))
                           if f.lower().endswith(self.IMG_EXTS))
            if k_shot is not None and len(files) > k_shot:
                files = list(rng.choice(files, size=k_shot, replace=False))
            self.samples.extend((os.path.join(cls, f), self.class_to_id[cls]) for f in files)
        self.image_ids = [path for path, _ in self.samples]
        self.templates = get_templates(dataset_name)

    def __len__(self) -> int:
        return len(self.samples)

    def label_of(self, image_id: str) -> int:
        return self.class_to_id[os.path.dirname(image_id)]

    def load_image(self, index: int) -> Image.Image:
        """The decoded image, for callers with their own geometry (TTA)."""
        return T.load_rgb(os.path.join(self.root, self.samples[index][0]))

    def load_sample(self, index: int) -> Tuple[str, np.ndarray, int]:
        rel, label = self.samples[index]
        return rel, T.eval_resize_crop(self.load_image(index), self.image_size), label

    @property
    def display_class_names(self) -> List[str]:
        return [c.lower().replace("_", " ") for c in self.class_names]


class CsvDataset:
    """A CSV of (filepath, caption) rows; relative paths are taken from the
    CSV's directory unless ``root`` is given."""

    def __init__(self, input_filename: str, img_key: str = "filepath",
                 caption_key: str = "title", sep: str = "\t", image_size: int = 224,
                 root: Optional[str] = None):
        self.image_size = image_size
        self.root = root or os.path.dirname(os.path.abspath(input_filename))
        with open(input_filename, newline="") as f:
            self.rows = [(r[img_key], r[caption_key])
                         for r in csv.DictReader(f, delimiter=sep)]

    def __len__(self) -> int:
        return len(self.rows)

    def load_sample(self, index: int) -> Tuple[np.ndarray, str]:
        path, caption = self.rows[index]
        if not os.path.isabs(path):
            path = os.path.join(self.root, path)
        return T.eval_resize_crop(T.load_rgb(path), self.image_size), caption
