"""Per-dataset prompt templates and the ImageNet class names (port of
``latteclip_tpu/data/eval_dataset.py::DATASET_TEMPLATES``/``get_templates``
and ``latteclip_tpu/eval/imagenet_metadata.py::imagenet_classnames``).
The flat-file dataset reader comes with a later slice."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List

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
