"""OpenAI ImageNet prompt templates and class names (port of
``latteclip_tpu/eval/imagenet_metadata.py``).

The 80-template ensemble and the 1000 class names are the standard OpenAI
CLIP evaluation metadata, read from the package's own byte-identical copies
under ``latteclip_torch/assets/`` and exposed as template callables for
:func:`latteclip_torch.eval.zero_shot.build_zero_shot_classifier`.
"""
from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Callable, List

_ASSET_DIR = Path(__file__).resolve().parents[1] / "assets"


@lru_cache()
def imagenet_classnames() -> List[str]:
    with open(_ASSET_DIR / "imagenet_classnames.json") as f:
        return json.load(f)


@lru_cache()
def _template_strings() -> List[str]:
    with open(_ASSET_DIR / "openai_imagenet_templates.json") as f:
        return json.load(f)


def openai_imagenet_templates() -> List[Callable[[str], str]]:
    """The 80-prompt ensemble as template callables."""
    return [lambda c, _t=t: _t.format(c) for t in _template_strings()]
