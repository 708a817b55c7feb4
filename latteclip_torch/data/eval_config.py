"""The YAML eval-task registry (port of ``latteclip_tpu/data/eval_config.py``;
reference ``eval_config/eval.yaml`` and abo.py).

Reads the reference's task schema, ``tasks.<name>`` entries with
``dataset_loading_kwargs.dataset_name`` and ``dataset_specific_kwargs``
(``preprocess_path``, ``train``), expands ``$ENV_VAR`` references in paths
(eval.yaml:41-56 lean on ``$LATTECLIP_DATA_DIR``) and builds the matching
:class:`FlatFileDataset`. PyYAML is imported when a file is read; without it
:func:`load_eval_config` raises a ``SystemExit`` that names the package.
"""
from __future__ import annotations

import os
import re
from typing import Dict

from latteclip_torch.data.eval_dataset import FlatFileDataset

_ENV_RE = re.compile(r"\$\{?(\w+)\}?")

# reference dataset_name keys -> the dataset/template keys (abo.py:450-513)
_DATASET_KEYS = {
    "dtd_zero_shot": "dtd",
    "eurosat_zero_shot": "eurosat",
    "sun397_zero_shot": "sun397",
    "caltech101_zero_shot": "caltech101",
    "flower102_zero_shot": "flower102",
    "oxford_pets_zero_shot": "oxford_pets",
    "fgvc_aircraft_zero_shot": "fgvc_aircraft",
    "stanford_cars_zero_shot": "stanford_cars",
    "ucf101_zero_shot": "ucf101",
    "food101_zero_shot": "food101",
    "ifood2019_zero_shot": "ifood2019",
    "inat_zero_shot": "inat",
    "ABO_zero_shot": "abo",
}


def expand_env(value: str) -> str:
    return _ENV_RE.sub(lambda m: os.environ.get(m.group(1), m.group(0)), value)


def load_eval_config(path: str) -> Dict[str, dict]:
    try:
        import yaml
    except ImportError as e:
        raise SystemExit(f"--eval-config-path {path}: reading it needs the PyYAML package "
                         "(import yaml), which is not installed in this environment") from e
    with open(path) as f:
        return yaml.safe_load(f)["tasks"]


def build_task_dataset(task_config: dict, image_size: int = 224) -> FlatFileDataset:
    loading = task_config.get("dataset_loading_kwargs", {})
    specific = task_config.get("dataset_specific_kwargs", {})
    dataset_key = _DATASET_KEYS.get(loading.get("dataset_name", ""), "default")
    kwargs = {}
    if dataset_key == "abo":  # ABO's class-map files are named differently (abo.py:159-178)
        kwargs = {"id_to_class_file": "id_to_product_type.json",
                  "class_to_id_file": "product_type_to_id.json",
                  "class_name_field": "product_type"}
    return FlatFileDataset(expand_env(str(specific["preprocess_path"])),
                           train=bool(specific.get("train", False)), image_size=image_size,
                           dataset_name=dataset_key, **kwargs)


def get_zero_shot_classification_data(eval_config_path: str, task_name: str,
                                      image_size: int = 224) -> FlatFileDataset:
    """One task by name (reference get_zero_shot_classification_data,
    abo.py:602-638)."""
    tasks = load_eval_config(eval_config_path)
    if task_name not in tasks:
        raise KeyError(f"task '{task_name}' not in {sorted(tasks)}")
    return build_task_dataset(tasks[task_name], image_size)
