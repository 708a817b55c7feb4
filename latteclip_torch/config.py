"""Model architecture configuration and JSON registry.

Port of ``latteclip_tpu/core/config.py`` for the towers this package has:
the native ViT vision tower and the native CLIP text tower. The JSON files in
``model_configs/`` are byte-identical copies of the reference package's.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Tuple

_CONFIG_DIR = Path(__file__).resolve().parent / "model_configs"

_LATER_SLICE = (
    "is not ported yet: latteclip_torch has the native ViT and native text "
    "towers only; the other towers and options come in the port's last slice "
    "(ROADMAP.md, section 1, item 6)"
)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    head_width: int = 64
    mlp_ratio: float = 4.0
    pool_type: str = "tok"          # 'tok' | 'avg'
    ln_eps: float = 1e-5

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        """Token count incl. class token."""
        return self.grid * self.grid + 1


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    vision: VisionConfig
    text: TextConfig
    quick_gelu: bool = False
    init_logit_scale: float = 2.6592600369  # ln(1/0.07)
    image_mean: tuple = None
    image_std: tuple = None
    # parameters and LayerNorm statistics stay float32; matmul inputs and
    # activations use this dtype
    compute_dtype: str = "bfloat16"


# vision_cfg / text_cfg keys that select a tower this package lacks
_FOREIGN_VISION = ("timm_model_name", "attentional_pool", "pos_embed_type")
_FOREIGN_TEXT = ("hf_model_name", "hf_tokenizer_name", "embed_cls")
# options of the reference towers that no config of this package sets yet,
# with the value that leaves them off
_UNPORTED_VISION = {"final_ln_after_pool": False, "no_ln_pre": False,
                    "no_cls_token": False, "ls_init_value": None}
_UNPORTED_TEXT = {"pool_type": "argmax", "no_causal_mask": False, "ls_init_value": None}


def _filter_fields(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def config_from_dict(name: str, raw: Dict[str, Any]) -> CLIPConfig:
    vision_raw = dict(raw.get("vision_cfg", {}))
    text_raw = dict(raw.get("text_cfg", {}))
    if "multimodal_cfg" in raw:
        raise NotImplementedError(f"{name}: the CoCa model {_LATER_SLICE}")
    if isinstance(vision_raw.get("layers"), (list, tuple)):
        raise NotImplementedError(f"{name}: the ModifiedResNet tower {_LATER_SLICE}")
    for key in _FOREIGN_VISION:
        if vision_raw.get(key) and vision_raw.get(key) != "learnable":
            raise NotImplementedError(f"{name}: vision_cfg.{key} {_LATER_SLICE}")
    if vision_raw.get("pool_type", "tok") not in ("tok", "avg"):
        raise NotImplementedError(
            f"{name}: vision pool_type {vision_raw['pool_type']!r} {_LATER_SLICE}")
    for key in _FOREIGN_TEXT:
        if text_raw.get(key):
            raise NotImplementedError(f"{name}: text_cfg.{key} {_LATER_SLICE}")
    for prefix, sub, off in (("vision_cfg", vision_raw, _UNPORTED_VISION),
                             ("text_cfg", text_raw, _UNPORTED_TEXT)):
        for key, value in off.items():
            if sub.get(key, value) != value:
                raise NotImplementedError(f"{name}: {prefix}.{key}={sub[key]!r} {_LATER_SLICE}")
    for sub in (vision_raw, text_raw):
        nk = sub.get("norm_kwargs")
        if isinstance(nk, dict) and "eps" in nk and "ln_eps" not in sub:
            sub["ln_eps"] = float(nk["eps"])
    kwargs = {}
    if raw.get("init_logit_scale") is not None:
        kwargs["init_logit_scale"] = float(raw["init_logit_scale"])
    if raw.get("init_logit_bias") is not None:
        raise NotImplementedError(f"{name}: the SigLIP logit bias {_LATER_SLICE}")
    if raw.get("gelu_tanh"):
        raise NotImplementedError(f"{name}: gelu_tanh {_LATER_SLICE}")
    if raw.get("compute_dtype"):
        kwargs["compute_dtype"] = str(raw["compute_dtype"])
    if raw.get("image_mean") is not None:
        kwargs["image_mean"] = tuple(raw["image_mean"])
    if raw.get("image_std") is not None:
        kwargs["image_std"] = tuple(raw["image_std"])
    return CLIPConfig(
        name=name,
        embed_dim=int(raw["embed_dim"]),
        vision=VisionConfig(**_filter_fields(VisionConfig, vision_raw)),
        text=TextConfig(**_filter_fields(TextConfig, text_raw)),
        quick_gelu=bool(raw.get("quick_gelu", False)) or name.endswith("-quickgelu"),
        **kwargs,
    )


def list_models() -> Tuple[str, ...]:
    return tuple(sorted(p.stem for p in _CONFIG_DIR.glob("*.json")))


def get_model_config(name: str) -> CLIPConfig:
    path = _CONFIG_DIR / f"{name}.json"
    if not path.exists():
        raise ValueError(f"unknown model config '{name}'; available: {list_models()}")
    with open(path) as f:
        raw = json.load(f)
    return config_from_dict(name, raw)
