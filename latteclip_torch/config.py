"""Model architecture configuration and JSON registry.

Port of ``latteclip_tpu/core/config.py`` for the towers this package has:
the native ViT vision tower and the native CLIP text tower, with every option
of theirs that a ``ViT-*`` config sets (class token or none, ``ln_pre`` or
none, token, average or MAP pooling, LayerScale, sin-cos positions, patch
dropout, tanh GELU, the SigLIP logit bias, text pooling at the EOT token,
the first or the last column, with or without the causal mask). The JSON
files in ``model_configs/`` are byte-identical copies of the reference
package's.
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
    pool_type: str = "tok"          # 'tok' | 'avg' | 'map' (big_vision MAP head)
    final_ln_after_pool: bool = False
    no_ln_pre: bool = False
    no_cls_token: bool = False      # SigLIP towers have no class token
    patch_dropout: float = 0.0      # train-time patch dropout probability
    pos_embed_type: str = "learnable"  # 'learnable' | 'sin_cos_2d'
    ls_init_value: float = None     # LayerScale init (None = no LayerScale)
    ln_eps: float = 1e-5

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        """Token count, with the class token where the tower has one."""
        return self.grid * self.grid + (0 if self.no_cls_token else 1)


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    pool_type: str = "argmax"       # 'argmax' (EOT) | 'first' | 'last'
    no_causal_mask: bool = False
    ls_init_value: float = None     # LayerScale init (None = no LayerScale)
    ln_eps: float = 1e-5
    # a non-CLIP vocabulary on the native tower (CLIPA: bert-base-uncased)
    hf_tokenizer_name: str = ""


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    vision: VisionConfig
    text: TextConfig
    quick_gelu: bool = False
    gelu_tanh: bool = False         # tanh-approximate GELU (SigLIP towers)
    init_logit_scale: float = 2.6592600369  # ln(1/0.07)
    init_logit_bias: float = None   # SigLIP's logit bias
    image_mean: tuple = None
    image_std: tuple = None
    resize_mode: str = "shortest"   # eval geometry: 'shortest' | 'squash' | 'longest'
    # parameters and LayerNorm statistics stay float32; matmul inputs and
    # activations use this dtype
    compute_dtype: str = "bfloat16"


def _filter_fields(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _refuse_other_towers(name: str, raw: Dict[str, Any], vision: Dict[str, Any],
                         text: Dict[str, Any]) -> None:
    """NotImplementedError for the towers and options of ROADMAP item 6."""
    if "multimodal_cfg" in raw:
        raise NotImplementedError(f"{name}: the CoCa model {_LATER_SLICE}")
    if isinstance(vision.get("layers"), (list, tuple)):
        raise NotImplementedError(f"{name}: the ModifiedResNet tower {_LATER_SLICE}")
    if vision.get("timm_model_name"):
        raise NotImplementedError(f"{name}: vision_cfg.timm_model_name {_LATER_SLICE}")
    if vision.get("attentional_pool"):
        raise NotImplementedError(f"{name}: the attentional pool (CoCa) {_LATER_SLICE}")
    if text.get("hf_model_name"):
        raise NotImplementedError(f"{name}: the HF text tower {_LATER_SLICE}")
    if text.get("embed_cls"):
        raise NotImplementedError(f"{name}: text_cfg.embed_cls (CoCa) {_LATER_SLICE}")
    for key, sub, allowed in (("vision_cfg.pool_type", vision, ("tok", "avg", "map")),
                              ("vision_cfg.pos_embed_type", vision, ("learnable", "sin_cos_2d")),
                              ("text_cfg.pool_type", text, ("argmax", "first", "last"))):
        value = sub.get(key.split(".")[1])
        if value is not None and value not in allowed:
            raise NotImplementedError(f"{name}: {key}={value!r} {_LATER_SLICE}")


def config_from_dict(name: str, raw: Dict[str, Any]) -> CLIPConfig:
    vision_raw = dict(raw.get("vision_cfg", {}))
    text_raw = dict(raw.get("text_cfg", {}))
    _refuse_other_towers(name, raw, vision_raw, text_raw)
    for sub in (vision_raw, text_raw):
        nk = sub.get("norm_kwargs")
        if isinstance(nk, dict) and "eps" in nk and "ln_eps" not in sub:
            sub["ln_eps"] = float(nk["eps"])
    kwargs = {}
    if raw.get("init_logit_bias") is not None:
        kwargs["init_logit_bias"] = float(raw["init_logit_bias"])
    if raw.get("init_logit_scale") is not None:
        kwargs["init_logit_scale"] = float(raw["init_logit_scale"])
    if raw.get("gelu_tanh"):
        kwargs["gelu_tanh"] = True
    if raw.get("compute_dtype"):
        kwargs["compute_dtype"] = str(raw["compute_dtype"])
    if raw.get("image_mean") is not None:
        kwargs["image_mean"] = tuple(raw["image_mean"])
    if raw.get("image_std") is not None:
        kwargs["image_std"] = tuple(raw["image_std"])
    if raw.get("resize_mode"):
        kwargs["resize_mode"] = str(raw["resize_mode"])
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
