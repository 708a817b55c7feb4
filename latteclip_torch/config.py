"""Model architecture configuration and JSON registry.

Port of ``latteclip_tpu/core/config.py``: the native ViT vision tower with
every option a config sets (class token or none, ``ln_pre`` or none, token,
average, MAP or CoCa's attentional pooling, LayerScale, sin-cos positions,
patch dropout, tanh GELU, the SigLIP logit bias) and the timm trunks
expressed on it (EVA01's giant, ViT-medium with average pooling); the EVA02,
ModifiedResNet, ConvNeXt, Swin and ViT-relpos towers; the native CLIP text
tower (pooling at the EOT token, the first or the last column, with or
without the causal mask, CoCa's class token); the HF-architecture text
towers (``hf_model_name``: :class:`~latteclip_torch.models.hf_text.
HFTextConfig`); and CoCa (``multimodal_cfg``: :class:`CoCaConfig`). The
trunk tables (``EVA02_TRUNKS``, ``EVA_TRUNKS``, ``TIMM_VIT_TRUNKS``,
``CONVNEXT_TRUNKS``, ``SWIN_TRUNKS``, ``RELPOS_TRUNKS``) are the JAX
package's. The JSON files in ``model_configs/`` are byte-identical copies of
the reference package's.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Tuple

_CONFIG_DIR = Path(__file__).resolve().parent / "model_configs"

_LATER_SLICE = (
    "is no option of a JAX package tower: latteclip_torch has every tower, pool "
    "and option of the JAX package's configs, and no other"
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
    attentional_pool: bool = False  # CoCa's learned-query pooling head
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    ls_init_value: float = None     # LayerScale init (None = no LayerScale)
    ln_eps: float = 1e-5
    # the timm trunk a config reaches this tower through (EVA01's giant,
    # ViT-medium): timm's checkpoint layout (visual.trunk.*), a biased patch
    # conv, and EVA's biased head projection
    timm_trunk: str = ""

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
class ResNetVisionConfig:
    """OpenAI's ModifiedResNet: ``layers`` blocks per stage; the feature
    width is ``width * 32``."""

    layers: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    image_size: int = 224
    head_width: int = 64

    @property
    def embed_width(self) -> int:
        return self.width * 32

    @property
    def heads(self) -> int:
        return self.embed_width // self.head_width


# timm ConvNeXt trunks: (blocks per stage, width per stage)
CONVNEXT_TRUNKS: Dict[str, Any] = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}


@dataclasses.dataclass(frozen=True)
class ConvNeXtVisionConfig:
    """A timm ConvNeXt trunk (average pool, head LayerNorm) and OpenCLIP's
    ``timm_proj`` head: ``linear``, ``mlp`` or ``none``."""

    trunk: str = "convnext_base"
    image_size: int = 224
    proj: str = "linear"
    drop_path: float = 0.0          # timm_drop_path (stochastic depth ramp)
    ls_init_value: float = 1e-6     # LayerScale gamma at init
    ln_eps: float = 1e-6

    @property
    def depths(self) -> Tuple[int, ...]:
        return CONVNEXT_TRUNKS[self.trunk][0]

    @property
    def dims(self) -> Tuple[int, ...]:
        return CONVNEXT_TRUNKS[self.trunk][1]

    @property
    def embed_width(self) -> int:
        return self.dims[-1]


@dataclasses.dataclass(frozen=True)
class Eva02VisionConfig:
    """EVA-02's TrV trunk (timm ``eva02_*_clip_*``): 2-D rope, SwiGLU with a
    sub-LayerNorm, an inner attention LayerNorm; or, for the enormous tower,
    post-norm blocks with a plain MLP and no rope."""

    trunk: str = "eva02_base_patch16_clip_224"
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    head_width: int = 64
    swiglu_hidden: int = 2048
    swiglu: bool = True
    use_rope: bool = True
    inner_attn_norm: bool = True
    post_norm: bool = False
    qkv_fused: bool = True          # fused qkv with q/v bias (B, E); L splits q/k/v
    ref_feat_shape: int = 16        # the rope's reference grid
    rope_temperature: float = 10000.0
    ln_eps: float = 1e-6

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


SWIN_TRUNKS: Dict[str, Dict[str, Any]] = {
    "swin_base_patch4_window7_224": dict(
        embed_dim=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32),
        window=7, patch_size=4, mlp_ratio=4.0,
    ),
}


@dataclasses.dataclass(frozen=True)
class SwinVisionConfig:
    """A timm Swin trunk: windowed attention with a relative-position bias."""

    trunk: str = "swin_base_patch4_window7_224"
    image_size: int = 224
    ln_eps: float = 1e-5

    @property
    def embed_width(self) -> int:
        t = SWIN_TRUNKS[self.trunk]
        return t["embed_dim"] * 2 ** (len(t["depths"]) - 1)


RELPOS_TRUNKS: Dict[str, Dict[str, Any]] = {
    "vit_relpos_medium_patch16_cls_224": dict(
        width=512, layers=12, heads=8, patch_size=16, mlp_ratio=4.0,
        rel_pos_hidden=256, init_values=1e-6,
    ),
}


@dataclasses.dataclass(frozen=True)
class RelPosVisionConfig:
    """timm's VisionTransformerRelPos: a rel-pos MLP bias in every block and
    no absolute position embedding."""

    trunk: str = "vit_relpos_medium_patch16_cls_224"
    image_size: int = 224
    ln_eps: float = 1e-6

    @property
    def embed_width(self) -> int:
        return RELPOS_TRUNKS[self.trunk]["width"]


# EVA02-CLIP trunks (EVA-02 arXiv 2303.11331 Table 2; EVA-CLIP arXiv
# 2303.15389 Table 1); the enormous tower is EVA-CLIP's pre-TrV giant
EVA02_TRUNKS: Dict[str, Dict[str, Any]] = {
    "eva02_base_patch16_clip_224": dict(
        patch_size=16, width=768, layers=12, head_width=64,
        swiglu_hidden=2048, ref_feat_shape=16,
    ),
    "eva02_large_patch14_clip_224": dict(
        patch_size=14, width=1024, layers=24, head_width=64,
        swiglu_hidden=2730, ref_feat_shape=16, qkv_fused=False,
    ),
    "eva02_large_patch14_clip_336": dict(
        patch_size=14, width=1024, layers=24, head_width=64,
        swiglu_hidden=2730, ref_feat_shape=16, qkv_fused=False,
    ),
    "eva02_enormous_patch14_clip_224": dict(
        patch_size=14, width=1792, layers=64, head_width=112,
        swiglu_hidden=15360, swiglu=False, use_rope=False,
        inner_attn_norm=False, post_norm=True,
    ),
}

# timm Eva trunks that are plain pre-norm ViTs, on the native tower
EVA_TRUNKS: Dict[str, Dict[str, Any]] = {
    "eva_giant_patch14_224": dict(
        width=1408, layers=40, head_width=88, mlp_ratio=6144 / 1408,
        patch_size=14,
    ),
}

# timm plain-ViT trunks on the native tower: ViT-medium without a class
# token, average pooled, LayerNorm after the pool, no pre-LN
TIMM_VIT_TRUNKS: Dict[str, Dict[str, Any]] = {
    "vit_medium_patch16_gap_256": dict(
        width=512, layers=12, head_width=64, mlp_ratio=4.0, patch_size=16,
        no_cls_token=True, pool_type="avg", final_ln_after_pool=True,
        no_ln_pre=True, ln_eps=1e-6,
    ),
}

TOWER_CONFIGS = (VisionConfig, ResNetVisionConfig, ConvNeXtVisionConfig, Eva02VisionConfig,
                 SwinVisionConfig, RelPosVisionConfig)


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
    embed_cls: bool = False         # CoCa: a class token after the text
    ls_init_value: float = None     # LayerScale init (None = no LayerScale)
    ln_eps: float = 1e-5
    # a non-CLIP vocabulary on the native tower (CLIPA: bert-base-uncased)
    hf_tokenizer_name: str = ""
    strip_sep_token: bool = False   # tokenizer_kwargs.strip_sep_token (CLIPA)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    vision: Any                     # one of TOWER_CONFIGS
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


@dataclasses.dataclass(frozen=True)
class CoCaConfig:
    """CoCa: the contrastive towers and a multimodal caption decoder, whose
    width, heads, layers and vocabulary ``multimodal`` holds as a
    :class:`TextConfig` (JAX ``CoCaConfig``)."""

    name: str
    embed_dim: int
    vision: VisionConfig
    text: Any                       # TextConfig (embed_cls) or HFTextConfig
    multimodal: TextConfig
    quick_gelu: bool = False
    init_logit_scale: float = 2.6592600369
    compute_dtype: str = "bfloat16"
    pad_id: int = 0
    image_mean: tuple = None
    image_std: tuple = None
    resize_mode: str = "shortest"
    # CLIPConfig's fields that a CoCa config never sets
    init_logit_bias = None
    gelu_tanh = False


def _filter_fields(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _refuse_unknown_options(name: str, vision: Dict[str, Any], text: Dict[str, Any]) -> None:
    """NotImplementedError for a pool or position type no JAX tower has."""
    for key, sub, allowed in (("vision_cfg.pool_type", vision, ("tok", "avg", "map")),
                              ("vision_cfg.pos_embed_type", vision, ("learnable", "sin_cos_2d")),
                              ("text_cfg.pool_type", text, ("argmax", "first", "last"))):
        value = sub.get(key.split(".")[1])
        if value is not None and value not in allowed:
            raise NotImplementedError(f"{name}: {key}={value!r} {_LATER_SLICE}")


def vision_config(raw: Dict[str, Any]):
    """The vision tower's config from ``vision_cfg``, by JAX's dispatch:
    a timm trunk name selects EVA01 (native tower), EVA02, ViT-relpos, Swin,
    a timm plain ViT (native tower) or ConvNeXt; a per-stage layer list
    the ModifiedResNet; else the native ViT."""
    timm_name = raw.get("timm_model_name")
    size = int(raw.get("image_size", 224))
    if timm_name in EVA_TRUNKS:
        # timm_pool 'token' is 'tok'; timm_proj null is the trunk's biased head
        return VisionConfig(image_size=size, no_ln_pre=True, pool_type="tok",
                            timm_trunk=timm_name, ln_eps=1e-6, **EVA_TRUNKS[timm_name])
    if timm_name in EVA02_TRUNKS:
        return Eva02VisionConfig(trunk=timm_name, image_size=size, **EVA02_TRUNKS[timm_name])
    if timm_name is not None and timm_name.startswith("vit_relpos"):
        if timm_name not in RELPOS_TRUNKS:
            raise ValueError(f"unknown vit_relpos trunk '{timm_name}'")
        return RelPosVisionConfig(trunk=timm_name, image_size=size)
    if timm_name is not None and timm_name.startswith("swin"):
        if timm_name not in SWIN_TRUNKS:
            raise ValueError(f"unknown swin trunk '{timm_name}'")
        return SwinVisionConfig(trunk=timm_name, image_size=size)
    if timm_name in TIMM_VIT_TRUNKS:
        return VisionConfig(image_size=size, timm_trunk=timm_name, **TIMM_VIT_TRUNKS[timm_name])
    if timm_name is not None:
        if timm_name not in CONVNEXT_TRUNKS:
            raise ValueError(f"timm vision trunk '{timm_name}' has no native implementation")
        return ConvNeXtVisionConfig(
            trunk=timm_name, image_size=size,
            proj=str(raw.get("timm_proj", "linear") or "none"),
            drop_path=float(raw.get("timm_drop_path") or 0.0))
    if isinstance(raw.get("layers"), (list, tuple)):
        fields = _filter_fields(ResNetVisionConfig, raw)
        fields["layers"] = tuple(fields["layers"])
        return ResNetVisionConfig(**fields)
    return VisionConfig(**_filter_fields(VisionConfig, raw))


def config_from_dict(name: str, raw: Dict[str, Any]) -> CLIPConfig:
    vision_raw = dict(raw.get("vision_cfg", {}))
    text_raw = dict(raw.get("text_cfg", {}))
    _refuse_unknown_options(name, vision_raw, text_raw)
    for sub in (vision_raw, text_raw):
        nk = sub.get("norm_kwargs")
        if isinstance(nk, dict) and "eps" in nk and "ln_eps" not in sub:
            sub["ln_eps"] = float(nk["eps"])
    if "hf_model_name" in text_raw:
        from latteclip_torch.models.hf_text import hf_text_config

        text = hf_text_config(text_raw)
    else:
        tk = text_raw.get("tokenizer_kwargs")
        if isinstance(tk, dict) and tk.get("strip_sep_token") and "strip_sep_token" not in text_raw:
            text_raw["strip_sep_token"] = True
        text = TextConfig(**_filter_fields(TextConfig, text_raw))
    quick_gelu = bool(raw.get("quick_gelu", False)) or name.endswith("-quickgelu")
    if "multimodal_cfg" in raw:
        return CoCaConfig(name=name, embed_dim=int(raw["embed_dim"]),
                          vision=vision_config(vision_raw), text=text,
                          multimodal=TextConfig(**_filter_fields(TextConfig, raw["multimodal_cfg"])),
                          quick_gelu=quick_gelu)
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
        vision=vision_config(vision_raw),
        text=text,
        quick_gelu=quick_gelu,
        **kwargs,
    )


def list_models() -> Tuple[str, ...]:
    return tuple(sorted(p.stem for p in _CONFIG_DIR.glob("*.json")))


def get_model_config(name: str):
    """The named config: a :class:`CLIPConfig`, or a :class:`CoCaConfig`
    where the JSON has ``multimodal_cfg``."""
    path = _CONFIG_DIR / f"{name}.json"
    if not path.exists():
        raise ValueError(f"unknown model config '{name}'; available: {list_models()}")
    with open(path) as f:
        raw = json.load(f)
    return config_from_dict(name, raw)
