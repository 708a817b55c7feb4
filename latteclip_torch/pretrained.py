"""Pretrained checkpoint registry and local resolver.

Port of ``latteclip_tpu/core/pretrained.py``: the same (model, tag) table
with its URLs, HF repos and per-tag preprocessing (mean, std, interpolation,
resize mode, QuickGELU), ``get_pretrained_cfg`` and the cache-first
``resolve_pretrained``. A tag resolves to a file in ``$LATTECLIP_CACHE_DIR``
(default ``~/.cache/latteclip``) named after the URL's basename or the HF
repo's file; a missing file raises with the URL to fetch it from. Nothing
here downloads.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)


def _pcfg(url: str = "", hf_hub: str = "", **kw) -> Dict:
    return {"url": url, "hf_hub": hf_hub, "mean": OPENAI_MEAN, "std": OPENAI_STD,
            "interpolation": "bicubic", "resize_mode": "shortest", **kw}


def _slpcfg(url: str = "", hf_hub: str = "", **kw) -> Dict:
    # SigLIP defaults (reference pretrained.py:42-52)
    return {"url": url, "hf_hub": hf_hub, "mean": INCEPTION_MEAN, "std": INCEPTION_STD,
            "interpolation": "bicubic", "resize_mode": "squash", **kw}


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _apcfg(url: str = "", hf_hub: str = "", **kw) -> Dict:
    # CLIPA defaults (reference pretrained.py:55-65)
    return {"url": url, "hf_hub": hf_hub, "mean": IMAGENET_MEAN, "std": IMAGENET_STD,
            "interpolation": "bilinear", "resize_mode": "squash", **kw}


_OPENAI = "https://openaipublic.azureedge.net/clip/models"
_GH = "https://github.com/mlfoundations/open_clip/releases/download"

# model -> tag -> cfg; the slice of the reference table covering every
# architecture the JAX package ships a config for (pretrained.py:68-440)
PRETRAINED: Dict[str, Dict[str, Dict]] = {
    "RN50": {
        "openai": _pcfg(f"{_OPENAI}/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt", quick_gelu=True),
        "yfcc15m": _pcfg(f"{_GH}/v0.2-weights/rn50-quickgelu-yfcc15m-455df137.pt", quick_gelu=True),
        "cc12m": _pcfg(f"{_GH}/v0.2-weights/rn50-quickgelu-cc12m-f000538c.pt", quick_gelu=True),
    },
    "RN101": {
        "openai": _pcfg(f"{_OPENAI}/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt", quick_gelu=True),
        "yfcc15m": _pcfg(f"{_GH}/v0.2-weights/rn101-quickgelu-yfcc15m-3e04b30e.pt", quick_gelu=True),
    },
    "ViT-B-32": {
        "openai": _pcfg(f"{_OPENAI}/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt", quick_gelu=True),
        "laion400m_e31": _pcfg(f"{_GH}/v0.2-weights/vit_b_32-quickgelu-laion400m_e31-d867053b.pt", quick_gelu=True),
        "laion400m_e32": _pcfg(f"{_GH}/v0.2-weights/vit_b_32-quickgelu-laion400m_e32-46683a32.pt", quick_gelu=True),
        "laion2b_e16": _pcfg(f"{_GH}/v0.2-weights/vit_b_32-laion2b_e16-af8dbd0c.pth"),
        "laion2b_s34b_b79k": _pcfg(hf_hub="laion/CLIP-ViT-B-32-laion2B-s34B-b79K/"),
    },
    "ViT-B-16": {
        "openai": _pcfg(f"{_OPENAI}/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt", quick_gelu=True),
        "laion400m_e31": _pcfg(f"{_GH}/v0.2-weights/vit_b_16-laion400m_e31-00efa78f.pt"),
        "laion400m_e32": _pcfg(f"{_GH}/v0.2-weights/vit_b_16-laion400m_e32-55e67d44.pt"),
        "laion2b_s34b_b88k": _pcfg(hf_hub="laion/CLIP-ViT-B-16-laion2B-s34B-b88K/"),
    },
    "ViT-B-16-plus-240": {
        "laion400m_e31": _pcfg(f"{_GH}/v0.2-weights/vit_b_16_plus_240-laion400m_e31-8fb26589.pt"),
        "laion400m_e32": _pcfg(f"{_GH}/v0.2-weights/vit_b_16_plus_240-laion400m_e32-699c4b84.pt"),
    },
    "ViT-L-14": {
        "openai": _pcfg(f"{_OPENAI}/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt", quick_gelu=True),
        "laion400m_e31": _pcfg(f"{_GH}/v0.2-weights/vit_l_14-laion400m_e31-69988bb6.pt"),
        "laion400m_e32": _pcfg(f"{_GH}/v0.2-weights/vit_l_14-laion400m_e32-3d133497.pt"),
        "laion2b_s32b_b82k": _pcfg(hf_hub="laion/CLIP-ViT-L-14-laion2B-s32B-b82K/",
                                   mean=INCEPTION_MEAN, std=INCEPTION_STD),
    },
    "ViT-L-14-336": {
        "openai": _pcfg(f"{_OPENAI}/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt", quick_gelu=True),
    },
    "ViT-H-14": {
        "laion2b_s32b_b79k": _pcfg(hf_hub="laion/CLIP-ViT-H-14-laion2B-s32B-b79K/"),
    },
    "ViT-g-14": {
        "laion2b_s12b_b42k": _pcfg(hf_hub="laion/CLIP-ViT-g-14-laion2B-s12B-b42K/"),
        "laion2b_s34b_b88k": _pcfg(hf_hub="laion/CLIP-ViT-g-14-laion2B-s34B-b88K/"),
    },
    "ViT-B-16-SigLIP": {
        # official big_vision .npz (the layout core/big_vision.py imports;
        # the timm/hf-hub re-upload uses a timm state-dict layout instead)
        "webli": _slpcfg("https://storage.googleapis.com/big_vision/siglip/webli_en_b16_224_63724782.npz"),
    },
    "ViT-SO400M-14-SigLIP": {
        "webli": _slpcfg("https://storage.googleapis.com/big_vision/siglip/webli_en_so400m_224_57633886.npz"),
    },
    "roberta-ViT-B-32": {
        "laion2b_s12b_b32k": _pcfg(hf_hub="laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k/"),
    },
    "xlm-roberta-base-ViT-B-32": {
        "laion5b_s13b_b90k": _pcfg(hf_hub="laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k/"),
    },
    # EVA-CLIP (QuanSun/EVA-CLIP exports re-hosted on the timm hub;
    # reference pretrained.py:350-377)
    "EVA01-g-14": {
        "laion400m_s11b_b41k": _pcfg(hf_hub="timm/eva_giant_patch14_clip_224.laion400m_s11b_b41k/"),
    },
    "EVA01-g-14-plus": {
        "merged2b_s11b_b114k": _pcfg(hf_hub="timm/eva_giant_patch14_plus_clip_224.merged2b_s11b_b114k/"),
    },
    "EVA02-B-16": {
        "merged2b_s8b_b131k": _pcfg(hf_hub="timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k/"),
    },
    "EVA02-L-14": {
        "merged2b_s4b_b131k": _pcfg(hf_hub="timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k/"),
    },
    "EVA02-L-14-336": {
        "merged2b_s6b_b61k": _pcfg(hf_hub="timm/eva02_large_patch14_clip_336.merged2b_s6b_b61k/"),
    },
    "EVA02-E-14": {
        "laion2b_s4b_b115k": _pcfg(hf_hub="timm/eva02_enormous_patch14_clip_224.laion2b_s4b_b115k/"),
    },
    "EVA02-E-14-plus": {
        "laion2b_s9b_b144k": _pcfg(hf_hub="timm/eva02_enormous_patch14_plus_clip_224.laion2b_s9b_b144k/"),
    },
    # SigLIP hub checkpoints (reference pretrained.py:379-405)
    "ViT-B-16-SigLIP-256": {"webli": _slpcfg(hf_hub="timm/ViT-B-16-SigLIP-256/")},
    "ViT-B-16-SigLIP-384": {"webli": _slpcfg(hf_hub="timm/ViT-B-16-SigLIP-384/")},
    "ViT-B-16-SigLIP-512": {"webli": _slpcfg(hf_hub="timm/ViT-B-16-SigLIP-512/")},
    "ViT-B-16-SigLIP-i18n-256": {"webli": _slpcfg(hf_hub="timm/ViT-B-16-SigLIP-i18n-256/")},
    "ViT-L-16-SigLIP-256": {"webli": _slpcfg(hf_hub="timm/ViT-L-16-SigLIP-256/")},
    "ViT-L-16-SigLIP-384": {"webli": _slpcfg(hf_hub="timm/ViT-L-16-SigLIP-384/")},
    "ViT-SO400M-14-SigLIP-384": {"webli": _slpcfg(hf_hub="timm/ViT-SO400M-14-SigLIP-384/")},
    # CLIPA hub checkpoints (reference pretrained.py:407-425)
    "ViT-L-14-CLIPA": {"datacomp1b": _apcfg(hf_hub="UCSC-VLAA/ViT-L-14-CLIPA-datacomp1B/")},
    "ViT-L-14-CLIPA-336": {"datacomp1b": _apcfg(hf_hub="UCSC-VLAA/ViT-L-14-CLIPA-336-datacomp1B/")},
    "ViT-H-14-CLIPA": {"datacomp1b": _apcfg(hf_hub="UCSC-VLAA/ViT-H-14-CLIPA-datacomp1B/")},
    "ViT-H-14-CLIPA-336": {
        "laion2b": _apcfg(hf_hub="UCSC-VLAA/ViT-H-14-CLIPA-336-laion2B/"),
        "datacomp1b": _apcfg(hf_hub="UCSC-VLAA/ViT-H-14-CLIPA-336-datacomp1B/"),
    },
    "ViT-bigG-14-CLIPA": {"datacomp1b": _apcfg(hf_hub="UCSC-VLAA/ViT-bigG-14-CLIPA-datacomp1B/")},
    "ViT-bigG-14-CLIPA-336": {"datacomp1b": _apcfg(hf_hub="UCSC-VLAA/ViT-bigG-14-CLIPA-336-datacomp1B/")},
    # NLLB-CLIP (reference pretrained.py:427-438)
    "nllb-clip-base": {"v1": _pcfg(hf_hub="visheratin/nllb-clip-base-oc/")},
    "nllb-clip-large": {"v1": _pcfg(hf_hub="visheratin/nllb-clip-large-oc/")},
    "nllb-clip-base-siglip": {"v1": _slpcfg(hf_hub="visheratin/nllb-clip-base-siglip/")},
    "nllb-clip-large-siglip": {"v1": _slpcfg(hf_hub="visheratin/nllb-clip-large-siglip/")},
    "coca_ViT-B-32": {
        "laion2b_s13b_b90k": _pcfg(hf_hub="laion/CoCa-ViT-B-32-laion2B-s13B-b90k/"),
        "mscoco_finetuned_laion2b_s13b_b90k": _pcfg(hf_hub="laion/mscoco_finetuned_CoCa-ViT-B-32-laion2B-s13B-b90k/"),
    },
}

HF_WEIGHTS_NAME = "open_clip_pytorch_model.bin"
HF_SAFE_WEIGHTS_NAME = "open_clip_model.safetensors"


def list_pretrained() -> List[Tuple[str, str]]:
    """All (model, tag) pairs (reference pretrained.py:447-453)."""
    return [(m, t) for m, tags in PRETRAINED.items() for t in tags]


def list_pretrained_tags_by_model(model: str) -> List[str]:
    return list(PRETRAINED.get(model, {}))


def get_pretrained_cfg(model: str, tag: str) -> Dict:
    # -quickgelu config variants share their base model's weights (the
    # reference registry carries explicit aliases; we normalize the name)
    if model not in PRETRAINED and model.endswith("-quickgelu"):
        model = model[: -len("-quickgelu")]
    return PRETRAINED.get(model, {}).get(tag.lower().replace("-", "_"), {}) or \
        PRETRAINED.get(model, {}).get(tag, {})


def cache_dir() -> str:
    return os.environ.get(
        "LATTECLIP_CACHE_DIR", os.path.expanduser("~/.cache/latteclip")
    )


def _candidate_names(cfg: Dict) -> List[str]:
    # repo-prefixed names ONLY: a bare open_clip_model.safetensors fallback
    # would silently resolve one model/tag's cached file for another
    names = []
    if cfg.get("url"):
        names.append(os.path.basename(cfg["url"]))
    if cfg.get("hf_hub"):
        repo = cfg["hf_hub"].rstrip("/").replace("/", "_")
        names += [f"{repo}_{HF_SAFE_WEIGHTS_NAME}", f"{repo}_{HF_WEIGHTS_NAME}"]
    return names


def resolve_pretrained(model: str, tag: str) -> str:
    """Tag -> local checkpoint path (cache-first ``download_pretrained``).

    Raises ``FileNotFoundError`` carrying the upstream URL/HF repo when the
    file is not in the cache — this environment cannot download.
    """
    cfg = get_pretrained_cfg(model, tag)
    if not cfg:
        base = model[: -len("-quickgelu")] if model.endswith("-quickgelu") else model
        raise ValueError(
            f"unknown pretrained tag {tag!r} for {model!r}; known: "
            f"{list_pretrained_tags_by_model(base)}"
        )
    root = cache_dir()
    for name in _candidate_names(cfg):
        path = os.path.join(root, name)
        if os.path.exists(path):
            return path
    src = cfg.get("url") or f"hf-hub:{cfg.get('hf_hub')}"
    raise FileNotFoundError(
        f"pretrained weights for ({model!r}, {tag!r}) not found in {root}; "
        f"fetch {src} into that directory (no network egress here). "
        f"Accepted filenames: {_candidate_names(cfg)}"
    )
