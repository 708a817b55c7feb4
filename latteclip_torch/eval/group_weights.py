"""Fusion-weight analysis job (port of ``latteclip_tpu/eval/group_weights.py``).

As the reference's ``extract_group_weights`` (``src/training/train.py:
639-808``): run the frozen model over the train pipeline and write, per
sample, the relative weight of the group caption in the fused text feature,
``w_group / (w_label + w_image + w_group)`` with each ``w`` the confidence
margin against the prototypes (ungated, ``train.py:780-783``), to
``group_weights.npy``, and ``all_labels.json`` with the zero-shot,
fine-tune and ground-truth labels and the two captions of each image
(``train.py:744-752``).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from latteclip_torch.data import transforms as T
from latteclip_torch.data.pipeline import LatteCLIPTrainData, PipelineConfig, TrainPipeline
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models.layers import l2_normalize
from latteclip_torch.models.tokenizer import ClipTokenizer
from latteclip_torch.train.objective import text_confidence_weights
from latteclip_torch.train.state import build_template_table

logger = logging.getLogger(__name__)

WEIGHT_EPS = 1e-6


@torch.no_grad()
def group_weight_terms(model: clip_mod.CLIP, images_u8: np.ndarray, per_img_tok: np.ndarray,
                       per_grp_tok: np.ndarray, prototypes: torch.Tensor,
                       class_feats: torch.Tensor, *, attention: str = "kernel",
                       ln_linear: str = "unfused") -> Tuple[torch.Tensor, ...]:
    """One batch's ``(w_label, w_img, w_grp, preds)``: the confidence margins
    (plus ``WEIGHT_EPS``) of the fine-tune label's class text, the image
    caption and the group caption, and the prototype classifier's labels.
    ``class_feats`` are the normalised class texts [C, E]."""
    routes = {"attention": attention, "ln_linear": ln_linear}
    dev = prototypes.device
    images = T.normalize_images(torch.from_numpy(images_u8).to(dev), *T.model_mean_std(model.cfg))
    img = clip_mod.encode_image(model, images, normalize=True, **routes)
    preds = (100.0 * img @ l2_normalize(prototypes).T).argmax(dim=1)
    cap = torch.from_numpy(np.concatenate([per_img_tok, per_grp_tok])).to(dev)
    per_img_f, per_grp_f = clip_mod.encode_text(model, cap, normalize=True, **routes).chunk(2)
    return (text_confidence_weights(class_feats[preds], prototypes) + WEIGHT_EPS,
            text_confidence_weights(per_img_f, prototypes) + WEIGHT_EPS,
            text_confidence_weights(per_grp_f, prototypes) + WEIGHT_EPS, preds)


def _text(tokenizer: ClipTokenizer, tokens: np.ndarray) -> str:
    """The caption of a token row: its ids between SOT and EOT, decoded."""
    return tokenizer.decode([t for t in tokens if 0 < t < tokenizer.sot_token_id]).strip()


@torch.no_grad()
def extract_group_weights(model: clip_mod.CLIP, data: LatteCLIPTrainData, memory_bank,
                          templates, tokenizer: ClipTokenizer, out_dir: str, *,
                          batch_size: int = 64, image_size: int = 224, attention: str = "kernel",
                          ln_linear: str = "unfused") -> np.ndarray:
    """Write ``group_weights.npy`` and ``all_labels.json`` into ``out_dir``
    and return the weights, one a train sample.

    The samples come from the train pipeline's stream of epoch 0 (host crop,
    ``shuffle_buffer=1``), exactly ``len(data.zs_top1)`` of them: the last
    short batch is padded with its first sample and trimmed after."""
    routes = {"attention": attention, "ln_linear": ln_linear}
    os.makedirs(out_dir, exist_ok=True)
    dev = next(model.parameters()).device
    prototypes = torch.as_tensor(memory_bank, dtype=torch.float32).to(dev)
    table = torch.from_numpy(build_template_table(tokenizer, data.class_names, templates)).to(dev)
    class_feats = clip_mod.encode_text(model, table, normalize=True, **routes)

    pipe = TrainPipeline(data, PipelineConfig(batch_size=batch_size, image_size=image_size,
                                              shuffle_buffer=1),
                         num_samples=len(data.zs_top1))
    # the whole dataset once: epoch() would drop the tail and wrap when N < B
    stream = pipe._sample_stream(0)
    group_weights: List[np.ndarray] = []
    items: List[Dict] = []
    remaining = pipe.num_samples
    while remaining > 0:
        samples = [next(stream) for _ in range(min(batch_size, remaining))]
        valid = len(samples)
        remaining -= valid
        samples += samples[:1] * (batch_size - valid)
        per_img_tok = np.stack([s["per_image_tokens"] for s in samples]).astype(np.int32)
        per_grp_tok = np.stack([s["per_group_tokens"] for s in samples]).astype(np.int32)
        w_label, w_img, w_grp, preds = group_weight_terms(
            model, np.stack([s["image"] for s in samples]), per_img_tok, per_grp_tok, prototypes,
            class_feats, **routes)
        gw = (w_grp / (w_label + w_img + w_grp))[:valid].cpu().numpy()
        preds = preds[:valid].cpu().numpy()
        group_weights.append(gw)
        for row in range(valid):
            gt = int(samples[row]["gt"])
            items.append({
                "zs_lb": data.class_names[int(samples[row]["zs_pred"])],
                "ft_lb": data.class_names[int(preds[row])],
                "gt_lb": data.class_names[gt] if gt >= 0 else "",
                "per_image_text": _text(tokenizer, per_img_tok[row]),
                "per_image_group_text": _text(tokenizer, per_grp_tok[row]),
            })

    all_weights = np.concatenate(group_weights)
    np.save(os.path.join(out_dir, "group_weights.npy"), all_weights)
    with open(os.path.join(out_dir, "all_labels.json"), "w") as f:
        json.dump(items, f, indent=2)
    logger.info("saved %d group weights + labels to %s", len(all_weights), out_dir)
    return all_weights
