"""Zero-shot classification: classifier builders and top-k evaluation.

Port of ``latteclip_tpu/eval/zero_shot.py``. The README's quick start maps to
these functions one to one:

* :func:`build_zero_shot_classifier`: template texts per class through the
  padded or the packed text tower, mean over templates, L2-normalized,
  stacked to ``[D, C]``;
* :func:`prototype_classifier`: the LatteCLIP memory bank ``[C, D]`` as a
  normalized ``[D, C]`` classifier;
* :func:`run_zero_shot_eval`: ``logits = 100 * normalize(f(image)) @
  classifier`` over uint8 batches, with top-1/5/10 accuracy; on the card
  the batches come from pinned memory, copied a batch ahead.

Everything runs on the model's device under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List, Sequence

import numpy as np
import torch

from latteclip_torch.data import transforms as T
from latteclip_torch.data.packing import pack_token_rows, token_lengths
from latteclip_torch.data.pipeline import prefetch
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models.layers import l2_normalize
from latteclip_torch.models.tokenizer import ClipTokenizer


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def tokenize_class_templates(tokenizer: ClipTokenizer, classnames: Sequence[str],
                             templates: Sequence[Callable[[str], str]]) -> np.ndarray:
    """[C*T, ctx] int32 token table, class-major (templates contiguous)."""
    return tokenizer([t(c) for c in classnames for t in templates])


@torch.no_grad()
def build_zero_shot_classifier(
    model: clip_mod.CLIP,
    tokenizer: ClipTokenizer,
    classnames: Sequence[str],
    templates: Sequence[Callable[[str], str]],
    *,
    chunk_classes: int = 64,
    packing: int = 0,
    attention: str = "kernel",
    ln_linear: str = "unfused",
) -> torch.Tensor:
    """Classifier weights ``[D, C]`` (template mean, L2-normalized), encoded
    ``chunk_classes`` classes at a time through the padded text tower or,
    with ``packing`` (the pack length, e.g. 128), through the packed one.
    ``attention`` and ``ln_linear`` select the towers' kernel routes."""
    num_templates = len(templates)
    table = tokenize_class_templates(tokenizer, classnames, templates)
    if packing and packing < table.shape[1]:
        raise ValueError(f"packing={packing} < token context {table.shape[1]}")
    dev = _device(model)
    chunk = chunk_classes * num_templates
    outs = []
    for start in range(0, table.shape[0], chunk):
        block = table[start:start + chunk]
        if packing:
            pk = pack_token_rows(block, token_lengths(block), packing)
            feats = clip_mod.encode_text_packed(
                model, *(torch.from_numpy(a).to(dev) for a in pk), normalize=True,
                attention=attention, ln_linear=ln_linear)
        else:
            feats = clip_mod.encode_text(model, torch.from_numpy(block).to(dev), normalize=True,
                                         attention=attention, ln_linear=ln_linear)
        feats = feats.reshape(-1, num_templates, feats.shape[-1]).mean(dim=1)
        outs.append(l2_normalize(feats))
    return torch.cat(outs).T


def prototype_classifier(memory_bank: torch.Tensor) -> torch.Tensor:
    """Memory bank [C, D] -> normalized classifier [D, C]."""
    return l2_normalize(torch.as_tensor(memory_bank)).T


def make_eval_step(model: clip_mod.CLIP, classifier: torch.Tensor, *,
                   attention: str = "kernel", ln_linear: str = "unfused"):
    """uint8 images [B, H, W, 3] (numpy or tensor) -> logits float32 [B, C]."""
    dev = _device(model)
    mean, std = T.model_mean_std(model.cfg)
    classifier = classifier.to(dev)

    @torch.no_grad()
    def step(images_u8) -> torch.Tensor:
        images = T.normalize_images(torch.as_tensor(images_u8).to(dev), mean, std)
        feats = clip_mod.encode_image(model, images, normalize=True, attention=attention,
                                      ln_linear=ln_linear)
        return 100.0 * feats @ classifier
    return step


def topk_counts(logits: np.ndarray, target: np.ndarray, ks=(1, 5, 10)) -> List[float]:
    """Count of targets within the top-k predictions."""
    order = np.argsort(-logits, axis=1)
    return [float((order[:, :k] == target[:, None]).any(axis=1).sum()) for k in ks]


def on_device(batches: Iterable, dev: torch.device) -> Iterator:
    """``(ids, images, labels, valid)`` batches with the images on ``dev``;
    on a CUDA device they come from pinned memory, copied ahead on a side
    stream by :func:`latteclip_torch.data.pipeline.prefetch`."""
    items = ({"images": images, "meta": (ids, labels, valid)}
             for ids, images, labels, valid in batches)
    for item in prefetch(items, device=dev) if dev.type == "cuda" else items:
        ids, labels, valid = item["meta"]
        yield ids, item["images"], labels, valid


def run_zero_shot_eval(model: clip_mod.CLIP, classifier: torch.Tensor, batches: Iterable, *,
                       attention: str = "kernel", ln_linear: str = "unfused") -> Dict[str, float]:
    """Top-1/5/10 over an iterator of ``(ids, uint8 images, labels, valid)``;
    only the first ``valid`` rows of a batch count."""
    step = make_eval_step(model, classifier, attention=attention, ln_linear=ln_linear)
    top1 = top5 = top10 = n = 0.0
    for _ids, images, labels, valid in on_device(batches, _device(model)):
        logits = step(images)[:valid].cpu().numpy()
        a1, a5, a10 = topk_counts(logits, np.asarray(labels)[:valid])
        top1 += a1
        top5 += a5
        top10 += a10
        n += valid
    if n == 0:
        raise ValueError("zero-shot eval received no samples: empty val split or a filter "
                         "that dropped every image")
    return {"top1": top1 / n, "top5": top5 / n, "top10": top10 / n, "n": n}
