"""Image-text retrieval metrics and the validation loss (port of
``latteclip_tpu/eval/retrieval.py``).

:func:`clip_retrieval_metrics` is the reference's ``get_clip_metrics``
(``src/training/train.py:1506-1523``): mean rank (+1), median rank
(``floor(median) + 1``) and R@1/5/10 in both directions over the whole
feature matrix. :func:`validation_loss` is the "val" branch of ``evaluate``
(``train.py:1399-1468``): the symmetric InfoNCE of each batch, weighted by
its size, plus the retrieval metrics over all batches' features.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from latteclip_torch.data import transforms as T
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models.tokenizer import ClipTokenizer, get_tokenizer
from latteclip_torch.train.objective import clip_loss


def clip_retrieval_metrics(image_features: np.ndarray, text_features: np.ndarray,
                           logit_scale: float) -> Dict[str, float]:
    logits_i2t = logit_scale * image_features @ text_features.T
    out: Dict[str, float] = {}
    gt = np.arange(len(text_features))[:, None]
    for name, logits in (("image_to_text", logits_i2t), ("text_to_image", logits_i2t.T)):
        ranking = np.argsort(-logits, axis=1)
        preds = np.where(ranking == gt)[1]
        out[f"{name}_mean_rank"] = float(preds.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in (1, 5, 10):
            out[f"{name}_R@{k}"] = float(np.mean(preds < k))
    return out


@torch.no_grad()
def validation_loss(model: clip_mod.CLIP, batches: Iterable[Tuple[np.ndarray, np.ndarray]], *,
                    attention: str = "kernel", ln_linear: str = "unfused") -> Dict[str, float]:
    """Over ``(uint8 images, tokens)`` batches: ``clip_val_loss``,
    ``num_samples`` and the retrieval metrics; ``{}`` without batches."""
    routes = {"attention": attention, "ln_linear": ln_linear}
    dev = next(model.parameters()).device
    mean, std = T.model_mean_std(model.cfg)
    all_img, all_txt = [], []
    cumulative, n, scale = 0.0, 0, 1.0
    for images_u8, tokens in batches:
        images = T.normalize_images(torch.as_tensor(images_u8).to(dev), mean, std)
        img = clip_mod.encode_image(model, images, normalize=True, **routes)
        txt = clip_mod.encode_text(model, torch.as_tensor(tokens).to(dev), normalize=True,
                                   **routes)
        scale_t = model.logit_scale.exp()
        bs = images_u8.shape[0]
        cumulative += float(clip_loss(img, txt, scale_t)) * bs
        n += bs
        scale = float(scale_t)
        all_img.append(img.cpu().numpy())
        all_txt.append(txt.cpu().numpy())
    if n == 0:
        return {}
    metrics = clip_retrieval_metrics(np.concatenate(all_img), np.concatenate(all_txt), scale)
    metrics["clip_val_loss"] = cumulative / n
    metrics["num_samples"] = n
    return metrics


def evaluate_val_pairs(model: clip_mod.CLIP, dataset, batch_size: int = 64,
                       tokenizer: ClipTokenizer = None, *, attention: str = "kernel",
                       ln_linear: str = "unfused") -> Dict[str, float]:
    """The epoch's val-set evaluation over an (image, caption) dataset with
    ``__len__`` and ``load_sample(i) -> (uint8 image, caption)``, such as
    :class:`latteclip_torch.data.folder_dataset.CsvDataset`."""
    tokenizer = tokenizer or get_tokenizer(model.cfg.text.context_length)

    def batches():
        for start in range(0, len(dataset), batch_size):
            samples = [dataset.load_sample(i)
                       for i in range(start, min(start + batch_size, len(dataset)))]
            yield np.stack([s[0] for s in samples]), tokenizer([s[1] for s in samples])

    return validation_loss(model, batches(), attention=attention, ln_linear=ln_linear)
