"""Pseudo-label extraction: the ``clip_features_<split>.pkl`` job (port of
``latteclip_tpu/eval/features.py``).

As the reference's ``extract_features`` (``src/training/train.py:1310-1382``):
build the dataset-template zero-shot classifier, run the frozen model over a
split and pickle ``image_id -> {image, top_class_ids, class_names,
top_logit, gt_classname, gt_class_id}``. This file is the join key of the
whole system: caption generation, the train data's caption join and the
zero-shot pseudo-labels all read it. The pickle holds numpy arrays and
lists only (``image`` float32 [E], ``top_class_ids`` the int64 indices of
``np.argsort``, ``top_logit`` float32 [k]), byte-compatible with the JAX
package's.
"""
from __future__ import annotations

import logging
import os
import pickle
from typing import Dict

import numpy as np
import torch

from latteclip_torch.data import transforms as T
from latteclip_torch.data.eval_dataset import FlatFileDataset, iter_batches
from latteclip_torch.eval.zero_shot import build_zero_shot_classifier, on_device, topk_counts
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models.tokenizer import ClipTokenizer

logger = logging.getLogger(__name__)


@torch.no_grad()
def extract_features(model: clip_mod.CLIP, tokenizer: ClipTokenizer, dataset: FlatFileDataset,
                     out_dir: str, split: str, *, batch_size: int = 64, topk: int = 10,
                     attention: str = "kernel", ln_linear: str = "unfused") -> Dict[str, dict]:
    """Write ``out_dir/clip_features_<split>.pkl`` and return its dict.
    ``attention`` and ``ln_linear`` select the towers' kernel routes."""
    routes = {"attention": attention, "ln_linear": ln_linear}
    classnames = dataset.display_class_names
    classifier = build_zero_shot_classifier(model, tokenizer, classnames, dataset.templates,
                                            **routes)
    dev = classifier.device
    mean, std = T.model_mean_std(model.cfg)

    features: Dict[str, dict] = {}
    top1 = top5 = top10 = n = 0.0
    batches = iter_batches(dataset, batch_size, pad_final=True)
    for ids, images, labels, valid in on_device(batches, dev):
        feats = clip_mod.encode_image(model, T.normalize_images(torch.as_tensor(images).to(dev),
                                                                mean, std),
                                      normalize=True, **routes)
        logits = (100.0 * feats @ classifier)[:valid].cpu().numpy()
        feats = feats[:valid].cpu().numpy()
        a1, a5, a10 = topk_counts(logits, np.asarray(labels)[:valid])
        top1 += a1
        top5 += a5
        top10 += a10
        n += valid
        order = np.argsort(-logits, axis=1)[:, :topk]
        top_logits = np.take_along_axis(logits, order, axis=1)
        for row in range(valid):
            gt = int(labels[row])
            features[ids[row]] = {
                "image": feats[row],
                "top_class_ids": order[row],
                "class_names": [classnames[i] for i in order[row]],
                "top_logit": top_logits[row],
                "gt_classname": classnames[gt],
                "gt_class_id": gt,
            }
    if n == 0:
        raise ValueError(f"extract_features[{split}]: dataset produced no samples")
    logger.info("extract_features[%s]: n=%d top1=%.4f top5=%.4f top10=%.4f",
                split, int(n), top1 / n, top5 / n, top10 / n)
    os.makedirs(out_dir, exist_ok=True)
    save_path = os.path.join(out_dir, f"clip_features_{split}.pkl")
    with open(save_path, "wb") as f:
        pickle.dump(features, f)
    logger.info("saved features to %s", save_path)
    return features
