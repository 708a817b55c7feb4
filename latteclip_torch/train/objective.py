"""Contrastive objective and confidence weights (port of
``latteclip_tpu/train/objective.py``: ``cross_entropy_with_int_labels``,
``clip_loss``, ``text_confidence_weights``).

``clip_loss`` is the reference ``ClipLoss``: symmetric cross-entropy over
``scale * img @ text.T`` with diagonal targets, log-softmax in float32.
``text_confidence_weights`` is ``compute_text_weights``: the top1 - top2
margin of ``text @ prototypes.T``, detached.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_with_int_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with the log-softmax in float32."""
    return F.cross_entropy(logits.float(), labels)


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch."""
    logits_per_image = logit_scale * image_features @ text_features.T
    labels = torch.arange(logits_per_image.shape[0], device=logits_per_image.device)
    return 0.5 * (cross_entropy_with_int_labels(logits_per_image, labels)
                  + cross_entropy_with_int_labels(logits_per_image.T, labels))


def text_confidence_weights(text_features: torch.Tensor, prototypes: torch.Tensor) -> torch.Tensor:
    """Top1 - top2 margin of ``text_features @ prototypes.T``, detached."""
    top2 = torch.topk(text_features.detach() @ prototypes.T, 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]
