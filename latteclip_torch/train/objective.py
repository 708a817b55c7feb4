"""Contrastive objectives and confidence weights (port of
``latteclip_tpu/train/objective.py``: ``cross_entropy_with_int_labels``,
``clip_loss``, ``distill_clip_loss``, ``_sigmoid_pair_loss``,
``siglip_full_loss``, ``text_confidence_weights``).

``clip_loss`` is the reference ``ClipLoss``: symmetric cross-entropy over
``scale * img @ text.T`` with diagonal targets, log-softmax in float32.
``text_confidence_weights`` is ``compute_text_weights``: the top1 - top2
margin of ``text @ prototypes.T``, detached. ``distill_clip_loss`` and
``siglip_full_loss`` are the FLYP trainer's ``--distill-*`` and ``--siglip``
objectives. Under data parallelism the steps call them on features
gathered over the data group (:func:`latteclip_torch.mesh.gather`), the
global batch, as JAX's GSPMD step does. ``siglip_ring_loss`` is JAX's ring
form: text blocks passed round the data ranks instead of gathered; a
library function, as in JAX, whose FLYP step takes the full form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from latteclip_torch import mesh as mesh_mod


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


def distill_clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                      logit_scale: torch.Tensor, teacher_image_features: torch.Tensor,
                      teacher_text_features: torch.Tensor,
                      teacher_logit_scale: torch.Tensor) -> torch.Tensor:
    """Soft-target distillation (reference ``DistillClipLoss``): the
    cross-entropy of the student's logit distributions against the frozen
    teacher's, image to text and text to image, in float32."""

    def dist_loss(teacher_logits, student_logits):
        t = torch.softmax(teacher_logits.float(), dim=1)
        return -(t * F.log_softmax(student_logits.float(), dim=1)).sum(dim=1).mean()

    student = logit_scale * image_features @ text_features.T
    teacher = teacher_logit_scale * teacher_image_features @ teacher_text_features.T
    return 0.5 * (dist_loss(teacher, student) + dist_loss(teacher.T, student.T))


def sigmoid_pair_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                      logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                      negative_only: bool = False) -> torch.Tensor:
    """Sum over every (image, text) pair of ``-log sigmoid(target * logit)``
    divided by the number of images; the target is +1 on the diagonal and -1
    elsewhere, or -1 everywhere with ``negative_only`` (JAX
    ``_sigmoid_pair_loss``)."""
    logits = logit_scale * image_features @ text_features.T + logit_bias
    n, m = logits.shape
    targets = -torch.ones(n, m, dtype=torch.float32, device=logits.device)
    if not negative_only:
        targets = targets + 2.0 * torch.eye(n, m, dtype=torch.float32, device=logits.device)
    return -F.logsigmoid(targets * logits).sum() / n


def siglip_full_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                     logit_scale: torch.Tensor, logit_bias: torch.Tensor) -> torch.Tensor:
    """The SigLIP loss over the whole batch (reference ``SigLipLoss`` on one
    device): :func:`sigmoid_pair_loss` over every pair."""
    return sigmoid_pair_loss(image_features, text_features, logit_scale, logit_bias)


def siglip_ring_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                     logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                     mesh: "mesh_mod.Mesh") -> torch.Tensor:
    """The SigLIP loss of the data group's global batch with the text
    blocks passed round a ring of data ranks (JAX ``siglip_ring_loss``,
    objective.py:79-111; the reference's neighbour exchange, loss.py:
    365-450): each rank scores its images against its own texts, then
    against each other rank's texts as they arrive (``batch_isend_irecv``;
    the gradients go back the other way), and the ranks' sums are averaged.
    Equal to :func:`siglip_full_loss` on the gathered features; the
    gradient on each rank's features is the data size times its share, as
    :func:`latteclip_torch.mesh.gather` gives it."""
    loss = sigmoid_pair_loss(image_features, text_features, logit_scale, logit_bias)
    text = text_features
    for _ in range(mesh.data_size - 1):
        text = mesh_mod.ring_shift(text, mesh)
        loss = loss + sigmoid_pair_loss(image_features, text, logit_scale, logit_bias,
                                        negative_only=True)
    return mesh_mod.data_sum(loss, mesh) / mesh.data_size
