"""The LatteCLIP v2 train step (port of ``latteclip_tpu/train/step.py``:
``LatteHParams``, ``_fuse``, ``fuse_text_streams``, ``latteclip_loss_fn``,
``update_memory_bank``, ``make_train_step``).

One step, as the reference's ``train_one_epoch_v2`` inner loop
(``src/training/train.py:358-565``) and the JAX step run it:

  1. colour-augment and normalize the uint8 images on the device;
  2. image forward, prototype-classifier logits from the live bank, and
     fine-tune pseudo-labels;
  3. text forward of the C class templates (once, rows gathered by label)
     and of both caption streams, padded at 77 or packed
     (``hp.text_packing``);
  4. confidence-weighted caption fusion against the epoch prototypes;
  5. prototype anchoring ``bank + alpha * (fused - bank)``;
  6. two symmetric InfoNCE losses (fine-tune and zero-shot pseudo-labels);
  7. backward, the AdamW update, the logit-scale clamp to [0, ln 100];
  8. the memory-bank update: per-class mean of this batch's anchored text
     features over both branches, renormalized; classes not seen keep their
     rows.

The JAX step's TPU levers (``remat``, ``fuse_text_fwd``) and its CoCa-only
``zero_update_subtrees`` are not ported (ROADMAP.md, section 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from latteclip_torch.data import transforms as T
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models.layers import l2_normalize
from latteclip_torch.train.objective import clip_loss, text_confidence_weights
from latteclip_torch.train.state import TrainState

LOG100 = 4.6051702  # ln(100), reference train.py:563-565
WEIGHT_EPS = 1e-6   # reference train.py:444-449
PACKED_KEYS = ("cap_tokens", "cap_positions", "cap_seg_ids", "cap_eot_row", "cap_eot_col")


@dataclasses.dataclass(frozen=True)
class LatteHParams:
    """Static hyperparameters of the v2 objective (reference params.py flags)."""

    alpha: float = 0.01                 # prototype blend, params.py:408-412
    use_template_caption: float = 1.0   # params.py:43-75 gates
    use_image_caption: float = 1.0
    use_batch_caption: float = 1.0
    use_zeroshot_pseudolabel: float = 1.0
    use_finetune_pseudolabel: float = 1.0
    augment: bool = True
    bug_compat: bool = False            # replay the reference's fusion quirks
    # captions packed by data.packing (batch carries the cap_* arrays)
    text_packing: bool = False


def _fuse(label_f, per_img_f, per_grp_f, w_label, w_img, w_grp) -> torch.Tensor:
    total = w_label + w_img + w_grp
    fused = w_label[:, None] * label_f + w_img[:, None] * per_img_f + w_grp[:, None] * per_grp_f
    return fused / total[:, None]


def fuse_text_streams(label_f, label_zs_f, per_img_f, per_grp_f,
                      w_label_g, w_label_zs_g, w_img_g, w_grp_g, bug_compat: bool = False):
    """Confidence-weighted caption fusion for both branches (train.py:469-484).

    By default per-sample weights in numerator and denominator, each branch
    self-consistent. ``bug_compat`` replays the reference's two quirks, as
    the JAX package does: (a) the label stream's weight broadcasts along the
    embedding axis, which only runs at batch == embed_dim; (b) the zero-shot
    numerator uses the fine-tune label weight, its denominator the zero-shot
    one."""
    if not bug_compat:
        return (_fuse(label_f, per_img_f, per_grp_f, w_label_g, w_img_g, w_grp_g),
                _fuse(label_zs_f, per_img_f, per_grp_f, w_label_zs_g, w_img_g, w_grp_g))
    B, E = label_f.shape
    if B != E:
        raise ValueError(
            f"bug_compat fusion requires batch == embed_dim (got {B} vs {E}); "
            "the reference's unbatched broadcast only runs at 512==512")
    captions = w_img_g[:, None] * per_img_f + w_grp_g[:, None] * per_grp_f
    total = w_label_g + w_img_g + w_grp_g
    total_zs = w_label_zs_g + w_img_g + w_grp_g
    return ((label_f * w_label_g[None, :] + captions) / total[:, None],
            (label_zs_f * w_label_g[None, :] + captions) / total_zs[:, None])


def _to_device(batch: Dict, keys: Sequence[str], device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(batch[k]).to(device) for k in keys)


def latteclip_loss_fn(
    model: clip_mod.CLIP,
    hp: LatteHParams,
    batch: Dict,
    images: torch.Tensor,
    memory_bank: torch.Tensor,
    prototypes: torch.Tensor,
    template_table: torch.Tensor,
    template_packed: Optional[Tuple[torch.Tensor, ...]] = None,
    *,
    attention: str = "kernel",
    ln_linear: str = "unfused",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The v2 objective -> ``(total loss, aux)``; ``aux`` holds the
    pseudo-labels and the detached anchored text features the bank update
    reads. ``template_packed`` is the packed template table (on the device)
    for ``hp.text_packing``; without it the templates run padded.
    ``attention`` and ``ln_linear`` select the towers' kernel routes."""
    dev = images.device
    zs_preds = torch.as_tensor(batch["zs_preds"]).to(dev).long()
    routes = {"attention": attention, "ln_linear": ln_linear}
    image_features = clip_mod.encode_image(model, images, normalize=True, **routes)
    logit_scale = model.logit_scale.exp()

    # fine-tune pseudo-labels from the live prototype classifier (train.py:384-411)
    with torch.no_grad():
        preds = (100.0 * image_features @ l2_normalize(memory_bank).T).argmax(dim=1)

    # the C class templates run once and their rows are gathered per label
    if hp.text_packing and template_packed is not None:
        class_text_feats = clip_mod.encode_text_packed(model, *template_packed, normalize=True,
                                                       **routes)
    else:
        class_text_feats = clip_mod.encode_text(model, template_table, normalize=True, **routes)
    B = zs_preds.shape[0]
    if hp.text_packing:
        caption_feats = clip_mod.encode_text_packed(
            model, *_to_device(batch, PACKED_KEYS, dev), normalize=True, **routes)
    else:
        tokens = torch.cat(_to_device(batch, ("per_image_tokens", "per_group_tokens"), dev))
        caption_feats = clip_mod.encode_text(model, tokens, normalize=True, **routes)
    per_img_f, per_grp_f = caption_feats[:B], caption_feats[B:]
    label_f = class_text_feats[preds]
    label_zs_f = class_text_feats[zs_preds]

    # confidence weights against the epoch prototypes (detached), gated
    w_img_g = (text_confidence_weights(per_img_f, prototypes) + WEIGHT_EPS) * hp.use_image_caption
    w_grp_g = (text_confidence_weights(per_grp_f, prototypes) + WEIGHT_EPS) * hp.use_batch_caption
    w_label_g = (text_confidence_weights(label_f, prototypes) + WEIGHT_EPS) * hp.use_template_caption
    w_label_zs_g = ((text_confidence_weights(label_zs_f, prototypes) + WEIGHT_EPS)
                    * hp.use_template_caption)
    text_fused, text_fused_zs = fuse_text_streams(
        label_f, label_zs_f, per_img_f, per_grp_f,
        w_label_g, w_label_zs_g, w_img_g, w_grp_g, hp.bug_compat)

    # prototype anchoring (train.py:487-488)
    anchor, anchor_zs = memory_bank[preds], memory_bank[zs_preds]
    text_final = anchor + hp.alpha * (text_fused - anchor)
    text_final_zs = anchor_zs + hp.alpha * (text_fused_zs - anchor_zs)

    loss_ft = clip_loss(image_features, text_final, logit_scale)
    loss_zs = clip_loss(image_features, text_final_zs, logit_scale) * hp.use_zeroshot_pseudolabel
    total = (loss_ft + loss_zs) * hp.use_finetune_pseudolabel
    aux = {
        "loss": total.detach(),
        "contrastive_loss": loss_ft.detach(),
        "zeroshot": loss_zs.detach(),
        "preds": preds,
        "zs_preds": zs_preds,
        "text_final": text_final.detach(),
        "text_final_zs": text_final_zs.detach(),
        "logit_scale": logit_scale.detach(),
        "pseudo_agreement": (preds == zs_preds).float().mean(),
    }
    return total, aux


@torch.no_grad()
def update_memory_bank(memory_bank: torch.Tensor, preds: torch.Tensor, zs_preds: torch.Tensor,
                       text_final: torch.Tensor, text_final_zs: torch.Tensor) -> torch.Tensor:
    """Segment-mean bank update over both branches (train.py:508-530): a new
    bank whose rows of the classes seen in this batch are the renormalized
    mean of their anchored features; the other rows are the old ones."""
    C = memory_bank.shape[0]
    ids = torch.cat([zs_preds, preds]).long()
    feats = torch.cat([text_final_zs, text_final]).float()
    sums = torch.zeros(C, feats.shape[1], dtype=torch.float32, device=feats.device)
    sums.index_add_(0, ids, feats)
    counts = torch.bincount(ids, minlength=C).float()
    updated = l2_normalize(sums / counts.clamp_min(1.0)[:, None])
    return torch.where((counts > 0)[:, None], updated, memory_bank)


def make_train_step(
    model: clip_mod.CLIP,
    hp: LatteHParams,
    template_table,
    aug: Optional[T.AugConfig] = None,
    template_packed=None,
    *,
    attention: str = "kernel",
    ln_linear: str = "unfused",
):
    """Build the step ``(state, batch, generator) -> metrics``, which
    updates ``state`` in place: augment, forward, backward, AdamW update,
    logit-scale clamp, then the bank update from the detached anchored text
    features (JAX step.py:329-372).

    ``batch`` holds numpy or tensor arrays: ``images`` uint8 [B, H, W, 3],
    ``zs_preds`` [B], and ``per_image_tokens``/``per_group_tokens`` [B, 77]
    or, with ``hp.text_packing``, the ``cap_*`` arrays of
    :func:`latteclip_torch.data.packing.pack_caption_batch`.
    ``template_packed``: the packed template table (a ``PackedText``) for
    ``hp.text_packing``. ``generator`` draws the augment (a
    ``torch.Generator`` on the model's device). ``attention`` and
    ``ln_linear`` select the towers' kernel routes. Metrics are 0-d tensors
    on the device."""
    aug = aug or T.AugConfig()
    cfg = model.cfg
    dev = next(model.parameters()).device
    table = torch.as_tensor(template_table).to(dev)
    packed = None
    if template_packed is not None:
        packed = tuple(torch.as_tensor(a).to(dev) for a in template_packed)
    mean, std = T.model_mean_std(cfg)

    def step_fn(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None):
        images_u8 = torch.as_tensor(batch["images"]).to(dev)
        if hp.augment:
            images = T.train_augment_normalize(images_u8, generator, aug, mean=mean, std=std)
        else:
            images = T.normalize_images(images_u8, mean=mean, std=std)

        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = latteclip_loss_fn(state.model, hp, batch, images, state.memory_bank,
                                      state.prototypes, table, packed, attention=attention,
                                      ln_linear=ln_linear)
        loss.backward()
        state.optimizer.step()
        with torch.no_grad():
            state.model.logit_scale.clamp_(0.0, LOG100)

        state.memory_bank = update_memory_bank(state.memory_bank, aux["preds"], aux["zs_preds"],
                                               aux["text_final"], aux["text_final_zs"])
        state.step += 1
        return {k: aux[k] for k in ("loss", "contrastive_loss", "zeroshot", "logit_scale",
                                    "pseudo_agreement")}

    return step_fn
