"""The train steps (port of ``latteclip_tpu/train/step.py``:
``LatteHParams``, ``_fuse``, ``fuse_text_streams``, ``latteclip_loss_fn``,
``update_memory_bank``, ``make_train_step``; the legacy v1 trainer
``v1_loss_fn``, ``v1_update_memory_bank``, ``make_v1_step``; the FLYP
baseline ``flyp_loss_fn``, ``make_flyp_step``).

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

``hp.remat`` (per tower ``remat_text``/``remat_vision``) rematerialises the
towers' blocks, keeping the attention outputs (:mod:`latteclip_torch.models.layers`);
``hp.fuse_text_fwd`` runs the templates and both caption streams as one
padded ``[C + 2B, ctx]`` text forward, rows zero-padded to a multiple of 8,
where JAX does (captions not packed). With ``batch["crop_boxes"]`` the
images are canvases and the random resized crop runs in the step. The update
(:func:`apply_gradients`) accumulates, clips and steps as the JAX package's
optax chain does (:mod:`latteclip_torch.train.optim`).
``zero_update_subtrees`` keeps the parameters under those names (CoCa's
``text_decoder``, which the v2 objective never reads) as they were, as JAX
zeroes their updates after AdamW: their moments see zero gradients.

On a mesh (``state.mesh``, :mod:`latteclip_torch.mesh`) each rank runs
the step on its local batch with the semantics of JAX's GSPMD step on the
global batch: the image and text features are gathered over the data
group for the global logits, the bank's float32 segment sums and counts
are summed over the ranks before the mean, the logged metrics are global,
and the gradients are averaged before every :func:`apply_gradients` (the
gather's backward leaves a rank W times its share). Each rank packs and
pools its own captions.

The other trainers of the JAX CLI: ``--gamma`` selects the legacy v1 step
(the reference's ``train_one_epoch``: a detached template anchor, only the
image tower and the logit scale train, the gamma bank update), and
``--method flyp|flyp_gt`` the FLYP step (``train_one_epoch_original_clip``:
InfoNCE against the padded template of each sample's pseudo-label or
ground-truth label, with ``--siglip`` the sigmoid loss and with
``--distill-*`` a frozen teacher's soft targets). Neither encodes captions.
On a CoCa model FLYP takes CoCaLoss (``coca_weights``): the full forward on
each sample's template, InfoNCE plus the caption loss of the decoder.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from latteclip_torch import mesh as mesh_mod
from latteclip_torch.data import transforms as T
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models import coca as coca_mod
from latteclip_torch.models.layers import l2_normalize
from latteclip_torch.models.quantize import refuse_training
from latteclip_torch.train.objective import (
    clip_loss,
    distill_clip_loss,
    siglip_full_loss,
    text_confidence_weights,
)
from latteclip_torch.train.optim import clip_by_global_norm_, tower_parameters
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
    remat: bool = False                 # rematerialise both towers' blocks
    remat_text: Optional[bool] = None   # per-tower override; None follows remat
    remat_vision: Optional[bool] = None
    augment: bool = True
    bug_compat: bool = False            # replay the reference's fusion quirks
    # templates and both caption streams in one padded text forward
    fuse_text_fwd: bool = False
    # captions packed by data.packing (batch carries the cap_* arrays)
    text_packing: bool = False

    @property
    def text_remat(self) -> bool:
        return self.remat if self.remat_text is None else self.remat_text

    @property
    def vision_remat(self) -> bool:
        return self.remat if self.remat_vision is None else self.remat_vision


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
    """The batch's arrays on ``device``; a tensor already there is used as is."""
    return tuple(torch.as_tensor(batch[k]).to(device, non_blocking=True) for k in keys)


def _step_images(cfg, hp: LatteHParams, aug: T.AugConfig, batch: Dict,
                 generator: Optional[torch.Generator], dev) -> torch.Tensor:
    """The batch's uint8 images (or canvases with ``crop_boxes``) on ``dev``,
    augmented when ``hp.augment`` and normalized, as every trainer starts."""
    mean, std = T.model_mean_std(cfg)
    images_u8 = _to_device(batch, ("images",), dev)[0]
    if not hp.augment:
        return T.normalize_images(images_u8, mean=mean, std=std)
    boxes = batch.get("crop_boxes")
    if boxes is not None:
        boxes = _to_device(batch, ("crop_boxes",), dev)[0]
    return T.train_augment_normalize(images_u8, generator, aug, mean=mean, std=std, boxes=boxes,
                                     size=cfg.vision.image_size)


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
    mesh: Optional[mesh_mod.Mesh] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The v2 objective -> ``(total loss, aux)``; ``aux`` holds the
    pseudo-labels and the detached anchored text features the bank update
    reads. ``template_packed`` is the packed template table (on the device)
    for ``hp.text_packing``; without it the templates run padded.
    ``attention`` and ``ln_linear`` select the towers' kernel routes. On a
    ``mesh`` the two InfoNCE losses take the data group's gathered
    features."""
    dev = images.device
    zs_preds = _to_device(batch, ("zs_preds",), dev)[0].long()
    routes = {"attention": attention, "ln_linear": ln_linear}
    text = {**routes, "normalize": True, "remat": hp.text_remat}
    image_features = clip_mod.encode_image(model, images, normalize=True, remat=hp.vision_remat,
                                           **routes)
    logit_scale = model.logit_scale.exp()

    # fine-tune pseudo-labels from the live prototype classifier (train.py:384-411)
    with torch.no_grad():
        preds = (100.0 * image_features @ l2_normalize(memory_bank).T).argmax(dim=1)

    # the C class templates run once and their rows are gathered per label
    B = zs_preds.shape[0]
    if hp.text_packing:
        if template_packed is not None:
            class_text_feats = clip_mod.encode_text_packed(model, *template_packed, **text)
        else:
            class_text_feats = clip_mod.encode_text(model, template_table, **text)
        caption_feats = clip_mod.encode_text_packed(
            model, *_to_device(batch, PACKED_KEYS, dev), **text)
        per_img_f, per_grp_f = caption_feats[:B], caption_feats[B:]
    elif hp.fuse_text_fwd:
        C = template_table.shape[0]
        tokens = torch.cat([template_table,
                            *_to_device(batch, ("per_image_tokens", "per_group_tokens"), dev)])
        tokens = torch.cat([tokens, tokens.new_zeros((-tokens.shape[0] % 8, tokens.shape[1]))])
        feats = clip_mod.encode_text(model, tokens, **text)
        class_text_feats = feats[:C]
        per_img_f, per_grp_f = feats[C:C + B], feats[C + B:C + 2 * B]
    else:
        class_text_feats = clip_mod.encode_text(model, template_table, **text)
        tokens = torch.cat(_to_device(batch, ("per_image_tokens", "per_group_tokens"), dev))
        caption_feats = clip_mod.encode_text(model, tokens, **text)
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

    image_all = mesh_mod.gather(image_features, mesh)
    loss_ft = clip_loss(image_all, mesh_mod.gather(text_final, mesh), logit_scale)
    loss_zs = (clip_loss(image_all, mesh_mod.gather(text_final_zs, mesh), logit_scale)
               * hp.use_zeroshot_pseudolabel)
    total = (loss_ft + loss_zs) * hp.use_finetune_pseudolabel
    agreement = (preds == zs_preds).float().mean()
    aux = {
        "loss": total.detach(),
        "contrastive_loss": loss_ft.detach(),
        "zeroshot": loss_zs.detach(),
        "preds": preds,
        "zs_preds": zs_preds,
        "text_final": text_final.detach(),
        "text_final_zs": text_final_zs.detach(),
        "logit_scale": logit_scale.detach(),
        "pseudo_agreement": agreement if mesh is None else mesh.mean(agreement),
    }
    return total, aux


def _segment_sums(C: int, ids: torch.Tensor, feats: torch.Tensor,
                  mesh: Optional[mesh_mod.Mesh]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class float32 sums of ``feats`` [N, D] and counts of ``ids`` [N];
    on a mesh summed over every rank (a model group's K ranks hold the same
    batch, so both come out K times the global batch's and their ratio is
    its mean; JAX step.py:278-298 psums them over the data axis)."""
    sums = torch.zeros(C, feats.shape[1], dtype=torch.float32, device=feats.device)
    sums.index_add_(0, ids, feats)
    counts = torch.bincount(ids, minlength=C).float()
    if mesh is None:
        return sums, counts
    both = mesh.all_reduce_(torch.cat([sums, counts[:, None]], dim=1))
    return both[:, :-1], both[:, -1]


@torch.no_grad()
def update_memory_bank(memory_bank: torch.Tensor, preds: torch.Tensor, zs_preds: torch.Tensor,
                       text_final: torch.Tensor, text_final_zs: torch.Tensor,
                       mesh: Optional[mesh_mod.Mesh] = None) -> torch.Tensor:
    """Segment-mean bank update over both branches (train.py:508-530): a new
    bank whose rows of the classes seen in this batch (the global batch, on
    a ``mesh``) are the renormalized mean of their anchored features; the
    other rows are the old ones."""
    C = memory_bank.shape[0]
    ids = torch.cat([zs_preds, preds]).long()
    feats = torch.cat([text_final_zs, text_final]).float()
    sums, counts = _segment_sums(C, ids, feats, mesh)
    updated = l2_normalize(sums / counts.clamp_min(1.0)[:, None])
    return torch.where((counts > 0)[:, None], updated, memory_bank)


@torch.no_grad()
def apply_gradients(state: TrainState) -> None:
    """The optimizer update after the backward, as the JAX package's optax
    chain applies it: with ``state.accum`` the gradient joins the running
    mean of its cycle (``acc + (g - acc) / (n + 1)``) and only the cycle's
    last call goes on, with the mean; then the global-norm clip over every
    gradient, locked towers' included, when ``grad_clip_norm`` is set, and
    the AdamW step. On a mesh every call first averages the gradients over
    the ranks (:meth:`latteclip_torch.mesh.Mesh.sync_gradients`), as GSPMD's
    psums run on every micro-batch, and the clip's norm counts each
    model-sharded leaf's shards once."""
    opt, acc = state.optimizer, state.accum
    named = list(state.model.named_parameters())
    params = [p for _, p in named]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    sharded = [name in state.tp_dims for name, _ in named]
    if state.mesh is not None:
        state.mesh.sync_gradients(grads, sharded)
    if acc is not None:
        n = acc.mini_step
        torch._foreach_add_(acc.grads, torch._foreach_div(torch._foreach_sub(grads, acc.grads),
                                                          float(n + 1)))
        acc.mini_step = (n + 1) % acc.every
        if n != acc.every - 1:
            return
        grads = [g.clone() for g in acc.grads]
        torch._foreach_zero_(acc.grads)
        acc.gradient_step += 1
    for p, g in zip(params, grads):
        p.grad = g
    clip = getattr(opt, "grad_clip_norm", None)
    if clip is not None:
        clip_by_global_norm_(grads, clip, state.mesh, sharded)
    opt.step()


def make_train_step(
    model: clip_mod.CLIP,
    hp: LatteHParams,
    template_table,
    aug: Optional[T.AugConfig] = None,
    template_packed=None,
    *,
    attention: str = "kernel",
    ln_linear: str = "unfused",
    zero_update_subtrees: Sequence[str] = (),
):
    """Build the step ``(state, batch, generator) -> metrics``, which
    updates ``state`` in place: augment, forward, backward, the update of
    :func:`apply_gradients`, logit-scale clamp, then the bank update from
    the detached anchored text features (JAX step.py:329-372).

    ``batch`` holds numpy or tensor arrays: ``images`` uint8 [B, H, W, 3]
    (canvases, with ``crop_boxes`` [B, 4] float32), ``zs_preds`` [B], and
    ``per_image_tokens``/``per_group_tokens`` [B, 77] or, with
    ``hp.text_packing``, the ``cap_*`` arrays of
    :func:`latteclip_torch.data.packing.pack_caption_batch`.
    ``template_packed``: the packed template table (a ``PackedText``) for
    ``hp.text_packing``. ``generator`` draws the augment (a
    ``torch.Generator`` on the model's device). ``attention`` and
    ``ln_linear`` select the towers' kernel routes. The parameters under
    each of ``zero_update_subtrees`` (a top-level module name) are written
    back after the update, as in :func:`make_v1_step`. Metrics are 0-d
    tensors on the device."""
    refuse_training(model)
    aug = aug or T.AugConfig()
    cfg = model.cfg
    dev = next(model.parameters()).device
    table = torch.as_tensor(template_table).to(dev)
    packed = None
    if template_packed is not None:
        packed = tuple(torch.as_tensor(a).to(dev) for a in template_packed)
    frozen = [p for name, p in model.named_parameters()
              if name.split(".", 1)[0] in zero_update_subtrees]

    def step_fn(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None):
        images = _step_images(cfg, hp, aug, batch, generator, dev)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = latteclip_loss_fn(state.model, hp, batch, images, state.memory_bank,
                                      state.prototypes, table, packed, attention=attention,
                                      ln_linear=ln_linear, mesh=state.mesh)
        loss.backward()
        with torch.no_grad():
            kept = [p.detach().clone() for p in frozen]
        apply_gradients(state)
        with torch.no_grad():
            if frozen:
                torch._foreach_copy_(frozen, kept)
            state.model.logit_scale.clamp_(0.0, LOG100)

        state.memory_bank = update_memory_bank(state.memory_bank, aux["preds"], aux["zs_preds"],
                                               aux["text_final"], aux["text_final_zs"],
                                               state.mesh)
        state.step += 1
        return {k: aux[k] for k in ("loss", "contrastive_loss", "zeroshot", "logit_scale",
                                    "pseudo_agreement")}

    return step_fn


# -- the legacy v1 trainer (reference train_one_epoch): the --gamma path ------

def v1_loss_fn(model: clip_mod.CLIP, hp: LatteHParams, batch: Dict, images: torch.Tensor,
               memory_bank: torch.Tensor, template_table: torch.Tensor, *,
               attention: str = "kernel", ln_linear: str = "unfused",
               mesh: Optional[mesh_mod.Mesh] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of the reference's legacy ``train_one_epoch`` (JAX
    ``v1_loss_fn``): symmetric InfoNCE between the image features and the
    detached anchor of each sample's zero-shot pseudo-label. The anchor is
    ``normalize(bank) + alpha * (template - normalize(bank))`` over the
    gathered bank rows when their sum over the whole batch is not 0 (one
    test for the batch, as the reference's ``membank.sum() != 0``), else the
    template feature. The text tower runs without autograd, so only the
    image tower and ``logit_scale`` get gradients and no attention backward
    runs on the text. ``aux`` holds the un-normalized anchor and the detached
    image features that :func:`v1_update_memory_bank` mixes. On a ``mesh``
    the bank test sums the rows of the global batch and the loss takes the
    gathered features."""
    dev = images.device
    zs_preds = _to_device(batch, ("zs_preds",), dev)[0].long()
    routes = {"attention": attention, "ln_linear": ln_linear}
    image_features = clip_mod.encode_image(model, images, normalize=True, remat=hp.vision_remat,
                                           **routes)
    logit_scale = model.logit_scale.exp()
    with torch.no_grad():
        class_text_feats = clip_mod.encode_text(model, template_table, normalize=True,
                                                remat=hp.text_remat, **routes)
        label_f = class_text_feats[zs_preds]
        bank_rows = memory_bank[zs_preds]
        bank_norm = l2_normalize(bank_rows)
        total = bank_rows.sum()
        if mesh is not None:
            total = mesh.all_reduce_(total.clone())
        anchored = torch.where(total != 0.0,
                               bank_norm + hp.alpha * (label_f - bank_norm), label_f)
    loss = clip_loss(mesh_mod.gather(image_features, mesh),
                     mesh_mod.gather(l2_normalize(anchored), mesh), logit_scale)
    aux = {"loss": loss.detach(), "contrastive_loss": loss.detach(),
           "logit_scale": logit_scale.detach(), "zs_preds": zs_preds, "anchored": anchored,
           "image_features": image_features.detach()}
    return loss, aux


@torch.no_grad()
def v1_update_memory_bank(memory_bank: torch.Tensor, zs_preds: torch.Tensor,
                          anchored: torch.Tensor, image_features: torch.Tensor,
                          gamma: float, mesh: Optional[mesh_mod.Mesh] = None) -> torch.Tensor:
    """The gamma momentum-prototype update of v1 (JAX
    ``v1_update_memory_bank``): each sample mixes its un-normalized anchor
    with its image feature, ``anchored * (1 - gamma) + image * gamma``; each
    class seen in the batch (the global batch, on a ``mesh``) takes the mean
    of its samples' mixes, not renormalized; the other rows keep theirs."""
    C = memory_bank.shape[0]
    feats = (anchored * (1.0 - gamma) + image_features * gamma).float()
    sums, counts = _segment_sums(C, zs_preds.long(), feats, mesh)
    return torch.where((counts > 0)[:, None], sums / counts.clamp_min(1.0)[:, None], memory_bank)


def make_v1_step(model: clip_mod.CLIP, hp: LatteHParams, template_table, gamma: float,
                 aug: Optional[T.AugConfig] = None, *, attention: str = "kernel",
                 ln_linear: str = "unfused"):
    """Build the legacy-v1 step ``(state, batch, generator) -> metrics``
    (JAX ``make_v1_step``): augment, :func:`v1_loss_fn`, backward, the
    update of :func:`apply_gradients`, the logit-scale clamp and
    :func:`v1_update_memory_bank`. JAX zeroes the text subtree's updates
    after the optimizer: the text parameters stay as they were while their
    AdamW moments still see the zero gradients and the count advances.
    Here the text parameters are copied before the update and written back
    after it, which gives the same, since torch's AdamW would otherwise
    apply weight decay to them and move them where their moments are not 0."""
    refuse_training(model)
    aug = aug or T.AugConfig()
    cfg = model.cfg
    dev = next(model.parameters()).device
    table = torch.as_tensor(template_table).to(dev)
    text_params = tower_parameters(model, "text")

    def step_fn(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None):
        images = _step_images(cfg, hp, aug, batch, generator, dev)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = v1_loss_fn(state.model, hp, batch, images, state.memory_bank, table,
                               attention=attention, ln_linear=ln_linear, mesh=state.mesh)
        loss.backward()
        with torch.no_grad():
            kept = [p.detach().clone() for p in text_params]
        apply_gradients(state)
        with torch.no_grad():
            torch._foreach_copy_(text_params, kept)
            state.model.logit_scale.clamp_(0.0, LOG100)
        state.memory_bank = v1_update_memory_bank(state.memory_bank, aux["zs_preds"],
                                                  aux["anchored"], aux["image_features"], gamma,
                                                  state.mesh)
        state.step += 1
        return {k: aux[k] for k in ("loss", "contrastive_loss", "logit_scale")}

    return step_fn


# -- the FLYP baseline (reference train_one_epoch_original_clip) --------------

DEFAULT_LOGIT_BIAS = -10.0  # the reference SigLIP configs' init_logit_bias


def flyp_loss_fn(model: clip_mod.CLIP, hp: LatteHParams, batch: Dict, images: torch.Tensor,
                 template_table: torch.Tensor, use_gt: bool, use_siglip: bool = False,
                 teacher: Optional[clip_mod.CLIP] = None, *, attention: str = "kernel",
                 ln_linear: str = "unfused", coca_weights: Optional[Tuple[float, float]] = None,
                 mesh: Optional[mesh_mod.Mesh] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """FLYP's loss (JAX ``flyp_loss_fn``): InfoNCE, or with ``use_siglip``
    the SigLIP loss with ``model.logit_bias`` (-10 where the model has
    none), between the image features and the template feature of each
    sample's label, ``gt_labels`` with ``use_gt`` else ``zs_preds``. The C
    templates run once, padded, and their rows are gathered by label; a
    label of -1 gathers the last row, as JAX's indexing does. With a
    ``teacher`` (a frozen CLIP run without autograd on the same images and
    templates, its own logit scale) :func:`distill_clip_loss` joins the
    loss as ``distill_loss``. ``coca_weights`` ``(caption_w, clip_w)``, on a
    CoCa model: CoCaLoss on the full forward (the decoder cross-attends each
    sample's own image tokens) over each sample's template row, as JAX's
    CoCa branch. On a ``mesh`` every loss takes the data group's gathered
    features (the teacher's too) and the caption loss the global batch's
    tokens."""
    dev = images.device
    labels = _to_device(batch, ("gt_labels" if use_gt else "zs_preds",), dev)[0].long()
    if coca_weights is not None:
        caption_w, clip_w = coca_weights
        out = coca_mod.coca_forward(model, images, template_table[labels], attention=attention)
        losses = coca_mod.coca_loss(out, caption_loss_weight=caption_w, clip_loss_weight=clip_w,
                                    pad_id=model.cfg.pad_id, mesh=mesh)
        loss = losses["contrastive_loss"] + losses["caption_loss"]
        return loss, {"loss": loss.detach(), "contrastive_loss": losses["contrastive_loss"].detach(),
                      "caption_loss": losses["caption_loss"].detach(),
                      "logit_scale": out["logit_scale"].detach()}
    routes = {"attention": attention, "ln_linear": ln_linear}
    image_features = clip_mod.encode_image(model, images, normalize=True, remat=hp.vision_remat,
                                           **routes)
    class_text_feats = clip_mod.encode_text(model, template_table, normalize=True,
                                            remat=hp.text_remat, **routes)
    image_features = mesh_mod.gather(image_features, mesh)
    text_features = mesh_mod.gather(class_text_feats[labels], mesh)
    logit_scale = model.logit_scale.exp()
    if use_siglip:
        bias = getattr(model, "logit_bias", None)
        if bias is None:
            bias = torch.tensor(DEFAULT_LOGIT_BIAS, device=dev)
        loss = siglip_full_loss(image_features, text_features, logit_scale, bias)
    else:
        loss = clip_loss(image_features, text_features, logit_scale)
    metrics = {"contrastive_loss": loss.detach(), "logit_scale": logit_scale.detach()}
    if teacher is not None:
        with torch.no_grad():
            t_img = clip_mod.encode_image(teacher, images, normalize=True, **routes)
            t_txt = clip_mod.encode_text(teacher, template_table, normalize=True, **routes)[labels]
            t_img, t_txt = mesh_mod.gather(t_img, mesh), mesh_mod.gather(t_txt, mesh)
            t_scale = teacher.logit_scale.exp()
        d_loss = distill_clip_loss(image_features, text_features, logit_scale, t_img, t_txt,
                                   t_scale)
        loss = loss + d_loss
        metrics["distill_loss"] = d_loss.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics


def make_flyp_step(model: clip_mod.CLIP, hp: LatteHParams, template_table, use_gt: bool = False,
                   aug: Optional[T.AugConfig] = None, use_siglip: bool = False,
                   teacher: Optional[clip_mod.CLIP] = None, *, attention: str = "kernel",
                   ln_linear: str = "unfused", coca_weights: Optional[Tuple[float, float]] = None):
    """Build the FLYP step ``(state, batch, generator) -> metrics`` (JAX
    ``make_flyp_step``): augment, :func:`flyp_loss_fn`, backward, the update
    of :func:`apply_gradients` and the logit-scale clamp; the memory bank
    is carried unchanged. ``teacher`` is put in eval mode and frozen."""
    refuse_training(model)
    aug = aug or T.AugConfig()
    cfg = model.cfg
    dev = next(model.parameters()).device
    table = torch.as_tensor(template_table).to(dev)
    if teacher is not None:
        teacher.eval().requires_grad_(False)

    def step_fn(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None):
        images = _step_images(cfg, hp, aug, batch, generator, dev)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = flyp_loss_fn(state.model, hp, batch, images, table, use_gt, use_siglip,
                                     teacher, attention=attention, ln_linear=ln_linear,
                                     coca_weights=coca_weights, mesh=state.mesh)
        loss.backward()
        apply_gradients(state)
        with torch.no_grad():
            state.model.logit_scale.clamp_(0.0, LOG100)
        state.step += 1
        return metrics

    return step_fn
