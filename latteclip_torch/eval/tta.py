"""Test-time adaptation: TPT (entropy minimisation) and RLCF (CLIP rewards).

Port of ``latteclip_tpu/eval/tta.py``, the reference's TTA evaluation
(``src/training/train.py:1141-1305``, ``src/open_clip/model.py:971-1213``):

* a learnable prompt context of ``n_ctx`` vectors, initialised from the
  embedding of a phrase such as "a photo of a", is spliced between SOT and
  the class tokens (PromptLearner, 'end' class position);
* per test image, 1 + ``n_views`` AugMix views are encoded once by the
  frozen image tower;
* the most confident ``selection_p`` share of the views (lowest prediction
  entropy, on the initial prompts) is kept;
* **TPT** minimises the entropy of their mean prediction (``avg_entropy``)
  over the context for ``tta_steps`` AdamW steps, then classifies the base
  view;
* **RLCF** takes CLIPScore rewards from a frozen reward model, between its
  image features of the kept views and its class text features of each
  view's top-k classes, centred per view; the context maximises the
  reward-weighted log-likelihood.

Gradients reach the context only: every model parameter is frozen while an
image adapts (``requires_grad_(False)``), the view features are computed
without autograd, and the text tower's backward (the attention kernels'
backward on the card) carries the gradient to ``ctx``. Each image starts
from the initial context with a fresh AdamW, as the JAX package re-enters
its jitted function with ``init_ctx``; its update is optax's ``adamw``:
decay decoupled and applied to the old value, eps 1e-8, bias-corrected.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from latteclip_torch.data import transforms as T
from latteclip_torch.data.augmix import augmix_views
from latteclip_torch.models import clip as clip_mod
from latteclip_torch.models.layers import l2_normalize
from latteclip_torch.models.text import text_forward_embeds
from latteclip_torch.models.tokenizer import ClipTokenizer


@dataclasses.dataclass
class PromptContext:
    """Tokenised class prompts with an insertable learnable context."""

    tokens: torch.Tensor      # [C, ctx] ids of "X" * n_ctx + class name prompts
    init_ctx: torch.Tensor    # [n_ctx, D] float32 initial context vectors
    n_ctx: int

    @property
    def eot_pos(self) -> torch.Tensor:
        return self.tokens.argmax(dim=-1)


def build_prompt_context(model: clip_mod.CLIP, tokenizer: ClipTokenizer,
                         classnames: Sequence[str], ctx_init: str = "a photo of a",
                         n_ctx: int = 4) -> PromptContext:
    """PromptLearner's init (model.py:1014-1047): the context vectors are
    the token embeddings of ``ctx_init`` (which sets ``n_ctx``); the class
    prompts hold 'X' placeholders where the context goes."""
    if not hasattr(model, "token_embedding"):
        # JAX's prompt path reads params["text"] as the native tower: an HF
        # tower's tree fails there, CoCa's runs without its class token
        raise NotImplementedError(
            f"{model.cfg.name}: test-time prompt tuning needs the native CLIP text tower "
            "(the JAX package's prompt path fails on an HF tower and drops CoCa's class "
            "token; ROADMAP.md, section 3)")
    init_words = ctx_init.replace("_", " ").split()
    n_ctx = len(init_words) if ctx_init else n_ctx
    prefix = " ".join(["X"] * n_ctx)
    table = model.token_embedding.weight.detach()
    tokens = torch.from_numpy(tokenizer([f"{prefix} {c}." for c in classnames])).to(table.device)
    if ctx_init:
        init_ids = tokenizer.encode(" ".join(init_words))
        assert len(init_ids) == n_ctx, (init_ids, n_ctx)
        init_ctx = table[torch.as_tensor(init_ids, device=table.device)]
    else:
        init_ctx = torch.from_numpy(0.02 * np.random.RandomState(0).randn(n_ctx, table.shape[1]))
    return PromptContext(tokens=tokens, init_ctx=init_ctx.to(table.device, torch.float32).clone(),
                         n_ctx=n_ctx)


def prompt_text_features(model: clip_mod.CLIP, prompt: PromptContext, ctx: torch.Tensor, *,
                         attention: str = "kernel", ln_linear: str = "unfused") -> torch.Tensor:
    """Splice ``ctx`` into the class prompts and encode -> [C, E] normalised.
    ``ctx`` takes the embedding table's dtype, then the compute dtype."""
    embeds = F.embedding(prompt.tokens, model.token_embedding.weight)      # [C, L, D]
    C = embeds.shape[0]
    ctx_b = ctx[None].expand(C, prompt.n_ctx, ctx.shape[-1]).to(embeds.dtype)
    spliced = torch.cat([embeds[:, :1], ctx_b, embeds[:, 1 + prompt.n_ctx:]], dim=1)
    feats = text_forward_embeds(model, spliced, prompt.eot_pos, dtype=model.compute_dtype,
                                quick_gelu=model.cfg.quick_gelu, attention=attention,
                                ln_linear=ln_linear)
    return l2_normalize(feats)


def avg_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of the mean prediction (reference train.py:1175-1180)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    avg_logp = torch.logsumexp(logp, dim=0) - np.log(logits.shape[0])
    return -(avg_logp * avg_logp.exp()).sum()


def select_confident(logits: torch.Tensor, selection_p: float) -> torch.Tensor:
    """Indices of the lowest-entropy ``selection_p`` share of the rows
    (train.py:285-288), at least one."""
    probs = torch.softmax(logits.float(), dim=-1)
    entropy = -(probs * torch.log(probs + 1e-12)).sum(dim=-1)
    k = max(1, int(logits.shape[0] * selection_p))
    return torch.topk(-entropy, k).indices


@dataclasses.dataclass
class TTAConfig:
    n_views: int = 63
    selection_p: float = 0.1
    tta_steps: int = 1
    lr: float = 5e-3
    weight_decay: float = 5e-4
    ctx_init: str = "a photo of a"
    sample_k: int = 5              # RLCF top-k class sampling
    clipscore_weight: float = 2.5  # RLCF CLIPScore scale (model.py:85)


LogitsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def prompt_logits_fn(model: clip_mod.CLIP, prompt: PromptContext, *, attention: str = "kernel",
                     ln_linear: str = "unfused") -> LogitsFn:
    """``logits_of(ctx, feats) = exp(logit_scale) * feats @ text(ctx).T``."""
    def logits_of(ctx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        text = prompt_text_features(model, prompt, ctx, attention=attention, ln_linear=ln_linear)
        return model.logit_scale.exp() * feats @ text.T
    return logits_of


def _adapt(logits_of: LogitsFn, prompt: PromptContext, tta: TTAConfig, view_feats: torch.Tensor,
           loss_of: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The shared loop: select the confident views on the initial context,
    take ``tta.tta_steps`` AdamW steps of ``loss_of(out, selected)`` on a
    fresh copy of it, return the base view's logits [C]."""
    with torch.no_grad():
        selected = select_confident(logits_of(prompt.init_ctx, view_feats), tta.selection_p)
    ctx = prompt.init_ctx.clone().requires_grad_(True)
    opt = torch.optim.AdamW([ctx], lr=tta.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tta.weight_decay)
    with torch.enable_grad():
        for _ in range(tta.tta_steps):
            opt.zero_grad(set_to_none=True)
            loss_of(logits_of(ctx, view_feats[selected]), selected).backward()
            opt.step()
    with torch.no_grad():
        return logits_of(ctx, view_feats[:1])[0]


def tpt_adapt(logits_of: LogitsFn, prompt: PromptContext, tta: TTAConfig,
              view_feats: torch.Tensor) -> torch.Tensor:
    """TPT on one image's view features [V, E] -> base-view logits [C]."""
    return _adapt(logits_of, prompt, tta, view_feats, lambda out, _sel: avg_entropy(out))


def rlcf_adapt(logits_of: LogitsFn, prompt: PromptContext, tta: TTAConfig,
               view_feats: torch.Tensor, reward_view_feats: torch.Tensor,
               reward_class_features: torch.Tensor) -> torch.Tensor:
    """RLCF on one image (train.py:1141-1172): reward-weighted cross-entropy
    over each kept view's top-k classes -> base-view logits [C]."""
    def loss_of(out: torch.Tensor, selected: torch.Tensor) -> torch.Tensor:
        idx = torch.topk(out, tta.sample_k).indices                          # [S, K]
        txt = reward_class_features[idx]                                     # [S, K, E]
        score = tta.clipscore_weight * torch.einsum("se,ske->sk", reward_view_feats[selected],
                                                    txt)
        score = score.clamp_min(0.0)
        rewards = score - score.mean(dim=-1, keepdim=True)                   # centred per view
        ce = -torch.log_softmax(out.float(), dim=-1).gather(-1, idx)          # [S, K]
        return (rewards.detach().reshape(-1) * ce.reshape(-1)).mean()
    return _adapt(logits_of, prompt, tta, view_feats, loss_of)


@contextlib.contextmanager
def frozen(*models: torch.nn.Module):
    """Every parameter of ``models`` with ``requires_grad`` off, restored after."""
    params = [p for m in models if m is not None for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


@torch.no_grad()
def encode_views(model: clip_mod.CLIP, views_u8: np.ndarray, *, attention: str = "kernel",
                 ln_linear: str = "unfused") -> torch.Tensor:
    """uint8 views [V, S, S, 3] -> normalised image features [V, E]."""
    dev = next(model.parameters()).device
    images = T.normalize_images(torch.from_numpy(views_u8).to(dev), *T.model_mean_std(model.cfg))
    return clip_mod.encode_image(model, images, normalize=True, attention=attention,
                                 ln_linear=ln_linear)


def evaluate_tta(model: clip_mod.CLIP, tokenizer: ClipTokenizer, dataset,
                 tta: TTAConfig = TTAConfig(), *, method: str = "tpt",
                 reward_model: Optional[clip_mod.CLIP] = None,
                 max_samples: Optional[int] = None, seed: int = 0, attention: str = "kernel",
                 ln_linear: str = "unfused") -> Dict[str, float]:
    """Per-image TTA evaluation (reference evaluate_tta, train.py:1216-1305)
    over a dataset with ``image_ids``, ``load_image``, ``label_of``,
    ``image_size``, ``templates`` and ``display_class_names``; the views
    draw from ``np.random.default_rng(seed)``."""
    routes = {"attention": attention, "ln_linear": ln_linear}
    classnames = dataset.display_class_names
    with frozen(model, reward_model):
        prompt = build_prompt_context(model, tokenizer, classnames, tta.ctx_init)
        logits_of = prompt_logits_fn(model, prompt, **routes)
        if method == "rlcf":
            if reward_model is None:
                raise ValueError("method='rlcf' needs a reward_model")
            dev = next(reward_model.parameters()).device
            labels = torch.from_numpy(tokenizer([dataset.templates[0](c) for c in classnames]))
            with torch.no_grad():
                reward_class_features = clip_mod.encode_text(reward_model, labels.to(dev),
                                                             normalize=True, **routes)
        rng = np.random.default_rng(seed)
        top1 = top5 = n = 0.0
        total = min(len(dataset), max_samples or len(dataset))
        for index in range(total):
            label = dataset.label_of(dataset.image_ids[index])
            views = augmix_views(dataset.load_image(index), dataset.image_size, tta.n_views, rng)
            feats = encode_views(model, views, **routes)
            if method == "rlcf":
                logits = rlcf_adapt(logits_of, prompt, tta, feats,
                                    encode_views(reward_model, views, **routes),
                                    reward_class_features)
            else:
                logits = tpt_adapt(logits_of, prompt, tta, feats)
            order = np.argsort(-logits.float().cpu().numpy())
            top1 += float(order[0] == label)
            top5 += float(label in order[:5])
            n += 1
    return {"tta_top1": top1 / n, "tta_top5": top5 / n, "n": n}
