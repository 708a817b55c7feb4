"""CoCa, the contrastive captioner (port of ``latteclip_tpu/models/coca.py``).

:class:`CoCa` holds three parts under the reference's names, so its state
dict is the layout JAX's ``coca_params_to_state_dict`` writes:

* ``visual``: the native ViT with CoCa's attentional pool
  (:class:`~latteclip_torch.models.vit.AttentionalPooler`), whose pooled
  feature is the contrastive latent and whose other queries are the image
  tokens the decoder reads. On the card its blocks run the Hopper kernels as
  every native ViT does (pair-packed K2/K4 at B/32's 50 tokens);
* ``text``: the text tower with a class token appended after the text
  (``cls_emb``, one more position), a mask that is causal and, on the class
  token's row alone, hides the pads with the reference's left shift
  (``build_cls_mask``), pooled at the class token with ``ln_final`` after
  the pool; or, for ``coca_roberta``, an HF trunk with ``output_tokens``
  (:class:`~latteclip_torch.models.hf_text.HFTextTower`);
* ``text_decoder``: per layer a causal self-attention block over the text
  tokens and a cross-attention block onto the image tokens (``ln_1_kv``),
  then ``ln_final`` and the projection to the vocabulary.

Their attention is plain torch (:func:`~latteclip_torch.models.layers.
plain_attention`), as JAX runs it on XLA: no TPU kernel is behind it.

:func:`coca_loss` is CoCaLoss (weighted contrastive plus caption cross
entropy over the non-pad positions); :func:`generate` samples greedily or
top-k in a fixed-shape loop, and :func:`generate_beamsearch` is the
reference's grouped beam search with HF ``BeamSearchScorer``'s rules, run on
the host over the decoder's logits, as JAX runs it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latteclip_torch.models import layers
from latteclip_torch.models.hf_text import HFTextConfig, HFTextTower
from latteclip_torch.models.layers import NEG_INF, dense, l2_normalize, plain_attention
from latteclip_torch.models.vit import VisionTransformer, vit_forward


class CoCaTextTower(nn.Module):
    """The class-token text tower: ``token_embedding``, ``cls_emb``,
    ``positional_embedding`` (context + 1 rows), ``transformer``,
    ``ln_final``, ``text_projection``."""

    def __init__(self, t, embed_dim: int):
        super().__init__()
        D = t.width
        self.token_embedding = nn.Embedding(t.vocab_size, D)
        self.cls_emb = nn.Parameter(torch.empty(D))
        self.positional_embedding = nn.Parameter(torch.empty(t.context_length + 1, D))
        self.transformer = layers.Transformer(D, t.layers, t.heads, t.mlp_ratio)
        self.ln_final = layers.LayerNorm(D)
        self.text_projection = nn.Parameter(torch.empty(D, embed_dim))


class CrossAttentionBlock(layers.ResidualAttentionBlock):
    """A residual block whose attention reads the image tokens, LayerNormed
    by ``ln_1_kv``."""

    def __init__(self, width: int, heads: int, mlp_ratio: float):
        super().__init__(width, heads, mlp_ratio)
        self.ln_1_kv = layers.LayerNorm(width)


class MultimodalDecoder(nn.Module):
    """``resblocks`` (causal self-attention), ``cross_attn``, ``ln_final``
    and ``text_projection`` [width, vocab]."""

    def __init__(self, m):
        super().__init__()
        self.resblocks = nn.ModuleList(
            layers.ResidualAttentionBlock(m.width, m.heads, m.mlp_ratio) for _ in range(m.layers))
        self.cross_attn = nn.ModuleList(
            CrossAttentionBlock(m.width, m.heads, m.mlp_ratio) for _ in range(m.layers))
        self.ln_final = layers.LayerNorm(m.width)
        self.text_projection = nn.Parameter(torch.empty(m.width, m.vocab_size))


class CoCa(nn.Module):
    """``visual``, ``text``, ``text_decoder`` and ``logit_scale``. Like
    :class:`~latteclip_torch.models.clip.CLIP` it carries ``cfg`` and the
    ``compute_dtype``, ``map_head`` and ``text_projection_b`` the encoders
    read (CoCa has neither of the last two)."""

    map_head = None
    text_projection_b = None

    def __init__(self, cfg, *, hf_pooler: Optional[bool] = None):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg.vision, cfg.embed_dim)
        if isinstance(cfg.text, HFTextConfig):
            self.text = HFTextTower(cfg.text, cfg.embed_dim, pooler=hf_pooler)
        else:
            self.text = CoCaTextTower(cfg.text, cfg.embed_dim)
        self.text_decoder = MultimodalDecoder(cfg.multimodal)
        self.logit_scale = nn.Parameter(torch.tensor(float(cfg.init_logit_scale)))

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)


# -- masked attention (per-sample additive masks, plain torch) -----------------

def masked_mha(x: torch.Tensor, kv: torch.Tensor, attn, num_heads: int,
               mask: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """Multi-head attention of ``x [B, Lq, D]`` onto ``kv`` with an additive
    mask [B or 1, Lq, Lk] (or none), on ``nn.MultiheadAttention``'s packed
    in-projection: its q rows apply to ``x``, its k and v rows to ``kv``."""
    B, Lq, D = x.shape
    w, b = attn.in_proj_weight, attn.in_proj_bias
    hd = D // num_heads
    q = dense(x, w[:D], b[:D], dtype).reshape(B, Lq, num_heads, hd)
    k = dense(kv, w[D:2 * D], b[D:2 * D], dtype).reshape(B, -1, num_heads, hd)
    v = dense(kv, w[2 * D:], b[2 * D:], dtype).reshape(B, -1, num_heads, hd)
    out = plain_attention(q, k, v, dtype=dtype, bias=None if mask is None else mask[:, None])
    return dense(out.reshape(B, Lq, D), attn.out_proj.weight, attn.out_proj.bias, dtype)


def _mlp(x: torch.Tensor, blk, act, dtype: torch.dtype) -> torch.Tensor:
    return layers.mlp(x, blk.ln_2, blk.mlp.c_fc, blk.mlp.c_proj, act, dtype, tp=blk.mlp.tp)


def masked_block(x: torch.Tensor, blk, num_heads: int, mask, act, dtype) -> torch.Tensor:
    """Pre-LN residual block with a per-sample additive mask."""
    xn = blk.ln_1(x)
    x = x + masked_mha(xn, xn, blk.attn, num_heads, mask, dtype)
    return x + _mlp(x, blk, act, dtype)


def cross_block(x: torch.Tensor, kv: torch.Tensor, blk: CrossAttentionBlock, num_heads: int,
                act, dtype) -> torch.Tensor:
    """Cross-attention block: ``ln_1`` on the queries, ``ln_1_kv`` on the
    image tokens, no mask."""
    x = x + masked_mha(blk.ln_1(x), blk.ln_1_kv(kv), blk.attn, num_heads, None, dtype)
    return x + _mlp(x, blk, act, dtype)


def causal_mask(seq: int, device) -> torch.Tensor:
    i = torch.arange(seq, device=device)
    return torch.where(i[None, :] > i[:, None], NEG_INF, 0.0).float()


# -- forward -------------------------------------------------------------------

def coca_text_forward(text: CoCaTextTower, cfg, tokens: torch.Tensor, *, pad_id: int = 0,
                      dtype: torch.dtype = torch.bfloat16,
                      quick_gelu: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tokens [B, ctx] -> (pooled latent [B, E] float32, token embeddings
    [B, ctx, D]). The class token comes after the text; the mask is causal,
    and the class token's row also hides the pads with the reference's left
    shift: key 0 is always seen, key k is gated by ``tokens[:, k - 1]``."""
    act = layers.quick_gelu if quick_gelu else layers.gelu
    B, ctx = tokens.shape
    seq = ctx + 1
    x = F.embedding(tokens, text.token_embedding.weight).to(dtype)
    cls = text.cls_emb.to(dtype).expand(B, 1, x.shape[-1])
    x = torch.cat([x, cls], dim=1) + text.positional_embedding[:seq].to(dtype)
    keys = torch.cat([torch.ones_like(tokens[:, :1], dtype=torch.bool), tokens != pad_id], dim=1)
    cls_row = torch.where(keys, 0.0, NEG_INF).float()                       # [B, seq]
    is_cls = (torch.arange(seq, device=tokens.device) == seq - 1).float()[:, None]
    mask = causal_mask(seq, tokens.device)[None] + is_cls[None] * cls_row[:, None, :]
    for blk in text.transformer.resblocks:
        x = masked_block(x, blk, cfg.heads, mask, act, dtype)
    pooled, token_embs = x[:, -1], x[:, :-1]
    pooled = text.ln_final(pooled)
    return dense(pooled, text.text_projection.t(), None, dtype).float(), token_embs


def coca_decode(decoder: MultimodalDecoder, cfg, token_embs: torch.Tensor,
                image_embs: torch.Tensor, *, dtype: torch.dtype = torch.bfloat16,
                quick_gelu: bool = False) -> torch.Tensor:
    """The multimodal decoder: (text token embeddings, image token
    embeddings) -> vocabulary logits [B, ctx, V] (float32)."""
    act = layers.quick_gelu if quick_gelu else layers.gelu
    mask = causal_mask(token_embs.shape[1], token_embs.device)[None]
    x, kv = token_embs.to(dtype), image_embs.to(dtype)
    for self_blk, cross_blk in zip(decoder.resblocks, decoder.cross_attn):
        x = masked_block(x, self_blk, cfg.heads, mask, act, dtype)
        x = cross_block(x, kv, cross_blk, cfg.heads, act, dtype)
    x = decoder.ln_final(x)
    return dense(x, decoder.text_projection.t(), None, dtype).float()


def encode_text_tokens(model: CoCa, tokens: torch.Tensor, *,
                       dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The text tower: the class-token tower, or an HF trunk with
    ``output_tokens`` (``coca_roberta``); (latent, token embeddings) either
    way."""
    cfg = model.cfg
    if isinstance(cfg.text, HFTextConfig):
        return model.text.forward_tokens(tokens, dtype=dtype)
    return coca_text_forward(model.text, cfg.text, tokens, pad_id=cfg.pad_id, dtype=dtype,
                             quick_gelu=cfg.quick_gelu)


def generation_pad_id(cfg) -> int:
    """The fill of positions not generated yet in the fixed-shape decode: any
    value for the causal class-token tower, but an HF trunk is
    bidirectional, so its own pad id, which its mask hides."""
    return cfg.text.pad_id if isinstance(cfg.text, HFTextConfig) else cfg.pad_id


def encode_image_tokens(model: CoCa, images: torch.Tensor, *, attention: str = "kernel",
                        remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images -> (image latent [B, E] float32, image tokens)."""
    cfg = model.cfg
    return vit_forward(model.visual, images, dtype=model.compute_dtype,
                       quick_gelu=cfg.quick_gelu, attention=attention, remat=remat,
                       output_tokens=True)


def coca_forward(model: CoCa, images: torch.Tensor, tokens: torch.Tensor, *,
                 attention: str = "kernel", remat: bool = False) -> Dict[str, torch.Tensor]:
    """The full forward: normalized image and text features, the caption
    logits, their labels and ``exp(logit_scale)`` (JAX ``coca_forward``,
    whose labels are the last ``ctx`` columns of the tokens)."""
    dtype = model.compute_dtype
    image_latent, image_embs = encode_image_tokens(model, images, attention=attention,
                                                   remat=remat)
    text_latent, token_embs = encode_text_tokens(model, tokens, dtype=dtype)
    logits = coca_decode(model.text_decoder, model.cfg.multimodal, token_embs, image_embs,
                         dtype=dtype, quick_gelu=model.cfg.quick_gelu)
    return {"image_features": l2_normalize(image_latent),
            "text_features": l2_normalize(text_latent),
            "logits": logits, "labels": tokens[:, -logits.shape[1]:],
            "logit_scale": model.logit_scale.exp()}


def coca_loss(out: Dict[str, torch.Tensor], *, caption_loss_weight: float = 2.0,
              clip_loss_weight: float = 1.0, pad_id: int = 0,
              mesh=None) -> Dict[str, torch.Tensor]:
    """CoCaLoss: ``clip_loss_weight`` times InfoNCE and ``caption_loss_weight``
    times the caption cross entropy over the positions whose label is not
    ``pad_id``; on a ``mesh`` (:mod:`latteclip_torch.mesh`) both over the
    data group's global batch."""
    from latteclip_torch import mesh as mesh_mod
    from latteclip_torch.train.objective import clip_loss

    contrastive = torch.zeros((), device=out["logits"].device)
    if clip_loss_weight:
        contrastive = clip_loss_weight * clip_loss(mesh_mod.gather(out["image_features"], mesh),
                                                   mesh_mod.gather(out["text_features"], mesh),
                                                   out["logit_scale"])
    logp = torch.log_softmax(out["logits"].float(), dim=-1)
    labels = out["labels"].long()
    picked = logp.gather(-1, labels[..., None])[..., 0]
    valid = (labels != pad_id).float()
    nll, count = -(picked * valid).sum(), valid.sum()
    if mesh is not None:
        nll = mesh_mod.data_sum(nll, mesh)
        count = mesh.all_reduce_(count.clone(), mesh.data_group)
    caption = nll / count.clamp_min(1.0)
    return {"contrastive_loss": contrastive, "caption_loss": caption_loss_weight * caption}


# -- generation ----------------------------------------------------------------

def _step_logits(model: CoCa, image_embs: torch.Tensor):
    dtype, cfg = model.compute_dtype, model.cfg

    @torch.no_grad()
    def step(tokens: torch.Tensor) -> torch.Tensor:
        _latent, token_embs = encode_text_tokens(model, tokens, dtype=dtype)
        return coca_decode(model.text_decoder, cfg.multimodal, token_embs, image_embs,
                           dtype=dtype, quick_gelu=cfg.quick_gelu)

    return step


@torch.no_grad()
def generate(model: CoCa, images: torch.Tensor, *, seq_len: int = 30, top_k: int = 1,
             temperature: float = 1.0, sot_token_id: int = 49406, eot_token_id: int = 49407,
             generator: Optional[torch.Generator] = None, attention: str = "kernel") -> np.ndarray:
    """Greedy (``top_k`` 1) or top-k caption sampling, one fixed-shape
    [B, ctx] decode a position (JAX ``generate``): positions not generated
    yet hold :func:`generation_pad_id`, which causality (or the HF trunk's
    pad mask) hides; a row that has emitted EOT is filled with ``pad_id``;
    the loop stops when every row has. Top-k draws from ``generator``.
    Returns the tokens [B, ctx] (int32, numpy)."""
    cfg = model.cfg
    B, ctx = images.shape[0], cfg.text.context_length
    _latent, image_embs = encode_image_tokens(model, images, attention=attention)
    step = _step_logits(model, image_embs)
    tokens = np.full((B, ctx), generation_pad_id(cfg), dtype=np.int32)
    tokens[:, 0] = sot_token_id
    done = np.zeros(B, dtype=bool)
    dev = images.device
    for pos in range(1, min(seq_len, ctx)):
        logits = step(torch.from_numpy(tokens).to(dev).long())[:, pos - 1]
        if top_k <= 1:
            nxt = logits.argmax(dim=-1).cpu().numpy()
        else:
            vals, idx = (logits / temperature).topk(top_k, dim=-1)
            choice = torch.multinomial(torch.softmax(vals, dim=-1).cpu(), 1, generator=generator)
            nxt = idx.cpu().gather(1, choice)[:, 0].numpy()
        nxt = np.where(done, cfg.pad_id, nxt)
        tokens[:, pos] = nxt
        done |= nxt == eot_token_id
        if done.all():
            break
    return tokens


@torch.no_grad()
def generate_beamsearch(model: CoCa, images: torch.Tensor, *, num_beams: int = 6,
                        num_beam_groups: int = 3, min_seq_len: int = 5, seq_len: int = 30,
                        sot_token_id: int = 49406, eot_token_id: int = 49407,
                        attention: str = "kernel") -> np.ndarray:
    """Grouped beam search (JAX ``generate_beamsearch``, the reference's
    ``_generate_beamsearch`` with HF ``BeamSearchScorer``'s rules): the beams
    split into groups, each group's first beam starts at score 0 and the
    rest at -1e9; each step a group takes its top ``2 * group_size``
    candidates, banks the EOS ones ranked within ``group_size`` (replacing
    the worst hypothesis when full) and continues the rest; EOS is masked
    below ``min_seq_len``; a hypothesis scores ``sum_logprob / len``. The
    beams ride the batch axis of the same fixed-shape decode as
    :func:`generate`; the search runs on the host in float64."""
    cfg = model.cfg
    B, ctx = images.shape[0], cfg.text.context_length
    sub = num_beams // num_beam_groups
    if sub * num_beam_groups != num_beams:
        raise ValueError("num_beam_groups must divide num_beams")
    _latent, image_embs = encode_image_tokens(model, images, attention=attention)
    step = _step_logits(model, image_embs.repeat_interleave(num_beams, dim=0))
    dev = images.device
    BB = B * num_beams
    tokens = np.full((BB, ctx), generation_pad_id(cfg), dtype=np.int32)
    tokens[:, 0] = sot_token_id
    beam_scores = np.full((B, num_beams), -1e9, dtype=np.float64)
    beam_scores[:, ::sub] = 0.0
    beam_scores = beam_scores.reshape(BB)
    hyps = [[[] for _ in range(num_beam_groups)] for _ in range(B)]  # (avg score, row)
    max_pos = min(seq_len, ctx)
    for pos in range(1, max_pos):
        logits = step(torch.from_numpy(tokens).to(dev).long())[:, pos - 1]
        logits = logits.cpu().numpy().astype(np.float64)
        m = logits.max(-1, keepdims=True)
        logp = logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))
        if pos < min_seq_len:
            logp[:, eot_token_id] = -np.inf
        V = logp.shape[-1]
        new_tokens = tokens.copy()
        for b in range(B):
            for gidx in range(num_beam_groups):
                rows = [b * num_beams + gidx * sub + s for s in range(sub)]
                flat = (logp[rows] + beam_scores[rows][:, None]).reshape(-1)
                top = np.argsort(flat)[::-1][: 2 * sub]
                kept = 0
                for rank, cand in enumerate(top):
                    beam_i, tok = divmod(int(cand), V)
                    src = rows[beam_i]
                    if tok == eot_token_id:
                        if rank >= sub:
                            continue
                        seq = tokens[src].copy()
                        seq[pos] = eot_token_id
                        entry = (flat[cand] / pos, seq)
                        bank = hyps[b][gidx]
                        if len(bank) < sub:
                            bank.append(entry)
                        else:
                            worst = min(range(len(bank)), key=lambda i: bank[i][0])
                            if entry[0] > bank[worst][0]:
                                bank[worst] = entry
                        continue
                    if kept < sub:
                        dst = rows[kept]
                        new_tokens[dst] = tokens[src]
                        new_tokens[dst, pos] = tok
                        beam_scores[dst] = flat[cand]
                        kept += 1
        tokens = new_tokens
        if all(len(g) >= sub for bh in hyps for g in bh):
            break
    out = np.full((B, ctx), cfg.pad_id, dtype=np.int32)
    for b in range(B):
        pool = [h for g in hyps[b] for h in g]
        for gidx in range(num_beam_groups):
            if len(hyps[b][gidx]) < sub:
                # HF's finalize: a group whose bank never filled adds its
                # running beams at the final length
                for s in range(sub):
                    row = b * num_beams + gidx * sub + s
                    pool.append((beam_scores[row] / max_pos, tokens[row]))
        out[b] = max(pool, key=lambda t: t[0])[1]
    return out
