"""HuggingFace-architecture text towers (port of
``latteclip_tpu/models/hf_text.py``), as ``nn.Module``s under HF's own
parameter names, so that the state dict is the reference's
``text.transformer.*`` layout.

* BERT family (bert, roberta, xlm-roberta): token, position and token-type
  embeddings and their LayerNorm, then post-LN blocks with a key-padding
  mask; RoBERTa's positions start at ``pad_id + 1`` and pads keep
  ``pad_id``.
* mt5: the T5 encoder stack. RMSNorm (no bias, no mean), gated tanh-GELU
  feed-forward, unscaled attention logits (the 1/sqrt(d) lives in T5's
  init), ``d_kv``-wide heads, and a bucketed relative-position bias held by
  block 0 and shared by every layer, with the pad mask folded in.
* m2m_100 (NLLB): pre-LN blocks over sqrt(width)-scaled embeddings plus
  fairseq's sinusoidal table (recomputed, not a parameter), a final
  LayerNorm.

Then the reference's poolers (``mean_pooler``, ``max_pooler``,
``cls_pooler`` with BERT's tanh head where the tower has one,
``cls_last_hidden_state_pooler``) and projection (``linear`` or the
``mlp`` default, width -> (width + embed) / 2 -> embed with exact GELU).
The attention is :func:`~latteclip_torch.models.layers.plain_attention`,
JAX's ``xla_attention``: plain torch ops on every device, as JAX runs these
towers on XLA, not on a Pallas kernel.

``import_hf_state_dict`` and ``export_hf_state_dict`` are numpy copies of
JAX's: HF names <-> the JAX parameter tree (stacked blocks, ``[in, out]``
weights); the checkpoint and optimizer converters use them.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from latteclip_torch.models import layers
from latteclip_torch.models.layers import NEG_INF, dense, plain_attention

# the published config.json dimensions of the hub names the model JSONs use
KNOWN_HF_CONFIGS = {
    "roberta-base": dict(model_type="roberta", vocab_size=50265, width=768,
                         layers=12, heads=12, intermediate=3072,
                         max_positions=514, pad_id=1, ln_eps=1e-5),
    "xlm-roberta-base": dict(model_type="xlm-roberta", vocab_size=250002,
                             width=768, layers=12, heads=12, intermediate=3072,
                             max_positions=514, pad_id=1, ln_eps=1e-5),
    "xlm-roberta-large": dict(model_type="xlm-roberta", vocab_size=250002,
                              width=1024, layers=24, heads=16, intermediate=4096,
                              max_positions=514, pad_id=1, ln_eps=1e-5),
    "bert-base-uncased": dict(model_type="bert", vocab_size=30522, width=768,
                              layers=12, heads=12, intermediate=3072,
                              max_positions=512, pad_id=0, ln_eps=1e-12),
    # T5 encoders have no absolute position table; max_positions is unused
    "google/mt5-base": dict(model_type="mt5", vocab_size=250112, width=768,
                            layers=12, heads=12, intermediate=2048, d_kv=64,
                            max_positions=512, pad_id=0, ln_eps=1e-6),
    "google/mt5-xl": dict(model_type="mt5", vocab_size=250112, width=2048,
                          layers=24, heads=32, intermediate=5120, d_kv=64,
                          max_positions=512, pad_id=0, ln_eps=1e-6),
    "facebook/nllb-200-distilled-600M": dict(
        model_type="m2m_100", vocab_size=256206, width=1024, layers=12,
        heads=16, intermediate=4096, max_positions=1024, pad_id=1,
        ln_eps=1e-5, scale_embedding=True),
    "facebook/nllb-200-distilled-1.3B": dict(
        model_type="m2m_100", vocab_size=256206, width=1024, layers=24,
        heads=16, intermediate=8192, max_positions=1024, pad_id=1,
        ln_eps=1e-5, scale_embedding=True),
}
BERT_FAMILY = ("bert", "roberta", "xlm-roberta")


@dataclasses.dataclass(frozen=True)
class HFTextConfig:
    """An HF-architecture text tower (``hf_model_name`` in ``text_cfg``)."""

    model_name: str = ""
    tokenizer_name: str = ""        # hf_tokenizer_name of the model JSON
    model_type: str = "roberta"     # one of hf_configs.SUPPORTED_MODEL_TYPES
    vocab_size: int = 50265
    width: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 514
    type_vocab_size: int = 1
    pad_id: int = 1
    ln_eps: float = 1e-5
    context_length: int = 77        # the tokenizer's padding length
    pooler_type: str = "mean_pooler"
    proj_type: Optional[str] = None  # None | 'linear' | 'mlp'
    # mt5: heads d_kv wide (heads * d_kv may differ from width) and the
    # relative-position buckets
    d_kv: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    # m2m_100: token embeddings times sqrt(width)
    scale_embedding: bool = False

    @property
    def position_offset(self) -> int:
        """RoBERTa's and M2M100's positions start at pad_id + 1; BERT's at 0."""
        return self.pad_id + 1 if self.model_type in ("roberta", "xlm-roberta", "m2m_100") else 0


def hf_text_config(text_raw: Dict) -> HFTextConfig:
    """:class:`HFTextConfig` from a model JSON's ``text_cfg`` (JAX
    ``hf_text_config``): the known hub dimensions, overridden by the JSON's
    fields; an unknown model type, or an unknown hub name without explicit
    dimensions, raises."""
    from latteclip_torch.models.hf_configs import SUPPORTED_MODEL_TYPES, arch_dict

    name = text_raw.get("hf_model_name", "")
    base = dict(KNOWN_HF_CONFIGS.get(name, {}))
    explicit = {k: v for k, v in text_raw.items()
                if k in {f.name for f in dataclasses.fields(HFTextConfig)}}
    base.update(explicit)
    mt = base.get("model_type", "roberta")
    if mt not in SUPPORTED_MODEL_TYPES:
        raise ValueError(
            f"hf model_type '{mt}' has no native tower (supported: "
            f"{SUPPORTED_MODEL_TYPES}); registry entry: {arch_dict.get(mt)}")
    if name and name not in KNOWN_HF_CONFIGS and not {"width", "layers"} <= set(explicit):
        raise ValueError(
            f"hf_model_name {name!r} is not in KNOWN_HF_CONFIGS and the "
            "text_cfg does not specify its dimensions; add width/layers/"
            "heads/intermediate/vocab_size/max_positions explicitly")
    base["model_name"] = name
    base["tokenizer_name"] = text_raw.get("hf_tokenizer_name", name)
    if text_raw.get("hf_pooler_type") is not None:
        base["pooler_type"] = text_raw["hf_pooler_type"]
    if base.get("pooler_type") is None:
        base["pooler_type"] = arch_dict[mt]["pooler"]
    for key in ("proj", "hf_proj_type"):
        if text_raw.get(key) is not None:
            base["proj_type"] = text_raw[key]
    if base.get("proj_type") is None:
        # the reference's hf_proj_type defaults to 'mlp' and is always passed
        base["proj_type"] = "mlp"
    return HFTextConfig(**base)


def _proj_kind(cfg: HFTextConfig, embed_dim: int) -> Optional[str]:
    proj = cfg.proj_type
    if proj is None and cfg.width != embed_dim:
        proj = "linear"  # a projection is needed when the widths differ
    return proj


# -- the towers, under HF's names ---------------------------------------------

def _module(**children) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


class RMSNorm(nn.Module):
    """T5's LayerNorm: a scale, no bias, no mean subtraction."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, W = x.shape
    return x.reshape(B, T, heads, W // heads)


class BertLayer(nn.Module):
    def __init__(self, cfg: HFTextConfig):
        super().__init__()
        D, M, eps = cfg.width, cfg.intermediate, cfg.ln_eps
        self.attention = _module(
            self=_module(query=nn.Linear(D, D), key=nn.Linear(D, D), value=nn.Linear(D, D)),
            output=_module(dense=nn.Linear(D, D), LayerNorm=layers.LayerNorm(D, eps=eps)))
        self.intermediate = _module(dense=nn.Linear(D, M))
        self.output = _module(dense=nn.Linear(M, D), LayerNorm=layers.LayerNorm(D, eps=eps))
        self.heads = cfg.heads

    def forward(self, x, mask_bias, dtype):
        s, H = self.attention.self, self.heads
        q, k, v = (_heads(dense(x, lin.weight, lin.bias, dtype), H)
                   for lin in (s.query, s.key, s.value))
        a = plain_attention(q, k, v, dtype=dtype, bias=mask_bias).flatten(2)
        out = self.attention.output
        h = out.LayerNorm(x + dense(a, out.dense.weight, out.dense.bias, dtype))
        inter = layers.gelu(dense(h, self.intermediate.dense.weight,
                                  self.intermediate.dense.bias, dtype))
        o = self.output
        return o.LayerNorm(h + dense(inter, o.dense.weight, o.dense.bias, dtype))


class BertEncoder(nn.Module):
    """bert/roberta/xlm-roberta: ``embeddings.*``, ``encoder.layer.{i}.*``
    and, for a tower that pools with BERT's tanh head, ``pooler.dense``."""

    def __init__(self, cfg: HFTextConfig, pooler: bool):
        super().__init__()
        D = cfg.width
        self.embeddings = _module(
            word_embeddings=nn.Embedding(cfg.vocab_size, D),
            position_embeddings=nn.Embedding(cfg.max_positions, D),
            token_type_embeddings=nn.Embedding(cfg.type_vocab_size, D),
            LayerNorm=layers.LayerNorm(D, eps=cfg.ln_eps))
        self.encoder = _module(layer=nn.ModuleList(BertLayer(cfg) for _ in range(cfg.layers)))
        if pooler:
            self.pooler = _module(dense=nn.Linear(D, D))


class T5Block(nn.Module):
    def __init__(self, cfg: HFTextConfig, has_rel_bias: bool):
        super().__init__()
        D, inner = cfg.width, cfg.heads * cfg.d_kv
        attn = _module(q=nn.Linear(D, inner, bias=False), k=nn.Linear(D, inner, bias=False),
                       v=nn.Linear(D, inner, bias=False), o=nn.Linear(inner, D, bias=False))
        if has_rel_bias:
            attn.relative_attention_bias = nn.Embedding(cfg.rel_buckets, cfg.heads)
        ff = _module(wi_0=nn.Linear(D, cfg.intermediate, bias=False),
                     wi_1=nn.Linear(D, cfg.intermediate, bias=False),
                     wo=nn.Linear(cfg.intermediate, D, bias=False))
        self.layer = nn.ModuleList([
            _module(SelfAttention=attn, layer_norm=RMSNorm(D, cfg.ln_eps)),
            _module(DenseReluDense=ff, layer_norm=RMSNorm(D, cfg.ln_eps))])
        self.heads = cfg.heads

    def forward(self, x, bias, dtype):
        sa, ffl = self.layer
        a = sa.SelfAttention
        h = sa.layer_norm(x).to(dtype)
        q, k, v = (_heads(dense(h, lin.weight, None, dtype), self.heads) for lin in (a.q, a.k, a.v))
        att = plain_attention(q, k, v, dtype=dtype, bias=bias, scale=1.0).flatten(2)
        x = x + dense(att, a.o.weight, None, dtype)
        h = ffl.layer_norm(x).to(dtype)
        f = ffl.DenseReluDense
        ff = layers.gelu_tanh(dense(h, f.wi_0.weight, None, dtype)) * dense(h, f.wi_1.weight, None,
                                                                            dtype)
        return x + dense(ff, f.wo.weight, None, dtype)


class T5Encoder(nn.Module):
    """mt5's encoder: ``embed_tokens``, ``block.{i}.layer.{0,1}.*`` (block
    0 holds the shared ``relative_attention_bias``), ``final_layer_norm``."""

    def __init__(self, cfg: HFTextConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.width)
        self.block = nn.ModuleList(T5Block(cfg, i == 0) for i in range(cfg.layers))
        self.final_layer_norm = RMSNorm(cfg.width, cfg.ln_eps)


class M2MLayer(nn.Module):
    def __init__(self, cfg: HFTextConfig):
        super().__init__()
        D, M, eps = cfg.width, cfg.intermediate, cfg.ln_eps
        self.self_attn = _module(q_proj=nn.Linear(D, D), k_proj=nn.Linear(D, D),
                                 v_proj=nn.Linear(D, D), out_proj=nn.Linear(D, D))
        self.self_attn_layer_norm = layers.LayerNorm(D, eps=eps)
        self.fc1 = nn.Linear(D, M)
        self.fc2 = nn.Linear(M, D)
        self.final_layer_norm = layers.LayerNorm(D, eps=eps)
        self.heads = cfg.heads

    def forward(self, x, mask_bias, dtype):
        a = self.self_attn
        h = self.self_attn_layer_norm(x).to(dtype)
        q, k, v = (_heads(dense(h, lin.weight, lin.bias, dtype), self.heads)
                   for lin in (a.q_proj, a.k_proj, a.v_proj))
        att = plain_attention(q, k, v, dtype=dtype, bias=mask_bias).flatten(2)
        x = x + dense(att, a.out_proj.weight, a.out_proj.bias, dtype)
        h = self.final_layer_norm(x).to(dtype)
        ff = F.relu(dense(h, self.fc1.weight, self.fc1.bias, dtype))
        return x + dense(ff, self.fc2.weight, self.fc2.bias, dtype)


class M2MEncoder(nn.Module):
    """M2M100/NLLB's encoder: ``embed_tokens``, ``layers.{i}.*``,
    ``layer_norm``; the sinusoidal table is a buffer outside the state dict,
    as HF registers it."""

    def __init__(self, cfg: HFTextConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.width)
        self.layers = nn.ModuleList(M2MLayer(cfg) for _ in range(cfg.layers))
        self.layer_norm = layers.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.register_buffer("embed_positions", torch.from_numpy(
            sinusoid_table(cfg.max_positions + 2, cfg.width, cfg.pad_id)), persistent=False)


@lru_cache(maxsize=8)
def t5_rel_buckets(T: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional T5 relative-position buckets [T, T] (HF
    ``T5Attention._relative_position_bucket``): half the buckets for each
    sign, half of those exact, the rest log-spaced out to max_distance."""
    ctx = np.arange(T)
    rel = ctx[None, :] - ctx[:, None]          # memory_pos - query_pos
    nb = num_buckets // 2
    ret = (rel > 0).astype(np.int32) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int32)
    return ret + np.where(n < max_exact, n, np.minimum(large, nb - 1))


def sinusoid_table(n_pos: int, dim: int, padding_idx: int) -> np.ndarray:
    """fairseq/M2M100's sinusoidal table [n_pos, dim]: the first half sin,
    the second cos (not interleaved), zero at ``padding_idx``."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(np.log(10000.0) / (half - 1)))
    ang = np.arange(n_pos, dtype=np.float64)[:, None] * freq[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((n_pos, 1))], axis=1)
    emb[padding_idx] = 0.0
    return emb.astype(np.float32)


class HFTextTower(nn.Module):
    """``transformer`` (the encoder of ``cfg.model_type``) and ``proj``
    (an unbiased ``Linear``, or the ``mlp`` head as ``proj.0`` and
    ``proj.2``). ``pooler`` gives a BERT-family tower BERT's tanh pooler
    head (``transformer.pooler.dense``): by default where it pools at the
    class token, as JAX's init does; a checkpoint without the head loads
    into a tower built with ``pooler=False``."""

    def __init__(self, cfg: HFTextConfig, embed_dim: int, pooler: Optional[bool] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.model_type == "mt5":
            self.transformer = T5Encoder(cfg)
        elif cfg.model_type == "m2m_100":
            self.transformer = M2MEncoder(cfg)
        else:
            if pooler is None:
                pooler = cfg.pooler_type == "cls_pooler"
            self.transformer = BertEncoder(cfg, pooler)
        D, proj = cfg.width, _proj_kind(cfg, embed_dim)
        if proj == "linear":
            self.proj = nn.Linear(D, embed_dim, bias=False)
        elif proj == "mlp":
            hidden = (D + embed_dim) // 2
            self.proj = nn.Sequential(nn.Linear(D, hidden, bias=False), nn.GELU(),
                                      nn.Linear(hidden, embed_dim, bias=False))

    def hidden(self, tokens: torch.Tensor, *, dtype: torch.dtype,
               remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token ids [B, T] -> (last hidden state [B, T, D] float32, mask
        [B, T], 1 at the tokens that are not ``pad_id``)."""
        cfg, t = self.cfg, self.transformer
        mask = (tokens != cfg.pad_id).int()
        B, T = tokens.shape
        mask_bias = torch.where(mask == 0, NEG_INF, 0.0).float()[:, None, None, :]
        if cfg.model_type == "mt5":
            x = F.embedding(tokens, t.embed_tokens.weight).to(dtype)  # no positions, no scale
            buckets = torch.from_numpy(t5_rel_buckets(T, cfg.rel_buckets, cfg.rel_max_distance))
            rel = t.block[0].layer[0].SelfAttention.relative_attention_bias.weight
            bias = F.embedding(buckets.to(tokens.device).long(), rel).permute(2, 0, 1)[None]
            x = _run(t.block, x, bias.float() + mask_bias, dtype, remat)
            return t.final_layer_norm(x).float(), mask
        if cfg.model_type == "m2m_100":
            if cfg.pad_id + T >= cfg.max_positions + 2:
                raise ValueError(f"sequence length {T} exceeds the sinusoidal table "
                                 f"(max_positions={cfg.max_positions} + offset 2)")
            pos_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_id
            scale = cfg.width ** 0.5 if cfg.scale_embedding else 1.0
            x = (F.embedding(tokens, t.embed_tokens.weight) * scale
                 + t.embed_positions[pos_ids]).to(dtype)
            x = _run(t.layers, x, mask_bias, dtype, remat)
            return t.layer_norm(x).float(), mask
        max_pos = cfg.pad_id + T if cfg.position_offset else T - 1
        if max_pos >= cfg.max_positions:
            raise ValueError(f"sequence length {T} exceeds the position table "
                             f"(max_positions={cfg.max_positions}, offset {cfg.position_offset})")
        if cfg.position_offset:
            pos_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_id
        else:
            pos_ids = torch.arange(T, device=tokens.device).expand(B, T)
        e = t.embeddings
        x = (F.embedding(tokens, e.word_embeddings.weight)
             + F.embedding(pos_ids, e.position_embeddings.weight)
             + e.token_type_embeddings.weight[0])
        x = e.LayerNorm(x).to(dtype)
        return _run(t.encoder.layer, x, mask_bias, dtype, remat).float(), mask

    def pool_project(self, x: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The pooler of ``cfg.pooler_type`` then the projection: x [B, T, D]
        float32 -> [B, embed_dim] float32 (JAX ``_pool_project``)."""
        kind = self.cfg.pooler_type
        maskf = mask.float()
        if kind == "mean_pooler":
            pooled = (x * maskf[:, :, None]).sum(1) / maskf.sum(1, keepdim=True)
        elif kind == "max_pooler":
            pooled = x.masked_fill(maskf[:, :, None] == 0, float("-inf")).amax(dim=1)
        elif kind in ("cls_pooler", "cls_last_hidden_state_pooler"):
            pooled = x[:, 0]
            head = getattr(self.transformer, "pooler", None)
            if kind == "cls_pooler" and head is not None:  # BERT's tanh pooler head
                pooled = torch.tanh(dense(pooled.float(), head.dense.weight, head.dense.bias,
                                          torch.float32))
        else:
            raise ValueError(f"unknown pooler_type: {kind}")
        pooled = pooled.to(dtype)
        proj = getattr(self, "proj", None)
        if isinstance(proj, nn.Linear):
            pooled = dense(pooled, proj.weight, None, dtype)
        elif proj is not None:
            h = layers.gelu(dense(pooled, proj[0].weight, None, dtype))
            pooled = dense(h, proj[2].weight, None, dtype)
        return pooled.float()

    def forward(self, tokens: torch.Tensor, *, dtype: torch.dtype = torch.bfloat16,
                remat: bool = False) -> torch.Tensor:
        """Token ids [B, T] -> pooled, projected features [B, embed_dim]
        (float32), JAX ``hf_text_forward``."""
        x, mask = self.hidden(tokens, dtype=dtype, remat=remat)
        return self.pool_project(x, mask, dtype)

    def forward_tokens(self, tokens: torch.Tensor, *, dtype: torch.dtype = torch.bfloat16,
                       remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``output_tokens`` (JAX ``hf_text_forward_tokens``, CoCa's
        ``coca_roberta``): (the pooled latent [B, E] float32, the raw last
        hidden states in ``dtype``, without the class position for the
        class-token poolers)."""
        if self.cfg.model_type not in BERT_FAMILY:
            raise NotImplementedError(
                "output_tokens is only wired for the BERT-family towers (no "
                "reference config pairs an encoder-decoder text tower with CoCa)")
        x, mask = self.hidden(tokens, dtype=dtype, remat=remat)
        pooled = self.pool_project(x, mask, dtype)
        if self.cfg.pooler_type in ("cls_pooler", "cls_last_hidden_state_pooler"):
            x = x[:, 1:]
        return pooled, x.to(dtype)


def _run(blocks, x: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype, remat: bool):
    """Each block in turn; ``remat`` recomputes each in the backward (JAX's
    ``jax.checkpoint`` on the scanned body), where autograd records."""
    remat = remat and torch.is_grad_enabled()
    for block in blocks:
        x = (checkpoint(block, x, bias, dtype, use_reentrant=False) if remat
             else block(x, bias, dtype))
    return x


def init_rule(name: str, cfg: HFTextConfig):
    """JAX's seeded init (``init_hf_text_params``) for one parameter of an
    :class:`HFTextTower`, named from the tower (``transformer.*``,
    ``proj*``): ("normal", std) or ("const", value)."""
    leaf = name.rsplit(".", 1)[-1]
    if "LayerNorm" in name or "layer_norm" in name:
        return ("const", 1.0 if leaf == "weight" else 0.0)
    if leaf == "bias":
        return ("const", 0.0)
    if cfg.model_type != "mt5" or name.startswith("proj"):
        return ("normal", 0.02)
    D, M, inner = cfg.width, cfg.intermediate, cfg.heads * cfg.d_kv
    if name == "transformer.embed_tokens.weight":
        return ("normal", 1.0)
    if "relative_attention_bias" in name:
        return ("normal", (D // cfg.heads) ** -0.5)
    for suffix, std in ((".q.weight", (D * cfg.d_kv) ** -0.5), (".o.weight", inner ** -0.5),
                        (".wo.weight", M ** -0.5)):
        if name.endswith(suffix):
            return ("normal", std)
    return ("normal", D ** -0.5)  # k, v, wi_0, wi_1


# -- HF state dict <-> the JAX parameter tree (numpy) -------------------------

_BERT_BLOCK = [
    ("q_w", "attention.self.query.weight", True), ("q_b", "attention.self.query.bias", False),
    ("k_w", "attention.self.key.weight", True), ("k_b", "attention.self.key.bias", False),
    ("v_w", "attention.self.value.weight", True), ("v_b", "attention.self.value.bias", False),
    ("attn_out_w", "attention.output.dense.weight", True),
    ("attn_out_b", "attention.output.dense.bias", False),
    ("attn_ln_scale", "attention.output.LayerNorm.weight", False),
    ("attn_ln_bias", "attention.output.LayerNorm.bias", False),
    ("inter_w", "intermediate.dense.weight", True), ("inter_b", "intermediate.dense.bias", False),
    ("out_w", "output.dense.weight", True), ("out_b", "output.dense.bias", False),
    ("out_ln_scale", "output.LayerNorm.weight", False),
    ("out_ln_bias", "output.LayerNorm.bias", False),
]
_BERT_TOP = [
    ("word_emb", "embeddings.word_embeddings.weight"),
    ("pos_emb", "embeddings.position_embeddings.weight"),
    ("type_emb", "embeddings.token_type_embeddings.weight"),
    ("emb_ln_scale", "embeddings.LayerNorm.weight"),
    ("emb_ln_bias", "embeddings.LayerNorm.bias"),
]
_T5_BLOCK = [
    ("q_w", "layer.0.SelfAttention.q.weight", True),
    ("k_w", "layer.0.SelfAttention.k.weight", True),
    ("v_w", "layer.0.SelfAttention.v.weight", True),
    ("o_w", "layer.0.SelfAttention.o.weight", True),
    ("ln1_scale", "layer.0.layer_norm.weight", False),
    ("wi0_w", "layer.1.DenseReluDense.wi_0.weight", True),
    ("wi1_w", "layer.1.DenseReluDense.wi_1.weight", True),
    ("wo_w", "layer.1.DenseReluDense.wo.weight", True),
    ("ln2_scale", "layer.1.layer_norm.weight", False),
]
_T5_TOP = [
    ("word_emb", "embed_tokens.weight"),
    ("rel_bias", "block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
    ("final_ln_scale", "final_layer_norm.weight"),
]
_M2M_BLOCK = [
    ("q_w", "self_attn.q_proj.weight", True), ("q_b", "self_attn.q_proj.bias", False),
    ("k_w", "self_attn.k_proj.weight", True), ("k_b", "self_attn.k_proj.bias", False),
    ("v_w", "self_attn.v_proj.weight", True), ("v_b", "self_attn.v_proj.bias", False),
    ("o_w", "self_attn.out_proj.weight", True), ("o_b", "self_attn.out_proj.bias", False),
    ("ln1_scale", "self_attn_layer_norm.weight", False),
    ("ln1_bias", "self_attn_layer_norm.bias", False),
    ("fc1_w", "fc1.weight", True), ("fc1_b", "fc1.bias", False),
    ("fc2_w", "fc2.weight", True), ("fc2_b", "fc2.bias", False),
    ("ln2_scale", "final_layer_norm.weight", False),
    ("ln2_bias", "final_layer_norm.bias", False),
]
_M2M_TOP = [("word_emb", "embed_tokens.weight"), ("final_ln_scale", "layer_norm.weight"),
            ("final_ln_bias", "layer_norm.bias")]


def _layout(cfg: HFTextConfig):
    """(top-level keys, per-block keys, block prefix) of ``cfg.model_type``."""
    if cfg.model_type == "mt5":
        return _T5_TOP, _T5_BLOCK, "block"
    if cfg.model_type == "m2m_100":
        return _M2M_TOP, _M2M_BLOCK, "layers"
    return _BERT_TOP, _BERT_BLOCK, "encoder.layer"


def import_hf_state_dict(state_dict: Dict, cfg: HFTextConfig) -> Dict:
    """HF names -> the JAX parameter tree (JAX ``import_hf_state_dict``):
    a leading ``bert.``/``roberta.`` prefix, or for mt5 and m2m_100 the
    ``encoder.`` prefix of a live ``AutoModel``, is stripped, their
    decoder, ``lm_head``, ``shared.weight`` and position table left out;
    BERT's pooler head is kept for a ``cls_pooler`` tower that has one."""
    sd = {}
    for k, v in state_dict.items():
        if cfg.model_type in BERT_FAMILY:
            if k.split(".", 1)[0] in ("bert", "roberta"):
                k = k.split(".", 1)[1]
        else:
            if k in ("shared.weight", "encoder.embed_positions.weights"):
                continue
            if k.startswith("encoder."):
                k = k[len("encoder."):]
            if k.startswith("decoder.") or k == "lm_head.weight":
                continue
        sd[k] = np.asarray(torch.as_tensor(v).detach().float().cpu()) \
            if isinstance(v, torch.Tensor) else np.asarray(v, dtype=np.float32)
    top, block, stem = _layout(cfg)
    params = {ours: sd[theirs] for ours, theirs in top}
    params["blocks"] = {
        ours: np.stack([sd[f"{stem}.{i}.{theirs}"].T if tr else sd[f"{stem}.{i}.{theirs}"]
                        for i in range(cfg.layers)])
        for ours, theirs, tr in block}
    if cfg.model_type in BERT_FAMILY and "pooler.dense.weight" in sd \
            and cfg.pooler_type == "cls_pooler":
        params["pooler_w"] = sd["pooler.dense.weight"].T.copy()
        params["pooler_b"] = sd["pooler.dense.bias"]
    return params


def export_hf_state_dict(params: Dict, cfg: HFTextConfig) -> Dict[str, np.ndarray]:
    """The inverse (JAX ``export_hf_state_dict``): the JAX tree -> HF names,
    mt5 and m2m_100 under the bare encoder namespace the reference's
    checkpoints use."""
    top, block, stem = _layout(cfg)
    sd = {theirs: np.asarray(params[ours], np.float32) for ours, theirs in top}
    b = params["blocks"]
    for i in range(cfg.layers):
        for ours, theirs, tr in block:
            a = np.asarray(b[ours][i], np.float32)
            sd[f"{stem}.{i}.{theirs}"] = a.T.copy() if tr else a
    if "pooler_w" in params:
        sd["pooler.dense.weight"] = np.asarray(params["pooler_w"], np.float32).T.copy()
        sd["pooler.dense.bias"] = np.asarray(params["pooler_b"], np.float32)
    return sd


def proj_from_state_dict(sd, prefix: str) -> Dict[str, np.ndarray]:
    """The projection's JAX leaves (``proj_w`` or ``proj1_w``/``proj2_w``,
    ``[in, out]``) from ``prefix + "proj.weight"`` or ``"proj.{0,2}.weight"``."""
    out = {}
    if prefix + "proj.weight" in sd:
        out["proj_w"] = np.asarray(sd[prefix + "proj.weight"], np.float32).T.copy()
    if prefix + "proj.0.weight" in sd:
        out["proj1_w"] = np.asarray(sd[prefix + "proj.0.weight"], np.float32).T.copy()
        out["proj2_w"] = np.asarray(sd[prefix + "proj.2.weight"], np.float32).T.copy()
    return out


def proj_to_state_dict(t: Dict, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    if "proj_w" in t:
        out[prefix + "proj.weight"] = np.ascontiguousarray(np.asarray(t["proj_w"], np.float32).T)
    if "proj1_w" in t:
        out[prefix + "proj.0.weight"] = np.ascontiguousarray(np.asarray(t["proj1_w"], np.float32).T)
        out[prefix + "proj.2.weight"] = np.ascontiguousarray(np.asarray(t["proj2_w"], np.float32).T)
    return out
