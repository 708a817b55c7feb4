"""Vision transformer tower (port of ``latteclip_tpu/models/vit.py``).

Images are NHWC ``[B, H, W, 3]`` at :func:`vit_forward`, as in JAX. The
stride-P patch convolution runs as patchify + one matmul against
``conv1.weight`` reshaped to ``[D, P*P*3]``; then the class token (where the
tower has one), learned or fixed sin-cos positions, train-time patch
dropout, ``ln_pre`` (where the tower has one), the pre-LN stack and one of
the JAX tower's pooling orders: the big_vision MAP head after ``ln_post``
(SigLIP), token or average pooling then ``ln_post`` (``final_ln_after_pool``,
CLIPA), or ``ln_post`` then token or average pooling (OpenCLIP's
``VisionTransformer``); last the projection, where the tower has one.

The timm trunks the JAX package runs on this tower (EVA01's giant,
``vit_medium_patch16_gap_256``) are :class:`TimmVisionTransformer`, the same
computation under timm's parameter names (``visual.trunk.*``, OpenCLIP's
``visual.head.proj`` for ViT-medium's unbiased projection): a biased patch
conv, EVA's q/v biases (with the k bias JAX trains but does not save) and
its biased head.

Pair-packing: at ViT-B/32's L=50, two images share one row of 100 tokens
and the segment-masked kernel keeps each image to itself, with exactly the
same attention math. The port packs only when that kernel will run (a bf16
CUDA tensor, even batch, 2L <= 128, head_dim 64 or 128); ``pack_pairs=``
overrides the rule, so a test can force it on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from latteclip_torch.config import VisionConfig
from latteclip_torch.kernels import kernel_route
from latteclip_torch.models import layers


class VisionTransformer(nn.Module):
    """Parameters under OpenCLIP's ``visual.*`` names. ``ln_pre`` stays a
    parameter under ``no_ln_pre`` (unused), as in the JAX parameter tree;
    a SigLIP tower's MAP head lives outside ``visual`` (:class:`MapHead`).
    :func:`vit_forward` reads a tower through the accessors below, which
    :class:`TimmVisionTransformer` also has."""

    def __init__(self, cfg: VisionConfig, embed_dim: int):
        super().__init__()
        D, P = cfg.width, cfg.patch_size
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, D, kernel_size=P, stride=P, bias=False)
        if not cfg.no_cls_token:
            self.class_embedding = nn.Parameter(torch.empty(D))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.seq_len, D))
        self.ln_pre = layers.LayerNorm(D, eps=cfg.ln_eps)
        self.transformer = layers.Transformer(D, cfg.layers, cfg.heads, cfg.mlp_ratio, cfg.ln_eps,
                                              layer_scale=cfg.ls_init_value is not None)
        # CoCa's attentional pool maps the tokens to embed_dim before ln_post
        pool_dim = embed_dim if cfg.attentional_pool else D
        if cfg.attentional_pool:
            self.attn_pool = AttentionalPooler(embed_dim, D, cfg.attn_pooler_queries)
        self.ln_post = layers.LayerNorm(pool_dim, eps=cfg.ln_eps)
        if has_proj(cfg, embed_dim):
            self.proj = nn.Parameter(torch.empty(pool_dim, embed_dim))

    def patch_embed(self):
        return self.conv1.weight, self.conv1.bias

    def cls_pos(self):
        return getattr(self, "class_embedding", None), self.positional_embedding

    @property
    def blocks(self):
        return self.transformer.resblocks

    def projection(self):
        """(weight [E, D], bias) of the projection, or None."""
        return (self.proj.t(), None) if hasattr(self, "proj") else None


class TimmBlock(nn.Module):
    """timm's pre-norm ViT block (``norm1``, ``attn.qkv``, ``attn.proj``,
    ``norm2``, ``mlp.fc1``, ``mlp.fc2``); with ``qv_bias`` the qkv
    projection has EVA's separate ``q_bias`` and ``v_bias`` and the k bias
    JAX trains but does not save (:class:`layers.EvaAttention`)."""

    def __init__(self, width: int, heads: int, hidden: int, eps: float, qv_bias: bool):
        super().__init__()
        self.heads = heads
        self.norm1 = layers.LayerNorm(width, eps=eps)
        self.attn = layers.EvaAttention(width) if qv_bias else nn.Module()
        self.attn.qkv = nn.Linear(width, 3 * width, bias=not qv_bias)
        if qv_bias:
            self.attn.q_bias = nn.Parameter(torch.empty(width))
            self.attn.v_bias = nn.Parameter(torch.empty(width))
        self.attn.proj = nn.Linear(width, width)
        self.norm2 = layers.LayerNorm(width, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(width, hidden)
        self.mlp.fc2 = nn.Linear(hidden, width)

    def forward(self, x, **kwargs):
        a = self.attn
        in_b = a.qkv.bias if a.qkv.bias is not None else torch.cat([a.q_bias, a.k_bias, a.v_bias])
        return layers.pre_norm_block(x, self.norm1, a.qkv.weight, in_b, self.heads, a.proj,
                                     self.norm2, self.mlp.fc1, self.mlp.fc2, None, None, **kwargs)


def timm_init_rule(name: str, cfg: VisionConfig, embed_dim: int):
    """JAX ``init_vit_params``'s rule for one parameter of a timm trunk."""
    D = cfg.width
    scale = D ** -0.5
    proj_std = scale * (2 * cfg.layers) ** -0.5
    leaf = name.rsplit(".", 1)[-1]
    if "norm" in name:
        return ("const", 1.0 if leaf == "weight" else 0.0)
    if leaf.endswith("bias"):
        return ("const", 0.0)
    if name.endswith(("attn.proj.weight", "mlp.fc2.weight")):
        return ("normal", proj_std)
    if name.endswith("mlp.fc1.weight"):
        return ("normal", (2 * D) ** -0.5)
    return ("normal", scale)  # patch conv, class token, positions, qkv, head


class TimmVisionTransformer(nn.Module):
    """A timm ViT trunk on the native tower's computation, under timm's
    names: ``trunk.patch_embed.proj`` (biased), ``trunk.cls_token`` and
    ``trunk.pos_embed`` ``[1, L, D]``, ``trunk.blocks``, then EVA's
    ``trunk.norm`` and biased ``trunk.head``, or ViT-medium's
    ``trunk.fc_norm`` after the pool and OpenCLIP's unbiased
    ``head.proj``. Neither trunk has ``ln_pre``."""

    def __init__(self, cfg: VisionConfig, embed_dim: int):
        super().__init__()
        D, P = cfg.width, cfg.patch_size
        self.cfg = cfg
        eva = cfg.timm_trunk.startswith("eva")
        self.trunk = nn.Module()
        self.trunk.patch_embed = nn.Module()
        self.trunk.patch_embed.proj = nn.Conv2d(3, D, kernel_size=P, stride=P)
        if not cfg.no_cls_token:
            self.trunk.cls_token = nn.Parameter(torch.empty(1, 1, D))
        self.trunk.pos_embed = nn.Parameter(torch.empty(1, cfg.seq_len, D))
        self.trunk.blocks = nn.ModuleList(
            TimmBlock(D, cfg.heads, int(D * cfg.mlp_ratio), cfg.ln_eps, qv_bias=eva)
            for _ in range(cfg.layers))
        if eva:
            self.trunk.norm = layers.LayerNorm(D, eps=cfg.ln_eps)
            self.trunk.head = nn.Linear(D, embed_dim)
        else:
            self.trunk.fc_norm = layers.LayerNorm(D, eps=cfg.ln_eps)
            self.head = nn.Module()
            self.head.proj = nn.Linear(D, embed_dim, bias=False)

    def patch_embed(self):
        return self.trunk.patch_embed.proj.weight, self.trunk.patch_embed.proj.bias

    def cls_pos(self):
        cls = getattr(self.trunk, "cls_token", None)
        return (cls.reshape(-1) if cls is not None else None), self.trunk.pos_embed[0]

    @property
    def blocks(self):
        return self.trunk.blocks

    @property
    def ln_post(self):
        return self.trunk.norm if hasattr(self.trunk, "norm") else self.trunk.fc_norm

    def projection(self):
        lin = self.trunk.head if hasattr(self.trunk, "head") else self.head.proj
        return lin.weight, lin.bias


def has_proj(cfg: VisionConfig, embed_dim: int) -> bool:
    """A MAP-pooled tower whose width is the embedding's has no projection
    (big_vision: the head is the pool)."""
    pool_dim = embed_dim if cfg.attentional_pool else cfg.width
    return not (cfg.pool_type == "map" and pool_dim == embed_dim)


class AttentionalPooler(nn.Module):
    """CoCa's attentional pool (JAX ``init_attn_pool_params``): learned
    queries [Q, d_model] attend over the tokens [B, L, context_dim] through
    ``nn.MultiheadAttention``'s parameters with ``kdim = vdim =
    context_dim`` (separate ``q_proj_weight``, ``k_proj_weight``,
    ``v_proj_weight``, ``[out, in]``, one ``in_proj_bias``), with the
    queries LayerNormed by ``ln_q`` and the tokens by ``ln_k``."""

    def __init__(self, d_model: int, context_dim: int, n_queries: int):
        super().__init__()
        self.query = nn.Parameter(torch.empty(n_queries, d_model))
        self.attn = nn.Module()
        self.attn.q_proj_weight = nn.Parameter(torch.empty(d_model, d_model))
        self.attn.k_proj_weight = nn.Parameter(torch.empty(d_model, context_dim))
        self.attn.v_proj_weight = nn.Parameter(torch.empty(d_model, context_dim))
        self.attn.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.attn.out_proj = nn.Linear(d_model, d_model)
        self.ln_q = layers.LayerNorm(d_model)
        self.ln_k = layers.LayerNorm(context_dim)


def attentional_pool(x: torch.Tensor, pool: AttentionalPooler, num_heads: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """Tokens [B, L, C] -> [B, Q, d_model] (JAX ``attentional_pool``): the
    cross-attention is plain torch (:func:`layers.plain_attention`), as JAX
    runs it on XLA."""
    B = x.shape[0]
    keys = pool.ln_k(x.to(dtype))
    queries = pool.ln_q(pool.query)                                     # float32
    a = pool.attn
    bq, bk, bv = a.in_proj_bias.chunk(3)
    q = layers.dense(queries, a.q_proj_weight, bq, dtype)               # [Q, D]
    k = layers.dense(keys, a.k_proj_weight, bk, dtype)                  # [B, L, D]
    v = layers.dense(keys, a.v_proj_weight, bv, dtype)
    Q, D = q.shape
    hd = D // num_heads
    qh = q.reshape(1, Q, num_heads, hd).expand(B, Q, num_heads, hd)
    out = layers.plain_attention(qh, k.reshape(B, -1, num_heads, hd),
                                 v.reshape(B, -1, num_heads, hd), dtype=dtype)
    return layers.dense(out.reshape(B, Q, D), a.out_proj.weight, a.out_proj.bias, dtype)


class MapHead(nn.Module):
    """big_vision's MAP head, in the JAX package's flax layout (weights
    ``[in, out]``): a learned probe attends over the tokens, then LayerNorm
    and a residual MLP."""

    def __init__(self, width: int, mlp_width: int):
        super().__init__()
        D = width
        self.probe = nn.Parameter(torch.empty(1, D))
        for n in ("q", "k", "v", "out"):
            self.register_parameter(f"{n}_w", nn.Parameter(torch.empty(D, D)))
            self.register_parameter(f"{n}_b", nn.Parameter(torch.empty(D)))
        self.ln_scale = nn.Parameter(torch.empty(D))
        self.ln_bias = nn.Parameter(torch.empty(D))
        self.fc1_w = nn.Parameter(torch.empty(D, mlp_width))
        self.fc1_b = nn.Parameter(torch.empty(mlp_width))
        self.fc2_w = nn.Parameter(torch.empty(mlp_width, D))
        self.fc2_b = nn.Parameter(torch.empty(D))


def _flax_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    return layers.dense(x, w.t(), b, dtype)


def siglip_map_head(x: torch.Tensor, head: MapHead, num_heads: int, dtype: torch.dtype,
                    ln_eps: float) -> torch.Tensor:
    """Tokens [B, L, D] -> the probe's feature [B, D] (JAX ``siglip_map_head``).
    The cross-attention is plain torch, as JAX runs it through
    ``xla_attention`` (logits and softmax in float32 over the compute-dtype
    operands); the MLP takes tanh GELU whatever the tower's activation."""
    B, L, D = x.shape
    hd = D // num_heads
    x = x.to(dtype)
    q = _flax_dense(head.probe, head.q_w, head.q_b, dtype)                 # [1, D]
    k = _flax_dense(x, head.k_w, head.k_b, dtype).view(B, L, num_heads, hd)
    v = _flax_dense(x, head.v_w, head.v_b, dtype).view(B, L, num_heads, hd)
    qh = (q.view(1, num_heads, hd) * hd ** -0.5).to(dtype)
    logits = torch.einsum("qhd,bkhd->bhqk", qh.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dtype).reshape(B, 1, D)
    out = _flax_dense(out, head.out_w, head.out_b, dtype)
    y = layers.layer_norm(out, head.ln_scale, head.ln_bias, ln_eps)
    h = layers.gelu_tanh(_flax_dense(y, head.fc1_w, head.fc1_b, dtype))
    return (out + _flax_dense(h, head.fc2_w, head.fc2_b, dtype))[:, 0]


def patch_dropout(x: torch.Tensor, prob: float, generator: Optional[torch.Generator],
                  has_cls: bool = True) -> torch.Tensor:
    """Keep ``max(1, int(N * (1 - prob)))`` of the N patch tokens of each
    image, those of the highest N(0, 1) scores drawn from ``generator``, in
    the order of their scores; the class token, where there is one, always
    stays first (JAX ``patch_dropout``)."""
    n_cls = 1 if has_cls else 0
    cls_tok, patches = x[:, :n_cls], x[:, n_cls:]
    B, N, D = patches.shape
    num_keep = max(1, int(N * (1.0 - prob)))
    scores = torch.randn((B, N), generator=generator, device=x.device)
    keep = scores.topk(num_keep, dim=1).indices                          # [B, num_keep]
    kept = torch.gather(patches, 1, keep[..., None].expand(B, num_keep, D))
    return torch.cat([cls_tok, kept], dim=1)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch*patch*C] patch vectors in (i, j, c) order."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def pack_pairs_auto(B: int, L: int, cfg: VisionConfig, dtype: torch.dtype,
                    device: torch.device, attention: str = "kernel") -> bool:
    """Pack two images per row only where the segment-masked kernel runs."""
    return (B % 2 == 0 and 2 * L <= 128
            and kernel_route(3 * cfg.width, cfg.heads, dtype, device, attention))


def vit_forward(
    visual,
    images: torch.Tensor,
    *,
    dtype: torch.dtype = torch.bfloat16,
    quick_gelu: bool = False,
    gelu_tanh: bool = False,
    map_head: Optional[MapHead] = None,
    attention: str = "kernel",
    pack_pairs: Optional[bool] = None,
    ln_linear: str = "unfused",
    remat: bool = False,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    output_tokens: bool = False,
):
    """Images [B, H, W, 3] -> pooled features [B, embed_dim] (float32), on
    a :class:`VisionTransformer` or a :class:`TimmVisionTransformer`.
    ``attention`` and ``ln_linear`` select the routes of
    :func:`layers.pre_norm_block`; ``remat`` rematerialises each block
    (:func:`layers.run_blocks`). ``train`` applies the config's patch
    dropout, drawn from ``generator``; ``map_head`` is the MAP head of a
    tower that pools with one. ``output_tokens`` returns ``(pooled,
    tokens)``, the token embeddings CoCa's decoder reads: after an
    attentional pool and ``ln_post`` the queries but the first."""
    cfg = visual.cfg
    if cfg.no_cls_token and cfg.pool_type == "tok" and not cfg.attentional_pool:
        raise ValueError("pool_type='tok' needs a class token; this config sets "
                         "no_cls_token — use pool_type 'map' or 'avg'")
    act = layers.activation(quick_gelu, gelu_tanh)
    B = images.shape[0]
    P = cfg.patch_size
    conv_w, conv_b = visual.patch_embed()
    # conv weight [D, 3, P, P] -> [D, P*P*3] in patchify's (i, j, c) order
    w = conv_w.permute(0, 2, 3, 1).reshape(cfg.width, P * P * 3)
    x = layers.dense(patchify(images, P), w, conv_b, dtype)             # [B, N, D]
    cls, pos = visual.cls_pos()
    if cls is not None:
        x = torch.cat([cls.to(dtype).expand(B, 1, cfg.width), x], dim=1)
    if cfg.pos_embed_type == "sin_cos_2d":  # a fixed embedding
        pos = pos.detach()
    x = x + pos.to(dtype)
    if train and cfg.patch_dropout > 0.0:
        x = patch_dropout(x, cfg.patch_dropout, generator, has_cls=not cfg.no_cls_token)
    if not cfg.no_ln_pre:
        x = visual.ln_pre(x)

    L = x.shape[1]
    if pack_pairs is None:
        pack_pairs = pack_pairs_auto(B, L, cfg, dtype, x.device, attention)
    kwargs = dict(causal=False, act=act, dtype=dtype, attention=attention, ln_linear=ln_linear)
    if pack_pairs:
        if B % 2:
            raise ValueError(f"pair-packing needs an even batch, got {B}")
        seg = torch.arange(1, 3, dtype=torch.int32, device=x.device).repeat_interleave(L)
        x = layers.run_blocks(visual.blocks, x.reshape(B // 2, 2 * L, cfg.width), remat,
                              seg_ids=seg.expand(B // 2, 2 * L), **kwargs)
        x = x.reshape(B, L, cfg.width)
    else:
        x = layers.run_blocks(visual.blocks, x, remat, **kwargs)

    off = 0 if cfg.no_cls_token else 1
    if cfg.pool_type == "map":
        x = visual.ln_post(x)
        tokens = x
        pooled = siglip_map_head(x, map_head, cfg.heads, dtype, cfg.ln_eps)
    elif cfg.attentional_pool:
        x = visual.ln_post(attentional_pool(x, visual.attn_pool, cfg.attn_pooler_heads, dtype))
        tokens = x[:, 1:]
        pooled = tokens.mean(dim=1) if cfg.pool_type == "avg" else x[:, 0]
    elif cfg.final_ln_after_pool:
        tokens = x[:, off:]
        pooled = visual.ln_post(tokens.mean(dim=1) if cfg.pool_type == "avg" else x[:, 0])
    else:
        x = visual.ln_post(x)
        tokens = x[:, off:]
        pooled = tokens.mean(dim=1) if cfg.pool_type == "avg" else x[:, 0]
    proj = visual.projection()
    if proj is not None:
        pooled = layers.dense(pooled, proj[0], proj[1], dtype)
    return (pooled.float(), tokens) if output_tokens else pooled.float()
