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
    a SigLIP tower's MAP head lives outside ``visual`` (:class:`MapHead`)."""

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
        self.ln_post = layers.LayerNorm(D, eps=cfg.ln_eps)
        if has_proj(cfg, embed_dim):
            self.proj = nn.Parameter(torch.empty(D, embed_dim))


def has_proj(cfg: VisionConfig, embed_dim: int) -> bool:
    """A MAP-pooled tower whose width is the embedding's has no projection
    (big_vision: the head is the pool)."""
    return not (cfg.pool_type == "map" and cfg.width == embed_dim)


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
    visual: VisionTransformer,
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
) -> torch.Tensor:
    """Images [B, H, W, 3] -> pooled features [B, embed_dim] (float32).
    ``attention`` and ``ln_linear`` select the routes of
    :meth:`layers.ResidualAttentionBlock.forward`; ``remat`` rematerialises
    each block (:class:`layers.Transformer`). ``train`` applies the config's
    patch dropout, drawn from ``generator``; ``map_head`` is the MAP head of a
    tower that pools with one."""
    cfg = visual.cfg
    if cfg.no_cls_token and cfg.pool_type == "tok":
        raise ValueError("pool_type='tok' needs a class token; this config sets "
                         "no_cls_token — use pool_type 'map' or 'avg'")
    act = layers.activation(quick_gelu, gelu_tanh)
    B = images.shape[0]
    P = cfg.patch_size
    # conv1.weight [D, 3, P, P] -> [D, P*P*3] in patchify's (i, j, c) order
    w = visual.conv1.weight.permute(0, 2, 3, 1).reshape(cfg.width, P * P * 3)
    x = layers.dense(patchify(images, P), w, None, dtype)               # [B, N, D]
    if not cfg.no_cls_token:
        x = torch.cat([visual.class_embedding.to(dtype).expand(B, 1, cfg.width), x], dim=1)
    pos = visual.positional_embedding
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
    if pack_pairs:
        if B % 2:
            raise ValueError(f"pair-packing needs an even batch, got {B}")
        seg = torch.arange(1, 3, dtype=torch.int32, device=x.device).repeat_interleave(L)
        x = visual.transformer(
            x.reshape(B // 2, 2 * L, cfg.width), causal=False, act=act, dtype=dtype,
            seg_ids=seg.expand(B // 2, 2 * L), attention=attention, ln_linear=ln_linear,
            remat=remat)
        x = x.reshape(B, L, cfg.width)
    else:
        x = visual.transformer(x, causal=False, act=act, dtype=dtype, attention=attention,
                               ln_linear=ln_linear, remat=remat)

    off = 0 if cfg.no_cls_token else 1
    if cfg.pool_type == "map":
        pooled = siglip_map_head(visual.ln_post(x), map_head, cfg.heads, dtype, cfg.ln_eps)
    elif cfg.final_ln_after_pool:
        pooled = visual.ln_post(x[:, off:].mean(dim=1) if cfg.pool_type == "avg" else x[:, 0])
    else:
        x = visual.ln_post(x)
        pooled = x[:, off:].mean(dim=1) if cfg.pool_type == "avg" else x[:, 0]
    if hasattr(visual, "proj"):
        pooled = layers.dense(pooled, visual.proj.t(), None, dtype)
    return pooled.float()
