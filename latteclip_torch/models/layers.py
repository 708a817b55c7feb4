"""Transformer building blocks (port of ``latteclip_tpu/models/layers.py``).

Precision policy as in the JAX package: parameters live in float32, matmul
inputs and activations use the compute dtype, LayerNorm statistics are taken
in float32. Modules carry OpenCLIP's parameter names
(``resblocks.{i}.attn.in_proj_weight``, ``mlp.c_fc.weight``, ...), so an
OpenCLIP state dict loads with ``strict=True``. Weights keep torch's
``[out, in]`` orientation and go through ``F.linear``. ``layer_norm`` and
``dense`` come from :mod:`latteclip_torch.kernels.fused_ln_linear`, whose
``ln_linear`` runs the two LayerNorm -> projection pairs of each block.

``Transformer.forward(remat=True)`` rematerialises each block, as JAX's
``jax.checkpoint`` with ``REMAT_SAVE_NAMES`` does (layers.py:39-43,
244-253): the forward keeps only the block's input and its attention's
``(out, lse2)``, and the backward recomputes the block's projections,
LayerNorms and activations from them but replays the attention output, so
no attention forward kernel launches twice.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from latteclip_torch.kernels import (
    AttentionResiduals,
    attention_core_qkv,
    attention_core_qkv_segmented,
)
from latteclip_torch.kernels import fused_ln_linear as fused
from latteclip_torch.kernels.fused_ln_linear import LN_EPS, dense, layer_norm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def activation(quick: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    return quick_gelu if quick else gelu


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), computed in float32, returned in x's dtype."""
    return F.normalize(x.float(), dim=dim, eps=eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with float32 statistics (OpenCLIP's LayerNormFp32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Attention(nn.Module):
    """``nn.MultiheadAttention``'s parameters: a fused in-projection and an
    out-projection. The attention itself runs on the fused projection
    output through :mod:`latteclip_torch.kernels`."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN residual attention block (OpenCLIP ``ResidualAttentionBlock``)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float, ln_eps: float = LN_EPS):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=ln_eps)
        self.attn = Attention(width, heads)
        self.ln_2 = LayerNorm(width, eps=ln_eps)
        self.mlp = Mlp(width, int(width * mlp_ratio))

    def forward(self, x: torch.Tensor, *, causal: bool, act, dtype: torch.dtype,
                seg_ids: Optional[torch.Tensor] = None, attention: str = "kernel",
                ln_linear: str = "unfused",
                residuals: Optional[AttentionResiduals] = None) -> torch.Tensor:
        """``ln_linear`` routes the two LayerNorm -> projection pairs
        (``fused.ln_linear``); ``attention`` the attention (``kernels``);
        ``residuals`` records or replays its output under remat."""
        qkv = fused.ln_linear(x, self.ln_1.weight, self.ln_1.bias, self.attn.in_proj_weight,
                              self.attn.in_proj_bias, dtype, self.ln_1.eps, ln_linear)
        if seg_ids is not None:
            a = attention_core_qkv_segmented(qkv, self.attn.heads, seg_ids, causal, attention,
                                             residuals)
        else:
            a = attention_core_qkv(qkv, self.attn.heads, causal, attention, residuals)
        x = x + dense(a, self.attn.out_proj.weight, self.attn.out_proj.bias, dtype)
        h = act(fused.ln_linear(x, self.ln_2.weight, self.ln_2.bias, self.mlp.c_fc.weight,
                                self.mlp.c_fc.bias, dtype, self.ln_2.eps, ln_linear))
        return x + dense(h, self.mlp.c_proj.weight, self.mlp.c_proj.bias, dtype)


class _BlockRemat(torch.autograd.Function):
    """One block, rematerialised: ``forward`` runs it without autograd and
    keeps its input and its attention residuals; ``backward`` runs it again
    with autograd, replaying the attention, and differentiates that."""

    @staticmethod
    def forward(ctx, x, block, kwargs, *params):
        residuals = AttentionResiduals()
        with torch.no_grad():
            y = block(x, residuals=residuals, **kwargs)
        ctx.block, ctx.kwargs, ctx.residuals = block, kwargs, residuals
        ctx.save_for_backward(x)
        return y

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        x = x.detach().requires_grad_(True)
        ctx.residuals.replay = True
        params = tuple(ctx.block.parameters())
        with torch.enable_grad():
            y = ctx.block(x, residuals=ctx.residuals, **ctx.kwargs)
        grads = torch.autograd.grad(y, (x,) + params, dy, allow_unused=True)
        return (grads[0], None, None) + grads[1:]


class Transformer(nn.Module):
    """A stack of residual blocks, run as a Python loop (``resblocks.{i}``)."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float,
                 ln_eps: float = LN_EPS):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, ln_eps) for _ in range(layers))

    def forward(self, x: torch.Tensor, *, causal: bool, act, dtype: torch.dtype,
                seg_ids: Optional[torch.Tensor] = None, attention: str = "kernel",
                ln_linear: str = "unfused", remat: bool = False) -> torch.Tensor:
        kwargs = dict(causal=causal, act=act, dtype=dtype, seg_ids=seg_ids, attention=attention,
                      ln_linear=ln_linear)
        remat = remat and torch.is_grad_enabled()
        for block in self.resblocks:
            if remat:
                x = _BlockRemat.apply(x, block, kwargs, *block.parameters())
            else:
                x = block(x, **kwargs)
        return x
