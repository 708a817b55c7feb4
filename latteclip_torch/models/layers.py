"""Transformer building blocks (port of ``latteclip_tpu/models/layers.py``).

Precision policy as in the JAX package: parameters live in float32, matmul
inputs and activations use the compute dtype, LayerNorm statistics are taken
in float32. Modules carry OpenCLIP's parameter names
(``resblocks.{i}.attn.in_proj_weight``, ``mlp.c_fc.weight``, ...), so an
OpenCLIP state dict loads with ``strict=True``. Weights keep torch's
``[out, in]`` orientation and go through ``F.linear``. ``layer_norm`` and
``dense`` come from :mod:`latteclip_torch.kernels.fused_ln_linear`, whose
``ln_linear`` runs the two LayerNorm -> projection pairs of each block. On a
CUDA tensor ``dense`` adds each projection's bias in the product's epilogue,
to the float32 accumulator before the output's one rounding, as the fused
kernel does; on the CPU it adds it in the compute dtype after the rounded
product, as the JAX package's ``dense`` does.

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

from latteclip_torch import mesh as mesh_mod
from latteclip_torch.kernels import (
    AttentionResiduals,
    attention_core_qkv,
    attention_core_qkv_segmented,
)
from latteclip_torch.kernels import fused_ln_linear as fused
from latteclip_torch.kernels.fused_ln_linear import LN_EPS, dense, layer_norm
from latteclip_torch.obs.trace import counter_dict, span

# Blocks run under remat (one per forward of _BlockRemat) and recomputed
# (one per backward of it).
remat_counts = counter_dict("layers.remat_counts", ("blocks", "recomputed"))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU (flax's ``nn.gelu`` default, which the
    SigLIP towers use)."""
    return F.gelu(x, approximate="tanh")


def activation(quick: bool, tanh: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """The towers' MLP activation: QuickGELU first, then tanh GELU, else
    exact GELU (JAX ``vit_forward``/``text_forward``)."""
    return quick_gelu if quick else (gelu_tanh if tanh else gelu)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), computed in float32, returned in x's dtype."""
    return F.normalize(x.float(), dim=dim, eps=eps).to(x.dtype)


NEG_INF = -1e9  # the additive mask value of the JAX package's masked attention


def _softmax(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The float32 softmax of :func:`plain_attention` on q already scaled
    and rounded."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        logits.add_(bias.float())
    return torch.softmax(logits, dim=-1)


class _PlainAttention(torch.autograd.Function):
    """:func:`plain_attention` whose backward recomputes the softmax from q,
    k and v (kept in ``dtype``) instead of keeping its float32 logits,
    softmax and copies alive between the passes; the gradient is autograd's
    of the same ops, casts included (the probabilities' cotangent rounded to
    ``dtype``, as JAX's transpose of the cast gives it)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, dtype):
        ctx.save_for_backward(q, k, v, bias)
        ctx.dtype = dtype
        probs = _softmax(q, k, bias).to(dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        p = _softmax(q, k, bias)
        probs = p.to(ctx.dtype)
        dout = dout.float()
        dprobs = torch.einsum("bqhd,bkhd->bhqk", dout, v.float()).to(ctx.dtype).float()
        dv = torch.einsum("bhqk,bqhd->bkhd", probs.float(), dout).to(v.dtype)
        dlogits = p * (dprobs - (dprobs * p).sum(dim=-1, keepdim=True))
        dq = torch.einsum("bhqk,bkhd->bqhd", dlogits, k.float()).to(q.dtype)
        dk = torch.einsum("bhqk,bqhd->bkhd", dlogits, q.float()).to(k.dtype)
        dbias = dlogits.sum_to_size(bias.shape).to(bias.dtype) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, dtype: torch.dtype,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """JAX's ``xla_attention``, in plain torch: q [B, Lq, H, d], k and v
    [B, Lk, H, d] -> [B, Lq, H, d] in ``dtype``. q times ``scale`` (default
    d^-1/2) is rounded to ``dtype``; the logits are float32 products of the
    ``dtype`` operands, plus ``bias`` (float32, broadcast to [B, H, Lq, Lk]:
    padding, causal or relative-position terms, a learned one for T5); the
    softmax is float32, rounded to ``dtype`` before the float32 products
    with v. CoCa's masked and cross attention, its attentional pool and the
    HF towers run here, as JAX runs them on XLA. The backward recomputes
    the softmax (:class:`_PlainAttention`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _PlainAttention.apply((q * scale).to(dtype), k.to(dtype), v.to(dtype), bias, dtype)


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


class EvaAttention(nn.Module):
    """The parameters of an EVA attention (timm's ``q_bias``/``v_bias`` or
    ``q_proj``/``v_proj`` biases, set by the tower) and ``k_bias``, the key
    slice of the JAX package's packed in-projection bias. timm keeps that
    slice at zero; JAX's tree holds it as a parameter that trains, and its
    checkpoints drop it. So does this module: ``k_bias`` trains, stays out of
    the state dict, and loads as zeros from a state dict without it."""

    def __init__(self, width: int):
        super().__init__()
        self.k_bias = nn.Parameter(torch.zeros(width))

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        destination.pop(prefix + "k_bias", None)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.setdefault(prefix + "k_bias", torch.zeros_like(self.k_bias))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class Mlp(nn.Module):
    """A block's MLP, ``c_fc`` then ``c_proj``. ``tp`` is the mesh whose
    model group holds its shards under tensor parallelism (set by
    :func:`latteclip_torch.mesh.shard_train_state`), else None."""

    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)
        self.tp = None


class LayerScale(nn.Module):
    """OpenCLIP's ``LayerScale``: a learned per-channel ``gamma``."""

    def __init__(self, width: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(width))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN residual attention block (OpenCLIP ``ResidualAttentionBlock``);
    with ``layer_scale`` its ``ls_1.gamma`` and ``ls_2.gamma`` scale the
    attention and MLP branches before each joins the residual (JAX
    ``ls_1_gamma``/``ls_2_gamma``)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float, ln_eps: float = LN_EPS,
                 layer_scale: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=ln_eps)
        self.attn = Attention(width, heads)
        self.ln_2 = LayerNorm(width, eps=ln_eps)
        self.mlp = Mlp(width, int(width * mlp_ratio))
        self.ls_1 = LayerScale(width) if layer_scale else None
        self.ls_2 = LayerScale(width) if layer_scale else None

    def forward(self, x: torch.Tensor, *, causal: bool, act, dtype: torch.dtype,
                seg_ids: Optional[torch.Tensor] = None, attention: str = "kernel",
                ln_linear: str = "unfused",
                residuals: Optional[AttentionResiduals] = None) -> torch.Tensor:
        """``ln_linear`` routes the two LayerNorm -> projection pairs
        (``fused.ln_linear``); ``attention`` the attention (``kernels``);
        ``residuals`` records or replays its output under remat."""
        return pre_norm_block(
            x, self.ln_1, self.attn.in_proj_weight, self.attn.in_proj_bias, self.attn.heads,
            self.attn.out_proj, self.ln_2, self.mlp.c_fc, self.mlp.c_proj,
            self.ls_1.gamma if self.ls_1 is not None else None,
            self.ls_2.gamma if self.ls_2 is not None else None,
            causal=causal, act=act, dtype=dtype, seg_ids=seg_ids, attention=attention,
            ln_linear=ln_linear, residuals=residuals, tp=self.mlp.tp)


def pre_norm_block(x: torch.Tensor, ln_1: nn.LayerNorm, in_w: torch.Tensor,
                   in_b: torch.Tensor, heads: int, out_proj: nn.Linear, ln_2: nn.LayerNorm,
                   fc: nn.Linear, proj: nn.Linear, ls_1: Optional[torch.Tensor],
                   ls_2: Optional[torch.Tensor], *, causal: bool, act, dtype: torch.dtype,
                   seg_ids: Optional[torch.Tensor] = None, attention: str = "kernel",
                   ln_linear: str = "unfused",
                   residuals: Optional[AttentionResiduals] = None, tp=None) -> torch.Tensor:
    """JAX's ``residual_block`` on one block's parts, whatever their names
    (OpenCLIP's or timm's): ``x + ls_1 * attn(ln_1(x))``, then
    ``+ ls_2 * mlp(ln_2(.))``; ``tp``: the MLP's mesh (:func:`mlp`)."""
    qkv = fused.ln_linear(x, ln_1.weight, ln_1.bias, in_w, in_b, dtype, ln_1.eps, ln_linear)
    if seg_ids is not None:
        a = attention_core_qkv_segmented(qkv, heads, seg_ids, causal, attention, residuals)
    else:
        a = attention_core_qkv(qkv, heads, causal, attention, residuals)
    a = dense(a, out_proj.weight, out_proj.bias, dtype)
    if ls_1 is not None:
        a = a * ls_1.to(dtype)
    x = x + a
    h = mlp(x, ln_2, fc, proj, act, dtype, ln_linear, tp)
    if ls_2 is not None:
        h = h * ls_2.to(dtype)
    return x + h


def mlp(x: torch.Tensor, ln: nn.LayerNorm, fc: nn.Linear, proj: nn.Linear, act,
        dtype: torch.dtype, ln_linear: str = "unfused", tp=None) -> torch.Tensor:
    """``proj(act(fc(ln(x))))`` with the LayerNorm -> ``fc`` pair on
    ``ln_linear``'s route. Under tensor parallelism (``tp`` a mesh, ``fc``
    and ``proj`` this rank's shards) Megatron's pair brackets it: ``x`` and
    the LayerNorm's parameters enter through ``copy_to_model``, the partial
    ``proj`` products (float32 products of ``dtype`` operands, not rounded)
    are summed over the model group and rounded once, and ``proj``'s bias
    is added after the sum: the roundings of :func:`dense` on the whole
    product on the CPU (on CUDA ``dense`` adds the bias before the one
    rounding)."""
    ln_w, ln_b = ln.weight, ln.bias
    if tp is not None:
        x, ln_w, ln_b = mesh_mod.copy_to_model(tp, x, ln_w, ln_b)
    h = act(fused.ln_linear(x, ln_w, ln_b, fc.weight, fc.bias, dtype, ln.eps, ln_linear))
    if tp is None:
        return dense(h, proj.weight, proj.bias, dtype)
    h = mesh_mod.reduce_from_model(float32_product(h.to(dtype), proj.weight.to(dtype)), tp)
    return h.to(dtype) + proj.bias.to(dtype)


class _Float32Product(torch.autograd.Function):
    """``x @ w.T`` of two CUDA tensors of one dtype, written out as the
    tensor cores' float32 accumulator (``torch.mm(..., out_dtype=float32)``,
    which has no derivative); the backward takes the products in the
    operands' dtype from the cotangent rounded to it, as autograd gives
    :func:`dense`'s."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype).reshape(-1, w.shape[0])
        return (g @ w).reshape(x.shape), g.t() @ x.reshape(-1, x.shape[-1])


def float32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in float32 from operands of one dtype: on CUDA the
    tensor-core product with its float32 accumulator written out
    (:class:`_Float32Product`), on the CPU the float32 product of the same
    values."""
    if not x.is_cuda or x.dtype == torch.float32:
        return F.linear(x.float(), w.float())
    return _Float32Product.apply(x, w)


class _BlockRemat(torch.autograd.Function):
    """One block, rematerialised: ``forward`` runs it without autograd and
    keeps its input and its attention residuals; ``backward`` runs it again
    with autograd, replaying the attention, and differentiates that. The
    second forward, the cost of remat, runs inside a ``recompute`` span timed
    on the stream; on CUDA the backward runs on autograd's device thread,
    where the span has no parent and its events go on that thread's current
    stream, which autograd sets to the stream the forward ran on."""

    @staticmethod
    def forward(ctx, x, block, kwargs, *params):
        remat_counts["blocks"] += 1
        residuals = AttentionResiduals()
        with torch.no_grad():
            y = block(x, residuals=residuals, **kwargs)
        ctx.block, ctx.kwargs, ctx.residuals = block, kwargs, residuals
        ctx.save_for_backward(x)
        return y

    @staticmethod
    def backward(ctx, dy):
        remat_counts["recomputed"] += 1
        (x,) = ctx.saved_tensors
        x = x.detach().requires_grad_(True)
        ctx.residuals.replay = True
        params = tuple(ctx.block.parameters())
        with span("recompute", stream=True), torch.enable_grad():
            y = ctx.block(x, residuals=ctx.residuals, **ctx.kwargs)
        grads = torch.autograd.grad(y, (x,) + params, dy, allow_unused=True)
        return (grads[0], None, None) + grads[1:]


class Transformer(nn.Module):
    """A stack of residual blocks, run as a Python loop (``resblocks.{i}``)."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float,
                 ln_eps: float = LN_EPS, layer_scale: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, ln_eps, layer_scale)
            for _ in range(layers))

    def forward(self, x: torch.Tensor, *, causal: bool, act, dtype: torch.dtype,
                seg_ids: Optional[torch.Tensor] = None, attention: str = "kernel",
                ln_linear: str = "unfused", remat: bool = False) -> torch.Tensor:
        return run_blocks(self.resblocks, x, remat, causal=causal, act=act, dtype=dtype,
                          seg_ids=seg_ids, attention=attention, ln_linear=ln_linear)


def run_blocks(blocks, x: torch.Tensor, remat: bool = False, **kwargs) -> torch.Tensor:
    """Run ``blocks`` in order on ``x``, each called as ``block(x, **kwargs)``
    (and ``residuals=`` under remat, :class:`_BlockRemat`); ``remat`` only
    where autograd records."""
    remat = remat and torch.is_grad_enabled()
    for block in blocks:
        if remat:
            x = _BlockRemat.apply(x, block, kwargs, *block.parameters())
        else:
            x = block(x, **kwargs)
    return x
