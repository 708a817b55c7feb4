"""Attention dispatch for the towers.

Port of ``latteclip_tpu/kernels/__init__.py`` (``attention_core_qkv`` and
``attention_core_qkv_segmented``). The route follows the JAX package's rule:
where JAX runs its Pallas kernels (head_dim 64 or 128), a bf16 CUDA tensor
runs the Hopper kernels, forward and, under autograd, backward (the
``torch.autograd.Function``s of :mod:`.attention`); where JAX goes to XLA,
the port runs the forward kernel's plain version and autograd differentiates
it: the vision towers whose heads are 72 (SO400M), 80 (the H-14
family), 104 (bigG) or 112 (ViT-e) wide run there, as JAX runs them on
XLA. A CPU tensor always runs the plain version. ``attention="plain"``
forces the plain version on the card too, for comparisons. A text tower
without a causal mask (SigLIP, CLIPA) runs the same kernels with
``causal=False``.

The JAX package's attention switches are the other values of ``attention``.
``"headsplit"`` (``LATTECLIP_ATTN_HEADSPLIT=1``) runs whole-row sites on the
head-split kernels where JAX's ``_head_split`` applies (D in {64, 128},
H divisible by 128 / D); ``"blockdiag"`` (``LATTECLIP_ATTN_BLOCKDIAG=1``)
runs whole-row sites of at most 128 tokens and 1024 columns on the
block-diagonal forward and the whole-row backward. Other whole-row sites of
those routes run the whole-row kernels, as JAX does, and segmented sites
always run the segment-masked kernels. JAX's two switches together break its
backward (the block-diagonal forward's lse2 layout meets the head-split
backward), a combination one ``attention`` value cannot express.
"""
from __future__ import annotations

from typing import Optional

import torch

from latteclip_torch.kernels.attention import (
    BLOCKDIAG_MAX_LEN,
    BLOCKDIAG_MAX_WIDTH,
    KERNEL_HEAD_DIMS,
    AttentionResiduals,
    FlashAttention,
    FlashAttentionBlockDiag,
    FlashAttentionHeadSplit,
    FlashAttentionSegmented,
    flash_fwd_bd_plain,
    flash_fwd_plain,
    flash_fwd_seg_plain,
    head_split,
)

ATTENTION_CHOICES = ("kernel", "headsplit", "blockdiag", "plain")
_WHOLE_ROW = {"kernel": FlashAttention, "headsplit": FlashAttentionHeadSplit,
              "blockdiag": FlashAttentionBlockDiag}


def kernel_route(qkv_width: int, num_heads: int, dtype: torch.dtype, device: torch.device,
                 attention: str = "kernel") -> bool:
    """True when attention at this width, dtype and device runs a CUDA kernel."""
    if attention not in ATTENTION_CHOICES:
        raise ValueError(f"attention must be one of {ATTENTION_CHOICES}, got {attention!r}")
    return (attention != "plain" and torch.device(device).type == "cuda"
            and dtype == torch.bfloat16 and qkv_width // 3 // num_heads in KERNEL_HEAD_DIMS)


def whole_row_route(attention: str, seq_len: int, num_heads: int, head_dim: int) -> str:
    """The route a whole-row site of ``attention`` takes, by JAX's rule:
    ``"headsplit"`` only where ``_head_split`` applies, ``"blockdiag"`` only
    at L <= 128 and H*D <= 1024 (attention.py:713), else ``"kernel"``;
    ``"plain"`` stays plain."""
    if attention == "headsplit" and not head_split(num_heads, head_dim):
        return "kernel"
    if attention == "blockdiag" and (seq_len > BLOCKDIAG_MAX_LEN
                                     or num_heads * head_dim > BLOCKDIAG_MAX_WIDTH):
        return "kernel"
    return attention


def _apply(fn, residuals, *args) -> torch.Tensor:
    return residuals.attend(fn, *args) if residuals is not None else fn.apply(*args)[0]


def attention_core_qkv(qkv: torch.Tensor, num_heads: int, causal: bool = False,
                       attention: str = "kernel",
                       residuals: Optional[AttentionResiduals] = None) -> torch.Tensor:
    """Attention on the packed projection ``qkv [B, L, 3*H*D]`` -> ``[B, L, H*D]``.
    ``residuals`` records or replays the kernels' ``(out, lse2)`` for a
    rematerialised block; the plain route recomputes instead."""
    _, L, HD3 = qkv.shape
    on_kernel = kernel_route(HD3, num_heads, qkv.dtype, qkv.device, attention)
    route = whole_row_route(attention, L, num_heads, HD3 // 3 // num_heads)
    if on_kernel:
        return _apply(_WHOLE_ROW[route], residuals, qkv.contiguous(), num_heads, causal)
    plain = flash_fwd_bd_plain if route == "blockdiag" else flash_fwd_plain
    return plain(qkv, num_heads, causal)[0]


def attention_core_qkv_segmented(qkv: torch.Tensor, num_heads: int, seg_ids: torch.Tensor,
                                 causal: bool = True, attention: str = "kernel",
                                 residuals: Optional[AttentionResiduals] = None) -> torch.Tensor:
    """Segment-masked attention on packed rows ``qkv [R, P, 3*H*D]``,
    ``seg_ids [R, P]`` (0 = padding) -> ``[R, P, H*D]``."""
    if kernel_route(qkv.shape[-1], num_heads, qkv.dtype, qkv.device, attention):
        seg = seg_ids.to(torch.int32).contiguous()
        return _apply(FlashAttentionSegmented, residuals, qkv.contiguous(), seg, num_heads, causal)
    return flash_fwd_seg_plain(qkv, seg_ids, num_heads, causal)[0]
