"""Attention dispatch for the towers.

Port of ``latteclip_tpu/kernels/__init__.py`` (``attention_core_qkv`` and
``attention_core_qkv_segmented``). The route follows the JAX package's rule:
where JAX runs its Pallas kernels (head_dim 64 or 128), a bf16 CUDA tensor
runs the Hopper kernels, forward and, under autograd, backward (the
``torch.autograd.Function``s of :mod:`.attention`); where JAX goes to XLA,
the port runs the forward kernel's plain version and autograd differentiates
it. A CPU tensor always runs the plain version. ``attention="plain"`` forces
the plain version on the card too, for comparisons.
"""
from __future__ import annotations

import torch

from latteclip_torch.kernels.attention import (
    KERNEL_HEAD_DIMS,
    FlashAttention,
    FlashAttentionSegmented,
    flash_fwd_plain,
    flash_fwd_seg_plain,
)

ATTENTION_CHOICES = ("kernel", "plain")


def kernel_route(qkv_width: int, num_heads: int, dtype: torch.dtype, device: torch.device,
                 attention: str = "kernel") -> bool:
    """True when attention at this width, dtype and device runs a CUDA kernel."""
    if attention not in ATTENTION_CHOICES:
        raise ValueError(f"attention must be one of {ATTENTION_CHOICES}, got {attention!r}")
    return (attention == "kernel" and torch.device(device).type == "cuda"
            and dtype == torch.bfloat16 and qkv_width // 3 // num_heads in KERNEL_HEAD_DIMS)


def attention_core_qkv(qkv: torch.Tensor, num_heads: int, causal: bool = False,
                       attention: str = "kernel") -> torch.Tensor:
    """Attention on the packed projection ``qkv [B, L, 3*H*D]`` -> ``[B, L, H*D]``."""
    if kernel_route(qkv.shape[-1], num_heads, qkv.dtype, qkv.device, attention):
        return FlashAttention.apply(qkv.contiguous(), num_heads, causal)[0]
    return flash_fwd_plain(qkv, num_heads, causal)[0]


def attention_core_qkv_segmented(qkv: torch.Tensor, num_heads: int, seg_ids: torch.Tensor,
                                 causal: bool = True, attention: str = "kernel") -> torch.Tensor:
    """Segment-masked attention on packed rows ``qkv [R, P, 3*H*D]``,
    ``seg_ids [R, P]`` (0 = padding) -> ``[R, P, H*D]``."""
    if kernel_route(qkv.shape[-1], num_heads, qkv.dtype, qkv.device, attention):
        seg = seg_ids.to(torch.int32).contiguous()
        return FlashAttentionSegmented.apply(qkv.contiguous(), seg, num_heads, causal)[0]
    return flash_fwd_seg_plain(qkv, seg_ids, num_heads, causal)[0]
