"""Forward flash attention on the packed QKV projection: Hopper kernels and
their plain PyTorch versions.

Port of the forward half of ``latteclip_tpu/kernels/attention.py``:

* ``flash_attention_qkv`` launches ``csrc/flash_fwd.cu::latteclip_flash_fwd``,
  which replaces the TPU kernel ``_fwd_kernel`` (``_flash_fwd_impl``);
* ``flash_attention_qkv_segmented`` launches ``latteclip_flash_fwd_seg``,
  which replaces ``_fwd_kernel_seg`` (``_flash_fwd_seg_impl``).

Both read q, k and v straight from ``qkv [B, L, 3*H*D]`` (laid out
``[q | k | v]``) and return ``(out [B, L, H*D], lse2 [B, H, L])``, the
base-2 logsumexp the backward kernels will need. ``flash_fwd_plain`` and
``flash_fwd_seg_plain`` compute the same function in plain PyTorch, repeating
the TPU kernel's rounding step by step; the wrappers take them only for a
tensor on the CPU, and a CUDA tensor either launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e9
LOG2E = math.log2(math.e)
KERNEL_HEAD_DIMS = (64, 128)

# Launches of each kernel in this process (chip_smoke.py resets and reads them).
launch_counts = {"flash_fwd": 0, "flash_fwd_seg": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _split_heads(qkv: torch.Tensor, num_heads: int):
    B, L, HD3 = qkv.shape
    if HD3 % (3 * num_heads):
        raise ValueError(f"qkv width {HD3} is not 3 * {num_heads} heads * head_dim")
    D = HD3 // 3 // num_heads
    x = qkv.reshape(B, L, 3, num_heads, D)
    return x[:, :, 0].transpose(1, 2), x[:, :, 1].transpose(1, 2), x[:, :, 2].transpose(1, 2), D


def _attend_plain(qkv: torch.Tensor, num_heads: int, visible: Optional[torch.Tensor]):
    """The TPU kernel's arithmetic in the dtype of ``qkv``: bf16 rounding of
    the scaled q and of the probabilities, f32 scores, sums and PV. With a
    float32 ``qkv`` every step runs in float32. ``visible`` broadcasts to
    [B, H, L, L] (True = key visible) or is None."""
    dt = qkv.dtype
    B, L, _ = qkv.shape
    q, k, v, D = _split_heads(qkv, num_heads)
    qscale = (D ** -0.5) * LOG2E
    qs = (q.float() * qscale).to(dt).float()
    s = torch.matmul(qs, k.to(dt).float().transpose(-1, -2))     # [B, H, L, L] f32
    if visible is not None:
        s = s + torch.where(visible, 0.0, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m).to(dt).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.to(dt).float()) / l
    out = o.to(dt).transpose(1, 2).reshape(B, L, num_heads * D)
    lse2 = (m + torch.log2(l))[..., 0]
    return out, lse2


def _causal_visible(L: int, device) -> torch.Tensor:
    idx = torch.arange(L, device=device)
    return idx[None, :] <= idx[:, None]


def flash_fwd_plain(qkv: torch.Tensor, num_heads: int, causal: bool):
    """Plain version of ``_fwd_kernel``: ``(out, lse2)``."""
    visible = _causal_visible(qkv.shape[1], qkv.device) if causal else None
    return _attend_plain(qkv, num_heads, visible)


def flash_fwd_seg_plain(qkv: torch.Tensor, seg_ids: torch.Tensor, num_heads: int, causal: bool):
    """Plain version of ``_fwd_kernel_seg``: tokens see only their own
    segment (seg 0 = padding, which sees the padding), causally when
    ``causal``. Returns ``(out, lse2)``."""
    visible = seg_ids[:, :, None] == seg_ids[:, None, :]
    if causal:
        visible = visible & _causal_visible(qkv.shape[1], qkv.device)
    return _attend_plain(qkv, num_heads, visible[:, None])


def _check_cuda_qkv(qkv: torch.Tensor, num_heads: int) -> Tuple[int, int, int, int]:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, L, 3*H*D], got shape {tuple(qkv.shape)}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bfloat16 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    B, L, HD3 = qkv.shape
    if HD3 % (3 * num_heads):
        raise ValueError(f"qkv width {HD3} is not 3 * {num_heads} heads * head_dim")
    D = HD3 // 3 // num_heads
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {D}")
    if B == 0 or L == 0:
        raise ValueError(f"empty qkv {tuple(qkv.shape)}")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the forward kernels have no backward yet: call under torch.no_grad()")
    return B, L, num_heads, D


def _library():
    from latteclip_torch.kernels import build

    lib = build.load()
    if not getattr(lib, "_latteclip_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.latteclip_flash_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, ptr]
        lib.latteclip_flash_fwd.restype = i32
        lib.latteclip_flash_fwd_seg.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, ptr]
        lib.latteclip_flash_fwd_seg.restype = i32
        lib._latteclip_typed = True
    return lib


def _outputs(qkv: torch.Tensor, B: int, L: int, H: int, D: int):
    out = torch.empty((B, L, H * D), dtype=qkv.dtype, device=qkv.device)
    lse2 = torch.empty((B, H, L), dtype=torch.float32, device=qkv.device)
    return out, lse2


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int, causal: bool = False):
    """Fused attention on ``qkv [B, L, 3*H*D]`` -> ``(out, lse2)``.

    A CUDA tensor launches the Hopper kernel (bf16, head_dim 64 or 128) and
    raises on anything else; a CPU tensor takes :func:`flash_fwd_plain`."""
    if not qkv.is_cuda:
        return flash_fwd_plain(qkv, num_heads, causal)
    B, L, H, D = _check_cuda_qkv(qkv, num_heads)
    lib = _library()
    out, lse2 = _outputs(qkv, B, L, H, D)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = lib.latteclip_flash_fwd(
            qkv.data_ptr(), out.data_ptr(), lse2.data_ptr(), B, L, H, D,
            int(causal), (D ** -0.5) * LOG2E, stream)
    _raise_on(err, "latteclip_flash_fwd")
    launch_counts["flash_fwd"] += 1
    return out, lse2


def flash_attention_qkv_segmented(
    qkv: torch.Tensor, num_heads: int, seg_ids: torch.Tensor, causal: bool = True
):
    """Segment-masked fused attention on packed rows ``qkv [R, P, 3*H*D]``
    with ``seg_ids [R, P]`` (int32, 0 = padding) -> ``(out, lse2)``.

    A CUDA tensor launches the Hopper kernel and raises on what it does not
    take; a CPU tensor takes :func:`flash_fwd_seg_plain`."""
    if not qkv.is_cuda:
        return flash_fwd_seg_plain(qkv, seg_ids, num_heads, causal)
    B, L, H, D = _check_cuda_qkv(qkv, num_heads)
    if (seg_ids.device != qkv.device or seg_ids.dtype != torch.int32
            or tuple(seg_ids.shape) != (B, L) or not seg_ids.is_contiguous()):
        raise ValueError(
            f"seg_ids must be a contiguous int32 [{B}, {L}] tensor on {qkv.device}, got "
            f"{seg_ids.dtype} {tuple(seg_ids.shape)} on {seg_ids.device}")
    lib = _library()
    out, lse2 = _outputs(qkv, B, L, H, D)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = lib.latteclip_flash_fwd_seg(
            qkv.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), lse2.data_ptr(),
            B, L, H, D, int(causal), (D ** -0.5) * LOG2E, stream)
    _raise_on(err, "latteclip_flash_fwd_seg")
    launch_counts["flash_fwd_seg"] += 1
    return out, lse2
