"""Flash attention on the packed QKV projection: Hopper kernels, their plain
PyTorch versions and the autograd Functions around them.

Port of ``latteclip_tpu/kernels/attention.py``:

* ``flash_attention_qkv`` launches ``csrc/flash_fwd.cu::latteclip_flash_fwd``,
  which replaces the TPU kernel ``_fwd_kernel`` (``_flash_fwd_impl``);
* ``flash_attention_qkv_segmented`` launches ``latteclip_flash_fwd_seg``,
  which replaces ``_fwd_kernel_seg`` (``_flash_fwd_seg_impl``);
* ``flash_attention_qkv_bwd`` launches ``csrc/flash_bwd.cu::latteclip_flash_bwd``,
  which replaces ``_bwd_kernel`` (``_make_fa``'s backward);
* ``flash_attention_qkv_segmented_bwd`` launches ``latteclip_flash_bwd_seg``,
  which replaces ``_bwd_kernel_seg`` (``_make_fa_seg``'s backward).

The forwards read q, k and v straight from ``qkv [B, L, 3*H*D]`` (laid out
``[q | k | v]``) and return ``(out [B, L, H*D], lse2 [B, H, L])``, the
base-2 logsumexp; the backwards take those residuals and the cotangent of
``out`` and return ``dqkv`` in the layout of ``qkv``. ``FlashAttention`` and
``FlashAttentionSegmented`` pair them as ``torch.autograd.Function``s, with
``(qkv, out, lse2)`` (and ``seg_ids``) saved, the JAX package's residuals.
``flash_{fwd,bwd}{,_seg}_plain`` compute the same functions in plain PyTorch,
repeating the TPU kernels' rounding step by step; the wrappers take them only
for a tensor on the CPU, and a CUDA tensor either launches the kernel or
raises.
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
launch_counts = {"flash_fwd": 0, "flash_fwd_seg": 0, "flash_bwd": 0, "flash_bwd_seg": 0}


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


def _backward_plain(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                    lse2: torch.Tensor, num_heads: int, visible: Optional[torch.Tensor]):
    """The TPU backward kernel's arithmetic in the dtype of ``qkv``: p is
    recomputed from lse2 in f32 and rounded to pb for dv; delta is the f32
    row sum of do * out; ds = p * (dp - delta) * D^-1/2 is rounded once; the
    five products accumulate in f32 and each gradient is rounded once. With a
    float32 ``qkv`` every step runs in float32. ``visible`` as in
    :func:`_attend_plain`. Returns ``dqkv`` shaped like ``qkv``."""
    dt = qkv.dtype
    B, L, _ = qkv.shape
    q, k, v, D = _split_heads(qkv, num_heads)
    q, k, v = q.float(), k.float(), v.float()
    o = out.to(dt).reshape(B, L, num_heads, D).transpose(1, 2).float()
    do = dout.to(dt).reshape(B, L, num_heads, D).transpose(1, 2).float()
    scale = D ** -0.5
    qs = (q * (scale * LOG2E)).to(dt).float()
    s = torch.matmul(qs, k.transpose(-1, -2))                        # [B, H, L, L] f32
    if visible is not None:
        s = s + torch.where(visible, 0.0, NEG_INF)
    p = torch.exp2(s - lse2[..., None].float())
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv], dim=2).to(dt)                   # [B, H, 3, L, D]
    return dqkv.permute(0, 3, 2, 1, 4).reshape(B, L, 3 * num_heads * D)


def _causal_visible(L: int, device) -> torch.Tensor:
    idx = torch.arange(L, device=device)
    return idx[None, :] <= idx[:, None]


def _seg_visible(seg_ids: torch.Tensor, causal: bool) -> torch.Tensor:
    """[B, 1, L, L]: same segment (seg 0 = padding, which sees the padding),
    and causal when ``causal``."""
    visible = seg_ids[:, :, None] == seg_ids[:, None, :]
    if causal:
        visible = visible & _causal_visible(seg_ids.shape[1], seg_ids.device)
    return visible[:, None]


def flash_fwd_plain(qkv: torch.Tensor, num_heads: int, causal: bool):
    """Plain version of ``_fwd_kernel``: ``(out, lse2)``."""
    visible = _causal_visible(qkv.shape[1], qkv.device) if causal else None
    return _attend_plain(qkv, num_heads, visible)


def flash_fwd_seg_plain(qkv: torch.Tensor, seg_ids: torch.Tensor, num_heads: int, causal: bool):
    """Plain version of ``_fwd_kernel_seg``: tokens see only their own
    segment (seg 0 = padding, which sees the padding), causally when
    ``causal``. Returns ``(out, lse2)``."""
    return _attend_plain(qkv, num_heads, _seg_visible(seg_ids, causal))


def flash_bwd_plain(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                    lse2: torch.Tensor, num_heads: int, causal: bool) -> torch.Tensor:
    """Plain version of ``_bwd_kernel``: ``dqkv [B, L, 3*H*D]``."""
    visible = _causal_visible(qkv.shape[1], qkv.device) if causal else None
    return _backward_plain(qkv, out, dout, lse2, num_heads, visible)


def flash_bwd_seg_plain(qkv: torch.Tensor, seg_ids: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse2: torch.Tensor, num_heads: int,
                        causal: bool) -> torch.Tensor:
    """Plain version of ``_bwd_kernel_seg``: ``dqkv [R, P, 3*H*D]``."""
    return _backward_plain(qkv, out, dout, lse2, num_heads, _seg_visible(seg_ids, causal))


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
    return B, L, num_heads, D


def _check_seg(seg_ids: torch.Tensor, qkv: torch.Tensor, B: int, L: int) -> None:
    if (seg_ids.device != qkv.device or seg_ids.dtype != torch.int32
            or tuple(seg_ids.shape) != (B, L) or not seg_ids.is_contiguous()):
        raise ValueError(
            f"seg_ids must be a contiguous int32 [{B}, {L}] tensor on {qkv.device}, got "
            f"{seg_ids.dtype} {tuple(seg_ids.shape)} on {seg_ids.device}")


def _check_residual(name: str, x: torch.Tensor, qkv: torch.Tensor, shape, dtype) -> None:
    if (x.device != qkv.device or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(
            f"{name} must be a contiguous 16-byte aligned {dtype} {tuple(shape)} tensor on "
            f"{qkv.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


_SIGNATURES = {
    # name: argument kinds, "p" pointer, "i" int, "f" float; every one returns int
    "latteclip_flash_fwd": "pppiiiiifp",
    "latteclip_flash_fwd_seg": "ppppiiiiifp",
    "latteclip_flash_bwd": "ppppppiiiiiffp",
    "latteclip_flash_bwd_seg": "pppppppiiiiiffp",
}


def _kernel(name: str):
    """The C entry point ``name`` with its ctypes signature set."""
    from latteclip_torch.kernels import build

    lib = build.load("flash_bwd" if "_bwd" in name else "flash_fwd")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
        fn.argtypes = [kinds[c] for c in _SIGNATURES[name]]
        fn.restype = ctypes.c_int
    return fn


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
    kernel = _kernel("latteclip_flash_fwd")
    out, lse2 = _outputs(qkv, B, L, H, D)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = kernel(
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
    _check_seg(seg_ids, qkv, B, L)
    kernel = _kernel("latteclip_flash_fwd_seg")
    out, lse2 = _outputs(qkv, B, L, H, D)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = kernel(
            qkv.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), lse2.data_ptr(),
            B, L, H, D, int(causal), (D ** -0.5) * LOG2E, stream)
    _raise_on(err, "latteclip_flash_fwd_seg")
    launch_counts["flash_fwd_seg"] += 1
    return out, lse2


def _launch_bwd(qkv, seg_ids, out, dout, lse2, num_heads, causal) -> torch.Tensor:
    """Check the residuals and launch ``latteclip_flash_bwd`` (``seg_ids``
    None) or ``latteclip_flash_bwd_seg``; returns ``dqkv``."""
    B, L, H, D = _check_cuda_qkv(qkv, num_heads)
    _check_residual("out", out, qkv, (B, L, H * D), torch.bfloat16)
    _check_residual("dout", dout, qkv, (B, L, H * D), torch.bfloat16)
    _check_residual("lse2", lse2, qkv, (B, H, L), torch.float32)
    segmented = seg_ids is not None
    if segmented:
        _check_seg(seg_ids, qkv, B, L)
    name = "latteclip_flash_bwd_seg" if segmented else "latteclip_flash_bwd"
    kernel = _kernel(name)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B, H, L), dtype=torch.float32, device=qkv.device)  # kernel scratch
    tensors = [qkv, *([seg_ids] if segmented else []), out, dout, lse2, delta, dqkv]
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = kernel(*(t.data_ptr() for t in tensors), B, L, H, D, int(causal),
                     (D ** -0.5) * LOG2E, D ** -0.5, stream)
    _raise_on(err, name)
    launch_counts["flash_bwd_seg" if segmented else "flash_bwd"] += 1
    return dqkv


def flash_attention_qkv_bwd(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                            lse2: torch.Tensor, num_heads: int, causal: bool = False) -> torch.Tensor:
    """Gradient of :func:`flash_attention_qkv`'s ``out`` -> ``dqkv [B, L, 3*H*D]``.

    A CUDA tensor launches the Hopper kernel (bf16, head_dim 64 or 128, every
    tensor contiguous) and raises on anything else; a CPU tensor takes
    :func:`flash_bwd_plain`."""
    if not qkv.is_cuda:
        return flash_bwd_plain(qkv, out, dout, lse2, num_heads, causal)
    return _launch_bwd(qkv, None, out, dout, lse2, num_heads, causal)


def flash_attention_qkv_segmented_bwd(
    qkv: torch.Tensor, seg_ids: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    lse2: torch.Tensor, num_heads: int, causal: bool = True,
) -> torch.Tensor:
    """Gradient of :func:`flash_attention_qkv_segmented`'s ``out`` ->
    ``dqkv [R, P, 3*H*D]``. A CUDA tensor launches the Hopper kernel and
    raises on what it does not take; a CPU tensor takes
    :func:`flash_bwd_seg_plain`."""
    if not qkv.is_cuda:
        return flash_bwd_seg_plain(qkv, seg_ids, out, dout, lse2, num_heads, causal)
    return _launch_bwd(qkv, seg_ids, out, dout, lse2, num_heads, causal)


def _kernel_ready(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``, contiguous and 16-byte aligned, copied only if not."""
    x = x.to(dtype).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


class FlashAttention(torch.autograd.Function):
    """``(out, lse2) = flash_attention_qkv(qkv)`` with the backward kernel as
    its gradient (JAX ``_make_fa``). lse2 is not differentiable: its cotangent
    is ignored, as in the JAX backward."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, causal: bool):
        out, lse2 = flash_attention_qkv(qkv, num_heads, causal)
        ctx.save_for_backward(qkv, out, lse2)
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.mark_non_differentiable(lse2)
        return out, lse2

    @staticmethod
    def backward(ctx, dout: torch.Tensor, _dlse2):
        qkv, out, lse2 = ctx.saved_tensors
        dqkv = flash_attention_qkv_bwd(qkv, out, _kernel_ready(dout, qkv.dtype), lse2,
                                       ctx.num_heads, ctx.causal)
        return dqkv, None, None


class FlashAttentionSegmented(torch.autograd.Function):
    """``(out, lse2) = flash_attention_qkv_segmented(qkv, seg_ids)`` with the
    segment-masked backward kernel as its gradient (JAX ``_make_fa_seg``).
    ``seg_ids`` and lse2 take no gradient."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, seg_ids: torch.Tensor, num_heads: int, causal: bool):
        out, lse2 = flash_attention_qkv_segmented(qkv, num_heads, seg_ids, causal)
        ctx.save_for_backward(qkv, seg_ids, out, lse2)
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.mark_non_differentiable(lse2)
        return out, lse2

    @staticmethod
    def backward(ctx, dout: torch.Tensor, _dlse2):
        qkv, seg_ids, out, lse2 = ctx.saved_tensors
        dqkv = flash_attention_qkv_segmented_bwd(
            qkv, seg_ids, out, _kernel_ready(dout, qkv.dtype), lse2, ctx.num_heads, ctx.causal)
        return dqkv, None, None, None
