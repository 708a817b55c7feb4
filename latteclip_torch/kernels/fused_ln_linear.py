"""LayerNorm -> linear, fused: the Hopper kernel, its plain PyTorch version,
the autograd Function and the dispatch (port of
``latteclip_tpu/kernels/fused_ln_linear.py``).

``fused_ln_linear`` launches ``csrc/ln_linear.cu::latteclip_ln_linear``, which
replaces the TPU kernel ``_kernel`` (``_fwd_pallas``): LayerNorm with float32
statistics (population variance, eps 1e-5), the affine map, one rounding to
bf16, then ``xn . bf16(W)^T`` accumulated in float32 with the bias added to
the accumulator before the one rounding of the output. The unfused route,
``dense(layer_norm(x))``, rounds the product first and adds the bias in the
compute dtype, so the two routes round differently and :func:`ln_linear`
follows the JAX package's rule for which one a pair takes. ``FusedLnLinear``'s
gradient is that of the unfused composition, as JAX's ``_bwd`` is.

``layer_norm`` and ``dense`` live here, beside the kernel that fuses them;
:mod:`latteclip_torch.models.layers` re-exports them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
LN_LINEAR_CHOICES = ("unfused", "fused")
# the TPU kernel's VMEM budget: its batch-group rule decides which pairs fuse
_TPU_VMEM_BUDGET = 10 * 1024 * 1024

# Launches of the kernel in this process (chip_smoke.py resets and reads them).
launch_counts = {"ln_linear": 0}


def reset_launch_counts() -> None:
    launch_counts["ln_linear"] = 0


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to the input dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight.T`` emitted in ``dtype``; the bias is added in ``dtype``
    after the product, as the JAX package does."""
    y = F.linear(x.to(dtype), weight.to(dtype))
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def fused_route(b: int, l: int, d: int, o: int) -> bool:
    """Whether JAX fuses an LN -> projection pair on x [b, l, d] into o
    outputs: its ``_group_size(b, l, d, o) != 0``, the TPU kernel's VMEM
    rule, kept because it decides which rounding the reference gives."""
    w_bytes = d * o * 2
    return any(b % g == 0 and w_bytes + g * l * (d * 2 + d * 4 + o * 2) <= _TPU_VMEM_BUDGET
               for g in (8, 4, 2, 1))


def fused_ln_linear_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                          w: torch.Tensor, wb: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """Plain version of ``_kernel``: LayerNorm of ``x [..., D]`` in float32
    (mean, then the mean square of x - mean), the affine map, one bf16
    rounding; then float32 products of that and ``bf16(w)`` (``w [O, D]``),
    the float32 bias ``wb [O]``, and one rounding to the dtype of ``x``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    xn = (x32 - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    xn = xn.to(torch.bfloat16).float()
    y = torch.matmul(xn, w.to(torch.bfloat16).float().t()) + wb.float()
    return y.to(x.dtype)


def _check_cuda(x, ln_w, ln_b, w, wb):
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"the CUDA kernel takes a contiguous 16-byte aligned bfloat16 x "
                         f"[B, L, D], got {x.dtype} {tuple(x.shape)}")
    D, O = x.shape[-1], w.shape[0]
    if D % 64 or O % 8:
        raise ValueError(f"the CUDA kernel takes D a multiple of 64 and O a multiple of 8, "
                         f"got D={D}, O={O}")
    for name, t, shape in (("ln_w", ln_w, (D,)), ("ln_b", ln_b, (D,)), ("w", w, (O, D)),
                           ("wb", wb, (O,))):
        if (t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous 16-byte aligned float32 {shape} "
                             f"tensor on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel():
    from latteclip_torch.kernels import build

    fn = build.load("ln_linear").latteclip_ln_linear
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_ln_linear(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w: torch.Tensor,
                    wb: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """``bf16(LN(x) . bf16(w)^T + wb)`` for ``x [B, L, D]``, ``w [O, D]``.

    A CUDA tensor launches the Hopper kernel (bf16 x, float32 parameters,
    D a multiple of 64, O of 8) and raises on anything else; a CPU tensor
    takes :func:`fused_ln_linear_plain`."""
    if not x.is_cuda:
        return fused_ln_linear_plain(x, ln_w, ln_b, w, wb, eps)
    _check_cuda(x, ln_w, ln_b, w, wb)
    B, L, D = x.shape
    O = w.shape[0]
    y = torch.empty((B, L, O), dtype=x.dtype, device=x.device)
    kernel = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = kernel(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(), wb.data_ptr(),
                     y.data_ptr(), B * L, D, O, eps, stream)
    if err:
        raise RuntimeError(f"latteclip_ln_linear launch failed with CUDA error {err}")
    launch_counts["ln_linear"] += 1
    return y


class FusedLnLinear(torch.autograd.Function):
    """``y = fused_ln_linear(x, ln_w, ln_b, w, wb)``; the gradient is that of
    ``dense(layer_norm(x, ln_w, ln_b), w, wb, x.dtype)`` (JAX ``_bwd``): the
    LayerNorm is recomputed under autograd, and the linear layer's gradient
    is taken as autograd takes it for ``dense``, with no second forward
    product. Saves the inputs only."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w, wb, eps: float):
        ctx.save_for_backward(x, ln_w, ln_b, w, wb)
        ctx.eps = eps
        return fused_ln_linear(x, ln_w, ln_b, w, wb, eps)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, w, wb = ctx.saved_tensors
        dt = x.dtype
        with torch.enable_grad():
            inputs = tuple(t.detach().requires_grad_(True) for t in (x, ln_w, ln_b))
            xn = layer_norm(*inputs, ctx.eps)
        dy = dy.to(dt)
        O, D = w.shape
        dxn = torch.matmul(dy, w.to(dt))
        dw = torch.matmul(dy.reshape(-1, O).t(), xn.detach().reshape(-1, D)).to(w.dtype)
        dwb = dy.reshape(-1, O).sum(dim=0).to(wb.dtype)
        dx, dln_w, dln_b = torch.autograd.grad(xn, inputs, dxn)
        return dx, dln_w, dln_b, dw, dwb, None


def ln_linear(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w: torch.Tensor,
              wb: torch.Tensor, dtype: torch.dtype, eps: float = LN_EPS,
              route: str = "unfused") -> torch.Tensor:
    """``LN(x) -> linear`` in ``dtype``: ``route="fused"`` takes the fused
    kernel (its plain version on the CPU) where JAX's ``ln_linear`` would,
    i.e. at eps 1e-5 on ``x [B, L, D]`` whose shape passes
    :func:`fused_route`; everything else is ``dense(layer_norm(x))``."""
    if route not in LN_LINEAR_CHOICES:
        raise ValueError(f"ln_linear must be one of {LN_LINEAR_CHOICES}, got {route!r}")
    if (route == "fused" and eps == LN_EPS and x.dim() == 3
            and fused_route(*x.shape, w.shape[0])):
        return FusedLnLinear.apply(x.to(dtype).contiguous(), ln_w, ln_b, w, wb, eps)
    return dense(layer_norm(x, ln_w, ln_b, eps), w, wb, dtype)
