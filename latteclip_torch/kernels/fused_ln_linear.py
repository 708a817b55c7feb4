"""LayerNorm -> linear, fused: the Hopper kernel, its plain PyTorch version,
the autograd Function and the dispatch (port of
``latteclip_tpu/kernels/fused_ln_linear.py``).

``fused_ln_linear`` launches ``csrc/ln_linear.cu::latteclip_ln_linear``, which
replaces the TPU kernel ``_kernel`` (``_fwd_pallas``): LayerNorm with float32
statistics (population variance, eps 1e-5), the affine map, one rounding to
bf16, then ``xn . bf16(W)^T`` accumulated in float32 with the bias added to
the accumulator before the one rounding of the output. The kernel takes W
already rounded to bf16 (the rounding the TPU kernel applies as it reads W),
made once per forward, and runs under the launch plan of
:func:`ln_linear_plan`, computed here so that the CPU tests hold it. The
unfused route, ``dense(layer_norm(x))``, rounds the product first and adds the bias in the
compute dtype, so the two routes round differently and :func:`ln_linear`
follows the JAX package's rule for which one a pair takes. ``FusedLnLinear``'s
gradient is that of the unfused composition, as JAX's ``_bwd`` is.

``layer_norm`` and ``dense`` live here, beside the kernel that fuses them;
:mod:`latteclip_torch.models.layers` re-exports them.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from latteclip_torch.device import sm_count
from latteclip_torch.kernels.attention import MAX_SMEM

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


# The launch plan of csrc/ln_linear.cu; the constants are the kernel's.
LN_PANEL = 64                 # inputs per shared panel and per W tile (128 bytes)
LN_TILES = ((128, 128), (64, 128), (64, 64))  # (rows, outputs) a CTA, first that fits
LN_MIN_STAGES, LN_MAX_STAGES = 2, 8
LN_ALIGN = 1024               # slack to align the swizzled buffers to 1024 bytes
LN_COST = 1.5                 # a row tile's LayerNorm, in units of one output tile's products


@dataclasses.dataclass(frozen=True)
class LnLinearPlan:
    """How ``ln_linear_kernel`` runs ``x [M, D] -> [M, O]``: ``bm`` rows and
    ``bn`` outputs a tile, ``n_splits`` CTAs over the output tiles of one
    row tile, ``stages`` W tiles in the shared ring, and the CTA's dynamic
    shared memory."""
    bm: int
    bn: int
    n_splits: int
    stages: int
    smem_bytes: int


def ln_linear_smem_bytes(bm: int, bn: int, D: int, stages: int) -> int:
    """Shared memory of one CTA (mirrors ``smem_bytes`` in csrc/ln_linear.cu):
    alignment slack, xn [bm, D] bf16, ``stages`` W tiles [bn, 64] bf16 and
    2 * stages + 1 mbarriers."""
    return LN_ALIGN + bm * D * 2 + stages * bn * LN_PANEL * 2 + 8 * (2 * stages + 1)


def ln_linear_plan(M: int, D: int, O: int, sms: int) -> LnLinearPlan:
    """The launch plan of ``x [M, D] -> [M, O]`` on a card of ``sms`` SMs.

    * tile: the first of (128, 128), (64, 128), (64, 64) rows x outputs whose
      normalised rows and two W stages fit a CTA, with as many more stages
      as fit, up to 8 (one CTA an SM): at D = 512 three stages or more beat
      two; at D = 768 only two fit;
    * splits: a row tile's output tiles are split over ``n_splits`` CTAs,
      each recomputing the LayerNorm, to the count that minimises the waves
      times the work of a CTA, ``ceil(row_tiles * n / sms) * (LN_COST +
      ceil(n_tiles / n))``, the fewest splits on a tie: at the template
      site (3619 rows, 29 row tiles of 128) that fills the SMs, at the
      vision site (25600 rows, 200 row tiles) it trims the last wave.
    ``python -m latteclip_torch.tools.ln_linear_plans`` times other plans on
    the card (PERF.md keeps its numbers).
    """
    if M <= 0 or D <= 0 or O <= 0 or D % LN_PANEL or O % 8:
        raise ValueError(f"the fused LayerNorm -> linear kernel takes D a multiple of "
                         f"{LN_PANEL} and O a multiple of 8, got M={M}, D={D}, O={O}")
    for bm, bn in LN_TILES:
        fixed = ln_linear_smem_bytes(bm, bn, D, 0)
        stages = min(LN_MAX_STAGES, (MAX_SMEM - fixed) // (bn * LN_PANEL * 2 + 16))
        if stages >= LN_MIN_STAGES:
            break
    else:
        raise ValueError(f"the fused LayerNorm -> linear kernel takes D up to 1664, got D={D}")
    row_tiles, n_tiles = -(-M // bm), -(-O // bn)
    n_splits = min(range(1, n_tiles + 1),
                   key=lambda n: (-(-row_tiles * n // sms) * (LN_COST + -(-n_tiles // n)), n))
    return LnLinearPlan(bm, bn, n_splits, stages, ln_linear_smem_bytes(bm, bn, D, stages))


def _check_cuda(x, ln_w, ln_b, w, wb):
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"the CUDA kernel takes a contiguous 16-byte aligned bfloat16 x "
                         f"[B, L, D], got {x.dtype} {tuple(x.shape)}")
    D, O = x.shape[-1], w.shape[0]
    if D % 64 or O % 8:
        raise ValueError(f"the CUDA kernel takes D a multiple of 64 and O a multiple of 8, "
                         f"got D={D}, O={O}")
    for name, t, shape, dtype in (("ln_w", ln_w, (D,), torch.float32),
                                  ("ln_b", ln_b, (D,), torch.float32),
                                  ("w", w, (O, D), torch.bfloat16), ("wb", wb, (O,), torch.float32)):
        if (t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous 16-byte aligned {dtype} {shape} "
                             f"tensor on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel():
    from latteclip_torch.kernels import build

    fn = build.load("ln_linear").latteclip_ln_linear
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fused_ln_linear(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w: torch.Tensor,
                    wb: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """``bf16(LN(x) . bf16(w)^T + wb)`` for ``x [B, L, D]``, ``w [O, D]``.

    A CUDA tensor launches the Hopper kernel (bf16 x, float32 LayerNorm
    parameters and bias, D a multiple of 64, O of 8) on ``bf16(w)``, made
    here unless ``w`` is bf16 already, under :func:`ln_linear_plan`, and
    raises on anything else; a CPU tensor takes :func:`fused_ln_linear_plain`."""
    if not x.is_cuda:
        return fused_ln_linear_plain(x, ln_w, ln_b, w, wb, eps)
    w16 = w.to(torch.bfloat16)
    _check_cuda(x, ln_w, ln_b, w16, wb)
    B, L, D = x.shape
    O = w16.shape[0]
    plan = ln_linear_plan(B * L, D, O, sm_count(x.device.index))
    y = torch.empty((B, L, O), dtype=x.dtype, device=x.device)
    kernel = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = kernel(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w16.data_ptr(), wb.data_ptr(),
                     y.data_ptr(), B * L, D, O, eps, plan.bm, plan.bn, plan.n_splits, plan.stages,
                     stream)
    if err:
        raise RuntimeError(f"latteclip_ln_linear launch failed with CUDA error {err}")
    launch_counts["ln_linear"] += 1
    return y


class FusedLnLinear(torch.autograd.Function):
    """``y = fused_ln_linear(x, ln_w, ln_b, bf16(w), wb)``; the gradient is
    that of ``dense(layer_norm(x, ln_w, ln_b), w, wb, x.dtype)`` (JAX
    ``_bwd``): the LayerNorm is recomputed under autograd, and the linear
    layer's gradient is taken as autograd takes it for ``dense``, with no
    second forward product. ``bf16(w)`` is made once: the kernel reads it,
    and in bf16 it is also ``w.to(x.dtype)``, which the backward's
    ``dy . w`` takes, so it is saved beside the inputs."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w, wb, eps: float):
        w16 = w.to(torch.bfloat16)
        ctx.save_for_backward(x, ln_w, ln_b, w16 if x.dtype == torch.bfloat16 else w.to(x.dtype), wb)
        ctx.eps, ctx.w_dtype = eps, w.dtype
        return fused_ln_linear(x, ln_w, ln_b, w16, wb, eps)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, w_dt, wb = ctx.saved_tensors
        dt = x.dtype
        with torch.enable_grad():
            inputs = tuple(t.detach().requires_grad_(True) for t in (x, ln_w, ln_b))
            xn = layer_norm(*inputs, ctx.eps)
        dy = dy.to(dt)
        O, D = w_dt.shape
        dxn = torch.matmul(dy, w_dt)
        dw = torch.matmul(dy.reshape(-1, O).t(), xn.detach().reshape(-1, D)).to(ctx.w_dtype)
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
