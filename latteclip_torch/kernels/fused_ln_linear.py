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
:func:`ln_linear_plan`, computed here so that the CPU tests hold it. On the
CPU the unfused route, ``dense(layer_norm(x))``, rounds the product first and adds the bias
in the compute dtype, so the two routes round differently and :func:`ln_linear`
follows the JAX package's rule for which one a pair takes; on CUDA ``dense`` adds
the bias in the product's epilogue, and rounds once too. ``FusedLnLinear``'s
gradient is that of the unfused composition, as JAX's ``_bwd`` is.

``layer_norm`` and ``dense`` live here, beside the kernel that fuses them;
:mod:`latteclip_torch.models.layers` re-exports them. On a CUDA tensor
``layer_norm`` runs ``csrc/layer_norm.cu``'s kernels (:class:`LayerNormFunction`
under autograd, the forward kernel alone otherwise), on the CPU its plain
version :func:`layer_norm_plain`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from latteclip_torch.device import sm_count
from latteclip_torch.kernels.attention import MAX_SMEM
from latteclip_torch.models.quantize import Int8Weight, int8_dense
from latteclip_torch.obs.trace import counter_dict

LN_EPS = 1e-5
LN_LINEAR_CHOICES = ("unfused", "fused")
# the TPU kernel's VMEM budget: its batch-group rule decides which pairs fuse
_TPU_VMEM_BUDGET = 10 * 1024 * 1024

# Launches of the kernel in this process (chip_smoke.py resets and reads them).
launch_counts = counter_dict("fused_ln_linear.launch_counts", ("ln_linear",))
# Float-weight dense calls with a bias, by where the bias was added: in the
# product's epilogue (CUDA) or by a pass of its own after it (the CPU).
dense_counts = counter_dict("fused_ln_linear.dense_counts", ("epilogue", "separate"))
# Launches of csrc/layer_norm.cu: forward kernels, and backward pairs (the
# backward kernel with its reduce kernel).
layer_norm_counts = counter_dict("fused_ln_linear.layer_norm_counts", ("forward", "backward"))


def reset_launch_counts() -> None:
    for counts in (launch_counts, dense_counts, layer_norm_counts):
        for name in counts:
            counts[name] = 0


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to the input dtype: the
    composition the CPU runs and the card's kernels are held to."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
    return y.to(x.dtype)


# The launch plan of csrc/layer_norm.cu; the constants are the kernels'.
LN_ACCESS_BYTES = (16, 4)     # a lane's access, the wider that divides the row's bytes
LN_MAX_K = 4                  # accesses a lane makes in a row
LN_CTA_WARPS = 8              # warps a CTA where a row takes at most 8 (16-byte rows: always)
LN_MAX_WARPS = 32             # warps a row of narrower accesses
LN_BWD_THREADS_SM = 512       # the backward's persistent threads an SM (2 CTAs of 256)
LN_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


@dataclasses.dataclass(frozen=True)
class LayerNormPlan:
    """How ``csrc/layer_norm.cu`` covers a row of ``D`` elements: each lane
    makes ``k`` accesses of ``vec`` elements, ``warps`` warps a row, ``rows``
    rows a CTA; the backward runs ``ctas_per_sm`` persistent CTAs an SM."""
    vec: int
    k: int
    warps: int
    rows: int
    ctas_per_sm: int

    def bwd_ctas(self, M: int, sms: int) -> int:
        """The backward's grid over ``M`` rows: persistent CTAs, no more than
        there are row tiles."""
        return max(1, min(-(-M // self.rows), self.ctas_per_sm * sms))


@functools.lru_cache(maxsize=None)
def layer_norm_plan(D: int, itemsize: int) -> LayerNormPlan:
    """The launch plan of LayerNorm over rows of ``D`` elements of
    ``itemsize`` bytes (2: bf16 or fp16, 4: fp32).

    * access: 16 bytes a lane where ``D * itemsize`` is a multiple of 16, so
      that every row starts aligned, else 4 bytes (D = 2730 in bf16 takes
      two elements); an odd width in bf16 or fp16 is refused;
    * warps a row: as few as hold the row at ``k <= 4`` accesses a lane (one
      warp up to D = 1024 in bf16, 512 in fp32), at most 8 for 16-byte
      accesses (whose lanes hold up to 32 elements) and 32 for narrower ones;
      ``k`` then the fewest that cover the row;
    * rows a CTA: 8 // warps, so that a CTA has eight warps where it can;
    * backward: 512 threads an SM, as 2 CTAs of 256 (1 of a wider row).
    Raises past D = 8192 in bf16 (4096 in fp32, or where the access is 4
    bytes)."""
    access = next((b for b in LN_ACCESS_BYTES if D * itemsize % b == 0), None)
    if itemsize not in (2, 4) or D <= 0 or access is None:
        raise ValueError(f"the LayerNorm kernels take rows of a multiple of 4 bytes of 2- or "
                         f"4-byte elements, got itemsize={itemsize}, D={D}")
    vec = access // itemsize
    accesses = D // vec
    max_warps = LN_CTA_WARPS if access == 16 else LN_MAX_WARPS
    warps = -(-accesses // (32 * LN_MAX_K))
    if warps > max_warps:
        limit = 32 * max_warps * LN_MAX_K * vec
        raise ValueError(f"the LayerNorm kernels take rows of at most {limit} elements of "
                         f"{itemsize} bytes at this alignment, got D={D}")
    k = -(-accesses // (32 * warps))
    rows = max(1, LN_CTA_WARPS // warps)
    return LayerNormPlan(vec, k, warps, rows, max(1, LN_BWD_THREADS_SM // (32 * warps * rows)))


# The C entries' arguments: pointers, ints (the plan's among them), eps, stream.
_LN_ARGTYPES = {
    "fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
    "bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}
_ln_entries = {}


def _ln_entry(name: str):
    """The C entry ``latteclip_layernorm_<name>`` (fwd or bwd), loaded once."""
    fn = _ln_entries.get(name)
    if fn is None:
        from latteclip_torch.kernels import build

        fn = getattr(build.load("layer_norm"), f"latteclip_layernorm_{name}")
        fn.argtypes, fn.restype = _LN_ARGTYPES[name], ctypes.c_int
        _ln_entries[name] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return sm_count(index)


def _rows(t: torch.Tensor, D: int) -> torch.Tensor:
    """``t`` as contiguous 16-byte aligned rows ``[M, D]`` (a copy only where
    it is neither, as a pooled ``x[:, 0]``)."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t.view(-1, D)


def _param(t: torch.Tensor) -> torch.Tensor:
    """A LayerNorm parameter as the kernels read it: contiguous 16-byte
    aligned float32."""
    if t.dtype == torch.float32 and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.empty(t.shape, dtype=torch.float32, device=t.device).copy_(t)


def _call(name: str, device: torch.device, *args) -> None:
    """Launch entry ``name`` on ``device``'s current stream; raise on its error."""
    fn = _ln_entry(name)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"latteclip_layernorm_{name} failed with CUDA error {err}")


def _dtype_code(x: torch.Tensor) -> int:
    code = LN_DTYPES.get(x.dtype)
    if code is None:
        raise ValueError(f"the LayerNorm kernels take bf16, fp16 or fp32 x, got {x.dtype}")
    return code


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   stats: bool):
    """The forward kernel on a CUDA tensor: ``(y, mean, rstd, x2)``, y in
    x's dtype and shape, mean and rstd ``[M]`` float32 (None unless
    ``stats``), ``x2`` the ``[M, D]`` rows it read."""
    code = _dtype_code(x)
    D = x.shape[-1]
    plan = layer_norm_plan(D, x.element_size())
    x2 = _rows(x, D)
    M = x2.shape[0]
    y = torch.empty_like(x2)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty((2, M), dtype=torch.float32, device=x.device)
    if M:
        _call("fwd", x.device, x2.data_ptr(), _param(weight).data_ptr(), _param(bias).data_ptr(),
              y.data_ptr(), mean.data_ptr() if stats else None, rstd.data_ptr() if stats else None,
              M, D, code, plan.vec, plan.k, plan.warps, plan.rows, eps)
        layer_norm_counts["forward"] += 1
    return y.view(x.shape), mean, rstd, x2


def layer_norm_bwd(x2: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor):
    """The backward pair on the card: ``(dx [M, D], dgamma, dbeta)``, dx in
    x's dtype, the parameter gradients float32 ``[D]``."""
    M, D = x2.shape
    plan = layer_norm_plan(D, x2.element_size())
    dy2 = _rows(dy, D)
    dx = torch.empty_like(x2)
    if not M:
        zeros = torch.zeros((2, D), dtype=torch.float32, device=x2.device)
        return dx, zeros[0], zeros[1]
    ctas = plan.bwd_ctas(M, _sms(x2.device.index))
    part = torch.empty((2, ctas, D), dtype=torch.float32, device=x2.device)
    out = torch.empty((2, D), dtype=torch.float32, device=x2.device)
    _call("bwd", x2.device, x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
          weight.data_ptr(), dx.data_ptr(), part.data_ptr(), out.data_ptr(),
          M, D, _dtype_code(x2), plan.vec, plan.k, plan.warps, plan.rows, ctas)
    layer_norm_counts["backward"] += 1
    return dx, out[0], out[1]


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm on the card under autograd: the forward kernel, which also
    writes each row's float32 mean and rstd, and the backward pair. Saves
    x (in its own dtype), the float32 scale and the statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        w = _param(weight)
        y, mean, rstd, x2 = layer_norm_fwd(x, w, bias, eps, stats=True)
        ctx.save_for_backward(x2, w, mean, rstd)
        ctx.shape, ctx.dtypes = x.shape, (weight.dtype, bias.dtype)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x2, w, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2, dy, w, mean, rstd)
        return dx.view(ctx.shape), dw.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to the input dtype.

    A CUDA tensor runs ``csrc/layer_norm.cu`` (bf16, fp16 or fp32 x, any
    width :func:`layer_norm_plan` takes) and raises on anything else: through
    :class:`LayerNormFunction` where autograd will need the gradient, else
    the forward kernel alone, writing no statistics. A CPU tensor takes
    :func:`layer_norm_plain`."""
    if not x.is_cuda:
        return layer_norm_plain(x, weight, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return LayerNormFunction.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps, stats=False)[0]


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight.T + bias`` emitted in ``dtype``, from ``dtype`` operands.

    On a CUDA tensor the bias, rounded to ``dtype``, joins the product's
    float32 accumulator and the sum is rounded once, as K8 and JAX's fused
    route do: ``x`` is flattened to ``[M, K]``, where ``F.linear`` is
    ``addmm`` and takes cuBLASLt's bias epilogue, so no broadcast pass of its
    own adds it. On the CPU the product is rounded to ``dtype`` and the bias
    added in ``dtype`` after it, as JAX's ``dense`` does. ``dense_counts``
    counts the two. A quantised weight
    (:class:`~latteclip_torch.models.quantize.Int8Weight`) takes the int8
    product, as JAX's ``dense`` does on its ``{"int8", "scale"}`` dict."""
    if isinstance(weight, Int8Weight):
        return int8_dense(x, weight, bias, dtype)
    if bias is None:
        return F.linear(x.to(dtype), weight.to(dtype))
    if x.is_cuda:
        dense_counts["epilogue"] += 1
        x2d = x.to(dtype).reshape(-1, x.shape[-1]).contiguous()
        y = F.linear(x2d, weight.to(dtype), bias.to(dtype))
        return y.view(*x.shape[:-1], y.shape[-1])
    dense_counts["separate"] += 1
    return F.linear(x.to(dtype), weight.to(dtype)) + bias.to(dtype)


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
    :func:`fused_route`; everything else is ``dense(layer_norm(x))``, a
    quantised ``w`` too (JAX ``ln_linear``'s ``not isinstance(w, dict)``:
    never K8)."""
    if route not in LN_LINEAR_CHOICES:
        raise ValueError(f"ln_linear must be one of {LN_LINEAR_CHOICES}, got {route!r}")
    if (route == "fused" and eps == LN_EPS and x.dim() == 3
            and not isinstance(w, Int8Weight)
            and fused_route(*x.shape, w.shape[0])):
        return FusedLnLinear.apply(x.to(dtype).contiguous(), ln_w, ln_b, w, wb, eps)
    return dense(layer_norm(x, ln_w, ln_b, eps), w, wb, dtype)
