"""The attention lab's kernels: Hopper kernels, their plain PyTorch versions
and the autograd Function around the lab forward and backward.

Port of the Pallas bodies of the two lab tools, ``tools/attn_lab.py`` and
``tools/r4_transpose_probe.py``; every kernel is in ``csrc/lab.cu``:

* ``lab_fwd_packed`` launches ``latteclip_lab_fwd_packed``, which replaces
  ``_fwd_kernel_v1`` (``fwd_v1g``): q, k, v ``[B, L, H*D]`` -> ``(o, lse [B, H, L])``;
* ``lab_fwd_bhld`` launches ``latteclip_lab_fwd_bhld``, which replaces
  ``_fwd_kernel_v3`` (``fwd_v3``): ``[B, H, L, D]`` -> ``(o, lse [H, B, L])``;
  ``lab_fwd_v3_packed`` is that kernel between two permutes (``fwd_v3_packed``);
* ``lab_bwd_bhld`` launches ``latteclip_lab_bwd_bhld``, which replaces
  ``_bwd_kernel_v3`` (``bwd_v3``): ``(dq, dk, dv)`` in ``[B, H, L, D]``;
* ``qk_heads_natural`` / ``qk_heads_pret`` launch ``latteclip_lab_qk_natural`` /
  ``latteclip_lab_qk_pret``, which replace ``_kern_natural`` / ``_kern_pret``:
  ``S = sum_h q_h . k_h^T [B, L, L]`` f32 from k ``[B, L, HD]`` or kT ``[B, HD, L]``;
* ``pv_heads`` launches ``latteclip_lab_pv``, which replaces ``_kern_pv``:
  ``O = sum_h p . v_h [B, L, D]`` f32 with one p ``[B, L, L]`` for every head.

The lab attention is not the flash kernels' function (K1, K3): it scales
the f32 scores after the product, sums the unrounded p, rounds p to bf16
only for the P V product, divides by l after it, stores the natural
logsumexp ``m + ln l``, and its backward takes delta as the row sum of
``p * dp`` over the whole score row. ``*_plain`` repeat the Pallas bodies'
arithmetic step by step. The TPU grouping ``G`` has no counterpart here:
shapes come from the tensors. Each wrapper takes its plain version only for
tensors on the CPU; for a CUDA tensor it launches its kernel or raises.
``LabAttentionBHLD`` pairs the lab forward with the lab backward.
"""
from __future__ import annotations

import ctypes

import torch

KERNEL_HEAD_DIMS = (64, 128)
MAX_SMEM = 232448      # dynamic shared memory a CTA may use on an H100 (csrc/lab.cu)
PRODUCT_MAX_LEN = 128  # rows of the head-summed products held by one CTA
QK_CHUNK = 64          # HD columns of one streamed chunk of the Q K^T kernel

# Launches of each kernel in this process (chip_smoke.py resets and reads them).
launch_counts = {"lab_fwd": 0, "lab_bwd": 0, "lab_qk": 0, "lab_pv": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def to_bhld(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[B, L, H*D] -> [B, H, L, D]``, a view."""
    B, L, HD = x.shape
    if HD % num_heads:
        raise ValueError(f"width {HD} is not {num_heads} heads * head_dim")
    return x.reshape(B, L, num_heads, HD // num_heads).transpose(1, 2)


def from_bhld(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, L, D] -> [B, L, H*D]`` (a copy unless H == 1)."""
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D)


# -- plain versions --------------------------------------------------------------

def _attend_plain(qb: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor):
    """The lab forward on ``[B, H, L, D]`` in the dtype of ``qb``: f32 scores
    scaled after the product, p = exp(s - rowmax) in f32, l the sum of the
    unrounded p, o = (bf16(p) . v in f32) / l rounded once. Returns
    ``(o [B, H, L, D], lse [B, H, L])``, lse natural."""
    dt = qb.dtype
    s = torch.matmul(qb.float(), kb.float().transpose(-1, -2)) * qb.shape[-1] ** -0.5
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dt).float(), vb.float()) / l
    return o.to(dt), (m + torch.log(l))[..., 0]


def lab_fwd_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """Plain version of ``_fwd_kernel_v1``: ``(o [B, L, H*D], lse [B, H, L])``."""
    o, lse = _attend_plain(*(to_bhld(x, num_heads) for x in (q, k, v)))
    return from_bhld(o), lse


def lab_fwd_bhld_plain(qb: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor):
    """Plain version of ``_fwd_kernel_v3``: ``(o [B, H, L, D], lse [H, B, L])``."""
    o, lse = _attend_plain(qb, kb, vb)
    return o, lse.transpose(0, 1).contiguous()


def lab_bwd_bhld_plain(qb: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, dob: torch.Tensor,
                       lse: torch.Tensor):
    """Plain version of ``_bwd_kernel_v3`` in the dtype of ``qb``, from lse
    ``[H, B, L]``: p = exp(s - lse) in f32, dv = bf16(p)^T . do,
    dp = do . v^T, delta = rowsum(p * dp) in f32, ds = bf16(p (dp - delta)
    D^-1/2), dq = ds . k, dk = ds^T . q; every product in f32, every gradient
    rounded once. Returns ``(dq, dk, dv)`` in ``[B, H, L, D]``."""
    dt = qb.dtype
    scale = qb.shape[-1] ** -0.5
    q, k, v, do = (x.float() for x in (qb, kb, vb, dob))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.transpose(0, 1)[..., None].float())
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def qk_heads_natural_plain(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of ``_kern_natural``: the f32 sum over heads of
    q_h . k_h^T (products of the bf16 operands in f32), ``[B, L, L]``."""
    return torch.matmul(to_bhld(q, num_heads).float(),
                        to_bhld(k, num_heads).float().transpose(-1, -2)).sum(dim=1)


def qk_heads_pret_plain(q: torch.Tensor, kt: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of ``_kern_pret``: as :func:`qk_heads_natural_plain`
    with k given transposed, ``kT [B, HD, L]``."""
    B, HD, L = kt.shape
    ktb = kt.reshape(B, num_heads, HD // num_heads, L)
    return torch.matmul(to_bhld(q, num_heads).float(), ktb.float()).sum(dim=1)


def pv_heads_plain(p: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of ``_kern_pv``: the f32 sum over heads of p . v_h, one
    p ``[B, L, L]`` for every head, ``[B, L, D]``."""
    return torch.matmul(p.float()[:, None], to_bhld(v, num_heads).float()).sum(dim=1)


# -- wrappers ----------------------------------------------------------------------

_SIGNATURES = {
    # name: argument kinds, "p" pointer, "i" int, "f" float; every one returns int
    "latteclip_lab_fwd_packed": "pppppiiiifp",
    "latteclip_lab_fwd_bhld": "pppppiiiifp",
    "latteclip_lab_bwd_bhld": "ppppppppiiiifp",
    "latteclip_lab_qk_natural": "pppiiip",
    "latteclip_lab_qk_pret": "pppiiip",
    "latteclip_lab_pv": "pppiiiip",
}


def _kernel(name: str):
    """The C entry point ``name`` with its ctypes signature set."""
    from latteclip_torch.kernels import build

    fn = getattr(build.load("lab"), name)
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
        fn.argtypes = [kinds[c] for c in _SIGNATURES[name]]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, shape, dtype=torch.bfloat16) -> None:
    if (not x.is_cuda or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(
            f"{name} must be a contiguous 16-byte aligned {dtype} {tuple(shape)} CUDA tensor, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _head_dim(D: int) -> None:
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the lab kernels take head_dim in {KERNEL_HEAD_DIMS}, got {D}")


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _check_row_fits(L: int, D: int, tiles: int, extra: int = 0) -> None:
    """One (b, h)'s ``tiles`` [L, D] bf16 tiles (rows padded to 16, columns by
    8) must fit in a CTA's shared memory."""
    need = tiles * _round16(L) * (D + 8) * 2 + extra * _round16(L)
    if L < 1 or need > MAX_SMEM:
        raise ValueError(f"a row of L={L} at head_dim {D} needs {need} bytes of shared memory, "
                         f"more than {MAX_SMEM}")


def _check_product_len(L: int) -> None:
    if not 1 <= L <= PRODUCT_MAX_LEN:
        raise ValueError(f"the head-summed product kernels take 1 <= L <= {PRODUCT_MAX_LEN}, got {L}")


def _launch(name: str, counter: str, tensors, *args) -> None:
    dev = tensors[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel(name)(*(t.data_ptr() for t in tensors), *args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launch_counts[counter] += 1


def _fwd(name: str, q, k, v, B: int, L: int, H: int, D: int, o_shape, lse_shape):
    _head_dim(D)
    _check_row_fits(L, D, 3)
    for n, x in (("q", q), ("k", k), ("v", v)):
        _check(n, x, o_shape)
    o = torch.empty(o_shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(lse_shape, dtype=torch.float32, device=q.device)
    _launch(name, "lab_fwd", [q, k, v, o, lse], B, L, H, D, D ** -0.5)
    return o, lse


def lab_fwd_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """Lab attention on packed heads, q, k, v ``[B, L, H*D]`` ->
    ``(o [B, L, H*D], lse [B, H, L])`` (``fwd_v1g``).

    CPU tensors take :func:`lab_fwd_packed_plain`; a CUDA tensor launches the
    Hopper kernel (bf16, head_dim 64 or 128) and raises on anything else."""
    if q.device.type == "cpu":
        return lab_fwd_packed_plain(q, k, v, num_heads)
    if q.dim() != 3 or q.shape[-1] % num_heads:
        raise ValueError(f"q must be [B, L, {num_heads} * head_dim], got {tuple(q.shape)}")
    B, L, HD = q.shape
    H, D = num_heads, HD // num_heads
    return _fwd("latteclip_lab_fwd_packed", q, k, v, B, L, H, D, (B, L, HD), (B, H, L))


def lab_fwd_bhld(qb: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor):
    """Lab attention in ``[B, H, L, D]`` -> ``(o [B, H, L, D], lse [H, B, L])``
    (``fwd_v3``). CPU tensors take :func:`lab_fwd_bhld_plain`; a CUDA tensor
    launches the Hopper kernel or raises."""
    if qb.device.type == "cpu":
        return lab_fwd_bhld_plain(qb, kb, vb)
    if qb.dim() != 4:
        raise ValueError(f"qb must be [B, H, L, D], got {tuple(qb.shape)}")
    B, H, L, D = qb.shape
    return _fwd("latteclip_lab_fwd_bhld", qb, kb, vb, B, L, H, D, (B, H, L, D), (H, B, L))


def lab_fwd_v3_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """Packed ``[B, L, H*D]`` in and out, through :func:`lab_fwd_bhld`
    between permutes (``fwd_v3_packed``): ``(o [B, L, H*D], lse [H, B, L])``."""
    o, lse = lab_fwd_bhld(*(to_bhld(x, num_heads).contiguous() for x in (q, k, v)))
    return from_bhld(o), lse


def lab_bwd_bhld(qb: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, dob: torch.Tensor,
                 lse: torch.Tensor):
    """Gradient of :func:`lab_fwd_bhld`'s o from its lse ``[H, B, L]`` and the
    cotangent ``dob`` -> ``(dq, dk, dv)`` in ``[B, H, L, D]`` (``bwd_v3``).
    CPU tensors take :func:`lab_bwd_bhld_plain`; a CUDA tensor launches the
    Hopper kernel or raises."""
    if qb.device.type == "cpu":
        return lab_bwd_bhld_plain(qb, kb, vb, dob, lse)
    if qb.dim() != 4:
        raise ValueError(f"qb must be [B, H, L, D], got {tuple(qb.shape)}")
    B, H, L, D = qb.shape
    _head_dim(D)
    _check_row_fits(L, D, 4, extra=8)
    for n, x in (("qb", qb), ("kb", kb), ("vb", vb), ("dob", dob)):
        _check(n, x, (B, H, L, D))
    _check("lse", lse, (H, B, L), torch.float32)
    grads = [torch.empty_like(qb) for _ in range(3)]
    _launch("latteclip_lab_bwd_bhld", "lab_bwd", [qb, kb, vb, dob, lse, *grads], B, L, H, D,
            D ** -0.5)
    return tuple(grads)


def _qk(name: str, q: torch.Tensor, k: torch.Tensor, k_shape, num_heads: int) -> torch.Tensor:
    if q.dim() != 3:
        raise ValueError(f"q must be [B, L, HD], got {tuple(q.shape)}")
    B, L, HD = q.shape
    if HD % num_heads or HD % QK_CHUNK:
        raise ValueError(f"the Q K^T kernel takes HD a multiple of {QK_CHUNK} and of "
                         f"{num_heads} heads, got {HD}")
    _check_product_len(L)
    _check("q", q, (B, L, HD))
    _check("k", k, k_shape(B, L, HD))
    s = torch.empty((B, L, L), dtype=torch.float32, device=q.device)
    _launch(name, "lab_qk", [q, k, s], B, L, HD)
    return s


def qk_heads_natural(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``sum_h q_h . k_h^T`` from q, k ``[B, L, HD]`` -> ``[B, L, L]`` f32
    (``_kern_natural``). CPU tensors take :func:`qk_heads_natural_plain`; a
    CUDA tensor launches the Hopper kernel (bf16, L <= 128) or raises."""
    if q.device.type == "cpu":
        return qk_heads_natural_plain(q, k, num_heads)
    return _qk("latteclip_lab_qk_natural", q, k, lambda B, L, HD: (B, L, HD), num_heads)


def qk_heads_pret(q: torch.Tensor, kt: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``sum_h q_h . k_h^T`` from q ``[B, L, HD]`` and kT ``[B, HD, L]`` ->
    ``[B, L, L]`` f32 (``_kern_pret``). CPU tensors take
    :func:`qk_heads_pret_plain`; a CUDA tensor launches the Hopper kernel or
    raises."""
    if q.device.type == "cpu":
        return qk_heads_pret_plain(q, kt, num_heads)
    return _qk("latteclip_lab_qk_pret", q, kt, lambda B, L, HD: (B, HD, L), num_heads)


def pv_heads(p: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``sum_h p . v_h`` from p ``[B, L, L]`` and v ``[B, L, H*D]`` ->
    ``[B, L, D]`` f32 (``_kern_pv``). CPU tensors take
    :func:`pv_heads_plain`; a CUDA tensor launches the Hopper kernel (bf16,
    L <= 128, head_dim 64 or 128) or raises."""
    if p.device.type == "cpu":
        return pv_heads_plain(p, v, num_heads)
    if v.dim() != 3 or v.shape[-1] % num_heads:
        raise ValueError(f"v must be [B, L, {num_heads} * head_dim], got {tuple(v.shape)}")
    B, L, HD = v.shape
    D = HD // num_heads
    _head_dim(D)
    _check_product_len(L)
    _check("p", p, (B, L, L))
    _check("v", v, (B, L, HD))
    o = torch.empty((B, L, D), dtype=torch.float32, device=v.device)
    _launch("latteclip_lab_pv", "lab_pv", [p, v, o], B, L, num_heads, D)
    return o


class LabAttentionBHLD(torch.autograd.Function):
    """``(o, lse) = lab_fwd_bhld(qb, kb, vb)`` with :func:`lab_bwd_bhld` as its
    gradient (the lab tool's ``fwd_v3`` then ``bwd_v3``). lse takes no
    gradient."""

    @staticmethod
    def forward(ctx, qb: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor):
        o, lse = lab_fwd_bhld(qb, kb, vb)
        ctx.save_for_backward(qb, kb, vb, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, dob: torch.Tensor, _dlse):
        qb, kb, vb, lse = ctx.saved_tensors
        return lab_bwd_bhld(qb, kb, vb, dob.to(qb.dtype).contiguous(), lse)

