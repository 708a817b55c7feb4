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
  which replaces ``_bwd_kernel_seg`` (``_make_fa_seg``'s backward);
* ``flash_attention_qkv_hs`` launches ``latteclip_flash_fwd_hs``, which
  replaces the head-split forward ``_fwd_kernel_hs``: K1's function with
  lse2 laid out ``[H/HP, HP, B, L]`` (``HP = 128 / D`` heads per TPU program);
* ``flash_attention_qkv_hs_bwd`` launches ``csrc/flash_bwd.cu::latteclip_flash_bwd_hs``,
  which replaces ``_bwd_kernel_hs``: K3's gradient from that lse2 layout.
  The TPU kernel writes ``dqkv3 [3, B, L, H*D]`` and JAX moves the axis
  (attention.py:842); the Hopper kernel stores straight into the layout of
  ``qkv``, so the wrapper returns that layout and no copy follows;
* ``flash_attention_qkv_bd`` launches ``latteclip_flash_fwd_bd``, which
  replaces the block-diagonal forward ``_fwd_kernel_bd`` (``_flash_fwd_bd``):
  whole rows of at most 128 tokens, with that kernel's rounding (p stays f32,
  is normalised by the f32 sum of the unrounded p, then rounded; no division
  after the PV product).

Rows of at most 128 tokens take the forward's and the backward's ring
kernels (persistent CTAs fed by a TMA ring, consumer warpgroups of 64 rows),
their warp rings (the same with one consumer warp per 16 rows: the band of
65..96 tokens, text at 77, and the backward's few-item cases) or the
one-CTA-per-(row, head) form under :func:`short_row_plan` and
:func:`bwd_short_row_plan` (form, consumer warpgroups, CTAs an SM, ring
stages, grid). Rows of more than 128 tokens take the forward's rings at
head_dim 64 (the row ring up to 272 tokens, the stream ring beyond) or its
long-row kernel at head_dim 128, under the launch plan of
:func:`long_row_plan` (form, grid and slots of a ring; warps a CTA and CTAs
per (row, head) of the long-row kernel), and the backward's row kernel, its streamed pair or
its tiled pair under :func:`bwd_long_row_plan` (form, warps a CTA, the
streamed pair's grid). All are computed here so that the CPU tests
hold them.

The forwards read q, k and v straight from ``qkv [B, L, 3*H*D]`` (laid out
``[q | k | v]``) and return ``(out [B, L, H*D], lse2 [B, H, L])``, the
base-2 logsumexp; the backwards take those residuals and the cotangent of
``out`` and return ``dqkv`` in the layout of ``qkv``. ``FlashAttention`` and
``FlashAttentionSegmented`` pair them as ``torch.autograd.Function``s, with
``(qkv, out, lse2)`` (and ``seg_ids``) saved, the JAX package's residuals;
``FlashAttentionHeadSplit`` pairs the head-split kernels, and
``FlashAttentionBlockDiag`` pairs the block-diagonal forward with the
whole-row backward, as JAX does. Each Function takes ``residuals=(out,
lse2)`` from an earlier forward of the same call instead of launching its
forward: a rematerialised block replays them (:class:`AttentionResiduals`).
``flash_{fwd,bwd}{,_seg,_hs}_plain`` and
``flash_fwd_bd_plain`` compute the same functions in plain PyTorch,
repeating the TPU kernels' rounding step by step; the wrappers take them only
for a tensor on the CPU, and a CUDA tensor either launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from latteclip_torch.device import sm_count

NEG_INF = -1e9
LOG2E = math.log2(math.e)
KERNEL_HEAD_DIMS = (64, 128)
# the block-diagonal forward takes whole rows up to this length and width (JAX :713)
BLOCKDIAG_MAX_LEN, BLOCKDIAG_MAX_WIDTH = 128, 1024

# Launches of each kernel in this process (chip_smoke.py resets and reads them).
launch_counts = {"flash_fwd": 0, "flash_fwd_seg": 0, "flash_bwd": 0, "flash_bwd_seg": 0,
                 "flash_fwd_hs": 0, "flash_bwd_hs": 0, "flash_fwd_bd": 0}


# Launches of the long-row forms (rows past 128 tokens), by form: which form
# a path's flash_fwd* and flash_bwd* launches took (chip_smoke.py reads them).
fwd_form_counts = {"row_ring": 0, "stream_ring": 0, "resident": 0, "streamed": 0}
bwd_form_counts = {"streamed": 0, "resident": 0, "tiled": 0}
# Launches of the short-row forms (rows of at most 128 tokens) under their
# plans, forward (K1, K2, K5) and backward (K3, K4, K6); the block-diagonal
# forward has no plan and is not counted here.
short_fwd_form_counts = {"cta": 0, "ring": 0, "warp_ring": 0}
short_bwd_form_counts = {"cta": 0, "ring": 0, "warp_ring": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, fwd_form_counts, bwd_form_counts, short_fwd_form_counts,
                   short_bwd_form_counts):
        for name in counts:
            counts[name] = 0


def _split_heads(qkv: torch.Tensor, num_heads: int):
    B, L, HD3 = qkv.shape
    if HD3 % (3 * num_heads):
        raise ValueError(f"qkv width {HD3} is not 3 * {num_heads} heads * head_dim")
    D = HD3 // 3 // num_heads
    x = qkv.reshape(B, L, 3, num_heads, D)
    return x[:, :, 0].transpose(1, 2), x[:, :, 1].transpose(1, 2), x[:, :, 2].transpose(1, 2), D


def head_split(num_heads: int, head_dim: int) -> int:
    """Heads per TPU program of the head-split route, or 0 where that route
    does not apply (JAX ``_head_split`` with its switch on)."""
    if head_dim in KERNEL_HEAD_DIMS and num_heads % (128 // head_dim) == 0:
        return 128 // head_dim
    return 0


def _attend_plain(qkv: torch.Tensor, num_heads: int, visible: Optional[torch.Tensor],
                  normalize_first: bool = False):
    """The TPU kernel's arithmetic in the dtype of ``qkv``: bf16 rounding of
    the scaled q and of the probabilities, f32 scores, sums and PV. With a
    float32 ``qkv`` every step runs in float32. ``visible`` broadcasts to
    [B, H, L, L] (True = key visible) or is None. By default p = exp2(s - m)
    is rounded, l sums the rounded p and the PV product is divided by l
    (``_fwd_kernel``); ``normalize_first`` keeps p in f32, sums the unrounded
    p and rounds p / l before the product (``_fwd_kernel_bd``)."""
    dt = qkv.dtype
    B, L, _ = qkv.shape
    q, k, v, D = _split_heads(qkv, num_heads)
    qscale = (D ** -0.5) * LOG2E
    qs = (q.float() * qscale).to(dt).float()
    s = torch.matmul(qs, k.to(dt).float().transpose(-1, -2))     # [B, H, L, L] f32
    if visible is not None:
        s = s + torch.where(visible, 0.0, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if normalize_first:
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul((p / l).to(dt).float(), v.to(dt).float())
    else:
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


def _hs_lse_shape(B: int, L: int, num_heads: int, head_dim: int) -> Tuple[int, int, int, int]:
    """``[H/HP, HP, B, L]``, the head-split kernels' lse2 layout."""
    hp = head_split(num_heads, head_dim)
    if not hp:
        raise ValueError(f"the head-split route needs head_dim in {KERNEL_HEAD_DIMS} and "
                         f"num_heads divisible by 128 / head_dim, got {num_heads} x {head_dim}")
    return num_heads // hp, hp, B, L


def flash_fwd_hs_plain(qkv: torch.Tensor, num_heads: int, causal: bool):
    """Plain version of ``_fwd_kernel_hs``: ``(out, lse2 [H/HP, HP, B, L])``."""
    B, L, HD3 = qkv.shape
    out, lse2 = flash_fwd_plain(qkv, num_heads, causal)
    shape = _hs_lse_shape(B, L, num_heads, HD3 // 3 // num_heads)
    return out, lse2.transpose(0, 1).reshape(shape)


def flash_bwd_hs_plain(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                       lse2: torch.Tensor, num_heads: int, causal: bool) -> torch.Tensor:
    """Plain version of ``_bwd_kernel_hs``: lse2 in ``[H/HP, HP, B, L]``,
    returns ``dqkv3 [3, B, L, H*D]``."""
    B, L, HD3 = qkv.shape
    lse = lse2.reshape(num_heads, B, L).transpose(0, 1)
    dqkv = flash_bwd_plain(qkv, out, dout, lse, num_heads, causal)
    return dqkv.reshape(B, L, 3, HD3 // 3).permute(2, 0, 1, 3).contiguous()


def merge_dqkv(dqkv3: torch.Tensor) -> torch.Tensor:
    """``[3, B, L, H*D] -> [B, L, 3*H*D]``, the layout of ``qkv``: JAX's
    ``moveaxis(dqkv3, 0, 2)`` (attention.py:842), here one copy. The CUDA
    kernel stores that layout itself; the plain route and the tests merge."""
    _, B, L, HD = dqkv3.shape
    return dqkv3.permute(1, 2, 0, 3).reshape(B, L, 3 * HD)


def flash_fwd_bd_plain(qkv: torch.Tensor, num_heads: int, causal: bool):
    """Plain version of ``_fwd_kernel_bd``: ``(out, lse2 [B, H, L])`` with
    p / l rounded before the PV product."""
    visible = _causal_visible(qkv.shape[1], qkv.device) if causal else None
    return _attend_plain(qkv, num_heads, visible, normalize_first=True)


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
    "latteclip_flash_fwd": "pppiiiiifiiip",
    "latteclip_flash_fwd_seg": "ppppiiiiifiiip",
    "latteclip_flash_bwd": "ppppppiiiiiffiip",
    "latteclip_flash_bwd_seg": "pppppppiiiiiffiip",
    "latteclip_flash_fwd_hs": "pppiiiiifiiip",
    "latteclip_flash_fwd_bd": "pppiiiiifp",
    "latteclip_flash_bwd_hs": "ppppppiiiiiffiip",
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


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


# The launch plans of rows of at most SHORT_ROW tokens (csrc/flash_fwd.cu,
# flash_fwd_ring_kernel and flash_fwd_warp_ring_kernel; csrc/flash_bwd.cu,
# flash_bwd_ring_kernel and flash_bwd_warp_ring_kernel); the constants are
# the kernels'.
SHORT_ROW = 128           # longest row of the short-row kernels
RING_MAX_STAGES = 4       # ring slots a ring kernel takes at most
SW128_ALIGN = 1024        # the ring's alignment of its swizzled tiles
WARP_RING_CODE = 1        # the forward entry points' `resident` for the warp ring
BWD_WARP_RING_CODE = 16   # the backward's: its `resident` is this plus the stages
WARP_RING_STAGES = 2      # a warp ring's stages at most: a third ran slower (PERF.md)


@dataclasses.dataclass(frozen=True)
class ShortRowPlan:
    """How a row of at most 128 tokens is taken: ``form`` "ring" (``grid``
    persistent CTAs, ``ctas_per_sm`` of them an SM, each with ``warpgroups``
    consumer warpgroups of 64 query rows and one producer warp keeping
    ``stages`` (row, head) items in flight by TMA), "warp_ring" (the same
    with one consumer warp per 16 rows, mma.sync, and ``warpgroups`` 0) or
    "cta" (one CTA per (row, head), the first port's design; the backward's
    with its delta pre-pass), and a ring CTA's dynamic shared memory (0 for
    "cta")."""
    form: str
    warpgroups: int
    ctas_per_sm: int
    stages: int
    grid: int
    smem_bytes: int

    def c_args(self, bwd: bool = False) -> Tuple[int, ...]:
        """The entry points' plan integers for a short row: the forward's
        (warps, splits, resident) = (grid, stages, 0) of the ring, (grid,
        stages, WARP_RING_CODE) of the warp ring, (0, 0, 0) for one CTA per
        (row, head); the backward's (warps, resident) = (grid, stages),
        (grid, BWD_WARP_RING_CODE + stages), (0, 0)."""
        if self.form == "cta":
            return (0, 0) if bwd else (0, 0, 0)
        if bwd:
            return self.grid, self.stages + (BWD_WARP_RING_CODE if self.form == "warp_ring" else 0)
        return self.grid, self.stages, WARP_RING_CODE if self.form == "warp_ring" else 0


def ring_warpgroups(L: int) -> int:
    """Consumer warpgroups of a ring CTA: one per 64 query rows."""
    return 1 if L <= 64 else 2


def short_row_smem_bytes(L: int, D: int, stages: int, segmented: bool) -> int:
    """Shared memory of one forward ring CTA (mirrors ``ring_smem_bytes`` in
    csrc/flash_fwd.cu): per stage Q, K and V of one (row, head) in boxes of
    64 token rows a warpgroup, and the seg ids; the mbarriers; 1 KB to align."""
    box = 64 * ring_warpgroups(L)
    return SW128_ALIGN + stages * (3 * D * box * 2 + (4 * box if segmented else 0)) + 16 * stages


def bwd_short_row_smem_bytes(L: int, D: int, stages: int, segmented: bool) -> int:
    """Shared memory of one backward ring CTA (mirrors ``ring_smem_bytes`` in
    csrc/flash_bwd.cu): per stage Q, K, V, dO and out of one (row, head),
    lse2, delta and the seg ids; the mbarriers; 1 KB to align."""
    box = 64 * ring_warpgroups(L)
    return SW128_ALIGN + stages * (5 * D * box * 2 + (12 if segmented else 8) * box) + 16 * stages


def warp_ring_smem_bytes(L: int, stages: int, segmented: bool) -> int:
    """Shared memory of one forward warp-ring CTA, head_dim 64 (mirrors
    ``warp_ring_smem_bytes`` in csrc/flash_fwd.cu): 1 KB to align, per stage
    Q, K and V of one (row, head) as round16(L) token rows of 128 B, the
    output tile (16 rows a consumer warp), the seg ids of each stage, two
    mbarriers a stage."""
    rows = -(-L // 16) * 16
    return SW128_ALIGN + stages * 3 * rows * 128 + rows * 128 + (stages * rows * 4 if segmented else 0) + 16 * stages


def bwd_warp_ring_smem_bytes(L: int, stages: int, segmented: bool) -> int:
    """Shared memory of one backward warp-ring CTA, head_dim 64 (mirrors
    ``warp_ring_smem_bytes`` in csrc/flash_bwd.cu): 1 KB to align, per stage
    Q, K, V, dO and out as round16(L) token rows of 128 B, one 16-row staging
    tile a consumer warp, lse2, delta and the seg ids of each stage, three
    mbarriers a stage."""
    rows = -(-L // 16) * 16
    return (SW128_ALIGN + stages * 5 * rows * 128 + rows * 128 + stages * rows * (12 if segmented else 8)
            + 24 * stages)


def warp_ring_ctas(L: int, bwd: bool) -> int:
    """CTAs an SM that a warp ring's registers allow (``WARP_RING_CTAS`` in
    csrc/flash_fwd.cu, ``warp_ring_min_ctas`` in csrc/flash_bwd.cu): forward
    two (three of five consumer warps, at 96 registers a thread, spilled and
    ran slower); backward two of up to five consumer warps (80 rows), else
    one."""
    rows = -(-L // 16) * 16
    return 2 if not bwd or rows <= 80 else 1


# The forms by row length and head width. Rows of WARP_RING_MIN..
# WARP_RING_MAX tokens (text at 77) take the warp ring, forward and backward:
# the warpgroup ring's second warpgroup holds at most 32 of its 64 rows
# there, so most of its products, masks and exp2 are spent on padding
# (77-token text ran at 1.3x the one-CTA form's time on it), and 16-row
# warps pad 77 to 80. At 81..96 tokens the backward's warp ring (one CTA an
# SM, six consumer warps at 96) also beat the warpgroup ring ([512, 96, 8 x
# 64] 0.199 against 0.280 ms causal, PERF.md). The backward's few-item cases at
# head_dim 64 take it as well (see bwd_short_row_plan). Head_dim 128 keeps
# the one-CTA form in the band: a slot of Q, K and V of 80 rows is 60 KB
# there (100 KB with dO and out), so two slots and the output tile hold one
# CTA of five warps an SM where the one-CTA form runs two.
WARP_RING_MIN, WARP_RING_MAX = 65, 96


def _ring_plan(B: int, L: int, H: int, D: int, sms: int, ctas: int, stages_cap: int,
               smem_of, form: str = "ring") -> ShortRowPlan:
    wg = ring_warpgroups(L) if form == "ring" else 0
    budget = min(MAX_SMEM, SM_SMEM // ctas - CTA_RESERVED_SMEM)
    stages = max(s for s in range(1, stages_cap + 1) if s == 1 or smem_of(s) <= budget)
    return ShortRowPlan(form, wg, ctas, stages, min(B * H, sms * ctas), smem_of(stages))


def _check_short(L: int, D: int) -> None:
    if L > SHORT_ROW or L < 1 or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the short-row plans take 1 <= L <= {SHORT_ROW} and head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got L={L}, head_dim={D}")


CTA_PLAN = ShortRowPlan("cta", 0, 0, 0, 0, 0)


def warp_ring_plan(B: int, L: int, H: int, segmented: bool, sms: int, bwd: bool = False) -> ShortRowPlan:
    """The warp ring at head_dim 64: :func:`warp_ring_ctas` CTAs an SM, as
    many stages as fit each one's share of an SM (at most
    ``WARP_RING_STAGES``), a grid of ``min(B * H, sms * ctas_per_sm)``."""
    smem = bwd_warp_ring_smem_bytes if bwd else warp_ring_smem_bytes
    return _ring_plan(B, L, H, 64, sms, warp_ring_ctas(L, bwd), WARP_RING_STAGES,
                      lambda s: smem(L, s, segmented), "warp_ring")


def short_row_plan(B: int, L: int, H: int, D: int, segmented: bool, sms: int) -> ShortRowPlan:
    """The forward's launch plan for a row of ``L <= 128`` tokens on a card
    of ``sms`` SMs:

    * ``WARP_RING_MIN <= L <= WARP_RING_MAX``: the warp ring at head_dim 64
      (:func:`warp_ring_plan`: two CTAs an SM of five consumer warps at
      65..80 tokens, of six at 81..96, two stages each), "cta" at head_dim
      128; otherwise
    * the ring, one consumer warpgroup a CTA up to 64 tokens and two beyond;
      as many CTAs an SM as the kernel's registers allow (``ring_min_ctas``
      in csrc/flash_fwd.cu: four with one warpgroup at D=64, two with one
      at D=128 or with two at D=64, else one), since its time falls with the
      warpgroups an SM holds; one stage where several CTAs share an SM (each
      one's copy-in overlaps the others' products, and one stage was faster
      than two or more there), else as many as fit (at most
      ``RING_MAX_STAGES``); a grid of ``min(B * H, sms * ctas_per_sm)``
      CTAs, each walking the (row, head) items ``x, x + grid, ...``.

    ``python -m latteclip_torch.tools.short_row_plans`` times the forms on
    the card (PERF.md keeps its numbers)."""
    _check_short(L, D)
    if WARP_RING_MIN <= L <= WARP_RING_MAX:
        return warp_ring_plan(B, L, H, segmented, sms) if D == 64 else CTA_PLAN
    one = ring_warpgroups(L) == 1
    ctas = (4 if D == 64 else 2) if one else (2 if D == 64 else 1)
    return _ring_plan(B, L, H, D, sms, ctas, 1 if ctas > 1 else RING_MAX_STAGES,
                      lambda s: short_row_smem_bytes(L, D, s, segmented))


def bwd_short_row_plan(B: int, L: int, H: int, D: int, segmented: bool, sms: int) -> ShortRowPlan:
    """The backward's launch plan for a row of ``L <= 128`` tokens:

    * the warp ring (:func:`warp_ring_plan`) at head_dim 64, "cta" (the row
      kernel with the delta pre-pass) at 128, for ``WARP_RING_MIN <= L <=
      WARP_RING_MAX``; where ``B * H`` items leave each SM at most one
      (the warpgroup ring then overlaps nothing; packed templates, [8, 128,
      8 x 64]); and at D=64 beyond 64 tokens where they leave it at most
      four, since the warpgroup ring's two passes over the queries there
      cost more than its few items a CTA save ([64, 128, 8 x 64] ran 5%
      slower on it than on the one-CTA form, which the warp ring beat by
      15%);
    * otherwise the ring, with warpgroups and grid as in
      :func:`short_row_plan`, two CTAs an SM at D=64 or with one warpgroup,
      else one (``ring_min_ctas`` in csrc/flash_bwd.cu), and as many stages
      of its five tiles as fit.
    """
    _check_short(L, D)
    two_passes = D == 64 and L > 64
    if (WARP_RING_MIN <= L <= WARP_RING_MAX or B * H <= sms
            or (two_passes and B * H <= 4 * sms)):
        return warp_ring_plan(B, L, H, segmented, sms, bwd=True) if D == 64 else CTA_PLAN
    ctas = 2 if D == 64 or ring_warpgroups(L) == 1 else 1
    return _ring_plan(B, L, H, D, sms, ctas, RING_MAX_STAGES,
                      lambda s: bwd_short_row_smem_bytes(L, D, s, segmented))


# The launch plan of rows longer than SHORT_ROW tokens (csrc/flash_fwd.cu,
# flash_fwd_long_kernel); the constants are the kernel's.
LONG_TILE = 64            # keys per copy stage and per ring slot
LONG_STREAM_SLOTS = 2     # ring slots of the streamed form
LONG_MAX_WARPS = 16       # __launch_bounds__ of the long-row kernel
LONG_MIN_WARPS = 4        # the fewest warps the resident form is given before it streams
MAX_SMEM = 232448         # dynamic shared memory a CTA may use on an H100
SM_SMEM = 233472          # shared memory of one SM
CTA_RESERVED_SMEM = 1024  # shared memory the system keeps for each CTA
MIN_SPLIT_BLOCKS = 4      # 16-row query blocks a split keeps at least


# The rings of rows longer than SHORT_ROW tokens at head_dim 64
# (csrc/flash_fwd.cu, flash_fwd_row_ring_kernel and
# flash_fwd_stream_ring_kernel); the constants are the kernels'.
RING_WARPGROUPS = 2          # consumer warpgroups of a long-row ring CTA, one CTA an SM
ROW_RING_WARPS = 8           # the row ring: no producer warp (its consumers refill the slots)
STREAM_RING_WARPS = 9        # the stream ring: and a producer warp
ROW_RING_KEYS = (208, 272)   # the row ring's key capacities (64 n + 16): the rows it takes
RING_MAX_SLOTS = 8           # slots of a long-row ring, at most
STREAM_RING_CHUNKS = (64, 128)  # the stream ring's chunks of keys
# the entry points' `resident` code of each form past SHORT_ROW tokens (the
# stream ring's with 128-key chunks is one more than its code)
FWD_FORMS = {"streamed": 0, "resident": 1, "row_ring": 2, "stream_ring": 3}


@dataclasses.dataclass(frozen=True)
class LongRowPlan:
    """How a row of more than 128 tokens is taken: ``form`` "row_ring" (one
    pass: Q, K and V of a whole (row, head) in one of ``stages`` slots,
    ``chunk`` its key capacity, every score of a 64-row block in registers)
    or "stream_ring" (two passes over ``chunk``-key chunks of K, then K and
    V, through ``stages`` ring slots), each on ``grid`` persistent CTAs of
    ``warps`` warps; or
    ``flash_fwd_long_kernel``'s "resident" (K and V of the row in shared
    memory) or "streamed" (a ring of 64-key slots), ``warps`` a CTA,
    ``splits`` CTAs per (row, head); and the CTA's dynamic shared memory."""
    form: str
    warps: int
    splits: int
    smem_bytes: int
    grid: int = 0
    stages: int = 0
    chunk: int = 0

    def c_args(self) -> Tuple[int, int, int]:
        """The entry points' plan integers ``(warps, splits, resident)``: a
        ring passes its grid, its stages and its form's code."""
        if self.form in ("row_ring", "stream_ring"):
            code = FWD_FORMS[self.form] + (self.chunk == 128)
            return self.grid, self.stages, code
        return self.warps, self.splits, FWD_FORMS[self.form]


def long_row_smem_bytes(L: int, D: int, warps: int, segmented: bool, resident: bool) -> int:
    """Shared memory of one ``flash_fwd_long_kernel`` CTA (mirrors
    ``long_smem_bytes`` in csrc/flash_fwd.cu): the seg ids and K and V of
    the whole row or of the ring, 16 rows a warp for its Q block and
    output."""
    kv_rows = -(-L // 16) * 16 if resident else LONG_STREAM_SLOTS * LONG_TILE
    return (4 * kv_rows if segmented else 0) + (2 * kv_rows + 16 * warps) * (D + 8) * 2


def row_ring_keys(L: int) -> int:
    """The row ring's key capacity for a row of ``L`` tokens (its kernel's
    template constant), or 0 past the longest it holds."""
    return next((kc for kc in ROW_RING_KEYS if L <= kc), 0)


def row_ring_smem_bytes(keys: int, stages: int) -> int:
    """Shared memory of one row-ring CTA (mirrors ``row_ring_smem_bytes`` in
    csrc/flash_fwd.cu): 1 KB to align, per stage Q, K and V of ``keys``
    token rows of 128 B, the two warpgroups' 64-row output tiles, and per
    stage an mbarrier and a release count."""
    return SW128_ALIGN + stages * 3 * keys * 128 + 2 * 64 * 128 + 16 * stages


def stream_ring_smem_bytes(chunk: int, stages: int, segmented: bool) -> int:
    """Shared memory of one stream-ring CTA (mirrors ``stream_ring_smem_bytes``
    in csrc/flash_fwd.cu): 1 KB to align, two item slots of Q (two 64-row
    boxes each), ``stages`` ring slots of K and V of ``chunk`` keys, the two
    output tiles, the seg ids of the item slots' queries and the ring slots'
    keys, two mbarriers a slot."""
    return (SW128_ALIGN + 4 * 64 * 128 + stages * 2 * chunk * 128 + 2 * 64 * 128
            + ((2 * 128 + stages * chunk) * 4 if segmented else 0) + 16 * (2 + stages))


def _most_stages(smem_of) -> int:
    return max(s for s in range(1, RING_MAX_SLOTS + 1) if s == 1 or smem_of(s) <= MAX_SMEM)


def row_ring_plan(B: int, L: int, H: int, sms: int) -> LongRowPlan:
    """The row ring at ``L`` <= 272 tokens: ``chunk`` its key capacity
    (:func:`row_ring_keys`), as many slots of a whole (row, head) as fit one
    CTA an SM (two: 177,184 B at 208 keys, 226,336 B at 272; segment ids
    are read from device memory), and a grid of ``min(B * H, sms)``."""
    keys = row_ring_keys(L)
    stages = _most_stages(lambda s: row_ring_smem_bytes(keys, s))
    return LongRowPlan("row_ring", ROW_RING_WARPS, 1, row_ring_smem_bytes(keys, stages),
                       min(B * H, sms), stages, keys)


def stream_ring_plan(B: int, L: int, H: int, segmented: bool, sms: int, chunk: int = 128) -> LongRowPlan:
    """The stream ring: ``chunk``-key chunks, as many ring slots as fit one
    CTA an SM (at most ``RING_MAX_SLOTS``), and a grid of ``min(items,
    sms)``, where the items are the ``B * H * ceil(ceil(L / 64) / 2)`` (row,
    head, pair of 64-row query blocks)s."""
    stages = _most_stages(lambda s: stream_ring_smem_bytes(chunk, s, segmented))
    query_blocks = -(-L // 64)
    items = B * H * -(-query_blocks // RING_WARPGROUPS)
    return LongRowPlan("stream_ring", STREAM_RING_WARPS, 1, stream_ring_smem_bytes(chunk, stages, segmented),
                       min(items, sms), stages, chunk)


def long_kernel_plan(B: int, L: int, H: int, D: int, segmented: bool, sms: int) -> LongRowPlan:
    """The plan of ``flash_fwd_long_kernel`` (one CTA per (row, head), warps
    walking 16-row query blocks with mma.sync), the form head_dim 128 takes
    and the one the rings replaced at head_dim 64:

    * splits: one CTA per (row, head) unless ``B * H`` would leave at least
      half the SMs idle; then as many splits as fill the SMs once, each
      keeping at least ``MIN_SPLIT_BLOCKS`` query blocks. Each split reads K
      and V again, from L2, and a CTA of more warps over the whole row beats
      that, even at [8, 577, 16 x 64] (128 pairs on 132 SMs);
    * warps: the kernel's time falls with the warps an SM holds, which its
      128 registers a thread cap at 16: 8 a CTA where two such CTAs fit an
      SM's shared memory, else 16, never more than the split's blocks;
    * form: resident if K and V of the row fit beside the warps' Q blocks,
      with the warps cut down to ``LONG_MIN_WARPS`` if need be; streamed
      otherwise.
    """
    _check_long(L, D)
    nblk = -(-L // 16)
    pairs = B * H
    splits = 1
    if 2 * pairs <= sms:
        splits = max(1, min(sms // pairs, nblk // MIN_SPLIT_BLOCKS))
    blocks = nblk // splits  # the fewest blocks of a split

    def smem(warps, resident):
        return long_row_smem_bytes(L, D, warps, segmented, resident)

    cap = LONG_MAX_WARPS
    if 2 * (smem(min(blocks, LONG_MAX_WARPS // 2), True) + CTA_RESERVED_SMEM) <= SM_SMEM:
        cap = LONG_MAX_WARPS // 2
    for warps in range(min(cap, blocks), LONG_MIN_WARPS - 1, -1):
        if smem(warps, True) <= MAX_SMEM:
            return LongRowPlan("resident", warps, splits, smem(warps, True))
    warps = min(cap, blocks)
    return LongRowPlan("streamed", warps, splits, smem(warps, False))


def _check_long(L: int, D: int) -> None:
    if L <= SHORT_ROW or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the long-row plan takes L > {SHORT_ROW} and head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got L={L}, head_dim={D}")


def long_row_plan(B: int, L: int, H: int, D: int, segmented: bool, sms: int,
                  causal: bool = False) -> LongRowPlan:
    """The launch plan of a row of ``L > 128`` tokens on a card of ``sms`` SMs.

    * head_dim 64: the row ring up to 272 tokens (ViT-B/16's 197, ViT-L/14's
      257, 256 without a class token), where a warpgroup holds every score
      of its 64 query rows in registers and takes the exact row maxima in
      one pass (:func:`row_ring_plan`); the stream ring beyond (336 px at
      577, SigLIP-512 at 1024), which computes the scores twice, in chunks
      of 128 keys, or of 64 under a causal mask, which would spill beside 128
      keys of scores (:func:`stream_ring_plan`);
    * head_dim 128: ``flash_fwd_long_kernel`` (:func:`long_kernel_plan`).
      The rings have no head_dim 128 form: P V's accumulator alone would
      take 64 registers a thread and Q's fragments 32, so the row ring would
      hold no row of 197 scores and the stream ring no chunk of 128.

    ``python -m latteclip_torch.tools.long_row_plans`` times the rings'
    chunks, slots and grids beside ``flash_fwd_long_kernel``'s plans on the
    card (PERF.md keeps its numbers).
    """
    _check_long(L, D)
    if D == 64:
        if row_ring_keys(L):
            return row_ring_plan(B, L, H, sms)
        return stream_ring_plan(B, L, H, segmented, sms, 64 if causal else 128)
    return long_kernel_plan(B, L, H, D, segmented, sms)


# The launch plan of the backward's rows longer than SHORT_ROW tokens
# (csrc/flash_bwd.cu); the constants are the kernel's.
BWD_ROW_WARPS = 8  # the row kernel's launch bounds: at D=128 dk and dv take 128 registers
# the entry points' `resident` (2 was an earlier form's, which the kernel now refuses)
BWD_FORMS = {"tiled": 0, "resident": 1, "streamed": 3}
BWD_STREAM_BLOCK = 64   # tokens of the streamed pair's resident blocks
BWD_STREAM_CHUNK = 32   # tokens of its streamed chunks
BWD_STREAM_STAGES = 3   # its ring slots (the kernels' constant)
BWD_STREAM_CTAS = 3     # CTAs an SM of the streamed pair (its launch bounds)
BWD_STREAM_SMEM = SM_SMEM // BWD_STREAM_CTAS - CTA_RESERVED_SMEM  # each one's share of an SM
BWD_STREAM_WARPS = 5    # a streamed CTA: one consumer warpgroup and one producer warp


@dataclasses.dataclass(frozen=True)
class BwdLongRowPlan:
    """How the backward takes a row of more than 128 tokens: ``form``
    "streamed" (the dq kernel, then the dk/dv kernel, each on ``grid``
    persistent CTAs of ``warps`` warps, three an SM, each holding a 64-token
    block and streaming the row in 32-token chunks through three ring
    slots), "resident" (the row kernel with Q, K, V and dO of the row in
    padded shared rows, one CTA per (row, head) an SM) or "tiled" (the pair
    of 64-token tile kernels, 4 warps a CTA), and the CTA's dynamic shared
    memory (the larger of the streamed pair's two)."""
    form: str
    warps: int
    smem_bytes: int
    grid: int = 0

    def c_args(self) -> Tuple[int, int]:
        """The entry points' plan integers ``(warps, resident)``: the
        streamed form passes its grid in place of warps, every form its
        code."""
        return self.grid if self.form == "streamed" else self.warps, BWD_FORMS[self.form]


def bwd_row_smem_bytes(L: int, D: int, segmented: bool) -> int:
    """Shared memory of one row-kernel CTA (mirrors ``Tiles<D>::bytes`` in
    csrc/flash_bwd.cu): Q, dO, K and V of the row in rows of D + 8 values,
    lse2 and delta, and the segment ids of queries and keys when
    segmented."""
    rows = -(-L // 16) * 16
    return 4 * rows * (D + 8) * 2 + 8 * rows + (8 * rows if segmented else 0)


def bwd_tiled_smem_bytes(D: int, segmented: bool) -> int:
    """Shared memory of one CTA of the tiled pair: the same for 64-token tiles."""
    return bwd_row_smem_bytes(LONG_TILE, D, segmented)


def bwd_stream_smem_bytes(segmented: bool) -> Tuple[int, int]:
    """Shared memory of one CTA of the streamed pair's dq kernel and of its
    dk/dv kernel (mirror ``stream_dq_smem_bytes`` and
    ``stream_dkdv_smem_bytes`` in csrc/flash_bwd.cu), head_dim 64, tiles in
    rows of 128 bytes: 1 KB to align; dq: two item slots of Q, dO and out (64
    rows each), three ring slots of K and V (32 rows each), lse2 and delta of
    the item slots; dk/dv: two item slots of K and V, three ring slots of Q,
    dO and Qs with their lse2 and delta; the seg ids of every slot when
    segmented; the mbarriers (three an item slot and two a ring slot in dq,
    two an item slot and three a ring slot in dk/dv)."""
    blk, chunk, stages = BWD_STREAM_BLOCK, BWD_STREAM_CHUNK, BWD_STREAM_STAGES
    seg = (2 * blk + stages * chunk) * 4 if segmented else 0
    dq = (SW128_ALIGN + 6 * blk * 128 + 2 * stages * chunk * 128 + 2 * 2 * blk * 4 + seg
          + 8 * (6 + 2 * stages))
    dkdv = (SW128_ALIGN + 4 * blk * 128 + 3 * stages * chunk * 128 + stages * chunk * 8 + seg
            + 8 * (4 + 3 * stages))
    return dq, dkdv


def bwd_stream_plan(B: int, L: int, H: int, segmented: bool, sms: int) -> BwdLongRowPlan:
    """The streamed pair's plan for ``L > 128`` at head_dim 64: three CTAs an
    SM (their registers and shared memory) on a grid of ``min(items, 3 *
    sms)`` CTAs, where the items are the ``B * H * ceil(L / 64)`` (row, head,
    64-token block)s."""
    items = B * H * -(-L // BWD_STREAM_BLOCK)
    return BwdLongRowPlan("streamed", BWD_STREAM_WARPS, max(bwd_stream_smem_bytes(segmented)),
                          min(items, BWD_STREAM_CTAS * sms))


def bwd_long_row_plan(B: int, L: int, H: int, D: int, segmented: bool, sms: int) -> BwdLongRowPlan:
    """The backward's launch plan for a row of ``L > 128`` tokens.

    * D=64: the streamed pair at every length (ViT-B/16's 197, ViT-L/14's
      257, 336 px at 577, SigLIP-512 at 1024), from :func:`bwd_stream_plan`.
      Up to 208 tokens it replaced an earlier form that held the whole row
      unpadded in shared memory, two CTAs of 8 warps an SM: the streamed
      pair was faster at both [64, 197, 12 x 64] and [512, 197, 12 x 64]
      (PERF.md keeps both times);
    * D=128: resident where the padded row fits a CTA (up to 208 tokens),
      one warp per 16-token block up to 8; warp w walks the blocks w, w +
      warps, ...; the tiled pair beyond. The streamed pair has no D=128
      form: dk and dv alone would take 128 f32 registers a thread, so the
      same template would hold one CTA an SM.
    ``python -m latteclip_torch.tools.long_row_plans`` times every form on
    the card (PERF.md keeps its numbers). ``B``, ``H`` and ``sms`` change
    only the streamed pair's grid.
    """
    if L <= SHORT_ROW or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the backward long-row plan takes L > {SHORT_ROW} and head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got L={L}, head_dim={D}")
    if D == 64:
        return bwd_stream_plan(B, L, H, segmented, sms)
    smem = bwd_row_smem_bytes(L, D, segmented)
    if smem <= MAX_SMEM:
        return BwdLongRowPlan("resident", min(-(-L // 16), BWD_ROW_WARPS), smem)
    return BwdLongRowPlan("tiled", 4, bwd_tiled_smem_bytes(D, segmented))


def _launch_fwd(name: str, counter: str, qkv: torch.Tensor, seg_ids: Optional[torch.Tensor],
                num_heads: int, causal: bool, lse_shape=None):
    """Check ``qkv`` (and ``seg_ids``), launch the forward entry point
    ``name`` and count it; ``lse_shape`` defaults to ``[B, H, L]``. Rows of
    at most 128 tokens carry their :func:`short_row_plan` (the block-diagonal
    forward none: it takes one CTA per (row, head), which beat its ring by
    4-27% at head width 64, PERF.md), whose form ``short_fwd_form_counts``
    counts, longer ones their :func:`long_row_plan`, whose form
    ``fwd_form_counts`` counts."""
    B, L, H, D = _check_cuda_qkv(qkv, num_heads)
    if seg_ids is not None:
        _check_seg(seg_ids, qkv, B, L)
    kernel = _kernel(name)
    out = torch.empty((B, L, H * D), dtype=qkv.dtype, device=qkv.device)
    lse2 = torch.empty(lse_shape or (B, H, L), dtype=torch.float32, device=qkv.device)
    tensors = [qkv, *([] if seg_ids is None else [seg_ids]), out, lse2]
    sms = sm_count(qkv.device.index)
    plan, forms = None, None
    if name == "latteclip_flash_fwd_bd":  # one CTA per (row, head): its ring was slower
        plan_args = ()
    elif L <= SHORT_ROW:
        plan, forms = short_row_plan(B, L, H, D, seg_ids is not None, sms), short_fwd_form_counts
        plan_args = plan.c_args()
    else:
        plan, forms = long_row_plan(B, L, H, D, seg_ids is not None, sms, causal), fwd_form_counts
        plan_args = plan.c_args()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = kernel(*(t.data_ptr() for t in tensors), B, L, H, D, int(causal),
                     (D ** -0.5) * LOG2E, *plan_args, stream)
    _raise_on(err, name)
    launch_counts[counter] += 1
    if plan is not None:
        forms[plan.form] += 1
    return out, lse2


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int, causal: bool = False):
    """Fused attention on ``qkv [B, L, 3*H*D]`` -> ``(out, lse2)``.

    A CUDA tensor launches the Hopper kernel (bf16, head_dim 64 or 128) and
    raises on anything else; a CPU tensor takes :func:`flash_fwd_plain`."""
    if not qkv.is_cuda:
        return flash_fwd_plain(qkv, num_heads, causal)
    return _launch_fwd("latteclip_flash_fwd", "flash_fwd", qkv, None, num_heads, causal)


def flash_attention_qkv_segmented(
    qkv: torch.Tensor, num_heads: int, seg_ids: torch.Tensor, causal: bool = True
):
    """Segment-masked fused attention on packed rows ``qkv [R, P, 3*H*D]``
    with ``seg_ids [R, P]`` (int32, 0 = padding) -> ``(out, lse2)``.

    A CUDA tensor launches the Hopper kernel and raises on what it does not
    take; a CPU tensor takes :func:`flash_fwd_seg_plain`."""
    if not qkv.is_cuda:
        return flash_fwd_seg_plain(qkv, seg_ids, num_heads, causal)
    return _launch_fwd("latteclip_flash_fwd_seg", "flash_fwd_seg", qkv, seg_ids, num_heads, causal)


def flash_attention_qkv_hs(qkv: torch.Tensor, num_heads: int, causal: bool = False):
    """Head-split attention on ``qkv [B, L, 3*H*D]`` -> ``(out, lse2 [H/HP, HP, B, L])``.

    A CUDA tensor launches the Hopper kernel and raises where the head-split
    route does not apply; a CPU tensor takes :func:`flash_fwd_hs_plain`."""
    if not qkv.is_cuda:
        return flash_fwd_hs_plain(qkv, num_heads, causal)
    B, L, H, D = _check_cuda_qkv(qkv, num_heads)
    return _launch_fwd("latteclip_flash_fwd_hs", "flash_fwd_hs", qkv, None, num_heads, causal,
                       _hs_lse_shape(B, L, H, D))


def flash_attention_qkv_bd(qkv: torch.Tensor, num_heads: int, causal: bool = False):
    """Whole-row attention with the block-diagonal kernel's rounding on
    ``qkv [B, L, 3*H*D]`` (L <= 128, H*D <= 1024) -> ``(out, lse2 [B, H, L])``.

    A CUDA tensor launches the Hopper kernel and raises on longer or wider
    rows; a CPU tensor takes :func:`flash_fwd_bd_plain`."""
    if not qkv.is_cuda:
        return flash_fwd_bd_plain(qkv, num_heads, causal)
    B, L, H, D = _check_cuda_qkv(qkv, num_heads)
    if L > BLOCKDIAG_MAX_LEN or H * D > BLOCKDIAG_MAX_WIDTH:
        raise ValueError(f"the block-diagonal kernel takes L <= {BLOCKDIAG_MAX_LEN} and H*D <= "
                         f"{BLOCKDIAG_MAX_WIDTH}, got L={L}, H*D={H * D}")
    return _launch_fwd("latteclip_flash_fwd_bd", "flash_fwd_bd", qkv, None, num_heads, causal)


def _launch_bwd(name: str, counter: str, qkv, seg_ids, out, dout, lse2, num_heads, causal,
                lse_shape=None) -> torch.Tensor:
    """Check the residuals, launch the backward entry point ``name`` and
    count it; ``lse_shape`` defaults to ``[B, H, L]``. The gradient comes in
    the layout of ``qkv``; rows of at most 128 tokens carry their
    :func:`bwd_short_row_plan`, longer ones their :func:`bwd_long_row_plan`,
    whose forms ``short_bwd_form_counts`` and ``bwd_form_counts`` count."""
    B, L, H, D = _check_cuda_qkv(qkv, num_heads)
    _check_residual("out", out, qkv, (B, L, H * D), torch.bfloat16)
    _check_residual("dout", dout, qkv, (B, L, H * D), torch.bfloat16)
    _check_residual("lse2", lse2, qkv, lse_shape or (B, H, L), torch.float32)
    if seg_ids is not None:
        _check_seg(seg_ids, qkv, B, L)
    kernel = _kernel(name)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B, H, L), dtype=torch.float32, device=qkv.device)  # kernel scratch
    tensors = [qkv, *([] if seg_ids is None else [seg_ids]), out, dout, lse2, delta, dqkv]
    sms = sm_count(qkv.device.index)
    if L <= SHORT_ROW:
        plan, forms = bwd_short_row_plan(B, L, H, D, seg_ids is not None, sms), short_bwd_form_counts
        plan_args = plan.c_args(bwd=True)
    else:
        plan, forms = bwd_long_row_plan(B, L, H, D, seg_ids is not None, sms), bwd_form_counts
        plan_args = plan.c_args()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = kernel(*(t.data_ptr() for t in tensors), B, L, H, D, int(causal),
                     (D ** -0.5) * LOG2E, D ** -0.5, *plan_args, stream)
    _raise_on(err, name)
    launch_counts[counter] += 1
    forms[plan.form] += 1
    return dqkv


def flash_attention_qkv_bwd(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                            lse2: torch.Tensor, num_heads: int, causal: bool = False) -> torch.Tensor:
    """Gradient of :func:`flash_attention_qkv`'s ``out`` -> ``dqkv [B, L, 3*H*D]``.

    A CUDA tensor launches the Hopper kernel (bf16, head_dim 64 or 128, every
    tensor contiguous) and raises on anything else; a CPU tensor takes
    :func:`flash_bwd_plain`."""
    if not qkv.is_cuda:
        return flash_bwd_plain(qkv, out, dout, lse2, num_heads, causal)
    return _launch_bwd("latteclip_flash_bwd", "flash_bwd", qkv, None, out, dout, lse2, num_heads,
                       causal)


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
    return _launch_bwd("latteclip_flash_bwd_seg", "flash_bwd_seg", qkv, seg_ids, out, dout, lse2,
                       num_heads, causal)


def flash_attention_qkv_hs_bwd(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                               lse2: torch.Tensor, num_heads: int, causal: bool = False) -> torch.Tensor:
    """Gradient of :func:`flash_attention_qkv_hs`'s ``out`` from its lse2
    ``[H/HP, HP, B, L]`` -> ``dqkv [B, L, 3*H*D]``, the layout of ``qkv``.

    A CUDA tensor launches the Hopper kernel, which stores that layout, and
    raises on what it does not take; a CPU tensor takes
    :func:`flash_bwd_hs_plain` (the TPU kernel's ``dqkv3``) and merges it."""
    if not qkv.is_cuda:
        return merge_dqkv(flash_bwd_hs_plain(qkv, out, dout, lse2, num_heads, causal))
    B, L, H, D = _check_cuda_qkv(qkv, num_heads)
    return _launch_bwd("latteclip_flash_bwd_hs", "flash_bwd_hs", qkv, None, out, dout, lse2,
                       num_heads, causal, _hs_lse_shape(B, L, H, D))


def _kernel_ready(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``, contiguous and 16-byte aligned, copied only if not."""
    x = x.to(dtype).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _stored(residuals):
    """``(out, lse2)`` kept from an earlier forward of the same call, as new
    tensor objects on the same storage, or None. A rematerialised block's
    recompute passes them so its attention forward launches no kernel
    (``AttentionResiduals``); the backward then reads them as saved."""
    if residuals is None:
        return None
    return tuple(t.detach() for t in residuals)


class AttentionResiduals:
    """The attention outputs of one rematerialised block: its forward under
    ``torch.no_grad`` records each attention call's ``(out, lse2)``, and its
    recompute in the backward replays them in order, so the recompute runs
    the projections, LayerNorms and activations again but never the
    attention forward (JAX keeps ``flash_out`` and ``flash_lse`` saved under
    ``jax.checkpoint`` for the same reason)."""

    def __init__(self):
        self.saved = []
        self.replay = False

    def attend(self, fn, *args) -> torch.Tensor:
        """``fn.apply(*args)[0]``, recorded or replayed."""
        if self.replay:
            return fn.apply(*args, self.saved.pop(0))[0]
        out, lse2 = fn.apply(*args)
        self.saved.append((out, lse2))
        return out


class FlashAttention(torch.autograd.Function):
    """``(out, lse2) = flash_attention_qkv(qkv)`` with the backward kernel as
    its gradient (JAX ``_make_fa``). lse2 is not differentiable: its cotangent
    is ignored, as in the JAX backward."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, causal: bool, residuals=None):
        out, lse2 = _stored(residuals) or flash_attention_qkv(qkv, num_heads, causal)
        ctx.save_for_backward(qkv, out, lse2)
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.mark_non_differentiable(lse2)
        return out, lse2

    @staticmethod
    def backward(ctx, dout: torch.Tensor, _dlse2):
        qkv, out, lse2 = ctx.saved_tensors
        dqkv = flash_attention_qkv_bwd(qkv, out, _kernel_ready(dout, qkv.dtype), lse2,
                                       ctx.num_heads, ctx.causal)
        return dqkv, None, None, None


class FlashAttentionSegmented(torch.autograd.Function):
    """``(out, lse2) = flash_attention_qkv_segmented(qkv, seg_ids)`` with the
    segment-masked backward kernel as its gradient (JAX ``_make_fa_seg``).
    ``seg_ids`` and lse2 take no gradient."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, seg_ids: torch.Tensor, num_heads: int, causal: bool,
                residuals=None):
        out, lse2 = _stored(residuals) or flash_attention_qkv_segmented(qkv, num_heads, seg_ids,
                                                                        causal)
        ctx.save_for_backward(qkv, seg_ids, out, lse2)
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.mark_non_differentiable(lse2)
        return out, lse2

    @staticmethod
    def backward(ctx, dout: torch.Tensor, _dlse2):
        qkv, seg_ids, out, lse2 = ctx.saved_tensors
        dqkv = flash_attention_qkv_segmented_bwd(
            qkv, seg_ids, out, _kernel_ready(dout, qkv.dtype), lse2, ctx.num_heads, ctx.causal)
        return dqkv, None, None, None, None


class FlashAttentionHeadSplit(torch.autograd.Function):
    """``(out, lse2) = flash_attention_qkv_hs(qkv)`` with the head-split
    backward kernel as its gradient (JAX ``_make_fa`` with the head-split
    switch on), which comes in the layout of ``qkv``. lse2
    ``[H/HP, HP, B, L]`` takes no gradient."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, causal: bool, residuals=None):
        out, lse2 = _stored(residuals) or flash_attention_qkv_hs(qkv, num_heads, causal)
        ctx.save_for_backward(qkv, out, lse2)
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.mark_non_differentiable(lse2)
        return out, lse2

    @staticmethod
    def backward(ctx, dout: torch.Tensor, _dlse2):
        qkv, out, lse2 = ctx.saved_tensors
        dqkv = flash_attention_qkv_hs_bwd(qkv, out, _kernel_ready(dout, qkv.dtype), lse2,
                                          ctx.num_heads, ctx.causal)
        return dqkv, None, None, None


class FlashAttentionBlockDiag(torch.autograd.Function):
    """``(out, lse2) = flash_attention_qkv_bd(qkv)`` with the whole-row
    backward kernel as its gradient, as JAX pairs ``_flash_fwd_bd`` with
    ``_bwd_kernel``. lse2 takes no gradient."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, causal: bool, residuals=None):
        out, lse2 = _stored(residuals) or flash_attention_qkv_bd(qkv, num_heads, causal)
        ctx.save_for_backward(qkv, out, lse2)
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.mark_non_differentiable(lse2)
        return out, lse2

    @staticmethod
    def backward(ctx, dout: torch.Tensor, _dlse2):
        qkv, out, lse2 = ctx.saved_tensors
        dqkv = flash_attention_qkv_bwd(qkv, out, _kernel_ready(dout, qkv.dtype), lse2,
                                       ctx.num_heads, ctx.causal)
        return dqkv, None, None, None
