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

Every kernel takes a launch plan (:func:`lab_fwd_plan`, :func:`lab_bwd_plan`,
:func:`lab_qk_plan`, :func:`lab_pv_plan`), read from the shape alone so that
both entry points of a kernel launch alike: "ring" (persistent CTAs fed by
TMA and multiplying with wgmma; the forward up to ``FWD_RING_MAX_LEN``
tokens, the backward at head_dim 64 up to ``BWD_RING_MAX_LEN``) or "cta"
(one CTA per (b, h) or batch row, the first port's kernels, for the other
rows). The C entry points take the plan's ``(grid, stages)``, grid 0 for the
one-CTA form, and refuse one they cannot run.

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
import dataclasses
from typing import Tuple

import torch

from latteclip_torch.device import sm_count
from latteclip_torch.kernels.attention import CTA_RESERVED_SMEM, SM_SMEM, SW128_ALIGN
from latteclip_torch.obs.trace import counter_dict

KERNEL_HEAD_DIMS = (64, 128)
MAX_SMEM = 232448      # dynamic shared memory a CTA may use on an H100 (csrc/lab.cu)
PRODUCT_MAX_LEN = 128  # rows of the head-summed products held by one CTA
QK_CHUNK = 64          # HD columns of one streamed chunk of the Q K^T kernels
FWD_RING_MAX_LEN = 256  # keys whose scores a forward ring warpgroup holds in registers
RING_MAX_STAGES = 4    # ring slots of the forward ring
QK_MIN_STAGES, QK_MAX_STAGES = 2, 8  # ring slots of the Q K^T ring: a chunk's slot is
                                     # released once the next chunk's products are issued
PV_MIN_STAGES, PV_MAX_STAGES = 2, 8  # v slots of the P V ring, one 16-key step each
PV_P_SLOTS = 3                       # p slots of the P V ring: p is copied a row ahead
PV_INFLIGHT_BYTES = 65536            # v the P V plan keeps in flight an SM
BWD_RING_MAX_LEN = 208  # rows whose item and ds fit one backward ring CTA (head_dim 64)
BWD_RING_MAX_STAGES = 2  # resident items of the backward ring

# Launches of each kernel in this process (chip_smoke.py resets and reads them).
launch_counts = counter_dict("lab.launch_counts", ("lab_fwd", "lab_bwd", "lab_qk", "lab_pv"))


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


# -- launch plans ------------------------------------------------------------------
# The constants and shared-memory sizes mirror csrc/lab.cu.


@dataclasses.dataclass(frozen=True)
class LabPlan:
    """How a lab kernel is launched: ``form`` "ring" (``grid`` persistent
    CTAs, ``ctas_per_sm`` of them an SM, each with ``warpgroups`` consumer
    warpgroups and ``stages`` slots of a TMA ring; the backward's stages
    are its resident items) or "cta" (the first port's kernel:
    one CTA per (b, h) for the forward and backward, per batch row for the
    products), and the ring CTA's dynamic shared memory (0 for "cta")."""
    form: str
    warpgroups: int
    ctas_per_sm: int
    stages: int
    grid: int
    smem_bytes: int

    def c_args(self) -> Tuple[int, int]:
        """The entry points' plan integers: (grid, stages) of the ring, or
        (0, 0) for the one-CTA form."""
        return (self.grid, self.stages) if self.form == "ring" else (0, 0)


CTA_PLAN = LabPlan("cta", 0, 0, 0, 0, 0)


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _ring_plan(items: int, sms: int, warpgroups: int, max_ctas: int, min_stages: int,
               max_stages: int, smem_of) -> LabPlan:
    """The most CTAs an SM (at most ``max_ctas``, which the kernel's registers
    allow) at which ``min_stages`` stages fit each CTA's share of the SM's
    shared memory; then as many stages as fit (at most ``max_stages``); a
    grid of ``min(items, sms * ctas)``. The rings' time falls with the
    warpgroups an SM holds, more than with their stages."""
    def fitting(ctas):
        budget = min(MAX_SMEM, SM_SMEM // ctas - CTA_RESERVED_SMEM)
        return [s for s in range(min_stages, max_stages + 1) if smem_of(s) <= budget]

    ctas = next(c for c in range(max_ctas, 0, -1) if fitting(c) or c == 1)
    stages = max(fitting(ctas))
    return LabPlan("ring", warpgroups, ctas, stages, min(items, sms * ctas), smem_of(stages))


def qk_warpgroups(L: int) -> int:
    """Consumer warpgroups of a Q K^T ring CTA: one per 64 rows of S."""
    return 1 if L <= 64 else 2


def lab_qk_smem_bytes(L: int, stages: int) -> int:
    """Shared memory of one Q K^T ring CTA (``qk_ring_smem`` in csrc/lab.cu):
    per stage a q and a k tile of 64 rows a warpgroup x 128 B and a flat
    64 x L chunk of kT, then S of one row (L x L f32, + 16 B), the
    mbarriers, and 1 KB to align."""
    tile = 64 * qk_warpgroups(L) * 128
    return SW128_ALIGN + stages * (2 * tile + 128 * L) + _round16(4 * L * L) + 16 + 16 * stages


def lab_qk_plan(B: int, L: int, HD: int, sms: int) -> LabPlan:
    """The head-summed Q K^T's launch plan (natural and pret alike) for B
    batch rows of L <= 128 tokens on a card of ``sms`` SMs: the ring, one
    consumer warpgroup up to 64 tokens and two beyond, two CTAs an SM where
    two stages (``QK_MIN_STAGES``) fit each, else one, as many stages as fit
    (at most ``QK_MAX_STAGES``), a grid of ``min(B, sms * ctas_per_sm)`` CTAs, each
    walking the batch rows ``x, x + grid, ...`` and each row's ``HD / 64``
    chunks through the ring."""
    if not 1 <= L <= PRODUCT_MAX_LEN or HD < QK_CHUNK or HD % QK_CHUNK:
        raise ValueError(f"the Q K^T plan takes 1 <= L <= {PRODUCT_MAX_LEN} and HD a multiple of "
                         f"{QK_CHUNK}, got L={L}, HD={HD}")
    return _ring_plan(B, sms, qk_warpgroups(L), 2, QK_MIN_STAGES, QK_MAX_STAGES,
                      lambda s: lab_qk_smem_bytes(L, s))


def pv_warpgroups(L: int) -> int:
    """Consumer warpgroups of a P V ring CTA: one per 64 rows of O."""
    return 1 if L <= 64 else 2


def pv_p_bytes(L: int) -> int:
    """Bytes of a P V ring's p slot: one batch row of p and the up to 14
    bytes on each side that its 16-byte aligned copy brings along."""
    return _round16(2 * L * L + 28)


def lab_pv_smem_bytes(L: int, HD: int, stages: int) -> int:
    """Shared memory of one P V ring CTA (``pv_ring_smem`` in csrc/lab.cu):
    per stage one 16-key step of every head (16 rows x HD bf16), the p
    slots, the mbarriers (16 B a stage and a p slot), and 1 KB to align."""
    return SW128_ALIGN + stages * 32 * HD + PV_P_SLOTS * pv_p_bytes(L) + 16 * (stages + PV_P_SLOTS)


def lab_pv_plan(B: int, L: int, H: int, D: int, sms: int) -> LabPlan:
    """The head-summed P V's launch plan for B batch rows of L <= 128 tokens
    and H heads of D on a card of ``sms`` SMs: the ring, one consumer
    warpgroup up to 64 tokens and two beyond; two CTAs an SM at head_dim 64
    (one at 128, whose accumulators need the registers) where two stages
    (``PV_MIN_STAGES``) fit each, else one; the fewest stages that keep
    ``PV_INFLIGHT_BYTES`` of v in flight an SM (the time rose with more, in
    the sweep of ``tools/lab_plans.py``), at most as many as fit; a grid of
    ``min(B, sms * ctas_per_sm)`` CTAs, each walking the batch rows
    ``x, x + grid, ...`` and each row's 16-key steps of v (every head a step)
    through the ring; "cta" where two stages of v do not fit a CTA."""
    _head_dim(D)
    if not 1 <= L <= PRODUCT_MAX_LEN or H < 1:
        raise ValueError(f"the P V plan takes 1 <= L <= {PRODUCT_MAX_LEN} and H >= 1, got L={L}, H={H}")

    def fits(ctas, stages):
        return lab_pv_smem_bytes(L, H * D, stages) <= min(MAX_SMEM, SM_SMEM // ctas - CTA_RESERVED_SMEM)

    ctas = 2 if D == 64 and fits(2, PV_MIN_STAGES) else 1
    if not fits(ctas, PV_MIN_STAGES):
        return CTA_PLAN
    want = min(PV_MAX_STAGES, max(PV_MIN_STAGES, -(-PV_INFLIGHT_BYTES // (ctas * 32 * H * D))))
    stages = max(s for s in range(PV_MIN_STAGES, want + 1) if fits(ctas, s))
    return LabPlan("ring", pv_warpgroups(L), ctas, stages, min(B, sms * ctas),
                   lab_pv_smem_bytes(L, H * D, stages))


def bwd_tile_rows(L: int) -> int:
    """Token rows of a backward ring tile (``bwd_ring_rows``): round16(L) for
    rows of two or more 64-row blocks, else 64."""
    return 64 if L <= 64 else _round16(L)


def lab_bwd_smem_bytes(L: int, stages: int) -> int:
    """Shared memory of one backward ring CTA at head_dim 64
    (``bwd_ring_smem`` in csrc/lab.cu): per stage Q, dO, V and K of one
    (b, h), and ds, one panel a 64-key block, each ``bwd_tile_rows(L)`` rows
    x 128 B; a 64 x 64 bf16 output tile for each of the two warpgroups;
    lse2 and delta (f32 a row); an mbarrier a stage and a count; 1 KB to
    align."""
    R = bwd_tile_rows(L)
    return (SW128_ALIGN + (4 * stages + fwd_key_blocks(L)) * R * 128 + 2 * 64 * 64 * 2 + 8 * R
            + 16 * stages)


def lab_bwd_plan(B: int, L: int, H: int, D: int, sms: int) -> LabPlan:
    """The lab backward's launch plan on a card of ``sms`` SMs:

    * the ring at head_dim 64 for rows of at most ``BWD_RING_MAX_LEN``
      tokens (an item and its ds must fit a CTA's shared memory): two
      consumer warpgroups, one CTA an SM, two resident items where they fit
      (up to 144 tokens), else one, and a grid of ``min(B * H, sms)`` CTAs,
      each walking the (b, h) items ``x, x + grid, ...``;
    * otherwise "cta": head_dim 128 and longer rows."""
    _head_dim(D)
    if L < 1:
        raise ValueError(f"the lab backward takes L >= 1, got {L}")
    if D != 64 or L > BWD_RING_MAX_LEN:
        return CTA_PLAN
    stages = max(s for s in range(1, BWD_RING_MAX_STAGES + 1) if lab_bwd_smem_bytes(L, s) <= MAX_SMEM)
    return LabPlan("ring", 2, 1, stages, min(B * H, sms), lab_bwd_smem_bytes(L, stages))


def fwd_key_blocks(L: int) -> int:
    """64-key blocks of a forward ring row (its box holds 64 of them a block)."""
    return -(-L // 64)


def fwd_warpgroups(L: int) -> int:
    """Consumer warpgroups of a forward ring CTA (``fwd_ring_wgs``): two where
    the row's 64-row query blocks split evenly between them, else one."""
    return 1 if fwd_key_blocks(L) % 2 else 2


def fwd_max_ctas(L: int, D: int) -> int:
    """CTAs an SM the forward ring's registers allow (``fwd_ring_min_ctas``:
    a warpgroup holds its rows' scores over 64 keys a key block in
    registers, 32 a thread each)."""
    kb = fwd_key_blocks(L)
    if kb == 1:
        return 4 if D == 64 else 2
    if kb == 3:
        return 2
    return 2 if kb == 2 and D == 64 else 1


def lab_fwd_smem_bytes(L: int, D: int, stages: int) -> int:
    """Shared memory of one forward ring CTA (``fwd_ring_smem`` in
    csrc/lab.cu): per stage Q, K and V of one (b, h) in boxes of 64 rows a
    key block, a full mbarrier and a release count; a warpgroup's 64 x D
    output tile; 1 KB to align."""
    return (SW128_ALIGN + stages * 3 * D * 64 * fwd_key_blocks(L) * 2 + fwd_warpgroups(L) * 64 * D * 2
            + 16 * stages)


def lab_fwd_plan(B: int, L: int, H: int, D: int, sms: int) -> LabPlan:
    """The lab forward's launch plan (packed and BHLD alike: it reads the
    shape only) on a card of ``sms`` SMs:

    * "cta" for rows of more than ``FWD_RING_MAX_LEN`` tokens, whose scores
      do not fit a warpgroup's registers;
    * otherwise the ring: one consumer warpgroup a CTA where the row has an
      odd number of 64-row blocks, else two; the most CTAs an SM that the
      kernel's registers allow and at which one stage fits; as many stages
      as fit (at most ``RING_MAX_STAGES``); a grid of
      ``min(B * H, sms * ctas_per_sm)`` CTAs, each walking the (b, h) items
      ``x, x + grid, ...``."""
    _head_dim(D)
    if L < 1:
        raise ValueError(f"the lab forward takes L >= 1, got {L}")
    if L > FWD_RING_MAX_LEN:
        return CTA_PLAN
    return _ring_plan(B * H, sms, fwd_warpgroups(L), fwd_max_ctas(L, D), 1, RING_MAX_STAGES,
                      lambda s: lab_fwd_smem_bytes(L, D, s))


# -- wrappers ----------------------------------------------------------------------

_SIGNATURES = {
    # name: argument kinds, "p" pointer, "i" int, "f" float; every one returns int
    "latteclip_lab_fwd_packed": "pppppiiiifiip",
    "latteclip_lab_fwd_bhld": "pppppiiiifiip",
    "latteclip_lab_bwd_bhld": "ppppppppiiiifiip",
    "latteclip_lab_qk_natural": "pppiiiiip",
    "latteclip_lab_qk_pret": "pppiiiiip",
    "latteclip_lab_pv": "pppiiiiiip",
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
    for n, x in (("q", q), ("k", k), ("v", v)):
        _check(n, x, o_shape)
    plan = lab_fwd_plan(B, L, H, D, sm_count(q.device.index))
    if plan.form == "cta":
        _check_row_fits(L, D, 3)
    o = torch.empty(o_shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(lse_shape, dtype=torch.float32, device=q.device)
    _launch(name, "lab_fwd", [q, k, v, o, lse], B, L, H, D, D ** -0.5, *plan.c_args())
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
    for n, x in (("qb", qb), ("kb", kb), ("vb", vb), ("dob", dob)):
        _check(n, x, (B, H, L, D))
    _check("lse", lse, (H, B, L), torch.float32)
    plan = lab_bwd_plan(B, L, H, D, sm_count(qb.device.index))
    if plan.form == "cta":
        _check_row_fits(L, D, 4, extra=8)
    grads = [torch.empty_like(qb) for _ in range(3)]
    _launch("latteclip_lab_bwd_bhld", "lab_bwd", [qb, kb, vb, dob, lse, *grads], B, L, H, D,
            D ** -0.5, *plan.c_args())
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
    _launch(name, "lab_qk", [q, k, s], B, L, HD, *lab_qk_plan(B, L, HD, sm_count(q.device.index)).c_args())
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
    _launch("latteclip_lab_pv", "lab_pv", [p, v, o], B, L, num_heads, D,
            *lab_pv_plan(B, L, num_heads, D, sm_count(v.device.index)).c_args())
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

