"""Int8 serving: per-output-channel int8 weights for the dense layers (port
of ``latteclip_tpu/models/quantize.py``).

* :func:`quantize_weight` -- symmetric absmax int8 of a torch ``[out, in]``
  weight, one float32 scale per output channel (JAX reduces over the ``in``
  axis of its ``(in, out)`` kernel: the same numbers);
* :class:`Int8Weight` -- the quantised weight as a module with ``int8`` and
  ``scale`` buffers. :func:`replace_linear` puts it in place of the weight
  parameter on the module that owns it (an ``nn.Linear``, or a block's
  ``attn.in_proj_weight``), so every forward that passes ``layer.weight``
  on to :func:`~latteclip_torch.kernels.fused_ln_linear.dense` or
  ``ln_linear`` dispatches on it, as JAX's ``layers.dense`` dispatches on
  the ``{"int8", "scale"}`` dict;
* :func:`int8_dense` -- per-row dynamic absmax quantisation of the
  activations, an int8 x int8 -> int32 product (``torch._int_mm``: a library
  GEMM, as JAX's ``lax.dot_general`` is), then ``acc * ax * scale`` in
  float32, cast to the compute dtype, and the bias added in that dtype.

Serving only: a train step on a quantised model is refused
(:func:`refuse_training`), as the JAX package never quantises for training.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_INCLUDE = ("c_fc_w", "c_proj_w")  # reference utils.py:66 include_modules

# JAX leaf name -> the port's weight, by the block layouts of checkpoint.py
# (native OpenCLIP blocks, CoCa's decoder and cross blocks, CoCa's attentional
# pool, and the stacked blocks of the timm ViT and EVA02 trunks)
_NATIVE = {"in_proj_w": "attn.in_proj_weight", "out_proj_w": "attn.out_proj.weight",
           "c_fc_w": "mlp.c_fc.weight", "c_proj_w": "mlp.c_proj.weight"}
_TIMM = {"in_proj_w": "attn.qkv.weight", "out_proj_w": "attn.proj.weight",
         "c_fc_w": "mlp.fc1.weight", "c_proj_w": "mlp.fc2.weight"}
_EVA02 = {"out_proj_w": "attn.proj.weight", "c_fc_w": "mlp.fc1.weight",
          "c_proj_w": "mlp.fc2.weight"}
_BLOCKS = (
    (re.compile(r"^(?:visual\.|text\.|)transformer\.resblocks\.\d+\.$"), _NATIVE),
    (re.compile(r"^text_decoder\.(?:resblocks|cross_attn)\.\d+\.$"), _NATIVE),
    (re.compile(r"^visual\.attn_pool\.$"), {"out_proj_w": "attn.out_proj.weight"}),
    (re.compile(r"^visual\.trunk\.(?:layers\.\d+\.)?blocks\.\d+\.$"), None),  # by the trunk
)
SUPPORTED = tuple(_NATIVE)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., out, in]`` float weight -> (int8 ``[..., out, in]``, float32
    scale ``[..., out]``): ``scale = max(absmax, 1e-12) / 127`` over ``in``,
    ``int8 = clip(round(w / scale), -127, 127)`` (round half to even)."""
    w = w.float()
    scale = w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


class Int8Weight(nn.Module):
    """A dense weight ``[out, in]`` held as ``int8`` and per-output-channel
    ``scale`` buffers. It stands where the weight parameter stood; only
    ``dense`` and ``ln_linear`` consume it (:func:`int8_dense`): a forward
    that slices the weight fails on it, as JAX's fails on its dict."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        q, scale = quantize_weight(weight.detach())
        self.register_buffer("int8", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.int8.shape


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - x.shape[dim]
    if extra <= 0:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, extra]
    return F.pad(x, pad)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] . wq [N, K]^T`` in int32 through ``torch._int_mm``, whose
    CUDA form takes more than 16 rows and K, N multiples of 8: rows, K and N
    are zero-padded to that and the padding sliced off (zeros add nothing to
    an integer sum)."""
    M, K = xq.shape
    N = wq.shape[0]
    Mp, Kp, Np = max(M, 24), -(-K // 8) * 8, -(-N // 8) * 8
    a = _pad_to(_pad_to(xq, 0, Mp), 1, Kp)
    b = _pad_to(_pad_to(wq, 0, Np), 1, Kp)
    return torch._int_mm(a.contiguous(), b.t())[:M, :N]


def int8_dense(x: torch.Tensor, w: Int8Weight, bias, dtype: torch.dtype) -> torch.Tensor:
    """JAX ``int8_dense``: ``ax = max(|x|_row, 1e-12) / 127``, ``xq =
    clip(round(x / ax))``, ``acc = xq . int8^T`` in int32, ``y = (acc * ax) *
    scale`` in float32, cast to ``dtype``, plus the bias in ``dtype``.

    The same float32 arithmetic in fewer passes than written: the row
    absmax is ``max(max x, -min x)`` read from ``x`` itself (exact in any
    dtype), ``x / ax`` and ``acc * ax`` promote to float32 as they read, and
    the rounding, clip and rescale run in place."""
    ax = torch.maximum(x.amax(dim=-1, keepdim=True), -x.amin(dim=-1, keepdim=True))
    ax = ax.float().clamp_min(1e-12) / 127.0
    xq = torch.div(x, ax).round_().clamp_(-127, 127).to(torch.int8)
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), w.int8)
    y = torch.mul(acc.reshape(*x.shape[:-1], -1), ax).mul_(w.scale).to(dtype)
    if bias is not None:
        y = y.add_(bias.to(dtype))
    return y


def _block_table(model, pattern_table, prefix: str) -> Dict[str, str]:
    if pattern_table is not None:
        return pattern_table
    from latteclip_torch.config import Eva02VisionConfig, VisionConfig

    v = model.cfg.vision
    if isinstance(v, Eva02VisionConfig):
        return _EVA02 if not v.swiglu else {"out_proj_w": "attn.proj.weight"}
    if isinstance(v, VisionConfig) and v.timm_trunk:
        return _TIMM
    # Swin and ViT-relpos: JAX keeps their blocks in lists, which its walk
    # does not enter, so it quantises none of them
    return {}


def quantizable_weights(model: nn.Module) -> Dict[str, Tuple[nn.Module, str, str]]:
    """Every dense weight of ``model`` that JAX's ``replace_linear`` can
    reach by a leaf name: ``{parameter name: (owner module, attribute, JAX
    leaf name)}``."""
    out: Dict[str, Tuple[nn.Module, str, str]] = {}
    modules = dict(model.named_modules())
    for name in modules:
        prefix = name + "."
        for pattern, table in _BLOCKS:
            if not pattern.match(prefix):
                continue
            for leaf, suffix in _block_table(model, table, prefix).items():
                owner_name, attr = (prefix + suffix).rsplit(".", 1)
                owner = modules.get(owner_name)
                if owner is not None and hasattr(owner, attr):
                    out[prefix + suffix] = (owner, attr, leaf)
    return out


def replace_linear(model: nn.Module, include: Sequence[str] = DEFAULT_INCLUDE
                   ) -> Tuple[nn.Module, int]:
    """Quantise, in place, every dense weight whose JAX leaf name is in
    ``include`` -> ``(model, count)``. JAX counts a stacked ``[L, in, out]``
    leaf once; here each layer's weight counts (ViT-B/32: 2 x (12 + 12)).
    Leaf names other than the block projections of :data:`SUPPORTED` are
    refused."""
    unknown = sorted(set(include) - set(SUPPORTED))
    if unknown:
        raise NotImplementedError(
            f"replace_linear: leaves {unknown} are not quantised by latteclip_torch; it takes "
            f"{list(SUPPORTED)} (ROADMAP.md, section 3)")
    count = 0
    for _name, (owner, attr, leaf) in quantizable_weights(model).items():
        w = getattr(owner, attr)
        if leaf not in include or isinstance(w, Int8Weight):
            continue
        q = Int8Weight(w).to(w.device)
        delattr(owner, attr)
        setattr(owner, attr, q)
        count += 1
    return model, count


def is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, Int8Weight) for m in model.modules())


def refuse_training(model: nn.Module) -> None:
    if is_quantized(model):
        raise ValueError("a quantised model serves only: int8 weights do not train "
                         "(models/quantize.py, as in the JAX package)")
