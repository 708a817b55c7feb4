"""EVA-02 vision trunk (port of ``latteclip_tpu/models/eva02.py``).

The TrV blocks of EVA02-B and -L: pre-norm, a 2-D axial rope on q and k
(identity on the class token), an inner LayerNorm on the merged heads before
the out-projection, and SwiGLU with a sub-LayerNorm,
``LN_sub(silu(h W1g) * (h W1x)) W2``; EVA02-E's blocks are post-norm with a
plain GELU MLP and no rope. Attention runs on the packed projection
``[B, L, 3*H*D]`` through :func:`latteclip_torch.kernels.attention_core_qkv`
(the Hopper kernels at head widths 64 and 128, as JAX runs its Pallas
kernels there; E's 112-wide heads take the plain route, as JAX takes XLA).

Parameters carry timm's names (``visual.trunk.*``): ``attn.qkv`` with
``q_bias``/``v_bias`` (B, E), or ``attn.{q,k,v}_proj`` with a biasless k
(L), and the k bias JAX trains but does not save
(:class:`~latteclip_torch.models.layers.EvaAttention`); ``mlp.{fc1_g,fc1_x,norm,fc2}``
or ``mlp.{fc1,fc2}``; ``head`` is the biased projection. So a real EVA-CLIP
checkpoint loads unchanged, and the rope is timm's: channels ``(2i, 2i+1)``
rotate together by the angle of band ``i`` (``concat(y_angles, x_angles)``,
``D/4`` bands of ``temperature^(-4i/D)`` each, positions scaled to
``ref_feat_shape``). The JAX package keeps q and k in its rotate-half order
and permutes their channels at import and export
(``core/checkpoint.py::_eva02_rope_qk_perm``); q . k is the same sum in
either order, so the two compute the same features from the same
checkpoint, and :mod:`latteclip_torch.checkpoint` applies that permutation
when it carries JAX's tree.

The JAX package runs these blocks without its fused LayerNorm -> linear
kernel and without pair-packing, so this tower takes no ``ln_linear`` and
no ``pack_pairs``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from latteclip_torch.config import Eva02VisionConfig
from latteclip_torch.kernels import attention_core_qkv
from latteclip_torch.kernels.fused_ln_linear import dense, layer_norm
from latteclip_torch.models import layers
from latteclip_torch.models.vit import patchify


def rope_angles(grid: int, head_dim: int, temperature: float = 10000.0,
                ref_shape: Optional[int] = None) -> torch.Tensor:
    """[1 + grid*grid, head_dim / 2] float32 angles, one per channel pair;
    row 0 (the class token) is 0. The pair order is JAX's ``rope_sin_cos``
    before its rotate-half duplication."""
    if head_dim % 4:
        raise ValueError("2-D rope needs head_dim divisible by 4")
    bands = head_dim // 4
    freqs = torch.pow(torch.tensor(temperature, dtype=torch.float32),
                      -torch.arange(bands, dtype=torch.float32) / bands)
    pos = torch.arange(grid, dtype=torch.float32)
    if ref_shape:
        pos = pos * (ref_shape / grid)
    a = pos[:, None] * freqs[None, :]                                  # [grid, bands]
    ang = torch.cat([a[:, None, :].expand(grid, grid, bands),
                     a[None, :, :].expand(grid, grid, bands)], dim=-1)
    return torch.cat([torch.zeros(1, head_dim // 2), ang.reshape(grid * grid, head_dim // 2)])


def apply_rope_interleaved(qkv: torch.Tensor, num_heads: int, sin: torch.Tensor,
                           cos: torch.Tensor) -> torch.Tensor:
    """Rotate q and k inside the packed ``[B, L, 3*H*D]`` tensor by timm's
    interleaved pairing (``sin``/``cos`` ``[L, D/2]``); v unchanged. The
    arithmetic is JAX's ``x * cos + rot(x) * sin`` in the tensor's dtype."""
    B, L, HD3 = qkv.shape
    HD = HD3 // 3
    D = HD // num_heads
    qk = qkv[..., :2 * HD].reshape(B, L, 2, num_heads, D // 2, 2)
    x0, x1 = qk[..., 0], qk[..., 1]
    s = sin.to(qkv.dtype).view(1, L, 1, 1, D // 2)
    c = cos.to(qkv.dtype).view(1, L, 1, 1, D // 2)
    rot = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1).reshape(B, L, 2 * HD)
    return torch.cat([rot, qkv[..., 2 * HD:]], dim=-1)


class Eva02Block(nn.Module):
    def __init__(self, cfg: Eva02VisionConfig):
        super().__init__()
        D, H, eps = cfg.width, cfg.swiglu_hidden, cfg.ln_eps
        self.cfg = cfg
        self.norm1 = layers.LayerNorm(D, eps=eps)
        self.attn = layers.EvaAttention(D)
        if cfg.qkv_fused:
            self.attn.qkv = nn.Linear(D, 3 * D, bias=False)
            self.attn.q_bias = nn.Parameter(torch.empty(D))
            self.attn.v_bias = nn.Parameter(torch.empty(D))
        else:
            self.attn.q_proj = nn.Linear(D, D)
            self.attn.k_proj = nn.Linear(D, D, bias=False)
            self.attn.v_proj = nn.Linear(D, D)
        if cfg.inner_attn_norm:
            self.attn.norm = layers.LayerNorm(D, eps=eps)
        self.attn.proj = nn.Linear(D, D)
        self.norm2 = layers.LayerNorm(D, eps=eps)
        self.mlp = nn.Module()
        if cfg.swiglu:
            self.mlp.fc1_g = nn.Linear(D, H)
            self.mlp.fc1_x = nn.Linear(D, H)
            self.mlp.norm = layers.LayerNorm(H, eps=eps)
        else:
            self.mlp.fc1 = nn.Linear(D, H)
        self.mlp.fc2 = nn.Linear(H, D)

    def qkv_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The packed in-projection ``([3D, D], [3D])``."""
        a = self.attn
        if self.cfg.qkv_fused:
            q_b, v_b, w = a.q_bias, a.v_bias, a.qkv.weight
        else:
            q_b, v_b = a.q_proj.bias, a.v_proj.bias
            w = torch.cat([a.q_proj.weight, a.k_proj.weight, a.v_proj.weight])
        return w, torch.cat([q_b, a.k_bias, v_b])

    def forward(self, x: torch.Tensor, *, sin: Optional[torch.Tensor],
                cos: Optional[torch.Tensor], dtype: torch.dtype, attention: str = "kernel",
                residuals=None) -> torch.Tensor:
        """JAX's ``_eva02_block``; ``residuals`` records or replays the
        attention under remat (:func:`layers.run_blocks`)."""
        cfg, a = self.cfg, self.attn
        post = cfg.post_norm
        h = x.to(dtype) if post else self.norm1(x).to(dtype)
        qkv = dense(h, *self.qkv_params(), dtype)
        if cfg.use_rope:
            qkv = apply_rope_interleaved(qkv, cfg.heads, sin, cos)
        o = attention_core_qkv(qkv, cfg.heads, False, attention, residuals)
        if cfg.inner_attn_norm:
            o = a.norm(o).to(dtype)
        o = dense(o, a.proj.weight, a.proj.bias, dtype)
        if post:
            o = self.norm1(o).to(dtype)
        x = x + o

        h = x.to(dtype) if post else self.norm2(x).to(dtype)
        m = self.mlp
        if cfg.swiglu:
            g = F.silu(dense(h, m.fc1_g.weight, m.fc1_g.bias, dtype))
            hid = m.norm(g * dense(h, m.fc1_x.weight, m.fc1_x.bias, dtype)).to(dtype)
        else:
            hid = layers.gelu(dense(h, m.fc1.weight, m.fc1.bias, dtype))
        out = dense(hid, m.fc2.weight, m.fc2.bias, dtype)
        if post:
            out = self.norm2(out).to(dtype)
        return x + out


class Eva02VisionTower(nn.Module):
    """``trunk.patch_embed.proj`` (biased), ``trunk.cls_token`` ``[1, 1, D]``,
    ``trunk.pos_embed`` ``[1, L, D]``, ``trunk.blocks``, ``trunk.norm`` and
    the biased ``trunk.head`` to ``embed_dim``."""

    def __init__(self, cfg: Eva02VisionConfig, embed_dim: int):
        super().__init__()
        D, P = cfg.width, cfg.patch_size
        self.cfg = cfg
        self.trunk = nn.Module()
        self.trunk.patch_embed = nn.Module()
        self.trunk.patch_embed.proj = nn.Conv2d(3, D, kernel_size=P, stride=P)
        self.trunk.cls_token = nn.Parameter(torch.empty(1, 1, D))
        self.trunk.pos_embed = nn.Parameter(torch.empty(1, cfg.seq_len, D))
        self.trunk.blocks = nn.ModuleList(Eva02Block(cfg) for _ in range(cfg.layers))
        self.trunk.norm = layers.LayerNorm(D, eps=cfg.ln_eps)
        self.trunk.head = nn.Linear(D, embed_dim)


def init_rule(name: str, cfg: Eva02VisionConfig, embed_dim: int):
    """JAX ``init_eva02_params``'s rule for one ``visual.*`` parameter."""
    D = cfg.width
    scale = D ** -0.5
    proj_std = scale * (2 * cfg.layers) ** -0.5
    leaf = name.rsplit(".", 1)[-1]
    if "norm" in name:
        return ("const", 1.0 if leaf == "weight" else 0.0)
    if leaf.endswith("bias"):
        return ("const", 0.0)
    if name.endswith(("attn.proj.weight", "mlp.fc2.weight")):
        return ("normal", proj_std)
    if ".mlp.fc1" in name:
        return ("normal", (2 * D) ** -0.5)
    return ("normal", scale)  # qkv/q/k/v, patch conv, class token, positions, head


def eva02_forward(visual: Eva02VisionTower, images: torch.Tensor, *,
                  dtype: torch.dtype = torch.bfloat16, attention: str = "kernel",
                  remat: bool = False) -> torch.Tensor:
    """Images [B, H, W, 3] -> pooled features [B, embed_dim] (float32)."""
    cfg, t = visual.cfg, visual.trunk
    B, P = images.shape[0], cfg.patch_size
    w = t.patch_embed.proj.weight.permute(0, 2, 3, 1).reshape(cfg.width, P * P * 3)
    x = dense(patchify(images, P), w, t.patch_embed.proj.bias, dtype)
    x = torch.cat([t.cls_token.to(dtype).expand(B, 1, cfg.width), x], dim=1)
    x = x + t.pos_embed[0].to(dtype)
    sin = cos = None
    if cfg.use_rope:
        # float32 angles as JAX computes them; their sine and cosine correctly
        # rounded (float64 on the host), which is what XLA's give but for a
        # few entries one ulp off
        ang = rope_angles(cfg.grid, cfg.head_width, cfg.rope_temperature,
                          cfg.ref_feat_shape).double()
        sin, cos = (t.float().to(x.device) for t in (ang.sin(), ang.cos()))
    x = layers.run_blocks(t.blocks, x, remat, sin=sin, cos=cos, dtype=dtype, attention=attention)
    pooled = layer_norm(x, t.norm.weight, t.norm.bias, cfg.ln_eps)[:, 0]
    return dense(pooled, t.head.weight, t.head.bias, dtype).float()
