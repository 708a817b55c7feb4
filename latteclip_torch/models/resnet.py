"""ModifiedResNet vision tower (port of ``latteclip_tpu/models/resnet.py``).

OpenAI CLIP's RN50 family: a three-conv stem with an average pool,
bottlenecks whose stride is an average pool before the third conv (and
before the downsample conv), and ``AttentionPool2d``, whose one query is the
mean token (the JAX package computes only that query; it is the whole
output of the reference's full attention pool). Convolutions run through
``F.conv2d`` in the compute dtype on NCHW views of channels-last tensors
(cuDNN on the card), as JAX runs ``lax.conv`` outside any Pallas kernel.

BatchNorm applies the running statistics in float32, always: the JAX
package trains these towers with inference-mode BatchNorm, and so does the
port. The statistics are buffers (:class:`FrozenBatchNorm2d`), so they never
reach the optimizer; ``num_batches_tracked``, which OpenCLIP's
checkpoints carry and the JAX package neither reads nor writes, is not one.
Parameter and buffer names are OpenCLIP's (``visual.conv1.weight``,
``visual.bn1.running_mean``, ``visual.layer1.0.downsample.0.weight``,
``visual.attnpool.q_proj.weight``, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from latteclip_torch.config import ResNetVisionConfig
from latteclip_torch.kernels.fused_ln_linear import dense

BN_EPS = 1e-5


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm from running statistics: ``weight``/``bias`` parameters,
    ``running_mean``/``running_var`` buffers."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W] -> the same dtype, ``(x - mean) * rsqrt(var + eps)
        * weight + bias`` in float32 inside one pass (``F.batch_norm`` in
        inference mode: float32 statistics and affine over a bf16 input),
        as JAX's ``batch_norm`` computes it up to float32 rounding order."""
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, momentum=0.0, eps=BN_EPS)


def conv2d(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    return F.conv2d(x.to(dtype), w.to(dtype), stride=stride, padding=padding)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool with stride k (``F.avg_pool2d`` sums in float32
    whatever the input's dtype, as JAX's ``reduce_window`` here does)."""
    return x if k <= 1 else F.avg_pool2d(x, k)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.Module()
            self.downsample.add_module("0", nn.Conv2d(inplanes, planes * 4, 1, bias=False))
            self.downsample.add_module("1", FrozenBatchNorm2d(planes * 4))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = F.relu(self.bn1(conv2d(x, self.conv1.weight, dtype)))
        out = F.relu(self.bn2(conv2d(out, self.conv2.weight, dtype, padding=1)))
        out = self.bn3(conv2d(avg_pool(out, self.stride), self.conv3.weight, dtype))
        identity = x
        if self.downsample is not None:
            conv, bn = getattr(self.downsample, "0"), getattr(self.downsample, "1")
            identity = bn(conv2d(avg_pool(x, self.stride), conv.weight, dtype))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial: int, width: int, heads: int, out_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial * spacial + 1, width))
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.c_proj = nn.Linear(width, out_dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x [B, C, H, W] -> [B, out_dim] float32 (JAX ``attention_pool``)."""
        B, C = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2).float()                     # [B, HW, C]
        seq = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        seq = (seq + self.positional_embedding.float()).to(dtype)
        hd = C // self.heads
        q = dense(seq[:, :1], self.q_proj.weight, self.q_proj.bias, dtype)
        q = q.view(B, 1, self.heads, hd) * hd ** -0.5
        k = dense(seq, self.k_proj.weight, self.k_proj.bias, dtype).view(B, -1, self.heads, hd)
        v = dense(seq, self.v_proj.weight, self.v_proj.bias, dtype).view(B, -1, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).reshape(B, C).to(dtype)
        return dense(out, self.c_proj.weight, self.c_proj.bias, dtype).float()


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: ResNetVisionConfig, embed_dim: int):
        super().__init__()
        w = cfg.width
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, w // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(w // 2)
        self.conv2 = nn.Conv2d(w // 2, w // 2, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(w // 2)
        self.conv3 = nn.Conv2d(w // 2, w, 3, padding=1, bias=False)
        self.bn3 = FrozenBatchNorm2d(w)
        inplanes = w
        for s, blocks in enumerate(cfg.layers):
            planes = w * 2 ** s
            stage = nn.Sequential()
            for b in range(blocks):
                stage.append(Bottleneck(inplanes, planes, 2 if s > 0 and b == 0 else 1))
                inplanes = planes * 4
            self.add_module(f"layer{s + 1}", stage)
        self.attnpool = AttentionPool2d(cfg.image_size // 32, cfg.embed_width, cfg.heads,
                                        embed_dim)


def init_rule(name: str, cfg: ResNetVisionConfig, embed_dim: int):
    """JAX ``init_resnet_params``'s rule for one ``visual.*`` parameter:
    He-normal convolutions, BatchNorm at identity with each bottleneck's
    ``bn3`` scale at 0, the attention pool's projections at width^-0.5."""
    leaf = name.rsplit(".", 1)[-1]
    if ".bn" in name or ".downsample.1." in name:
        return ("const", 0.0 if leaf == "bias" or (".layer" in name and ".bn3." in name) else 1.0)
    if ".attnpool." in name:
        return ("const", 0.0) if leaf == "bias" else ("normal", cfg.embed_width ** -0.5)
    return ("he_normal", None)


def resnet_forward(visual: ModifiedResNet, images: torch.Tensor, *,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Images [B, S, S, 3] -> pooled features [B, embed_dim] (float32)."""
    x = images.permute(0, 3, 1, 2)                    # NCHW view, channels-last memory
    for conv, bn, stride in ((visual.conv1, visual.bn1, 2), (visual.conv2, visual.bn2, 1),
                             (visual.conv3, visual.bn3, 1)):
        x = F.relu(bn(conv2d(x, conv.weight, dtype, stride=stride, padding=1)))
    x = avg_pool(x, 2)
    for s in range(len(visual.cfg.layers)):
        for block in getattr(visual, f"layer{s + 1}"):
            x = block(x, dtype)
    return visual.attnpool(x, dtype)
