"""Plain float32 reference of the measured paths, for the check that decides
``correct``.

OpenAI CLIP with a ViT image tower (Radford et al. 2021, arXiv:2103.00020;
OpenCLIP's layout and state-dict names), written from the published
description in plain PyTorch: pre-LayerNorm blocks, exact GELU, a causal
text tower pooled at its EOT token (the highest id), softmax attention in
float32. Around it, the LatteCLIP v2 fine-tune step: torchvision's colour
jitter and random grayscale on the device, the prototype pseudo-labels, the
confidence-weighted caption fusion, alpha-anchoring to the memory bank, two
symmetric InfoNCE losses, AdamW with decoupled weight decay, the
logit-scale clamp and the segment-mean bank update. And zero-shot
classification: ``100 * normalize(image) @ normalize(template text).T``.

It imports nothing of the measured program. Every matrix product runs in
float32 with TF32 off (:func:`strict_float32`). ``Arith("fp8")`` runs the
same arithmetic with each product's operands rounded to fp8 (e4m3 forward,
e5m2 for the gradients, one scale per tensor), the precision below the
program's bfloat16: it is the control that the limits must reject.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5
INIT_LOGIT_SCALE = math.log(1 / 0.07)
LOG100 = math.log(100.0)
WEIGHT_EPS = 1e-6  # added to each confidence weight (LatteCLIP train.py)
_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def strict_float32() -> None:
    """Keep float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Dims:
    """The widths of one configuration file (``configs/<name>.json``)."""

    def __init__(self, raw: dict):
        v, t = raw["vision_cfg"], raw["text_cfg"]
        self.embed = int(raw["embed_dim"])
        self.image, self.patch = int(v["image_size"]), int(v["patch_size"])
        self.v_width, self.v_layers = int(v["width"]), int(v["layers"])
        self.v_heads = self.v_width // int(v.get("head_width", 64))
        self.ctx, self.vocab = int(t["context_length"]), int(t["vocab_size"])
        self.t_width, self.t_heads, self.t_layers = int(t["width"]), int(t["heads"]), int(t["layers"])
        self.grid = self.image // self.patch
        self.v_tokens = self.grid * self.grid + 1


def _block_shapes(prefix: str, w: int) -> List[Tuple[str, tuple]]:
    return [(prefix + k, s) for k, s in (
        ("ln_1.weight", (w,)), ("ln_1.bias", (w,)),
        ("attn.in_proj_weight", (3 * w, w)), ("attn.in_proj_bias", (3 * w,)),
        ("attn.out_proj.weight", (w, w)), ("attn.out_proj.bias", (w,)),
        ("ln_2.weight", (w,)), ("ln_2.bias", (w,)),
        ("mlp.c_fc.weight", (4 * w, w)), ("mlp.c_fc.bias", (4 * w,)),
        ("mlp.c_proj.weight", (w, 4 * w)), ("mlp.c_proj.bias", (w,)))]


def state_dict_shapes(d: Dims) -> List[Tuple[str, tuple]]:
    """OpenCLIP's state-dict names and shapes of a ViT CLIP, in order."""
    vw, tw = d.v_width, d.t_width
    out = [("visual.conv1.weight", (vw, 3, d.patch, d.patch)), ("visual.class_embedding", (vw,)),
           ("visual.positional_embedding", (d.v_tokens, vw)),
           ("visual.ln_pre.weight", (vw,)), ("visual.ln_pre.bias", (vw,))]
    for i in range(d.v_layers):
        out += _block_shapes(f"visual.transformer.resblocks.{i}.", vw)
    out += [("visual.ln_post.weight", (vw,)), ("visual.ln_post.bias", (vw,)),
            ("visual.proj", (vw, d.embed)),
            ("token_embedding.weight", (d.vocab, tw)), ("positional_embedding", (d.ctx, tw))]
    for i in range(d.t_layers):
        out += _block_shapes(f"transformer.resblocks.{i}.", tw)
    out += [("ln_final.weight", (tw,)), ("ln_final.bias", (tw,)),
            ("text_projection", (tw, d.embed)), ("logit_scale", ())]
    return out


def _init(name: str, shape: tuple, d: Dims) -> Tuple[float, float]:
    """(mean, std) of a leaf: OpenCLIP's initialisation, with small random
    biases and LayerNorm affines so that every term of the blocks is live."""
    if name == "logit_scale":
        return INIT_LOGIT_SCALE, 0.0
    if "ln_" in name:
        return (1.0, 0.02) if name.endswith("weight") else (0.0, 0.02)
    if name.endswith("bias"):
        return 0.0, 0.02
    w = d.v_width if name.startswith("visual.") else d.t_width
    layers = d.v_layers if name.startswith("visual.") else d.t_layers
    if name.endswith("conv1.weight"):
        return 0.0, (3 * d.patch * d.patch) ** -0.5
    if name == "token_embedding.weight":
        return 0.0, 0.02
    if name == "positional_embedding":
        return 0.0, 0.01
    if name.endswith(("class_embedding", "visual.positional_embedding", "visual.proj",
                      "text_projection", "in_proj_weight")):
        return 0.0, w ** -0.5
    if name.endswith(("out_proj.weight", "c_proj.weight")):
        return 0.0, w ** -0.5 * (2 * layers) ** -0.5
    if name.endswith("c_fc.weight"):
        return 0.0, (2 * w) ** -0.5
    raise KeyError(name)


def make_weights(d: Dims, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights as an OpenCLIP state dict of float32 tensors on
    ``device``: one normal draw for all of them from a generator there."""
    shapes = state_dict_shapes(d)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, start = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        mean, std = _init(name, shape, d)
        out[name] = (flat[start:start + n] * std + mean).reshape(shape)
        start += n
    return out


def _qdq(x: torch.Tensor, fmt: str) -> torch.Tensor:
    dtype, top = _FP8[fmt]
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _qdq(x, "e4m3"), _qdq(w, "e4m3")
        ctx.save_for_backward(xq, wq)
        return xq @ wq.T

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _qdq(g, "e5m2")
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])
        return gx, gw


class _Fp8Round(torch.autograd.Function):
    """An attention operand rounded to e4m3; its gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _qdq(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return _qdq(g, "e5m2")


class Arith:
    """The precision of every product: ``"fp32"`` (the reference) or
    ``"fp8"`` (the control)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def linear(self, x, w, b=None):
        y = _Fp8Linear.apply(x, w) if self.fp8 else x @ w.T
        return y if b is None else y + b

    def operand(self, x):
        return _Fp8Round.apply(x) if self.fp8 else x


def _layer_norm(x, P, key):
    return F.layer_norm(x, (x.shape[-1],), P[key + ".weight"], P[key + ".bias"], LN_EPS)


def _block(x, P, pre: str, heads: int, causal: bool, ar: Arith):
    B, L, w = x.shape
    hd = w // heads
    h = _layer_norm(x, P, pre + "ln_1")
    qkv = ar.linear(h, P[pre + "attn.in_proj_weight"], P[pre + "attn.in_proj_bias"])
    q, k, v = (ar.operand(t) for t in qkv.reshape(B, L, 3, heads, hd).permute(2, 0, 3, 1, 4))
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(L, L, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
    o = (ar.operand(torch.softmax(s, dim=-1)) @ v).transpose(1, 2).reshape(B, L, w)
    x = x + ar.linear(o, P[pre + "attn.out_proj.weight"], P[pre + "attn.out_proj.bias"])
    h = F.gelu(ar.linear(_layer_norm(x, P, pre + "ln_2"), P[pre + "mlp.c_fc.weight"],
                         P[pre + "mlp.c_fc.bias"]))
    return x + ar.linear(h, P[pre + "mlp.c_proj.weight"], P[pre + "mlp.c_proj.bias"])


def _blocks(x, P, prefix: str, layers: int, heads: int, causal: bool, ar: Arith):
    """The tower's blocks; under autograd each block is recomputed in the
    backward (only its input is kept), so that float32 fits at full batch."""
    for i in range(layers):
        pre = f"{prefix}.{i}."
        if torch.is_grad_enabled():
            x = checkpoint(_block, x, P, pre, heads, causal, ar, use_reentrant=False)
        else:
            x = _block(x, P, pre, heads, causal, ar)
    return x


def encode_image(P, d: Dims, images: torch.Tensor, ar: Arith) -> torch.Tensor:
    """Normalized float32 images [B, H, W, 3] -> features [B, embed]."""
    B, p, g = images.shape[0], d.patch, d.grid
    patches = images.reshape(B, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, p * p * 3)
    w = P["visual.conv1.weight"].permute(0, 2, 3, 1).reshape(d.v_width, p * p * 3)
    x = ar.linear(patches, w)
    cls = P["visual.class_embedding"].expand(B, 1, d.v_width)
    x = torch.cat([cls, x], dim=1) + P["visual.positional_embedding"]
    x = _layer_norm(x, P, "visual.ln_pre")
    x = _blocks(x, P, "visual.transformer.resblocks", d.v_layers, d.v_heads, False, ar)
    return ar.linear(_layer_norm(x[:, 0], P, "visual.ln_post"), P["visual.proj"].T)


def encode_text(P, d: Dims, tokens: torch.Tensor, ar: Arith) -> torch.Tensor:
    """Token ids [N, ctx] -> features [N, embed], pooled at each row's EOT."""
    x = P["token_embedding.weight"][tokens.long()] + P["positional_embedding"][:tokens.shape[1]]
    x = _blocks(x, P, "transformer.resblocks", d.t_layers, d.t_heads, True, ar)
    x = _layer_norm(x, P, "ln_final")
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return ar.linear(pooled, P["text_projection"].T)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return F.normalize(x, dim=-1)


# -- the train step's augment ---------------------------------------------------

_LUMA = (0.2989, 0.587, 0.114)  # ITU-R 601-2, as torchvision's rgb_to_grayscale
MEAN = (0.48145466, 0.4578275, 0.40821073)  # OpenAI CLIP's image statistics
STD = (0.26862954, 0.26130258, 0.27577711)


def _gray(x):
    return (x[..., 0] * _LUMA[0] + x[..., 1] * _LUMA[1] + x[..., 2] * _LUMA[2])[..., None]


def _blend(a, b, f):
    return (f * a + (1.0 - f) * b).clamp(0.0, 1.0)


def _shift_hue(x, shift):
    r, g, b = x.unbind(-1)
    v, lo = x.amax(dim=-1), x.amin(dim=-1)
    c = v - lo
    s = torch.where(v > 0, c / v.clamp_min(1e-8), 0.0)
    cs = c.clamp_min(1e-8)
    rc, gc, bc = (v - r) / cs, (v - g) / cs, (v - b) / cs
    h = torch.where(v == r, bc - gc, torch.where(v == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(c > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    h = torch.remainder(h + shift, 1.0)

    def channel(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=-1).clamp(0.0, 1.0)


def augment(images_u8: torch.Tensor, gen: torch.Generator, jitter=(0.5, 0.5, 0.5, 0.1),
            p_jitter: float = 0.8, p_gray: float = 0.2) -> torch.Tensor:
    """LatteCLIP's train augment on uint8 [B, H, W, 3], normalized: colour
    jitter (brightness, contrast, saturation, hue, in that order) with
    probability ``p_jitter``, then grayscale with ``p_gray``. The six draws
    a sample are uniforms taken from ``gen`` in that order, one [B] call each."""
    B, dev = images_u8.shape[0], images_u8.device
    bf, cf, sf, hf = jitter
    bounds = ((max(0.0, 1 - bf), 1 + bf), (max(0.0, 1 - cf), 1 + cf), (max(0.0, 1 - sf), 1 + sf),
              (-hf, hf), (0.0, 1.0), (0.0, 1.0))
    draws = [(lo + (hi - lo) * torch.rand(B, generator=gen, device=dev)).reshape(B, 1, 1, 1)
             for lo, hi in bounds]
    bright, contrast, sat, hue, jit, gray = draws
    x = images_u8.float() / 255.0
    y = _blend(x, torch.zeros_like(x), bright)
    y = _blend(y, _gray(y).mean(dim=(1, 2, 3), keepdim=True).expand_as(y), contrast)
    y = _blend(y, _gray(y).expand_as(y), sat)
    y = _shift_hue(y, hue[..., 0])
    x = torch.where(jit < p_jitter, y, x)
    x = torch.where(gray < p_gray, _gray(x).expand_as(x), x)
    return standardize(x)


def standardize(x: torch.Tensor) -> torch.Tensor:
    m = torch.tensor(MEAN, device=x.device)
    s = torch.tensor(STD, device=x.device)
    return (x - m) / s


# -- the LatteCLIP v2 step --------------------------------------------------------

def clip_loss(img: torch.Tensor, txt: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    logits = scale * img @ txt.T
    labels = torch.arange(img.shape[0], device=img.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def _margins(f: torch.Tensor, prototypes: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(f.detach() @ prototypes.T, 2, dim=-1).values
    return top2[:, 0] - top2[:, 1] + WEIGHT_EPS


def decays(name: str, shape: tuple) -> bool:
    """OpenCLIP's rule: weight decay on leaves of two dimensions or more that
    are no norm, bias or logit scale."""
    return len(shape) >= 2 and not any(k in name for k in ("bn", "ln", "bias", "logit_scale"))


class AdamW:
    """Bias-corrected AdamW, decay applied to the parameter before the step."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas=(0.9, 0.98),
                 eps: float = 1e-6, weight_decay: float = 0.2):
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            if decays(k, tuple(p.shape)):
                p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


class TrainReference:
    """The v2 fine-tune from the seed's weights, step by step, on batches of
    host arrays: ``images`` uint8 [B, H, W, 3], ``zs_preds`` [B] and the two
    caption streams ``per_image_tokens``/``per_group_tokens`` [B, ctx].
    ``keep`` (a fault for the tests of the check) trains on the first
    ``keep`` samples of each batch only."""

    def __init__(self, d: Dims, weights: Dict[str, torch.Tensor], table: torch.Tensor, lr: float,
                 alpha: float, ar: Optional[Arith] = None, keep: Optional[int] = None):
        self.d, self.ar, self.alpha, self.keep = d, ar or Arith(), alpha, keep
        self.P = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
        self.table = table
        self.opt = AdamW(self.P, lr)
        with torch.no_grad():
            self.bank = normalize(encode_text(self.P, d, table, self.ar))
        self.prototypes = self.bank.clone()

    def step(self, batch: Dict[str, torch.Tensor], gen: torch.Generator):
        """One step -> (loss, {leaf: its gradient's norm})."""
        d, ar, P = self.d, self.ar, self.P
        n = self.keep or batch["images"].shape[0]
        b = {k: v[:n] for k, v in batch.items()}
        img = normalize(encode_image(P, d, augment(b["images"], gen), ar))
        scale = P["logit_scale"].exp()
        zs = b["zs_preds"].long()
        with torch.no_grad():
            logits = 100.0 * img @ self.bank.T
            preds = logits.argmax(dim=1)
            top2 = logits.topk(2, dim=1).values
            self.ties = {"classes": int(preds.unique().numel()),
                         "under_0.1": int((top2[:, 0] - top2[:, 1] < 0.1).sum())}
        classes = normalize(encode_text(P, d, self.table, ar))
        per_img = normalize(encode_text(P, d, b["per_image_tokens"], ar))
        per_grp = normalize(encode_text(P, d, b["per_group_tokens"], ar))
        w_img, w_grp = _margins(per_img, self.prototypes), _margins(per_grp, self.prototypes)
        finals = []
        for labels in (preds, zs):
            label_f = classes[labels]
            w_label = _margins(label_f, self.prototypes)
            fused = ((w_label[:, None] * label_f + w_img[:, None] * per_img + w_grp[:, None] * per_grp)
                     / (w_label + w_img + w_grp)[:, None])
            anchor = self.bank[labels]
            finals.append(anchor + self.alpha * (fused - anchor))
        loss = clip_loss(img, finals[0], scale) + clip_loss(img, finals[1], scale)
        names = list(P)
        grads = dict(zip(names, torch.autograd.grad(loss, [P[k] for k in names])))
        self.opt.step(P, grads)
        with torch.no_grad():
            P["logit_scale"].clamp_(0.0, LOG100)
            ids = torch.cat([zs, preds])
            feats = torch.cat([finals[1], finals[0]]).detach()
            sums = torch.zeros_like(self.bank).index_add_(0, ids, feats)
            counts = torch.bincount(ids, minlength=self.bank.shape[0]).float()
            mean = normalize(sums / counts.clamp_min(1.0)[:, None])
            self.bank = torch.where((counts > 0)[:, None], mean, self.bank)
        return float(loss.detach()), {k: float(g.norm()) for k, g in grads.items()}


@torch.no_grad()
def zero_shot_logits(P, d: Dims, table: torch.Tensor, images_u8: torch.Tensor, ar: Arith,
                     templates: int = 1, chunk: int = 256) -> torch.Tensor:
    """Logits [N, C] of uint8 images against the classifier of ``table``
    ([C x templates, ctx], class-major): ``100 * normalize(image) @
    classifier.T``, a class's row the normalized mean of its templates'
    normalized text features."""
    text = torch.cat([normalize(encode_text(P, d, t, ar)) for t in table.split(chunk)])
    clf = normalize(text.reshape(-1, templates, text.shape[-1]).mean(dim=1))
    feats = torch.cat([normalize(encode_image(P, d, standardize(x.float() / 255.0), ar))
                       for x in images_u8.split(chunk)])
    return 100.0 * feats @ clf.T
