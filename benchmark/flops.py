"""Work counted from a batch's contents, and the card's published peaks.

Model FLOPs count what the inputs need, whatever route computes them: a
linear layer 2 x weights x tokens, attention 4 x visible (query, key) pairs
x width (a causal row sees half), each image at its tower's token count,
each caption and template at its own length; a trained tower 3x its
forward, no recomputation. Padding is not counted.

An attention call's bound is ``max(FLOP / peak FLOP/s, bytes / peak B/s)``
from its shapes, segments and mask: the pairs the mask and segments leave
visible (the backward 2.5x the forward's FLOPs), each input byte read once
and each output byte written once (bf16 activations, float32 log-sum-exp,
int32 segment ids).
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from benchmark.reference import Dims

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def _block_flops(width: int, tokens: int, pairs: int) -> int:
    # in_proj 3w^2, out_proj w^2, c_fc 4w^2, c_proj 4w^2 weights a layer
    return 2 * 12 * width * width * tokens + 4 * pairs * width


def vision_forward(d: Dims, images: int) -> int:
    L = d.v_tokens
    per_image = (d.v_layers * _block_flops(d.v_width, L, L * L)
                 + 2 * 3 * d.patch * d.patch * d.v_width * (L - 1) + 2 * d.v_width * d.embed)
    return images * per_image


def text_forward(d: Dims, lengths: Iterable[int]) -> int:
    n = np.asarray(list(lengths), np.int64)
    pairs = n * (n + 1) // 2
    return int((d.t_layers * (2 * 12 * d.t_width ** 2 * n + 4 * pairs * d.t_width)
                + 2 * d.t_width * d.embed).sum())


def train_step(d: Dims, images: int, caption_lengths, template_lengths, classes: int) -> int:
    """The v2 step: both towers and the two InfoNCE products (2 x B x B x E
    each) trained; the pseudo-label product and the four confidence margins
    against the prototypes (2 x B x C x E each) forward only."""
    towers = vision_forward(d, images) + text_forward(d, caption_lengths) \
        + text_forward(d, template_lengths)
    infonce = 2 * 2 * images * images * d.embed
    return 3 * (towers + infonce) + 5 * 2 * images * classes * d.embed


def eval_request(d: Dims, images: int, classes: int) -> int:
    return vision_forward(d, images) + 2 * images * d.embed * classes


def lengths_of(rows: np.ndarray) -> np.ndarray:
    """Real lengths of padded token rows: the EOT (largest id) position + 1."""
    return np.argmax(rows, axis=-1) + 1


def attention_call(rows: int, L: int, width: int, heads: int, pairs: int,
                   segmented: bool, backward: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention call over ``rows`` rows of ``L``
    tokens on the packed projection [rows, L, 3 x width]."""
    act = rows * L * width * 2
    lse = rows * L * heads * 4
    seg = rows * L * 4 if segmented else 0
    fwd = 4.0 * pairs * width
    if not backward:
        return fwd, 3 * act + act + lse + seg
    return 2.5 * fwd, 3 * act + act + act + lse + seg + 3 * act


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def causal_pairs(lengths) -> int:
    n = np.asarray(list(lengths), np.int64)
    return int((n * (n + 1) // 2).sum())


def packed_call(seg_ids: np.ndarray) -> tuple:
    """One layer's text attention call on packed rows: ``(rows, L, visible
    pairs, True)`` from the segment ids [R, P] (0 = padding), causal within
    each segment."""
    lengths = [int(n) for row in seg_ids for n in np.bincount(row)[1:] if n]
    return seg_ids.shape[0], seg_ids.shape[1], causal_pairs(lengths), True


def padded_call(tokens: np.ndarray) -> tuple:
    """One layer's text attention call on padded rows [N, ctx]: causal over
    the whole row, padding included."""
    N, ctx = tokens.shape
    return N, ctx, N * causal_pairs([ctx]), False


def attention_bound_s(d: Dims, images: int, text: List[tuple], backward: bool) -> float:
    """The least time of one step's attention calls (every layer, forward
    and, with ``backward``, backward): the vision rows, one image each,
    and ``text``, each ``(rows, L, visible pairs, segmented)`` of a text
    site's call at one layer."""
    calls = [(images, d.v_tokens, images * d.v_tokens ** 2, False, d.v_width, d.v_heads,
              d.v_layers)]
    calls += [(r, L, p, s, d.t_width, d.t_heads, d.t_layers) for r, L, p, s in text]
    total = 0.0
    for rows, L, pairs, seg, width, heads, layers in calls:
        for bwd in ((False, True) if backward else (False,)):
            total += layers * bound_s(*attention_call(rows, L, width, heads, pairs, seg, bwd))
    return total
