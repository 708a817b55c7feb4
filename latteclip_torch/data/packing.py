"""Host-side variable-length packing of text rows (numpy only).

Port of ``latteclip_tpu/data/packing.py``. Caption and template token rows
are padded to the context (77); packing lays their real-length runs end to
end in ``[R, P]`` rows (next-fit, deterministic), and the segment-masked
attention keeps every sequence to itself. With causal attention and pooling
at each sequence's EOT token this is the padded tower's function on about
``sum(len)`` tokens instead of ``N * 77``.

The arrays are the JAX package's, element for element, for the same input
(``tests/test_torch_packing.py``).
"""
from __future__ import annotations

import logging
from typing import Dict, NamedTuple, Optional

import numpy as np

from latteclip_torch.obs.trace import counter_dict, span

logger = logging.getLogger(__name__)

# what pack_caption_batch packed: slots (rows x pack_len) and the real tokens
# in them (benchmark/metrics/pack_fill.*)
pack_counts = counter_dict("packing.pack_counts", ("pack_slots", "pack_tokens"))


class PackedText(NamedTuple):
    """One packed batch; every array is numpy."""

    tokens: np.ndarray     # [R, P] int32, 0-padded
    positions: np.ndarray  # [R, P] int32, position within the token's own sequence
    seg_ids: np.ndarray    # [R, P] int32, 1-based within each row, 0 = padding
    eot_row: np.ndarray    # [N] int32, packed row of sequence n's EOT token
    eot_col: np.ndarray    # [N] int32, packed column of sequence n's EOT token


def _next_fit(lengths: np.ndarray, pack_len: int):
    """Row, start column and 1-based segment id of each sequence under
    next-fit: sequences go in order, and one that does not fit in what is
    left of the current row opens the next row."""
    n = len(lengths)
    row, col, seg = (np.empty(n, np.int64) for _ in range(3))
    r, used, s = -1, pack_len, 0
    for i, ln in enumerate(lengths.tolist()):
        if used + ln > pack_len:
            r, used, s = r + 1, 0, 0
        s += 1
        row[i], col[i], seg[i] = r, used, s
        used += ln
    return row, col, seg


def pack_rows_needed(lengths: np.ndarray, pack_len: int) -> int:
    """Rows that next-fit packing of ``lengths`` fills."""
    lengths = np.asarray(lengths, np.int64)
    if lengths.size == 0:
        return 0
    return int(_next_fit(lengths, pack_len)[0][-1]) + 1


def pack_token_rows(tokens: np.ndarray, lengths: np.ndarray, pack_len: int = 128,
                    rows: Optional[int] = None) -> PackedText:
    """Pack ``tokens[n, :lengths[n]]`` end to end into ``[R, pack_len]``.

    ``lengths[n]`` counts the sequence's real tokens with SOT and EOT (EOT at
    ``lengths[n] - 1``). ``rows`` fixes R (padding rows are all segment 0);
    it must be at least the rows the packing fills."""
    tokens = np.asarray(tokens)
    lengths = np.asarray(lengths, np.int64)
    N, ctx = tokens.shape
    limit = min(pack_len, ctx)
    if lengths.min() < 1 or lengths.max() > limit:
        raise ValueError(f"lengths must be in [1, {limit}], got [{lengths.min()}, {lengths.max()}]")
    seq_row, seq_col, seq_seg = _next_fit(lengths, pack_len)
    need = int(seq_row[-1]) + 1
    R = need if rows is None else rows
    if R < need:
        raise ValueError(f"rows={rows} < packed need {need}")

    # every real token: its sequence, its position in it, its packed slot
    seq = np.repeat(np.arange(N, dtype=np.int64), lengths)
    starts = np.cumsum(lengths) - lengths
    pos = np.arange(seq.size, dtype=np.int64) - starts[seq]
    slot = seq_row[seq] * pack_len + seq_col[seq] + pos
    planes = np.zeros((3, R * pack_len), np.int32)
    planes[0, slot] = tokens[seq, pos]
    planes[1, slot] = pos
    planes[2, slot] = seq_seg[seq]
    tok, posn, segs = (p.reshape(R, pack_len) for p in planes)
    return PackedText(tok, posn, segs, seq_row.astype(np.int32),
                      (seq_col + lengths - 1).astype(np.int32))


def token_lengths(tokens: np.ndarray) -> np.ndarray:
    """Real lengths of padded CLIP token rows: EOT position + 1. EOT has the
    highest id in every row, so argmax finds it; an all-zero row gets
    length 1 and pools its token 0, as the padded tower does."""
    return np.argmax(np.asarray(tokens), axis=-1).astype(np.int64) + 1


def pack_template_table(table: np.ndarray, pack_len: int = 128) -> PackedText:
    """The per-class template table, packed once; rows rounded up to a
    multiple of 8, as in the JAX package."""
    table = np.asarray(table)
    lengths = token_lengths(table)
    need = pack_rows_needed(lengths, pack_len)
    return pack_token_rows(table, lengths, pack_len, rows=-(-need // 8) * 8)


def pack_caption_batch(per_image_tokens: np.ndarray, per_group_tokens: np.ndarray,
                       pack_len: int, rows: int) -> Dict[str, np.ndarray]:
    """Both caption streams of one train batch, packed in the order
    [per_image (B), per_group (B)], under the field names the step reads."""
    with span("pack"):
        tokens = np.concatenate([per_image_tokens, per_group_tokens], axis=0)
        lengths = token_lengths(tokens)
        packed = pack_token_rows(tokens, lengths, pack_len, rows=rows)
    pack_counts["pack_slots"] += rows * pack_len
    pack_counts["pack_tokens"] += int(lengths.sum())
    return {
        "cap_tokens": packed.tokens,
        "cap_positions": packed.positions,
        "cap_seg_ids": packed.seg_ids,
        "cap_eot_row": packed.eot_row,
        "cap_eot_col": packed.eot_col,
    }


class PackRowBucketer:
    """Row counts that only grow: each batch's need plus about 6% slack
    (at least 2 rows), rounded up to ``multiple``, and never below the
    largest count given so far. ``fixed`` pins the count outright."""

    def __init__(self, multiple: int = 8, fixed: Optional[int] = None):
        self.multiple = max(1, int(multiple))
        self.fixed = fixed
        self._rows = 0

    def rows_for(self, need: int) -> int:
        if self.fixed is not None:
            if need > self.fixed:
                raise ValueError(f"--text-packing-rows {self.fixed} < packed need {need}; "
                                 "raise the fixed row count")
            return self.fixed
        padded = need + max(2, need // 16)
        grown = -(-padded // self.multiple) * self.multiple
        if grown > self._rows:
            logger.info("text-packing row bucket: %d -> %d rows", self._rows, grown)
            self._rows = grown
        return self._rows
