"""Byte-level BPE tokenizer with OpenAI-CLIP token ids.

Port of ``latteclip_tpu/models/tokenizer.py`` (``ClipTokenizer`` with
``decode``, ``get_tokenizer``): the same byte-to-unicode table, merge ranks (the
package's own copy of ``assets/clip_bpe_merges.txt.gz``), special tokens
(``<start_of_text>`` = 49406, ``<end_of_text>`` = 49407), context length 77
and pad/truncate rules (zero padding, EOT forced on truncation). Output is an
``int32 [N, context_length]`` numpy array. Numpy and ``regex`` only.
"""
from __future__ import annotations

import gzip
import html
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import regex as re

DEFAULT_CONTEXT_LENGTH = 77
MERGES_PATH = Path(__file__).resolve().parents[1] / "assets" / "clip_bpe_merges.txt.gz"

try:  # optional: mojibake repair, identity on clean text
    import ftfy as _ftfy
except ImportError:  # pragma: no cover - environment dependent
    _ftfy = None


@lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode mapping."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in keep}
    offset = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + offset)
            offset += 1
    return mapping


_WS_RE = re.compile(r"\s+")


def clean_text(text: str) -> str:
    """ftfy (when installed), double HTML unescape, whitespace squeeze, lower case."""
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text)).strip()
    return _WS_RE.sub(" ", text).strip().lower()


def _adjacent_pairs(word: Tuple[str, ...]) -> set:
    return set(zip(word[:-1], word[1:]))


class ClipTokenizer:
    """CLIP byte-level BPE: 256 byte symbols, the same with ``</w>``, 48,894
    merges, then the two special tokens (49,408 ids)."""

    def __init__(self, context_length: int = DEFAULT_CONTEXT_LENGTH):
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(MERGES_PATH) as f:
            raw = f.read().decode("utf-8")
        merges: List[Tuple[str, str]] = [tuple(line.split()) for line in raw.split("\n") if line]
        self.merge_rank: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}

        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        self.special_tokens = ["<start_of_text>", "<end_of_text>"]
        vocab += self.special_tokens
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = dict(enumerate(vocab))
        self.vocab_size = len(self.encoder)
        self.sot_token_id = self.encoder["<start_of_text>"]
        self.eot_token_id = self.encoder["<end_of_text>"]
        self.context_length = context_length
        special = "|".join(self.special_tokens)
        self.pattern = re.compile(
            special + r"""|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re.IGNORECASE,
        )
        self._bpe_cache: Dict[str, str] = {t: t for t in self.special_tokens}

    def bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return token + "</w>"
        pairs = _adjacent_pairs(word)
        while True:
            best = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if best not in self.merge_rank:
                break
            first, second = best
            merged: List[str] = []
            i, n = 0, len(word)
            while i < n:
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                if j + 1 < n and word[j + 1] == second:
                    merged.append(first + second)
                    i = j + 2
                else:
                    merged.append(word[j])
                    i = j + 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _adjacent_pairs(word)
        result = " ".join(word)
        self._bpe_cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in re.findall(self.pattern, clean_text(text)):
            unicode_token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self.bpe(unicode_token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """Token ids -> text; each ``</w>`` becomes a space, bytes that are
        not valid UTF-8 become U+FFFD."""
        text = "".join(self.decoder[int(i)] for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, Sequence[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        """Tokenize to a zero-padded ``int32 [N, context_length]`` array."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(ids) > ctx:
                ids = ids[:ctx]
                ids[-1] = self.eot_token_id
            out[row, : len(ids)] = ids
        return out


@lru_cache()
def get_tokenizer(context_length: int = DEFAULT_CONTEXT_LENGTH) -> ClipTokenizer:
    return ClipTokenizer(context_length=context_length)
