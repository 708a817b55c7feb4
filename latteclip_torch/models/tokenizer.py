"""Tokenizers: byte-level BPE with OpenAI-CLIP token ids, and SigLIP's
sentencepiece vocabularies.

Port of ``latteclip_tpu/models/tokenizer.py`` (``ClipTokenizer`` with
``decode``, ``get_tokenizer``): the same byte-to-unicode table, merge ranks (the
package's own copy of ``assets/clip_bpe_merges.txt.gz``), special tokens
(``<start_of_text>`` = 49406, ``<end_of_text>`` = 49407), context length 77
and pad/truncate rules (zero padding, EOT forced on truncation). Output is an
``int32 [N, context_length]`` numpy array. Numpy and ``regex`` only.

Also ``canonicalize_text``, ``MiniSentencePiece`` (the dependency-free
sentencepiece ``.model`` reader and unigram Viterbi encoder),
``SigLipTokenizer`` on it, and ``get_tokenizer_for_config``, which picks a
model's tokenizer as JAX does and, like JAX, never substitutes another
vocabulary: an HF vocabulary (CLIPA's) or a SigLIP vocabulary that is not on
disk raises.
"""
from __future__ import annotations

import gzip
import html
import os
import string
import struct
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


def _basic_clean(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def canonicalize_text(text: str, keep_punctuation_exact_string: Optional[str] = None) -> str:
    """big_vision's canonicalization (SigLIP): ``_`` to space, punctuation
    stripped (around each ``keep_punctuation_exact_string``, which stays),
    lower case, whitespace squeezed."""
    text = text.replace("_", " ")
    strip = str.maketrans("", "", string.punctuation)
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(strip) for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(strip)
    return _WS_RE.sub(" ", text.lower()).strip()


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


class MiniSentencePiece:
    """A sentencepiece ``.model`` file read off the protobuf wire format
    (repeated field 1: piece, score, type) and a unigram Viterbi encoder: the
    best-scoring segmentation of the ``▁``-marked text over the vocabulary's
    pieces; a codepoint no piece covers becomes its UTF-8 BYTE pieces where
    the vocabulary has them, else the UNKNOWN piece. Normalisation is the
    whitespace-to-``▁`` rule with a dummy prefix only (SigLIP canonicalises
    its text first)."""

    _UNK_PENALTY = 10.0  # sentencepiece's kUnkPenalty

    def __init__(self, model_bytes: bytes):
        self.pieces: list = []      # (piece, score, type)
        self._ids: Dict[str, int] = {}
        self._byte_ids: Dict[int, int] = {}
        self.unk_id = 0
        min_score = 0.0
        for fno, wt, val in self._fields(model_bytes):
            if fno != 1 or wt != 2:
                continue
            piece, score, ptype = "", 0.0, 1
            for sfno, swt, sval in self._fields(val):
                if sfno == 1 and swt == 2:
                    piece = sval.decode("utf-8")
                elif sfno == 2 and swt == 5:
                    score = struct.unpack("<f", sval)[0]
                elif sfno == 3 and swt == 0:
                    ptype = sval
            idx = len(self.pieces)
            self.pieces.append((piece, score, ptype))
            if ptype == 2:              # UNKNOWN
                self.unk_id = idx
            elif ptype == 6:            # BYTE ("<0xAB>")
                self._byte_ids[int(piece[3:5], 16)] = idx
            elif ptype in (1, 4):       # NORMAL, USER_DEFINED
                self._ids[piece] = idx
                min_score = min(min_score, score)
        self._max_piece_len = max((len(p) for p in self._ids), default=1)
        self._unk_score = min_score - self._UNK_PENALTY

    @classmethod
    def from_file(cls, path: str) -> "MiniSentencePiece":
        with open(path, "rb") as f:
            return cls(f.read())

    @staticmethod
    def _fields(buf: bytes):
        """(field number, wire type, value) triples of a protobuf message."""
        i, n = 0, len(buf)
        while i < n:
            tag, i = MiniSentencePiece._varint(buf, i)
            fno, wt = tag >> 3, tag & 7
            if wt == 0:
                val, i = MiniSentencePiece._varint(buf, i)
            elif wt == 1:
                val, i = buf[i:i + 8], i + 8
            elif wt == 2:
                ln, i = MiniSentencePiece._varint(buf, i)
                val, i = buf[i:i + ln], i + ln
            elif wt == 5:
                val, i = buf[i:i + 4], i + 4
            else:
                raise ValueError(f"unsupported protobuf wire type {wt}")
            yield fno, wt, val

    @staticmethod
    def _varint(buf: bytes, i: int):
        out = shift = 0
        while True:
            b = buf[i]
            i += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out, i
            shift += 7

    def encode(self, text: str) -> List[int]:
        """Unigram Viterbi piece ids (no special tokens)."""
        s = "\u2581" + text.replace(" ", "\u2581")
        n = len(s)
        best = [float("-inf")] * (n + 1)
        back: List[Optional[Tuple[int, Optional[int]]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                tid = self._ids.get(s[i:j])
                if tid is not None and best[i] + self.pieces[tid][1] > best[j]:
                    best[j], back[j] = best[i] + self.pieces[tid][1], (i, tid)
            # an unknown codepoint keeps the lattice connected
            if best[i + 1] < best[i] + self._unk_score:
                best[i + 1], back[i + 1] = best[i] + self._unk_score, (i, None)
        ids: List[int] = []
        j = n
        while j > 0:
            i, tid = back[j]
            if tid is None:
                ch = s[i:j].encode("utf-8")
                if self._byte_ids:
                    ids.extend(self._byte_ids[b] for b in reversed(ch))
                else:
                    ids.append(self.unk_id)
            else:
                ids.append(tid)
            j = i
        return ids[::-1]


class SigLipTokenizer:
    """SigLIP's T5 sentencepiece tokenizer on a LOCAL ``.model`` file,
    through :class:`MiniSentencePiece`: text cleaned and big_vision-
    canonicalised, pieces then ``</s>``, truncated to the context with the
    ``</s>`` kept, padded; pad and eos are id 1."""

    VOCAB_URLS = {
        "c4-en": "http://storage.googleapis.com/t5-data/vocabs/cc_en.32000/sentencepiece.model",
        "mc4": "http://storage.googleapis.com/t5-data/vocabs/mc4.250000.100extra/sentencepiece.model",
    }

    def __init__(self, tokenizer_name: str, context_length: int = 64):
        if tokenizer_name in self.VOCAB_URLS and not os.path.exists(tokenizer_name):
            raise FileNotFoundError(
                f"sentencepiece vocab {tokenizer_name!r} must be fetched from "
                f"{self.VOCAB_URLS[tokenizer_name]} and passed as a local path "
                "(no network egress here)")
        self.mini = MiniSentencePiece.from_file(tokenizer_name)
        self.pad_id = self.eos_id = 1
        self.context_length = context_length

    def __call__(self, texts: Union[str, Sequence[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.full((len(texts), ctx), self.pad_id, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = self.mini.encode(canonicalize_text(_basic_clean(text)))[: ctx - 1] + [self.eos_id]
            out[row, : len(ids)] = ids
        return out


def get_tokenizer_for_config(cfg):
    """The model's tokenizer (JAX ``get_tokenizer_for_config``): CLIP BPE for
    the CLIP vocabulary, SigLIP's sentencepiece for the others, from
    ``$LATTECLIP_SIGLIP_VOCAB`` (a local ``.model`` path). An HF vocabulary
    (``hf_tokenizer_name``, CLIPA) is not ported and raises, with JAX's words
    where its files are not on disk."""
    text = cfg.text
    if text.hf_tokenizer_name:
        name = text.hf_tokenizer_name
        if not os.path.exists(name):
            raise RuntimeError(
                f"model {cfg.name!r} needs the HF tokenizer {name!r}; it is "
                "not available locally (no network egress). Fetch its files "
                "and point hf_tokenizer_name at the local path, or "
                "pre-tokenize inputs.")
        raise NotImplementedError(
            f"model {cfg.name!r}: HF tokenizers ({name!r}) are not ported to latteclip_torch "
            "yet (ROADMAP.md, section 1, item 6); pre-tokenize inputs")
    if text.vocab_size == 49408:
        return get_tokenizer(text.context_length)
    name = os.environ.get("LATTECLIP_SIGLIP_VOCAB", "mc4" if text.vocab_size >= 200000 else "c4-en")
    return SigLipTokenizer(name, context_length=text.context_length)
