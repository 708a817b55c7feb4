"""Webdataset-format tar shard reader (dependency-free): the port's copy of
``latteclip_tpu/data/tar_reader.py``.

Reads the ``NNNNN.tar`` shards produced by the reference preprocess step
(``preprocess/create_tarfiles.py:20-40``): members named
``{image_id}.{jpg,txt,json}`` grouped into samples by key. Error-handling
matches the reference's tolerant pipeline — malformed members/samples are
logged and skipped, and duplicate keys at shard boundaries don't raise
(reference ``src/training/data.py:208-256``).

Also provides the deterministic epoch-seeded shard shuffle (semantics of
``detshuffle2``, reference ``data.py:279-308``: rng seeded with
``seed + epoch``) and brace expansion for shard URL patterns like
``{00000..00039}.tar`` (replaces the reference's braceexpand dependency,
``data.py:97-117``).
"""
from __future__ import annotations

import logging
import os
import random
import re
import tarfile
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

logger = logging.getLogger(__name__)

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_shard_pattern(pattern: str) -> List[str]:
    """Expand ``{00000..00039}``-style ranges; also accepts ``::``-joined
    lists and plain directories of ``.tar`` files."""
    if "::" in pattern:
        out: List[str] = []
        for part in pattern.split("::"):
            out.extend(expand_shard_pattern(part))
        return out
    if os.path.isdir(pattern):
        return sorted(
            os.path.join(pattern, f) for f in os.listdir(pattern) if f.endswith(".tar")
        )
    m = _BRACE_RE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [
        pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]
        for i in range(int(lo), int(hi) + 1)
    ]


def shuffled_shards(shards: Sequence[str], seed: int, epoch: int) -> List[str]:
    """Deterministic epoch-seeded shuffle (detshuffle2 semantics)."""
    rng = random.Random(seed + epoch)
    out = list(shards)
    rng.shuffle(out)
    return out


def resampled_shards(
    shards: Sequence[str], seed: int, epoch: int,
    weights: "Sequence[float] | None" = None,
) -> List[str]:
    """Sample ``len(shards)`` shards WITH replacement (reference
    ResampledShards2, data.py:311-365; per-shard ``weights`` from
    --train-data-upsampling-factors, data.py:542-551). Deterministic per
    (seed, epoch) like :func:`shuffled_shards`."""
    rng = random.Random(seed + epoch)
    pool = list(shards)
    if weights is not None:
        assert len(weights) == len(pool), (len(weights), len(pool))
        return rng.choices(pool, weights=list(weights), k=len(pool))
    return rng.choices(pool, k=len(pool))


def split_shards(shards: Sequence[str], index: int, count: int) -> List[str]:
    """Round-robin shard assignment (split_by_node / split_by_worker)."""
    return list(shards)[index::count] if count > 1 else list(shards)


def iter_tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Stream samples from one shard: {'__key__': id, '<ext>': bytes, ...}.

    Groups consecutive members by key prefix (text before the first dot of
    the basename). A new occurrence of an already-complete key flushes the
    previous sample rather than raising.
    """
    try:
        tf = tarfile.open(path, "r")
    except (OSError, tarfile.TarError) as e:
        logger.warning("skipping unreadable shard %s: %s", path, e)
        return
    current_key: Optional[str] = None
    sample: Dict[str, bytes] = {}
    with tf:
        for member in tf:
            if not member.isfile():
                continue
            base = os.path.basename(member.name)
            if "." not in base:
                continue
            key, ext = base.split(".", 1)
            if key != current_key:
                if current_key is not None and sample:
                    yield {"__key__": current_key, **sample}
                current_key, sample = key, {}
            try:
                f = tf.extractfile(member)
                if f is None:
                    continue
                sample[ext.lower()] = f.read()
            except (OSError, tarfile.TarError) as e:
                logger.warning("skipping member %s in %s: %s", member.name, path, e)
        if current_key is not None and sample:
            yield {"__key__": current_key, **sample}


def iter_shards_samples(shards: Iterable[str]) -> Iterator[Dict[str, bytes]]:
    for shard in shards:
        yield from iter_tar_samples(shard)


class ShuffleBuffer:
    """Bounded reservoir shuffle (semantics of wds.shuffle, data.py:578-581)."""

    def __init__(self, bufsize: int, seed: int):
        self.bufsize = bufsize
        self.rng = random.Random(seed)

    def __call__(self, it: Iterator) -> Iterator:
        buf: List = []
        for item in it:
            if len(buf) < self.bufsize:
                buf.append(item)
                continue
            idx = self.rng.randrange(len(buf))
            buf[idx], item = item, buf[idx]
            yield item
        self.rng.shuffle(buf)
        yield from buf
