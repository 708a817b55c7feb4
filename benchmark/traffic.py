"""The one traffic generator: every mix under ``traffic/`` is a JSON file of
parameters that this module reads. Everything is drawn from ``--seed``.

Caption and template lengths are a fixed set of sizes (the quantiles of the
mix's lognormal, clipped), dealt out in an order that the seed draws, so
that every seed asks for the same work; token ids, images and zero-shot
labels are the seed's own.
"""
from __future__ import annotations

import statistics
import zlib
from typing import Dict, List

import numpy as np
import torch

SOT, EOT = 49406, 49407  # CLIP's BPE start and end ids; EOT is the largest id


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, *stream])


def torch_seed(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for ``seed`` and a stream number."""
    return int(rng(seed, 7, *stream).integers(0, 1 << 62))


def lognormal_lengths(n: int, median: float, sigma: float, lo: int, hi: int,
                      r: np.random.Generator) -> np.ndarray:
    """``n`` token counts (with SOT and EOT): the lognormal's quantiles at
    (i + 1/2) / n, rounded, plus 2, clipped to [lo, hi], shuffled by ``r``."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    lengths = np.clip(np.round(median * np.exp(sigma * z)).astype(np.int64) + 2, lo, hi)
    return r.permutation(lengths)


def token_rows(lengths: np.ndarray, ctx: int, r: np.random.Generator) -> np.ndarray:
    """[N, ctx] int32 rows: SOT, random ids below SOT, EOT at ``length - 1``."""
    rows = np.zeros((len(lengths), ctx), np.int32)
    for i, n in enumerate(lengths.tolist()):
        rows[i, 0] = SOT
        rows[i, 1:n - 1] = r.integers(1, SOT, n - 2)
        rows[i, n - 1] = EOT
    return rows


class SeededTokenizer:
    """Prompt text -> token rows made from the seed and the text's CRC32:
    the same ids for the same text and seed, a length in ``[lo, hi]``. It
    stands in for the BPE tokenizer, which the benchmark does not need."""

    def __init__(self, seed: int, ctx: int, lo: int, hi: int):
        self.seed, self.ctx, self.lo, self.hi = seed, ctx, lo, hi

    def __call__(self, texts) -> np.ndarray:
        texts = [texts] if isinstance(texts, str) else list(texts)
        rows = []
        for t in texts:
            r = rng(self.seed, 11, zlib.crc32(t.encode()))
            rows.append(token_rows(np.array([int(r.integers(self.lo, self.hi + 1))]), self.ctx, r))
        return np.concatenate(rows)


def grid_images(labels: torch.Tensor, cells: torch.Tensor, size: int, noise: int,
                gen: torch.Generator) -> torch.Tensor:
    """uint8 [N, size, size, 3]: each image is its label's grid of random
    colour cells (``cells`` [C, g, g, 3] uint8), upsampled, with +-``noise``
    levels of pixel noise. Made where ``cells`` lives."""
    g = cells.shape[1]
    rep = -(-size // g)
    img = cells[labels].repeat_interleave(rep, 1).repeat_interleave(rep, 2)[:, :size, :size]
    jitter = torch.randint(-noise, noise + 1, img.shape, generator=gen, device=cells.device,
                           dtype=torch.int16)
    return (img.to(torch.int16) + jitter).clamp(0, 255).to(torch.uint8)


def host_buffer(x: torch.Tensor, pinned: bool) -> np.ndarray:
    """``x`` on the host (pinned where ``pinned``), as a numpy view."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=pinned)
    out.copy_(x)
    return out.numpy()


def exemplar_cells(seed: int, classes: int, grid: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    return torch.randint(0, 256, (classes, grid, grid, 3), generator=gen, device=device,
                         dtype=torch.uint8)


def train_pool(mix: Dict, seed: int, image_size: int, ctx: int, device,
               pinned: bool) -> List[Dict[str, np.ndarray]]:
    """The train mix's pool of ``pool_batches`` host batches: ``images``
    uint8 [B, H, W, 3] (the grid of the sample's zero-shot label),
    ``zs_preds`` [B], and the two caption streams [B, ctx]."""
    B, C = mix["batch"], mix["classes"]
    cells = exemplar_cells(seed, C, mix["grid_cells"], device)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 2))
    pool = []
    for i in range(mix["pool_batches"]):
        r = rng(seed, 3, i)
        labels = r.integers(0, C, B).astype(np.int32)
        images = grid_images(torch.from_numpy(labels).to(device).long(), cells, image_size,
                             mix["pixel_noise"], gen)
        b = {"images": host_buffer(images, pinned), "zs_preds": labels}
        for stream in ("per_image_tokens", "per_group_tokens"):
            lengths = lognormal_lengths(B, mix["caption_median"], mix["caption_sigma"],
                                        mix["caption_min"], mix["caption_max"], r)
            b[stream] = token_rows(lengths, ctx, r)
        pool.append(b)
    return pool


def eval_pool(mix: Dict, seed: int, image_size: int, device, pinned: bool) -> List[Dict]:
    """The eval mix's pool of ``pool_requests`` requests: ``images`` uint8
    [N, H, W, 3] (the grid of the image's class) and ``labels`` [N]."""
    N, C = mix["request_images"], mix["classes"]
    cells = exemplar_cells(seed, C, mix["grid_cells"], device)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 2))
    pool = []
    for i in range(mix["pool_requests"]):
        labels = rng(seed, 4, i).integers(0, C, N).astype(np.int64)
        images = grid_images(torch.from_numpy(labels).to(device), cells, image_size,
                             mix["pixel_noise"], gen)
        pool.append({"images": host_buffer(images, pinned), "labels": labels})
    return pool
