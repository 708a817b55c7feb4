"""Device selection shared by the port's entry points, and the card's SM
count that the kernels' launch plans read."""
from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise when CUDA is asked for
    and absent, so no entry point quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
