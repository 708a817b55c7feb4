"""Device selection shared by the port's entry points."""
from __future__ import annotations

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
