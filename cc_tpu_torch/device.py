"""Device resolution: the GPU by default, the CPU only when asked for."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the device to run on; "cuda" when none is given.

    Raises instead of falling back to the CPU when CUDA is asked for (or
    implied) and absent.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
