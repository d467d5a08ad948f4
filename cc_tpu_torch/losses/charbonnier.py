"""Charbonnier-family helpers (counterpart of cc_tpu/losses/charbonnier.py)."""
from __future__ import annotations

import torch


def spatial_normalize(disp: torch.Tensor) -> torch.Tensor:
    """Divide a disparity map [B,...] by its per-sample global mean
    (loss_functions.py:13-16)."""
    mean = disp.mean(dim=tuple(range(1, disp.dim())), keepdim=True)
    return disp / mean
