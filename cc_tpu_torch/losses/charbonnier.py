"""Charbonnier (robust L1) penalties and disparity normalization
(counterpart of cc_tpu/losses/charbonnier.py; loss_functions.py:13-25)."""
from __future__ import annotations

import torch


def mean32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean with a float32 accumulator (the identity for float32 inputs)."""
    x = x.float()
    return x.mean() if dim is None else x.mean(dim)


def robust_l1(x: torch.Tensor, q: float = 0.5, eps: float = 1e-2,
              dim=None) -> torch.Tensor:
    """mean((x^2 + eps)^q), over `dim` when given."""
    return mean32(torch.pow(x * x + eps, q), dim)


def robust_l1_per_pix(x: torch.Tensor, q: float = 0.5,
                      eps: float = 1e-2) -> torch.Tensor:
    """(x^2 + eps)^q elementwise."""
    return torch.pow(x * x + eps, q)


def spatial_normalize(disp: torch.Tensor) -> torch.Tensor:
    """Divide a disparity map [B,...] by its per-sample global mean
    (loss_functions.py:13-16)."""
    mean = disp.mean(dim=tuple(range(1, disp.dim())), keepdim=True)
    return disp / mean
