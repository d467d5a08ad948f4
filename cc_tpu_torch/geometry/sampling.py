"""Bilinear sampling and flow warping, NCHW payloads.

Counterpart of cc_tpu/geometry/sampling.py: torch grid_sample with
align_corners=True (the torch<=1.2 default the reference ran under).
Zeros mode gives out-of-bounds taps weight 0, so a fully out-of-bounds pixel
comes out exactly 0; border mode clamps the location to the image.
Coordinates are float32 whatever the payload's dtype: a bf16 x-coordinate
at width 832 quantizes to about 4 px.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample `img` [B, C, H, W] at normalized `grid` [B, Hg, Wg, 2].

    grid[..., 0] is x in [-1, 1], grid[..., 1] is y.
    """
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    out = F.grid_sample(img.float(), grid.float(), mode="bilinear",
                        padding_mode=padding_mode, align_corners=True)
    return out.to(img.dtype)


def flow_warp(img: torch.Tensor, flow: torch.Tensor,
              padding_mode: str = "zeros") -> torch.Tensor:
    """Warp `img` [B, C, H, W] by optical `flow` [B, 2, H, W] (pixels).

    out(p) = img(p + flow(p)), the reference's inverse_warp.py:164-192.
    """
    _, _, h, w = flow.shape
    gx = torch.arange(w, dtype=torch.float32, device=flow.device)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=flow.device)[None, :, None]
    x = gx + flow[:, 0].float()
    y = gy + flow[:, 1].float()
    xn = 2.0 * (x / (w - 1.0) - 0.5)
    yn = 2.0 * (y / (h - 1.0) - 0.5)
    return grid_sample(img, torch.stack([xn, yn], dim=-1),
                       padding_mode=padding_mode)
