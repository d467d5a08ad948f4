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


def grid_sample_nhwc(img: torch.Tensor, grid: torch.Tensor,
                     padding_mode: str = "zeros") -> torch.Tensor:
    """grid_sample of an NHWC image [B, H, W, C]; the result is NHWC too.
    The image goes to grid_sample as an NCHW view, without a copy."""
    return grid_sample(img.permute(0, 3, 1, 2), grid,
                       padding_mode).permute(0, 2, 3, 1)


def _flow_grid(fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Normalized sampling grid [B, H, W, 2] of p + flow(p)."""
    _, h, w = fx.shape
    gx = torch.arange(w, dtype=torch.float32, device=fx.device)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=fx.device)[None, :, None]
    xn = 2.0 * ((gx + fx.float()) / (w - 1.0) - 0.5)
    yn = 2.0 * ((gy + fy.float()) / (h - 1.0) - 0.5)
    return torch.stack([xn, yn], dim=-1)


def flow_warp(img: torch.Tensor, flow: torch.Tensor,
              padding_mode: str = "zeros") -> torch.Tensor:
    """Warp `img` [B, C, H, W] by optical `flow` [B, 2, H, W] (pixels).

    out(p) = img(p + flow(p)), the reference's inverse_warp.py:164-192.
    """
    return grid_sample(img, _flow_grid(flow[:, 0], flow[:, 1]),
                       padding_mode=padding_mode)


def flow_warp_nhwc(img: torch.Tensor, flow: torch.Tensor,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """flow_warp of an NHWC image [B, H, W, C] by an NHWC flow [B, H, W, 2]
    (cc_tpu's layout)."""
    return grid_sample_nhwc(img, _flow_grid(flow[..., 0], flow[..., 1]),
                            padding_mode=padding_mode)
