"""Pinhole camera projection (pixel <-> camera frames), NHWC.

Counterpart of cc_tpu/geometry/camera.py (the reference's
inverse_warp.py:13-79).
"""
from __future__ import annotations

import torch


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device: torch.device | None = None) -> torch.Tensor:
    """Homogeneous pixel coordinate grid [H, W, 3] with rows (x, y, 1)."""
    y, x = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Back-project pixels: depth [B, H, W], K^-1 [B, 3, 3] -> camera-frame
    points [B, H, W, 3]."""
    _, h, w = depth.shape
    pix = pixel_grid(h, w, depth.dtype, depth.device)
    rays = torch.einsum("bij,hwj->bhwi", intrinsics_inv, pix)
    return rays * depth[..., None]


def cam2pixel(cam_coords: torch.Tensor, proj_rot: torch.Tensor,
              proj_tr: torch.Tensor | None,
              padding_mode: str | None) -> torch.Tensor:
    """Project camera-frame points [B, H, W, 3] by K@R [B, 3, 3] and K@t
    [B, 3] (or None) into normalized coords [B, H, W, 2] (x, y).

    Z is clamped to at least 1e-3. In 'zeros' mode every coordinate outside
    [-1, 1] is set to exactly 2, so that a zeros-padded sampler returns
    exactly 0 there; the mask itself carries no gradient.
    """
    _, h, w, _ = cam_coords.shape
    p = torch.einsum("bij,bhwj->bhwi", proj_rot, cam_coords)
    if proj_tr is not None:
        p = p + proj_tr[:, None, None, :]
    x, y = p[..., 0], p[..., 1]
    z = torch.maximum(p[..., 2], p.new_full((), 1e-3))
    x_norm = 2 * (x / z) / (w - 1) - 1
    y_norm = 2 * (y / z) / (h - 1) - 1
    if padding_mode == "zeros":
        x_norm = torch.where(x_norm.abs() > 1, 2.0, x_norm)
        y_norm = torch.where(y_norm.abs() > 1, 2.0, y_norm)
    return torch.stack([x_norm, y_norm], dim=-1)


def scale_intrinsics(intrinsics: torch.Tensor, downscale) -> torch.Tensor:
    """K for a pyramid level: the first two rows divided by downscale (as a
    product with 1/downscale, cc_tpu's rounding)."""
    return torch.cat([intrinsics[:, :2] * (1.0 / downscale),
                      intrinsics[:, 2:]], dim=1)


def scale_intrinsics_inv(intrinsics_inv: torch.Tensor, downscale) -> torch.Tensor:
    """K^-1 for a pyramid level: the first two columns times downscale."""
    return torch.cat([intrinsics_inv[..., :2] * downscale,
                      intrinsics_inv[..., 2:]], dim=-1)
