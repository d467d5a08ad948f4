"""Rigid-scene warping: inverse_warp, pose2flow, flow2oob (NHWC).

Counterpart of cc_tpu/geometry/warp.py (the reference's
inverse_warp.py:195-283).
"""
from __future__ import annotations

import torch

from cc_tpu_torch.geometry.camera import cam2pixel, pixel2cam
from cc_tpu_torch.geometry.rotation import pose_vec2mat
from cc_tpu_torch.geometry.sampling import grid_sample_nhwc


def _src_pixel_coords(depth, pose, intrinsics, intrinsics_inv,
                      rotation_mode, padding_mode):
    """Target pixels -> normalized coords in the source view [B,H,W,2]."""
    cam_coords = pixel2cam(depth, intrinsics_inv)
    proj = intrinsics @ pose_vec2mat(pose, rotation_mode)
    return cam2pixel(cam_coords, proj[:, :, :3], proj[:, :, 3], padding_mode)


def inverse_warp(img: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor,
                 intrinsics: torch.Tensor, intrinsics_inv: torch.Tensor,
                 rotation_mode: str = "euler",
                 padding_mode: str = "zeros") -> torch.Tensor:
    """Warp source `img` [B,H,W,C] into the target frame, given the target's
    depth [B,H,W], the pose target->source [B,6] and K, K^-1 [B,3,3]."""
    coords = _src_pixel_coords(depth, pose, intrinsics, intrinsics_inv,
                               rotation_mode, padding_mode)
    return grid_sample_nhwc(img, coords, padding_mode=padding_mode)


def pose2flow(depth: torch.Tensor, pose: torch.Tensor,
              intrinsics: torch.Tensor, intrinsics_inv: torch.Tensor,
              rotation_mode: str = "euler",
              padding_mode: str | None = None) -> torch.Tensor:
    """Rigid flow [B,H,W,2] (pixels) induced by depth and pose."""
    _, h, w = depth.shape
    coords = _src_pixel_coords(depth, pose, intrinsics, intrinsics_inv,
                               rotation_mode, padding_mode)
    gx = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, None, :]
    gy = torch.arange(h, dtype=depth.dtype, device=depth.device)[None, :, None]
    x = (w - 1) * (coords[..., 0] / 2.0 + 0.5) - gx
    y = (h - 1) * (coords[..., 1] / 2.0 + 0.5) - gy
    return torch.stack([x, y], dim=-1)


def flow2oob(flow: torch.Tensor) -> torch.Tensor:
    """Boolean out-of-bounds mask [B,H,W] of a flow field [B,H,W,2]."""
    _, h, w, _ = flow.shape
    gx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    gy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    xn = 2.0 * ((gx + flow[..., 0]) / (w - 1.0) - 0.5)
    yn = 2.0 * ((gy + flow[..., 1]) / (h - 1.0) - 0.5)
    return (xn.abs() > 1) | (yn.abs() > 1)
