"""Rotation parameterizations: Euler angles, quaternions, 6-DoF pose vectors.

Counterpart of cc_tpu/geometry/rotation.py (the reference's
inverse_warp.py:82-162), as batched torch math.
"""
from __future__ import annotations

import torch


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles (rx, ry, rz) [B, 3] -> rotation matrices [B, 3, 3],
    R = Rx @ Ry @ Rz."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)

    cosz, sinz = torch.cos(z), torch.sin(z)
    zmat = torch.stack([cosz, -sinz, zeros, sinz, cosz, zeros,
                        zeros, zeros, ones], dim=1).reshape(-1, 3, 3)
    cosy, siny = torch.cos(y), torch.sin(y)
    ymat = torch.stack([cosy, zeros, siny, zeros, ones, zeros,
                        -siny, zeros, cosy], dim=1).reshape(-1, 3, 3)
    cosx, sinx = torch.cos(x), torch.sin(x)
    xmat = torch.stack([ones, zeros, zeros, zeros, cosx, -sinx,
                        zeros, sinx, cosx], dim=1).reshape(-1, 3, 3)
    return xmat @ ymat @ zmat


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """3-coefficient quaternion [B, 3] -> rotation matrices [B, 3, 3]; w is
    taken as 1 before normalization."""
    b = quat.shape[0]
    full = torch.cat([torch.ones((b, 1), dtype=quat.dtype,
                                 device=quat.device), quat], dim=1)
    full = full / torch.linalg.norm(full, dim=1, keepdim=True)
    w, x, y, z = full[:, 0], full[:, 1], full[:, 2], full[:, 3]

    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=1).reshape(b, 3, 3)


def pose_vec2mat(vec: torch.Tensor, rotation_mode: str = "euler") -> torch.Tensor:
    """6-DoF pose [B, 6] (tx, ty, tz, rx, ry, rz) -> [B, 3, 4] transform."""
    translation = vec[:, :3, None]
    rot = vec[:, 3:]
    if rotation_mode == "euler":
        rot_mat = euler2mat(rot)
    elif rotation_mode == "quat":
        rot_mat = quat2mat(rot)
    else:
        raise ValueError(f"unknown rotation_mode: {rotation_mode!r}")
    return torch.cat([rot_mat, translation], dim=2)
