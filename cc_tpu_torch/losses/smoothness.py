"""Smoothness regularizers (counterpart of cc_tpu/losses/smoothness.py;
loss_functions.py:287-341). Inputs are lists over scales of NHWC tensors."""
from __future__ import annotations

import torch

from cc_tpu_torch.losses.charbonnier import mean32
from cc_tpu_torch.ops.image import adaptive_avg_pool


def _grad_hw(x: torch.Tensor):
    dy = x[:, 1:, :, :] - x[:, :-1, :, :]
    dx = x[:, :, 1:, :] - x[:, :, :-1, :]
    return dx, dy


def smooth_loss(preds) -> torch.Tensor:
    """Second-order gradient L1; the scale weight is divided by 2.3 per
    scale (loss_functions.py:323-341)."""
    if not isinstance(preds, (list, tuple)):
        preds = [preds]
    loss = 0.0
    weight = 1.0
    for p in preds:
        dx, dy = _grad_hw(p)
        dx2, dxdy = _grad_hw(dx)
        dydx, dy2 = _grad_hw(dy)
        loss = loss + weight * (
            mean32(dx2.abs()) + mean32(dxdy.abs())
            + mean32(dydx.abs()) + mean32(dy2.abs()))
        weight /= 2.3
    return loss


def edge_aware_smoothness_loss(img: torch.Tensor, preds) -> torch.Tensor:
    """|grad pred| * exp(-|grad img|) over scales (loss_functions.py:287-319).
    The reference computes a per-scale weight and never applies it; so all
    scales count equally here too."""
    if not isinstance(preds, (list, tuple)):
        preds = [preds]
    loss = 0.0
    for p in preds:
        img_s = adaptive_avg_pool(img, (p.shape[1], p.shape[2]))
        p_dx, p_dy = _grad_hw(p)
        i_dx, i_dy = _grad_hw(img_s)
        w_x = torch.exp(-i_dx.abs().mean(-1, keepdim=True))
        w_y = torch.exp(-i_dy.abs().mean(-1, keepdim=True))
        loss = loss + mean32(p_dx.abs() * w_x) + mean32(p_dy.abs() * w_y)
    return loss
