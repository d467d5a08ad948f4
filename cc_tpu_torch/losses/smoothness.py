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


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative: 1 at 0, where torch's abs gives 0. A bf16
    net's outputs are quantized, so that their differences are exactly 0 at
    many pixels (about 8% of a flow's second differences), and there the two
    conventions would pull the flow net's update apart."""
    return torch.where(x >= 0, x, -x)


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
            mean32(_abs(dx2)) + mean32(_abs(dxdy))
            + mean32(_abs(dydx)) + mean32(_abs(dy2)))
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
        loss = loss + mean32(_abs(p_dx) * w_x) + mean32(_abs(p_dy) * w_y)
    return loss
