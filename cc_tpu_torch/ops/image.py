"""Image resampling ops (counterpart of cc_tpu/ops/image.py).

The reference's upsampling is torch's bilinear with align_corners=False
(the torch>=1.0 default) and its default nearest mode, and its loss
pyramids are torch's adaptive average pooling; here they are the stock
torch calls themselves. (grid_sample, in geometry/sampling.py, uses
align_corners=True instead.) The resizes take NCHW, as the nets run;
adaptive_avg_pool takes NHWC, as the losses run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """F.interpolate(mode='bilinear') of [B, C, H, W] (no antialiasing)."""
    if tuple(img.shape[-2:]) == tuple(out_hw):
        return img
    return F.interpolate(img, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def upsample2x_bilinear(img: torch.Tensor,
                        align_corners: bool = False) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='bilinear') parity."""
    h, w = img.shape[-2:]
    return resize_bilinear(img, (2 * h, 2 * w), align_corners=align_corners)


def upsample_nearest(img: torch.Tensor, scale: int) -> torch.Tensor:
    """F.upsample(scale_factor=k) default-nearest parity."""
    return F.interpolate(img, scale_factor=scale, mode="nearest")


def adaptive_avg_pool(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """F.adaptive_avg_pool2d of an NHWC image [B, H, W, C] or of [B, H, W],
    with torch's bins at non-divisible sizes too."""
    if tuple(img.shape[1:3]) == tuple(out_hw):
        return img
    if img.dim() == 3:
        return F.adaptive_avg_pool2d(img[:, None], tuple(out_hw))[:, 0]
    return F.adaptive_avg_pool2d(img.permute(0, 3, 1, 2),
                                 tuple(out_hw)).permute(0, 2, 3, 1)
