"""SSIM map with a Gaussian window (counterpart of cc_tpu/losses/ssim.py;
the reference's ssim.py).

Window 13, sigma 1.5, zero 'same' padding; returns the map, not its mean.
The Gaussian is separable, so the blur is two depthwise conv2d passes (H,
then W), each with zero padding: equal to the 2-D depthwise convolution.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def _gaussian_1d(window_size: int, sigma: float, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The normalized taps, made once per device: a copy from host memory
    on every call would wait for the device each time."""
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2.0 * sigma ** 2))
    return torch.from_numpy((g / g.sum()).astype(np.float32)).to(device, dtype)


def _depthwise_blur(x: torch.Tensor, window_size: int,
                    sigma: float) -> torch.Tensor:
    """Separable Gaussian with zero 'same' padding of NHWC [B, H, W, C]."""
    c = x.shape[-1]
    g = _gaussian_1d(window_size, sigma, x.dtype, x.device)
    pad = window_size // 2
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, g.view(1, 1, -1, 1).repeat(c, 1, 1, 1),
                 padding=(pad, 0), groups=c)
    y = F.conv2d(y, g.view(1, 1, 1, -1).repeat(c, 1, 1, 1),
                 padding=(0, pad), groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 13,
         sigma: float = 1.5) -> torch.Tensor:
    """SSIM map of two NHWC images; constants C1=0.01^2, C2=0.03^2."""
    c = img1.shape[-1]
    # one blur over the 5 filtered quantities, stacked on channels
    blurred = _depthwise_blur(torch.cat(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1),
        window_size, sigma)
    mu1 = blurred[..., 0 * c:1 * c]
    mu2 = blurred[..., 1 * c:2 * c]
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = blurred[..., 2 * c:3 * c] - mu1_sq
    sigma2_sq = blurred[..., 3 * c:4 * c] - mu2_sq
    sigma12 = blurred[..., 4 * c:5 * c] - mu1_mu2
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
