"""Disparity networks D: DispNetS / DispNetS6 / DispResNet6 / DispResNetS6.

Counterpart of cc_tpu/models/dispnet.py: one parameterized encoder-decoder
for the reference family (models/DispNetS.py, DispNetS6.py, DispResNet6.py,
DispResNetS6.py). 7-level encoder (plain double convs or ResNet
BasicBlocks), transpose-conv decoder with skip concats, sigmoid disparity
heads `alpha*sig + beta`, coarse-disparity feedback at the 3 finest levels.
Training returns (disp1..dispN) finest-first; eval returns disp1.
NCHW: [B,3,H,W] -> [B,1,h,w].
"""
from __future__ import annotations

import torch
from torch import nn

from cc_tpu_torch.models.layers import (
    conv, conv_relu, crop_like, downsample_conv, res_layer, upconv_relu,
)
from cc_tpu_torch.ops.image import upsample2x_bilinear

ENC_PLANES = (32, 64, 128, 256, 512, 512, 512)
DEC_PLANES = (512, 512, 256, 128, 64, 32, 16)


class DispNet(nn.Module):
    """Parameterized disparity net; see the module docstring."""

    def __init__(self, alpha: float = 10.0, beta: float = 0.01,
                 num_scales: int = 6, resnet_encoder: bool = False,
                 enc_blocks: tuple = (2, 2, 2, 2, 2, 2),
                 dec_blocks: tuple = (1, 1, 1, 1, 1, 1, 1)):
        super().__init__()
        self.alpha, self.beta, self.num_scales = alpha, beta, num_scales
        # the finest levels with a disparity head
        self.n_heads = max(num_scales, 4)

        cin = 3
        for lvl, planes in enumerate(ENC_PLANES):
            if lvl == 0:
                block = downsample_conv(cin, planes, 7)
            elif resnet_encoder:
                block = res_layer(cin, planes, enc_blocks[lvl - 1], 2)
            else:
                block = downsample_conv(cin, planes, 5 if lvl == 1 else 3)
            setattr(self, f"conv{lvl + 1}", block)
            cin = planes

        for i, planes in enumerate(DEC_PLANES):
            level = 7 - i
            setattr(self, f"upconv{level}", upconv_relu(cin, planes))
            in_ch = planes + (ENC_PLANES[level - 2] if level >= 2 else 0)
            in_ch += 1 if level <= 3 else 0  # upsampled coarser disparity
            if resnet_encoder:
                iconv = res_layer(in_ch, planes, dec_blocks[i], 1)
            else:
                iconv = conv_relu(in_ch, planes, 3, 1)
            setattr(self, f"iconv{level}", iconv)
            if level <= self.n_heads:
                setattr(self, f"predict_disp{level}",
                        nn.Sequential(conv(planes, 1, 3, 1), nn.Sigmoid()))
            cin = planes

    def forward(self, x: torch.Tensor):
        feats = []
        h = x
        for lvl in range(1, 8):
            h = getattr(self, f"conv{lvl}")(h)
            feats.append(h)

        disps = {}
        prev_disp = None
        for level in range(7, 0, -1):
            skip = feats[level - 2] if level >= 2 else x
            pieces = [crop_like(getattr(self, f"upconv{level}")(h), skip)]
            if level >= 2:
                pieces.append(skip)
            if level <= 3:
                pieces.append(crop_like(upsample2x_bilinear(prev_disp), skip))
            h = getattr(self, f"iconv{level}")(torch.cat(pieces, 1))
            # in eval only the feedback levels and the output are needed
            if level <= (self.n_heads if self.training else 4):
                d = getattr(self, f"predict_disp{level}")(h)
                prev_disp = disps[level] = self.alpha * d + self.beta
        if not self.training:
            return disps[1]
        return tuple(disps[lvl] for lvl in range(1, self.num_scales + 1))


def DispNetS(**kw):
    """models/DispNetS.py:40-133: plain encoder, 4 scales."""
    return DispNet(num_scales=4, resnet_encoder=False, **kw)


def DispNetS6(**kw):
    """models/DispNetS6.py: plain encoder, 6 scales."""
    return DispNet(num_scales=6, resnet_encoder=False, **kw)


def DispResNet6(**kw):
    """models/DispResNet6.py:97-194: ResNet encoder (2 blocks), 6 scales.
    The paper-default D network."""
    return DispNet(num_scales=6, resnet_encoder=True, **kw)


def DispResNetS6(**kw):
    """models/DispResNetS6.py: 3-block encoder at conv4-conv7, 2-block
    decoder at iconv7-iconv4."""
    return DispNet(num_scales=6, resnet_encoder=True,
                   enc_blocks=(2, 2, 3, 3, 3, 3),
                   dec_blocks=(2, 2, 2, 2, 1, 1, 1), **kw)
