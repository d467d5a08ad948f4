"""FlowNetC6 optical flow network (2-frame, classic FlowNetC).

Counterpart of cc_tpu/models/flownetc.py; parity with the reference's
models/FlowNetC6.py:32-164 and models/submodules.py:5-39. One 3-conv stem
applied to both frames, a 21x21 dilation-2 correlation (ops/correlation.py,
the CUDA kernel on the GPU; 441 channels, LeakyReLU 0.1) after a 32-channel
conv_redir, a deep encoder, and a deconv decoder with a 2-channel flow head
per level and learned flow upsampling (ConvTranspose k=4 s=2 p=1).
full_res=True multiplies by div_flow=20 and upsamples 2x bilinearly.

NCHW in and out. Training returns the 6 flows, finest first; eval returns
the finest, [B,2,H,W].
"""
from __future__ import annotations

import torch
from torch import nn

from cc_tpu_torch.models.layers import conv
from cc_tpu_torch.ops.correlation import correlation
from cc_tpu_torch.ops.image import upsample2x_bilinear

PATCH, DILATION = 21, 2


def _conv_l(cin: int, cout: int, kernel: int = 3,
            stride: int = 1) -> nn.Sequential:
    """submodules.conv without BN: conv + LeakyReLU(0.1)."""
    return nn.Sequential(conv(cin, cout, kernel, stride), nn.LeakyReLU(0.1))


def _deconv(cin: int, cout: int) -> nn.Sequential:
    """submodules.deconv: ConvTranspose(4, 2, 1) + LeakyReLU(0.1)."""
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1),
                         nn.LeakyReLU(0.1))


def _up_flow() -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(2, 2, 4, 2, 1)


class FlowNetC6(nn.Module):
    def __init__(self, nlevels: int = 5, div_flow: float = 20.0,
                 full_res: bool = True):
        super().__init__()
        del nlevels  # unused; kept for constructor parity (FlowNetC6.py:33)
        self.div_flow = div_flow
        self.full_res = full_res
        self.conv1 = _conv_l(3, 64, 7, 2)
        self.conv2 = _conv_l(64, 128, 5, 2)
        self.conv3 = _conv_l(128, 256, 5, 2)
        self.conv_redir = _conv_l(256, 32, 1, 1)
        self.conv3_1 = _conv_l(32 + PATCH * PATCH, 256)
        self.conv4 = _conv_l(256, 512, 3, 2)
        self.conv4_1 = _conv_l(512, 512)
        self.conv5 = _conv_l(512, 512, 3, 2)
        self.conv5_1 = _conv_l(512, 512)
        self.conv6 = _conv_l(512, 1024, 3, 2)
        self.conv6_1 = _conv_l(1024, 1024)
        # decoder level l: deconv{l} and upsampled_flow{l+1}_to_{l} feed
        # concat{l} = [encoder skip, deconv, upsampled flow]
        skips = {5: 512, 4: 512, 3: 256, 2: 128, 1: 64}
        deconvs = {5: 512, 4: 256, 3: 128, 2: 64, 1: 32}
        cin = 1024
        self.predict_flow6 = conv(cin, 2, 3, 1)
        for lvl in (5, 4, 3, 2, 1):
            setattr(self, f"deconv{lvl}", _deconv(cin, deconvs[lvl]))
            setattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}", _up_flow())
            cin = skips[lvl] + deconvs[lvl] + 2
            setattr(self, f"predict_flow{lvl}", conv(cin, 2, 3, 1))

    def _correlate(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The cost volume of two NCHW feature maps, NCHW. The correlation
        op is NHWC and its kernel takes contiguous inputs only."""
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()
        return correlation(nhwc(a), nhwc(b), PATCH,
                           DILATION).permute(0, 3, 1, 2)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        a1 = self.conv1(x1)
        a2 = self.conv2(a1)
        a3 = self.conv3(a2)
        b3 = self.conv3(self.conv2(self.conv1(x2)))

        corr = nn.functional.leaky_relu(self._correlate(a3, b3), 0.1)
        x = torch.cat([self.conv_redir(a3), corr], 1)

        c3_1 = self.conv3_1(x)
        c4 = self.conv4_1(self.conv4(c3_1))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))

        skips = {5: c5, 4: c4, 3: c3_1, 2: a2, 1: a1}
        x = c6
        flows = [self.predict_flow6(x)]
        for lvl in (5, 4, 3, 2, 1):
            up = getattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}")(flows[-1])
            x = torch.cat([skips[lvl], getattr(self, f"deconv{lvl}")(x), up], 1)
            flows.append(getattr(self, f"predict_flow{lvl}")(x))
        flows = flows[::-1]  # flow1 (finest) .. flow6

        if self.full_res:
            flows = [self.div_flow * upsample2x_bilinear(f) for f in flows]
        return tuple(flows) if self.training else flows[0]
