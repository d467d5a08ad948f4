"""Shared building blocks, NCHW, with the reference's torch layer geometry.

Counterpart of cc_tpu/models/layers.py. Module attribute names follow the
reference nets, so reference-format state dicts load with strict=True.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cc_tpu_torch.parallel import distributed


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1,
         bias: bool = True, pad: int | None = None) -> nn.Conv2d:
    """nn.Conv2d with symmetric padding (k-1)//2 unless `pad` is given."""
    p = (kernel - 1) // 2 if pad is None else pad
    return nn.Conv2d(cin, cout, kernel, stride, p, bias=bias)


def conv_relu(cin: int, cout: int, kernel: int = 3,
              stride: int = 1) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, kernel, stride), nn.ReLU())


def downsample_conv(cin: int, cout: int, kernel: int = 3) -> nn.Sequential:
    """Stride-2 conv + same-size conv, both ReLU (DispNetS.py:5-11)."""
    return nn.Sequential(conv(cin, cout, kernel, 2), nn.ReLU(),
                         conv(cout, cout, kernel, 1), nn.ReLU())


def upconv_relu(cin: int, cout: int) -> nn.Sequential:
    """ConvTranspose(k=3, s=2, p=1, output_padding=1) + ReLU (DispNetS.py:28-32)."""
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 3, 2, 1, 1), nn.ReLU())


def upconv4_relu(cin: int, cout: int) -> nn.Sequential:
    """ConvTranspose(k=4, s=2, p=1) + ReLU (MaskNet6.py:12-16)."""
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1, 0), nn.ReLU())


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training forward moves running_var toward the
    biased batch variance, as flax's BatchNorm in cc_tpu does
    (cc_tpu/models/layers.py:314-315); torch's own moves it toward the
    unbiased one. Names, parameters and buffers are nn.BatchNorm2d's, so
    reference-format state dicts still load with strict=True.

    In a multi-process launch (parallel/distributed.py) the training
    forward normalizes by the statistics of the global batch, as cc_tpu's
    step does with its batch sharded over the mesh: the per-channel sums
    and counts, then the sums of squared deviations from the global mean,
    are summed over the processes, with autograd through the sums, and
    every process moves its running stats by the same global values.

    A bfloat16 input (compute_dtype bfloat16, with bf16 copies of weight
    and bias) is normalized as flax's BatchNorm normalizes it: statistics
    and normalization in float32, the running stats float32, the output
    rounded once to bfloat16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return self._forward(x.float(), self.weight.float(),
                                 self.bias.float()).to(x.dtype)
        return self._forward(x, self.weight, self.bias)

    def _forward(self, x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, 0.0, self.eps)
        if distributed.process_count() > 1:
            return self._global_batch_forward(x, weight, bias)
        with torch.no_grad():
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            self._move_running_stats(mean, var)
        return F.batch_norm(x, None, None, weight, bias,
                            training=True, eps=self.eps)

    @torch.no_grad()
    def _move_running_stats(self, mean, var) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)

    def _global_batch_forward(self, x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        sums = distributed.all_reduce_sum(torch.cat(
            [x.sum(dim=(0, 2, 3)), x.new_full((1,), x.numel() // c)]))
        count = sums[c]
        centred = x - (sums[:c] / count)[None, :, None, None]
        var = distributed.all_reduce_sum(
            centred.square().sum(dim=(0, 2, 3))) / count
        self._move_running_stats(sums[:c].detach() / count, var.detach())
        scale = weight * torch.rsqrt(var + self.eps)
        return (centred * scale[None, :, None, None]
                + bias[None, :, None, None])


class BasicBlock(nn.Module):
    """ResNet BasicBlock without BN in the residual path; BN only on the 1x1
    projection shortcut (DispResNet6.py:14-60)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, bias=False)
        self.conv2 = conv(planes, planes, 3, 1, bias=False)
        self.relu = nn.ReLU()
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                conv(inplanes, planes, 1, stride, bias=False, pad=0),
                BatchNorm2d(planes, eps=1e-5, momentum=0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.relu(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


def res_layer(inplanes: int, planes: int, blocks: int,
              stride: int = 1) -> nn.Sequential:
    """Stack of BasicBlocks; the first carries the stride."""
    layers = [BasicBlock(inplanes, planes, stride)]
    layers += [BasicBlock(planes, planes, 1) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


def crop_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Crop the spatial dims of x down to ref's (DispNetS.py:35-37)."""
    if x.shape[2] < ref.shape[2] or x.shape[3] < ref.shape[3]:
        raise ValueError(f"cannot crop {tuple(x.shape)} to {tuple(ref.shape)}")
    return x[:, :, :ref.shape[2], :ref.shape[3]]
