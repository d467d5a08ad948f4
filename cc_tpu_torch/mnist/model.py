"""LeNet for the MNIST CC demo: the counterpart of cc_tpu/mnist/model.py
as an NCHW nn.Module under the reference's parameter names (conv1, conv2,
fc1, fc2)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LeNet(nn.Module):
    """[B,1,28,28] -> [B,nout] logits: two VALID 3x3 convs of 40 channels,
    each with ReLU and a 2x2 max pool, then 1000 -> 40 -> nout. fc1 reads
    the [40,5,5] features flattened as c, h, w (torch's order)."""

    def __init__(self, nout: int = 10):
        super().__init__()
        self.nout = nout
        self.conv1 = nn.Conv2d(1, 40, 3)
        self.conv2 = nn.Conv2d(40, 40, 3)
        self.fc1 = nn.Linear(5 * 5 * 40, 40)
        self.fc2 = nn.Linear(40, nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = F.relu(self.fc1(x.flatten(1)))
        return self.fc2(x)
