"""Ego-motion network C: PoseNetB6 (counterpart of cc_tpu/models/posenet.py).

Consumes the target frame and nb_ref_imgs reference frames stacked on
channels and emits [B, nb_ref_imgs, 6] poses (tx,ty,tz,rx,ry,rz), averaged
over space and scaled by 0.01 (PoseNetB6.py:79-81).
"""
from __future__ import annotations

import torch
from torch import nn

from cc_tpu_torch.models.layers import conv, conv_relu


class PoseNetB6(nn.Module):
    """8 stride-2 convs, 1x1 pose head, global mean, x0.01.
    Parity: models/PoseNetB6.py:24-83 (the paper-default C network)."""

    PLANES = (16, 32, 64, 128, 256, 256, 256, 256)
    KERNELS = (7, 5, 3, 3, 3, 3, 3, 3)

    def __init__(self, nb_ref_imgs: int = 4):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        cin = 3 * (1 + nb_ref_imgs)
        for i, (p, k) in enumerate(zip(self.PLANES, self.KERNELS)):
            setattr(self, f"conv{i + 1}", conv_relu(cin, p, k, 2))
            cin = p
        self.pose_pred = conv(cin, 6 * nb_ref_imgs, 1, 1, pad=0)

    def forward(self, tgt: torch.Tensor, refs) -> torch.Tensor:
        if len(refs) != self.nb_ref_imgs:
            raise ValueError(f"expected {self.nb_ref_imgs} refs, got {len(refs)}")
        x = torch.cat([tgt, *refs], 1)
        for i in range(len(self.PLANES)):
            x = getattr(self, f"conv{i + 1}")(x)
        pose = self.pose_pred(x).mean(dim=(2, 3))
        return 0.01 * pose.reshape(pose.shape[0], self.nb_ref_imgs, 6)
