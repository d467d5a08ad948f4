"""Ego-motion networks C: PoseNet6, PoseNetB6 and PoseExpNet (counterpart
of cc_tpu/models/posenet.py).

Each consumes the target frame and nb_ref_imgs reference frames stacked on
channels and emits [B, nb_ref_imgs, 6] poses (tx,ty,tz,rx,ry,rz), averaged
over space and scaled by 0.01 (PoseNetB6.py:79-81). PoseExpNet also emits
SfMLearner-style explainability masks when built with output_exp.
"""
from __future__ import annotations

import torch
from torch import nn

from cc_tpu_torch.models.layers import conv, conv_relu, crop_like, upconv4_relu


def _stack(net: nn.Module, tgt: torch.Tensor, refs) -> torch.Tensor:
    if len(refs) != net.nb_ref_imgs:
        raise ValueError(f"expected {net.nb_ref_imgs} refs, got {len(refs)}")
    return torch.cat([tgt, *refs], 1)


def _pose(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    pose = net.pose_pred(x).mean(dim=(2, 3))
    return 0.01 * pose.reshape(pose.shape[0], net.nb_ref_imgs, 6)


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
        x = _stack(self, tgt, refs)
        for i in range(len(self.PLANES)):
            x = getattr(self, f"conv{i + 1}")(x)
        return _pose(self, x)


class PoseNet6(nn.Module):
    """conv0 (stride 2, keeps the channels), 7 stride-2 convs, 1x1 pose
    head. Parity: models/PoseNet6.py:19-62."""

    PLANES = (16, 32, 64, 128, 256, 256, 256)
    KERNELS = (7, 5, 3, 3, 3, 3, 3)

    def __init__(self, nb_ref_imgs: int = 4):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        cin = 3 * (1 + nb_ref_imgs)
        self.conv0 = conv_relu(cin, cin, 3, 2)
        for i, (p, k) in enumerate(zip(self.PLANES, self.KERNELS)):
            setattr(self, f"conv{i + 1}", conv_relu(cin, p, k, 2))
            cin = p
        self.pose_pred = conv(cin, 6 * nb_ref_imgs, 1, 1, pad=0)

    def forward(self, tgt: torch.Tensor, refs) -> torch.Tensor:
        x = self.conv0(_stack(self, tgt, refs))
        for i in range(len(self.PLANES)):
            x = getattr(self, f"conv{i + 1}")(x)
        return _pose(self, x)


class PoseExpNet(nn.Module):
    """SfMLearner's joint pose and explainability net.
    Parity: models/PoseExpNet.py:19-94. Returns (masks, pose): in training
    mode masks is [mask1..mask4], finest first, else mask1; without
    output_exp the masks are None. Masks are [B, nb_ref_imgs, h, w]."""

    PLANES = (16, 32, 64, 128, 256, 256, 256)
    KERNELS = (7, 5, 3, 3, 3, 3, 3)
    UP_PLANES = (256, 128, 64, 32, 16)

    def __init__(self, nb_ref_imgs: int = 4, output_exp: bool = False):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        self.output_exp = output_exp
        cin = 3 * (1 + nb_ref_imgs)
        for i, (p, k) in enumerate(zip(self.PLANES, self.KERNELS)):
            setattr(self, f"conv{i + 1}", conv_relu(cin, p, k, 2))
            cin = p
        self.pose_pred = conv(cin, 6 * nb_ref_imgs, 1, 1, pad=0)
        if output_exp:
            # upconv5 reads conv5's features; upconv5..upconv1 halve the
            # stride each
            cin = self.PLANES[4]
            for lev, p in zip(range(5, 0, -1), self.UP_PLANES):
                setattr(self, f"upconv{lev}", upconv4_relu(cin, p))
                cin = p
            for lev in range(4, 0, -1):
                setattr(self, f"predict_mask{lev}",
                        conv(self.UP_PLANES[5 - lev], nb_ref_imgs, 3, 1))

    def forward(self, tgt: torch.Tensor, refs):
        x = _stack(self, tgt, refs)
        feats, h = [], x
        for i in range(len(self.PLANES)):
            h = getattr(self, f"conv{i + 1}")(h)
            feats.append(h)
        pose = _pose(self, feats[6])
        if not self.output_exp:
            return ([None] * 4 if self.training else None), pose

        # each upconv's output cropped to the encoder level it mirrors
        crops = (feats[3], feats[2], feats[1], feats[0], x)
        up, ups = feats[4], {}
        for lev, ref in zip(range(5, 0, -1), crops):
            up = crop_like(getattr(self, f"upconv{lev}")(up), ref)
            ups[lev] = up
        masks = [torch.sigmoid(getattr(self, f"predict_mask{lev}")(ups[lev]))
                 for lev in range(1, 5)]
        return (masks if self.training else masks[0]), pose
