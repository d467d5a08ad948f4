"""Motion-segmentation networks M: MaskNet6 and MaskResNet6 (counterpart
of cc_tpu/models/masknet.py).

6-level stride-2 encoder over the channel-stacked (target + refs) input,
6-level transpose-conv decoder with skip concats, sigmoid mask head per
level. Training returns (mask1..mask6) finest-first; eval returns mask1.
Masks are [B, nb_ref_imgs, h, w]. Parity: models/MaskNet6.py:19-123,
models/MaskResNet6.py:69-160.
"""
from __future__ import annotations

import torch
from torch import nn

from cc_tpu_torch.models.layers import conv, conv_relu, res_layer, upconv4_relu

PLANES = (16, 32, 64, 128, 256, 256)
UP_PLANES = (256, 256, 128, 64, 32, 16)


class MaskNet6(nn.Module):
    """Plain conv encoder (the paper-default M)."""

    RESNET_ENCODER = False

    def __init__(self, nb_ref_imgs: int = 4):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        cin = 3 * (1 + nb_ref_imgs)
        for lvl, p in enumerate(PLANES):
            if lvl == 0:
                layer = conv_relu(cin, p, 7, 2)
            elif self.RESNET_ENCODER:
                layer = res_layer(cin, p, 2, 2)
            else:
                layer = conv_relu(cin, p, 5 if lvl == 1 else 3, 2)
            setattr(self, f"conv{lvl + 1}", layer)
            cin = p
        # deconv6 (coarsest) .. deconv1; each after the first also takes
        # the encoder features of its resolution
        for i, p in enumerate(UP_PLANES):
            if i > 0:
                cin = UP_PLANES[i - 1] + PLANES[5 - i]
            setattr(self, f"deconv{6 - i}", upconv4_relu(cin, p))
        # pred_mask1 reads deconv1 (finest) .. pred_mask6 reads deconv6
        for k in range(6):
            setattr(self, f"pred_mask{k + 1}",
                    conv(UP_PLANES[5 - k], nb_ref_imgs, 3, 1))

    def forward(self, tgt: torch.Tensor, refs):
        if len(refs) != self.nb_ref_imgs:
            raise ValueError(f"expected {self.nb_ref_imgs} refs, got {len(refs)}")
        h = torch.cat([tgt, *refs], 1)
        feats = []
        for lvl in range(6):
            h = getattr(self, f"conv{lvl + 1}")(h)
            feats.append(h)

        ups = []
        for i in range(6):
            inp = h if i == 0 else torch.cat([ups[-1], feats[5 - i]], 1)
            ups.append(getattr(self, f"deconv{6 - i}")(inp))

        def head(k):  # mask k+1 from deconv k+1
            return torch.sigmoid(getattr(self, f"pred_mask{k + 1}")(ups[5 - k]))

        if not self.training:
            return head(0)
        return tuple(head(k) for k in range(6))


class MaskResNet6(MaskNet6):
    """ResNet encoder: conv1 plain, conv2-conv6 ResLayers of 2 blocks."""

    RESNET_ENCODER = True
