"""Back2Future optical flow network F (3-frame, occlusion-aware).

Counterpart of cc_tpu/models/back2future.py; parity with the reference's
models/back2future.py:51-321. Takes (I_0, [I_-, I_+]), (0.5, 0.5)-normalized
NCHW images, and re-normalizes them to ImageNet stats. Six-level feature
pyramids per frame, 9x9 local correlation (ops/correlation.py, the CUDA
kernel on the GPU) with static channel reorders, coarse-to-fine fwd/bwd
decoders with border-mode feature warps, softmax occlusion decoders.

Eval returns the finest (full-resolution) (flow_fwd, flow_bwd, occ), flows
[B,2,H,W] and occlusion [B,2,H,W]. Training returns the 6-level pyramids
scaled by (20, 10, 5, 2.5, 1.25, 0.625); the decoders whose outputs eval
does not return (occlusion at levels 3-6) run in training only.
"""
from __future__ import annotations

import torch
from torch import nn

from cc_tpu_torch.geometry.sampling import flow_warp
from cc_tpu_torch.models.layers import conv
from cc_tpu_torch.ops.correlation import b2f_channel_permutations, correlation
from cc_tpu_torch.ops.image import upsample2x_bilinear, upsample_nearest

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
WIDTHS = (16, 32, 64, 96, 128, 192)
PATCH = 9
WARP_SCALES = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
OUT_SCALES = {2: 20.0, 3: 10.0, 4: 5.0, 5: 2.5, 6: 1.25}


def feat_block(cin: int, cout: int) -> nn.Sequential:
    """Stride-2 conv + conv, LeakyReLU(0.2) (back2future.py:27-33)."""
    return nn.Sequential(conv(cin, cout, 3, 2), nn.LeakyReLU(0.2),
                         conv(cout, cout, 3, 1), nn.LeakyReLU(0.2))


def dec_block(cin: int, cout: int = 2) -> nn.Sequential:
    """128-128-96-64-32 LeakyReLU(0.2) convs + linear head
    (back2future.py:35-48)."""
    layers = []
    for f in (128, 128, 96, 64, 32):
        layers += [conv(cin, f, 3, 1), nn.LeakyReLU(0.2)]
        cin = f
    layers.append(conv(cin, cout, 3, 1))
    return nn.Sequential(*layers)


class Back2Future(nn.Module):
    def __init__(self, nlevels: int = 6):
        super().__init__()
        self.nlevels = nlevels
        for s in "abc":
            cin = 3
            for lvl, f in enumerate(WIDTHS):
                setattr(self, f"conv{lvl + 1}{s}", feat_block(cin, f))
                cin = f
        ncorr = 2 * PATCH * PATCH
        for lvl in range(2, 7):
            # corr + target features of the level + upsampled coarser flow
            cin = ncorr if lvl == 6 else ncorr + WIDTHS[lvl - 1] + 2
            setattr(self, f"decoder_fwd{lvl}", dec_block(cin))
            setattr(self, f"decoder_bwd{lvl}", dec_block(cin))
            occ_in = ncorr + WIDTHS[5] if lvl == 6 else cin
            setattr(self, f"decoder_occ{lvl}", dec_block(occ_in))
        idx_fwd, idx_bwd = b2f_channel_permutations(PATCH)
        self.register_buffer("idx_fwd", torch.as_tensor(idx_fwd),
                             persistent=False)
        self.register_buffer("idx_bwd", torch.as_tensor(idx_bwd),
                             persistent=False)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def _renormalize(self, im: torch.Tensor) -> torch.Tensor:
        """(0.5,0.5)-normalized -> ImageNet-normalized (back2future.py:118-132)."""
        im = im * 0.5 + 0.5
        return (im - self.mean.to(im.dtype)) / self.std.to(im.dtype)

    def _pyramid(self, x: torch.Tensor, s: str) -> list[torch.Tensor]:
        feats = []
        for lvl in range(len(WIDTHS)):
            x = getattr(self, f"conv{lvl + 1}{s}")(x)
            feats.append(x)
        return feats  # feats[k] at 1/2^(k+1) resolution

    def _corr_pair(self, f_tgt, f_fwd, f_bwd) -> torch.Tensor:
        """Both cost volumes, channel-reordered and concatenated, NCHW.
        The correlation op is NHWC, so the features go through it as such."""
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()
        a = nhwc(f_tgt)
        c_fwd = correlation(a, nhwc(f_fwd), PATCH)[..., self.idx_fwd]
        c_bwd = correlation(a, nhwc(f_bwd), PATCH)[..., self.idx_bwd]
        return torch.cat([c_fwd, c_bwd], -1).permute(0, 3, 1, 2)

    def forward(self, im_tar: torch.Tensor, im_refs):
        """im_tar = I_0; im_refs = [I_-, I_+]."""
        fa = self._pyramid(self._renormalize(im_tar), "a")        # I_0
        fb = self._pyramid(self._renormalize(im_refs[1]), "b")    # I_+
        fc = self._pyramid(self._renormalize(im_refs[0]), "c")    # I_-

        dec = lambda name, lvl, x: getattr(self, f"decoder_{name}{lvl}")(x)
        softmax = lambda x: torch.softmax(x, dim=1)

        corr6 = self._corr_pair(fa[5], fb[5], fc[5])
        flow_fwd = dec("fwd", 6, corr6)
        flow_bwd = dec("bwd", 6, corr6)
        flow_fwd_up = upsample2x_bilinear(flow_fwd)
        flow_bwd_up = upsample2x_bilinear(flow_bwd)
        ups_fwd, ups_bwd, occs = {6: flow_fwd_up}, {6: flow_bwd_up}, {}
        if self.training:
            occs[6] = softmax(dec("occ", 6, torch.cat([corr6, fa[5]], 1)))

        for lvl in (5, 4, 3, 2):
            k = lvl - 1  # pyramid index
            s = WARP_SCALES[lvl]
            fb_w = flow_warp(fb[k], s * flow_fwd_up, padding_mode="border")
            fc_w = flow_warp(fc[k], -s * flow_fwd_up, padding_mode="border")
            corr = self._corr_pair(fa[k], fb_w, fc_w)
            upfeat_fwd = torch.cat([corr, fa[k], flow_fwd_up], 1)
            upfeat_bwd = torch.cat([corr, fa[k], flow_bwd_up], 1)
            flow_fwd = dec("fwd", lvl, upfeat_fwd)
            flow_bwd = dec("bwd", lvl, upfeat_bwd)
            if self.training or lvl == 2:
                occs[lvl] = softmax(dec("occ", lvl, upfeat_fwd))
            flow_fwd_up = ups_fwd[lvl] = upsample2x_bilinear(flow_fwd)
            flow_bwd_up = ups_bwd[lvl] = upsample2x_bilinear(flow_bwd)

        # full-resolution outputs (back2future.py:255-271)
        levels = (2, 3, 4, 5, 6) if self.training else (2,)
        flow_fwd_full = [OUT_SCALES[l] * upsample2x_bilinear(ups_fwd[l])
                         for l in levels]
        flow_bwd_full = [-OUT_SCALES[l] * upsample2x_bilinear(ups_bwd[l])
                         for l in levels]
        occ_full = [upsample_nearest(occs[l], 4) for l in levels]
        if not self.training:
            return flow_fwd_full[0], flow_bwd_full[0], occ_full[0]
        if self.nlevels == 6:
            flow_fwd_full.append(0.625 * ups_fwd[6])
            flow_bwd_full.append(-0.625 * ups_bwd[6])
            occ_full.append(upsample_nearest(occs[6], 2))
        return flow_fwd_full, flow_bwd_full, occ_full
