"""Competitive-Collaboration consensus losses, the moderator's targets.

Counterpart of cc_tpu/losses/consensus.py (loss_functions.py:160-261), with
cc_tpu's repaired compute_joint_mask_for_depth.
"""
from __future__ import annotations

import torch

from cc_tpu_torch.geometry.sampling import flow_warp_nhwc
from cc_tpu_torch.losses.charbonnier import mean32, robust_l1_per_pix
from cc_tpu_torch.losses.explainability import logical_or
from cc_tpu_torch.losses.photometric import _pool_to, _valid_pixels
from cc_tpu_torch.losses.ssim import ssim

EPSILON = 1e-8


def consensus_exp_masks(cam_flows_fwd, cam_flows_bwd, flows_fwd, flows_bwd,
                        tgt_img, ref_img_fwd, ref_img_bwd,
                        wssim, wrig, ws=0.1, flow_warped_fwd=None):
    """Per-scale binary targets "the rigid warp explains this pixel better"
    [B,h,w,1] (loss_functions.py:160-202). `ws` is accepted and unused, as
    in the reference; `flows_bwd` too. `flow_warped_fwd`, if given, is the
    per-scale flow_warped_refs(ref_img_fwd, flows_fwd)."""
    def err(tgt_s, warped):
        charb = robust_l1_per_pix(tgt_s - warped).mean(-1, keepdim=True)
        s = (1.0 - ssim(tgt_s, warped)).mean(-1, keepdim=True)
        return (1 - wssim) * charb + wssim * s

    targets = []
    for i, cam_flow_fwd in enumerate(cam_flows_fwd):
        _, h, w, _ = cam_flow_fwd.shape
        tgt_s = _pool_to(tgt_img, h, w)
        ref_fwd_s = _pool_to(ref_img_fwd, h, w)
        cam_w_fwd = flow_warp_nhwc(ref_fwd_s, cam_flow_fwd)
        cam_w_bwd = flow_warp_nhwc(_pool_to(ref_img_bwd, h, w),
                                   cam_flows_bwd[i])
        flow_w_fwd = (flow_warped_fwd[i] if flow_warped_fwd is not None
                      else flow_warp_nhwc(ref_fwd_s, flows_fwd[i]))
        valid_cam = logical_or(_valid_pixels(cam_w_fwd),
                               _valid_pixels(cam_w_bwd))
        cam_err = torch.minimum(err(tgt_s, cam_w_fwd),
                                err(tgt_s, cam_w_bwd)) * valid_cam
        flow_err = err(tgt_s, flow_w_fwd)
        targets.append((wrig * cam_err <= flow_err + EPSILON).to(cam_err.dtype))
    return targets


def weighted_binary_cross_entropy(output, target, weights=None):
    """loss_functions.py:252-261, with the log arguments kept >= EPSILON by
    a max() barrier (cc_tpu/losses/consensus.py:64-81); for output in
    (0, 1) it is the reference's formula. torch.maximum, like jnp.maximum,
    splits the gradient at a tie (an output of exactly 0 or 1)."""
    zero = output.new_zeros(())
    pos = torch.log(torch.maximum(output, zero) + EPSILON)
    neg = torch.log(torch.maximum(1.0 - output, zero) + EPSILON)
    if weights is not None:
        assert len(weights) == 2
        loss = weights[1] * (target * pos) + weights[0] * ((1 - target) * neg)
    else:
        loss = target * pos + (1 - target) * neg
    return -mean32(loss)


def consensus_depth_flow_mask(explainability_mask, census_mask_bwd,
                              census_mask_fwd, exp_masks_bwd_target,
                              exp_masks_fwd_target, THRESH, wbce):
    """Loss 5: weighted BCE between M's masks [B,h,w,4] (frame order bwd2,
    bwd1, fwd1, fwd2) and the consensus targets, which are detached
    (loss_functions.py:221-250). `census_mask_*` are the rigidity residuals
    |flow_cam - flow| per scale [B,h,w,2]."""
    assert len(explainability_mask) == len(census_mask_bwd)
    assert len(explainability_mask) == len(census_mask_fwd)
    loss = 0.0
    for i, exp_mask in enumerate(explainability_mask):
        census_fwd = torch.prod((census_mask_fwd[i] < THRESH).to(exp_mask.dtype),
                                dim=-1, keepdim=True)
        census_bwd = torch.prod((census_mask_bwd[i] < THRESH).to(exp_mask.dtype),
                                dim=-1, keepdim=True)
        census_fwd = logical_or(census_fwd, exp_masks_fwd_target[i]).detach()
        census_bwd = logical_or(census_bwd, exp_masks_bwd_target[i]).detach()
        combined = torch.cat([census_bwd, census_bwd, census_fwd, census_fwd],
                             dim=-1)
        loss = loss + weighted_binary_cross_entropy(exp_mask, combined,
                                                    [wbce, 1 - wbce])
    return loss


def compute_joint_mask_for_depth(explainability_mask, rigidity_mask_bwd,
                                 rigidity_mask_fwd, THRESH):
    """Joint (M OR census) masks for depth training, per scale [B,h,w,4],
    detached: cc_tpu's repair of the reference's unreachable
    loss_functions.py:204-219."""
    joint_masks = []
    for i, exp_mask in enumerate(explainability_mask):
        rig_fwd = torch.prod((rigidity_mask_fwd[i] > THRESH).to(exp_mask.dtype),
                             dim=-1, keepdim=True)
        rig_bwd = torch.prod((rigidity_mask_bwd[i] > THRESH).to(exp_mask.dtype),
                             dim=-1, keepdim=True)
        exp_joint = (logical_or(exp_mask[..., 1:2], exp_mask[..., 2:3])
                     > 0.5).to(exp_mask.dtype)
        joint_fwd = logical_or(rig_fwd, exp_joint)
        joint_bwd = logical_or(rig_bwd, exp_joint)
        joint_masks.append(torch.cat(
            [joint_bwd, joint_bwd, joint_fwd, joint_fwd], dim=-1).detach())
    return joint_masks
