"""Photometric self-supervision losses, rigid (camera) and flow paths, NHWC.

Counterpart of cc_tpu/losses/photometric.py (loss_functions.py:27-137).
Images [B,H,W,3]; flows [B,h,w,2]; depth scales [B,h,w,1]; explainability
masks [B,h,w,nref]; pose [B,nref,6]; intrinsics [B,3,3]. Multi-scale inputs
are lists.
"""
from __future__ import annotations

import torch

from cc_tpu_torch.geometry.camera import scale_intrinsics, scale_intrinsics_inv
from cc_tpu_torch.geometry.sampling import flow_warp_nhwc
from cc_tpu_torch.geometry.warp import inverse_warp, pose2flow
from cc_tpu_torch.losses.charbonnier import mean32, robust_l1
from cc_tpu_torch.losses.ssim import ssim
from cc_tpu_torch.ops.image import adaptive_avg_pool
from cc_tpu_torch.parallel import distributed


def occlusion_masks(flow_bw: torch.Tensor, flow_fw: torch.Tensor):
    """Forward/backward occlusion masks [B,h,w] each, by the reference's
    formula (loss_functions.py:343-352), whose two outputs are identical:
    occ = sum_ch(flow_fw + flow_bw) > 0.08*|flow|^2 + 1."""
    mag_sq = (flow_fw ** 2).sum(-1) + (flow_bw ** 2).sum(-1)
    flow_diff_sum = (flow_fw + flow_bw).sum(-1)
    occ = (flow_diff_sum > 0.08 * mag_sq + 1.0).to(flow_fw.dtype)
    return occ, occ


def depth_occlusion_masks(depth: torch.Tensor, pose: torch.Tensor,
                          intrinsics: torch.Tensor,
                          intrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Occlusion masks [B,h,w,4] from the rigid flows of the 4 ref frames,
    with the FULL-resolution intrinsics whatever the depth's scale, as
    loss_functions.py:126,132-137 calls it."""
    d = depth[..., 0] if depth.dim() == 4 else depth
    flows_cam = [pose2flow(d, pose[:, i], intrinsics, intrinsics_inv)
                 for i in range(pose.shape[1])]
    masks1, masks2 = occlusion_masks(flows_cam[1], flows_cam[2])
    masks0, masks3 = occlusion_masks(flows_cam[0], flows_cam[3])
    return torch.stack([masks0, masks1, masks2, masks3], dim=-1)


def _valid_pixels(warped: torch.Tensor) -> torch.Tensor:
    """1 - (all channels exactly zero), keepdim (loss_functions.py:45,100)."""
    allzero = torch.prod((warped == 0).to(warped.dtype), dim=-1, keepdim=True)
    return 1.0 - allzero


def _oob_norm(valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(numel / max(sum(valid), 1), sum(valid) > 0), over the global batch.

    valid is {0,1}-valued, so the barrier equals the reference's
    numel()/sum() wherever that is defined, and the gate is 1 there. For a
    warp wholly out of bounds the reference's loss is inf; here the gate
    zeroes the whole per-ref term (cc_tpu/losses/photometric.py:65-87).
    In a multi-process launch the sum and the count are the global
    batch's (each process holds an equal share of its rows), as in
    cc_tpu's step with the batch sharded over the mesh; no gradient flows
    through `valid`."""
    s = distributed.all_reduce_sum(valid.float().sum())
    n = valid.numel() * distributed.process_count()
    return n / s.clamp_min(1.0), (s > 0).float()


def _pool_to(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return adaptive_avg_pool(img, (h, w))


def _per_ref_term(tgt_s, warped, mask, lambda_oob, qch, wssim):
    """One ref's photometric term; `mask` multiplies both penalties."""
    valid = _valid_pixels(warped)
    diff = (tgt_s - warped) * valid
    ssim_loss = 1.0 - ssim(tgt_s, warped) * valid
    oob_norm, any_valid = _oob_norm(valid)
    if mask is not None:
        diff = diff * mask
        ssim_loss = ssim_loss * mask
    term = any_valid * (1 - wssim) * oob_norm * (
        robust_l1(diff, q=qch) + wssim * mean32(ssim_loss))
    if lambda_oob:  # off by default: its subgraph is skipped
        term = term + lambda_oob * robust_l1(1.0 - valid, q=qch)
    return term


def photometric_reconstruction_loss(
    tgt_img, ref_imgs, intrinsics, intrinsics_inv, depth,
    explainability_mask, pose, rotation_mode="euler", padding_mode="zeros",
    lambda_oob=0.0, qch=0.5, wssim=0.5,
):
    """Rigid-path photometric loss over all depth scales and ref frames
    (loss_functions.py:80-128). `depth` is a list of [B,h,w,1];
    `explainability_mask` a matching list of [B,h,w,nref] (or None)."""
    if not isinstance(explainability_mask, (list, tuple)):
        explainability_mask = [explainability_mask]
    if not isinstance(depth, (list, tuple)):
        depth = [depth]

    total = 0.0
    for d, exp_mask in zip(depth, explainability_mask):
        occ_masks = depth_occlusion_masks(d, pose, intrinsics, intrinsics_inv)
        _, h, w, _ = d.shape
        downscale = tgt_img.shape[1] / h
        tgt_s = _pool_to(tgt_img, h, w)
        occ_masks = occ_masks.to(tgt_s.dtype)
        k_s = scale_intrinsics(intrinsics, downscale)
        k_inv_s = scale_intrinsics_inv(intrinsics_inv, downscale)
        for i, ref in enumerate(ref_imgs):
            warped = inverse_warp(_pool_to(ref, h, w), d[..., 0], pose[:, i],
                                  k_s, k_inv_s, rotation_mode, padding_mode)
            mask = 1.0 - occ_masks[..., i:i + 1]
            if exp_mask is not None:
                mask = mask * exp_mask[..., i:i + 1]
            total = total + _per_ref_term(tgt_s, warped, mask, lambda_oob,
                                          qch, wssim)
    return total


def flow_warped_refs(ref_img: torch.Tensor, flows) -> list[torch.Tensor]:
    """[flow_warp(pool(ref_img), f) for f in flows]: the warps that the flow
    photometric loss and the consensus targets share."""
    return [flow_warp_nhwc(_pool_to(ref_img, f.shape[1], f.shape[2]), f)
            for f in flows]


def photometric_flow_loss(tgt_img, ref_imgs, flows, explainability_mask,
                          lambda_oob=0.0, qch=0.5, wssim=0.5,
                          warped_refs=None):
    """Non-rigid photometric loss (loss_functions.py:27-77).

    `flows` is [flows_bwd, flows_fwd], each a list over scales of
    [B,h,w,2]; `ref_imgs` is [ref_bwd, ref_fwd]; `explainability_mask` a
    list over scales of [B,h,w,2] (or None). `warped_refs`, if given, is the
    matching [warped_bwd, warped_fwd] of flow_warped_refs.
    """
    if not isinstance(flows[0], (list, tuple)):
        if explainability_mask is not None:
            explainability_mask = [explainability_mask]
        flows = [[uv] for uv in flows]

    total = 0.0
    for s in range(len(flows[0])):
        flows_s = [uv[s] for uv in flows]
        occ_bw, occ_fw = occlusion_masks(flows_s[0], flows_s[1])
        _, h, w, _ = flows_s[0].shape
        tgt_s = _pool_to(tgt_img, h, w)
        occ = torch.stack([occ_bw, occ_fw], dim=-1).to(tgt_s.dtype)
        exp_mask = (explainability_mask[s]
                    if explainability_mask is not None else None)
        for i, ref in enumerate(ref_imgs):
            warped = (warped_refs[i][s] if warped_refs is not None
                      else flow_warp_nhwc(_pool_to(ref, h, w), flows_s[i]))
            mask = 1.0 - occ[..., i:i + 1]
            if exp_mask is not None:
                mask = exp_mask[..., i:i + 1] * mask
            total = total + _per_ref_term(tgt_s, warped, mask, lambda_oob,
                                          qch, wssim)
    return total
