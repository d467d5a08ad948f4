"""Evaluation metrics: optical-flow EPE/Fl and monocular-depth errors; the
counterpart of cc_tpu/losses/metrics.py, whose two resizes are the port's
ops/image.resize_bilinear (F.interpolate, align_corners=False, which
cc_tpu's matrix resize reproduces) on NCHW tensors made from the NHWC
arrays.

Parity: loss_functions.py:355-467 (flow_diff, compute_epe, outlier_err,
compute_all_epes, compute_errors). These run host-side in the eval CLIs and
validation loops (medians over boolean-masked values). numpy in/out;
torch tensors, on any device, accepted.

Flow tensors are NHWC: gt [B,H,W,2 or 3] (third channel = validity),
pred [B,h,w,2]. Depth: gt/pred [B,H,W].
"""
from __future__ import annotations

import numpy as np
import torch

from cc_tpu_torch.ops.image import resize_bilinear

EPSILON = 1e-8


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _resize_nhwc(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an NHWC float32 array to out_hw, on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    return resize_bilinear(t, out_hw).permute(0, 2, 3, 1).numpy()


def _resize_flow_pred(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Bilinear-upsample pred to GT size with u,v magnitude rescale
    (loss_functions.py:359-361)."""
    h_pred, w_pred = pred.shape[1], pred.shape[2]
    h_gt, w_gt = gt.shape[1], gt.shape[2]
    up = np.array(_resize_nhwc(pred, (h_gt, w_gt)))
    up[..., 0] *= w_gt / w_pred
    up[..., 1] *= h_gt / h_pred
    return up


def flow_diff(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Per-pixel endpoint error map [B,H,W]."""
    gt = _host(gt).astype(np.float32)
    up = _resize_flow_pred(gt, _host(pred).astype(np.float32))
    return np.sqrt((gt[..., 0] - up[..., 0]) ** 2
                   + (gt[..., 1] - up[..., 1]) ** 2)


def compute_epe(gt: np.ndarray, pred: np.ndarray) -> float:
    """Average EPE; validity channel honored when gt has 3 channels
    (loss_functions.py:368-388)."""
    gt = _host(gt).astype(np.float32)
    epe = flow_diff(gt[..., :2], pred)
    if gt.shape[-1] == 3:
        valid = gt[..., 2]
        return float((epe * valid).sum() / (valid.sum() + EPSILON))
    b, h, w = epe.shape
    return float(epe.sum() / (b * h * w))


def outlier_err(gt: np.ndarray, pred: np.ndarray,
                tau=(3.0, 0.05)) -> float:
    """KITTI Fl outlier fraction (loss_functions.py:390-409)."""
    gt = _host(gt).astype(np.float32)
    valid = gt[..., 2]
    epe = flow_diff(gt[..., :2], pred) * valid
    f_mag = np.sqrt(gt[..., 0] ** 2 + gt[..., 1] ** 2)
    e0 = (epe > tau[0]).astype(np.float32)
    e1 = ((epe / (f_mag + EPSILON)) > tau[1]).astype(np.float32)
    n_err = e0 * e1 * valid
    return float(n_err.sum() / (valid.sum() + EPSILON))


def compute_all_epes(gt, rigid_pred, non_rigid_pred, rigidity_mask,
                     THRESH: float = 0.5):
    """[all_epe, rigid_epe, non_rigid_epe, outliers] given a rigidity mask.

    Parity: loss_functions.py:411-429. rigidity_mask [B,h,w,1] is bilinearly
    resized to both pred and gt resolutions.
    """
    gt = _host(gt).astype(np.float32)
    rigid_pred = _host(rigid_pred).astype(np.float32)
    non_rigid_pred = _host(non_rigid_pred).astype(np.float32)
    rigidity_mask = _host(rigidity_mask).astype(np.float32)

    h_pred, w_pred = rigid_pred.shape[1], rigid_pred.shape[2]
    h_gt, w_gt = gt.shape[1], gt.shape[2]
    rig_pred_mask = _resize_nhwc(rigidity_mask, (h_pred, w_pred))
    rig_gt_mask = _resize_nhwc(rigidity_mask, (h_gt, w_gt))

    non_rigid = (rig_pred_mask <= THRESH) * non_rigid_pred
    rigid = (rig_pred_mask > THRESH) * rigid_pred
    total = non_rigid + rigid

    gt_non_rigid = (rig_gt_mask <= THRESH) * gt
    gt_rigid = (rig_gt_mask > THRESH) * gt

    return [
        compute_epe(gt, total),
        compute_epe(gt_rigid, rigid),
        compute_epe(gt_non_rigid, non_rigid),
        outlier_err(gt, total),
    ]


def compute_depth_errors(gt: np.ndarray, pred: np.ndarray, crop: bool = True):
    """[abs_diff, abs_rel, sq_rel, a1, a2, a3], Eigen protocol.

    Parity: loss_functions.py:432-467 — Garg crop constants, valid range
    (0, 80), per-sample median scaling, pred clamp [1e-3, 80].
    """
    gt = _host(gt).astype(np.float32)
    pred = _host(pred).astype(np.float32)
    batch_size, h, w = gt.shape

    crop_mask = np.zeros((h, w), dtype=bool)
    if crop:
        y1, y2 = int(0.40810811 * h), int(0.99189189 * h)
        x1, x2 = int(0.03594771 * w), int(0.96405229 * w)
        crop_mask[y1:y2, x1:x2] = True

    abs_diff = abs_rel = sq_rel = a1 = a2 = a3 = 0.0
    for cur_gt, cur_pred in zip(gt, pred):
        valid = (cur_gt > 0) & (cur_gt < 80)
        if crop:
            valid = valid & crop_mask
        valid_gt = cur_gt[valid]
        valid_pred = np.clip(cur_pred[valid], 1e-3, 80)
        valid_pred = valid_pred * np.median(valid_gt) / np.median(valid_pred)

        thresh = np.maximum(valid_gt / valid_pred, valid_pred / valid_gt)
        a1 += float((thresh < 1.25).mean())
        a2 += float((thresh < 1.25 ** 2).mean())
        a3 += float((thresh < 1.25 ** 3).mean())
        abs_diff += float(np.abs(valid_gt - valid_pred).mean())
        abs_rel += float((np.abs(valid_gt - valid_pred) / valid_gt).mean())
        sq_rel += float(((valid_gt - valid_pred) ** 2 / valid_gt).mean())

    return [m / batch_size for m in (abs_diff, abs_rel, sq_rel, a1, a2, a3)]
