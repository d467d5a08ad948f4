"""Composite rigid+non-rigid flow, the shared eval logic the reference
replicates in four places (train.py:688-699, test_flow.py:117-146,
test_mask.py:119-138, submit_flow.py:109-133); the counterpart of
cc_tpu/eval/composite.py, on torch tensors.

All NHWC: flow_cam/flow_fwd [B,H,W,2], exp_mask [B,H,W,nref].
"""
from __future__ import annotations

import torch


def rigidity_masks(flow_cam: torch.Tensor, flow_fwd: torch.Tensor,
                   exp_mask: torch.Tensor, THRESH: float):
    """(rigidity_from_M, census, combined) each [B,H,W,1] float.

    rigidity_from_M: soft-OR of M's two middle-frame channels > 0.5
    census: both |flow_cam - flow_fwd| components below THRESH
    combined: soft-OR of the two.
    """
    rigidity = (1.0 - (1.0 - exp_mask[..., 1:2]) * (1.0 - exp_mask[..., 2:3])
                > 0.5).to(flow_fwd.dtype)
    census_soft = (flow_cam - flow_fwd).abs()
    census = ((census_soft[..., 0:1] < THRESH)
              & (census_soft[..., 1:2] < THRESH)).to(flow_fwd.dtype)
    combined = 1.0 - (1.0 - rigidity) * (1.0 - census)
    return rigidity, census, combined


def composite_flow(flow_cam: torch.Tensor, flow_fwd: torch.Tensor,
                   exp_mask: torch.Tensor, THRESH: float):
    """(total_flow, combined_mask): rigid pixels take the camera flow,
    non-rigid pixels take F's flow."""
    _, _, combined = rigidity_masks(flow_cam, flow_fwd, exp_mask, THRESH)
    non_rigid = (combined <= THRESH).to(flow_fwd.dtype) * flow_fwd
    rigid = (combined > THRESH).to(flow_cam.dtype) * flow_cam
    return rigid + non_rigid, combined
