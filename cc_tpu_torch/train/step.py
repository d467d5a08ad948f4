"""The four-net forward, the five CC losses and the joint train step
(counterpart of cc_tpu/train/step.py).

Batch layout as in cc_tpu: {'tgt': [B,H,W,3], 'refs': [B,nref,H,W,3],
'intrinsics': [B,3,3], 'intrinsics_inv': [B,3,3]}, NHWC, float images
(0.5,0.5)-normalized, or uint8. The nets run NCHW; the outputs come back
NHWC like cc_tpu's, and the losses run on them as cc_tpu's do.

CC alternation: a frozen net (--fix-*) has its outputs detached, which is
requires_grad=False here since no net reads another's outputs, and the
optimizer leaves its parameters and moments alone. Every net stays in
train mode, so BatchNorm running stats move in every phase.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from cc_tpu_torch.geometry.warp import pose2flow
from cc_tpu_torch.losses.charbonnier import spatial_normalize
from cc_tpu_torch.losses.consensus import (
    compute_joint_mask_for_depth, consensus_depth_flow_mask,
    consensus_exp_masks,
)
from cc_tpu_torch.losses.explainability import explainability_loss
from cc_tpu_torch.losses.photometric import (
    flow_warped_refs, photometric_flow_loss, photometric_reconstruction_loss,
)
from cc_tpu_torch.losses.smoothness import (
    edge_aware_smoothness_loss, smooth_loss,
)
from cc_tpu_torch.parallel import distributed
from cc_tpu_torch.train.config import TrainConfig
from cc_tpu_torch.train.state import NETS, AdamState, make_optimizer

FLOWNETS = ("Back2Future", "FlowNetC6")
METRICS = ("loss", "photo_cam_loss", "explainability_loss", "smooth_loss",
           "photo_flow_loss", "consensus_loss")


def _device_normalize(x: torch.Tensor) -> torch.Tensor:
    """uint8 batches (the compact host-to-device mode) are normalized here,
    on the device, with the host pipeline's op order: (x/255 - .5)/.5.
    Float batches pass through."""
    if x.dtype == torch.uint8:
        return (x.to(torch.float32) / 255.0 - 0.5) / 0.5
    return x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nhwc_all(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [_nhwc(t) for t in x]
    return _nhwc(x)


def check_ported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for a configuration the port does not run:
    bf16, a flow net other than FLOWNETS, or PoseExpNet as C, whose
    (masks, pose) output cc_tpu's step passes on as the pose
    (cc_tpu/train/step.py:66-67) and then indexes as one (:145), so that
    cc_tpu cannot train or evaluate with it either."""
    if cfg.compute_dtype != "float32" or cfg.loss_dtype != "float32":
        raise NotImplementedError("only float32 is ported so far")
    if cfg.flownet not in FLOWNETS:
        raise NotImplementedError(f"flownet {cfg.flownet!r} is not ported yet")
    if cfg.posenet == "PoseExpNet":
        raise NotImplementedError(
            "PoseExpNet as the pose net C: it returns (masks, pose), which "
            "cc_tpu's train step takes as the pose and fails on; neither "
            "package trains or evaluates with it")


def forward_all(cfg: TrainConfig, nets: nn.ModuleDict, batch: dict,
                training: bool = False) -> dict:
    """Run all four nets on the device of their parameters. Returns NHWC
    outputs; in training mode the per-scale outputs are lists. FlowNetC6
    gives no occlusion: `occ` is None."""
    check_ported(cfg)
    device = next(nets.parameters()).device
    nets.train(training)
    tgt = _device_normalize(torch.as_tensor(batch["tgt"]).to(device))
    refs_all = _device_normalize(torch.as_tensor(batch["refs"]).to(device))
    tgt_c = _nchw(tgt)
    refs_c = [_nchw(refs_all[:, i]) for i in range(refs_all.shape[1])]

    disparities = nets["disp"](tgt_c)
    pose = nets["pose"](tgt_c, refs_c)
    exp_masks = nets["mask"](tgt_c, refs_c)
    if cfg.flownet == "Back2Future":
        flow_fwd, flow_bwd, occ = nets["flow"](tgt_c, refs_c[1:3])
    else:  # a two-frame net, run once per direction
        flow_fwd = nets["flow"](tgt_c, refs_c[2])
        flow_bwd = nets["flow"](tgt_c, refs_c[1])
        occ = None
    return dict(
        disparities=_nhwc_all(disparities), pose=pose,
        exp_masks=_nhwc_all(exp_masks), flow_fwd=_nhwc_all(flow_fwd),
        flow_bwd=_nhwc_all(flow_bwd), occ=_nhwc_all(occ),
        refs=[refs_all[:, i] for i in range(refs_all.shape[1])], tgt=tgt)


def forward_eval(cfg: TrainConfig, nets: nn.ModuleDict, batch: dict) -> dict:
    """Eval-mode four-net forward, finest-scale outputs only (the
    validate_flow_with_gt forward, train.py:665-677); the counterpart of
    cc_tpu's build_forward_eval, with the same keys."""
    with torch.inference_mode():
        outputs = forward_all(cfg, nets, batch, training=False)
        disp = outputs["disparities"]
        if cfg.spatial_normalize:
            disp = spatial_normalize(disp)
        return {
            "disp": disp, "depth": 1.0 / disp, "pose": outputs["pose"],
            "exp_mask": outputs["exp_masks"], "flow_fwd": outputs["flow_fwd"],
            "flow_bwd": outputs["flow_bwd"], "occ": outputs["occ"],
        }


def _maybe_detach(x, frozen: bool):
    if not frozen:
        return x
    if isinstance(x, (list, tuple)):
        return [t.detach() for t in x]
    return x.detach()


def compute_losses(cfg: TrainConfig, outputs: dict, batch: dict):
    """The five CC losses (train.py:468-509) from forward_all's training
    outputs. Returns (total, metrics); a loss whose weight is 0 is not
    computed and reports 0."""
    tgt, refs = outputs["tgt"], outputs["refs"]
    device = tgt.device
    k = torch.as_tensor(batch["intrinsics"]).to(device)
    k_inv = torch.as_tensor(batch["intrinsics_inv"]).to(device)

    disparities = outputs["disparities"]
    if cfg.spatial_normalize:
        disparities = [spatial_normalize(d) for d in disparities]
    depth = _maybe_detach([1.0 / d for d in disparities], cfg.fix_dispnet)
    pose = _maybe_detach(outputs["pose"], cfg.fix_posenet)
    exp_masks = _maybe_detach(outputs["exp_masks"], cfg.fix_masknet)
    flow_fwd = _maybe_detach(outputs["flow_fwd"], cfg.fix_flownet)
    flow_bwd = _maybe_detach(outputs["flow_bwd"], cfg.fix_flownet)

    w1 = cfg.cam_photo_loss_weight
    w2 = cfg.mask_loss_weight
    w3 = cfg.smooth_loss_weight
    w4 = cfg.flow_photo_loss_weight
    w5 = cfg.consensus_loss_weight
    zero = torch.zeros((), device=device)

    if w5 > 0 or cfg.joint_mask_for_depth:
        flows_cam_fwd = [pose2flow(d[..., 0], pose[:, 2], k, k_inv,
                                   cfg.rotation_mode) for d in depth]
        flows_cam_bwd = [pose2flow(d[..., 0], pose[:, 1], k, k_inv,
                                   cfg.rotation_mode) for d in depth]
        rigidity_fwd = [(fc - f).abs() for fc, f in zip(flows_cam_fwd, flow_fwd)]
        rigidity_bwd = [(fc - f).abs() for fc, f in zip(flows_cam_bwd, flow_bwd)]

    if cfg.joint_mask_for_depth:
        exp_for_depth = compute_joint_mask_for_depth(
            exp_masks, rigidity_bwd, rigidity_fwd, cfg.THRESH)
    else:
        exp_for_depth = exp_masks
    flow_exp_mask = (None if cfg.no_non_rigid_mask
                     else [1.0 - m[..., 1:3] for m in exp_masks])

    loss1 = photometric_reconstruction_loss(
        tgt, refs, k, k_inv, depth, exp_for_depth, pose,
        rotation_mode=cfg.rotation_mode, padding_mode=cfg.padding_mode,
        lambda_oob=cfg.lambda_oob, qch=cfg.qch,
        wssim=cfg.wssim) if w1 > 0 else zero
    loss2 = explainability_loss(exp_masks) if w2 > 0 else zero
    if w3 <= 0:
        loss3 = zero
    elif cfg.smoothness_type == "regular":
        loss3 = (smooth_loss(depth) + smooth_loss(flow_fwd)
                 + smooth_loss(flow_bwd) + smooth_loss(exp_masks))
    else:
        loss3 = (edge_aware_smoothness_loss(tgt, depth)
                 + edge_aware_smoothness_loss(tgt, flow_fwd)
                 + edge_aware_smoothness_loss(tgt, flow_bwd)
                 + edge_aware_smoothness_loss(tgt, exp_masks))

    # the flow loss and the consensus targets warp the same refs by the
    # same flows: once
    warped_refs = None
    if w4 > 0 or w5 > 0:
        warped_refs = [flow_warped_refs(refs[1], flow_bwd),
                       flow_warped_refs(refs[2], flow_fwd)]
    loss4 = photometric_flow_loss(
        tgt, refs[1:3], [flow_bwd, flow_fwd], flow_exp_mask,
        lambda_oob=cfg.lambda_oob, qch=cfg.qch, wssim=cfg.wssim,
        warped_refs=warped_refs) if w4 > 0 else zero

    if w5 > 0:
        # thresholded targets: no gradient reaches through them, so their
        # graph is not built
        with torch.no_grad():
            exp_masks_target = consensus_exp_masks(
                flows_cam_fwd, flows_cam_bwd, flow_fwd, flow_bwd, tgt,
                refs[2], refs[1], wssim=cfg.wssim, wrig=cfg.wrig,
                ws=cfg.smooth_loss_weight, flow_warped_fwd=warped_refs[1])
        loss5 = consensus_depth_flow_mask(
            exp_masks, rigidity_bwd, rigidity_fwd, exp_masks_target,
            exp_masks_target, THRESH=cfg.THRESH, wbce=cfg.wbce)
    else:
        loss5 = zero

    total = w1 * loss1 + w2 * loss2 + w3 * loss3 + w4 * loss4 + w5 * loss5
    metrics = dict(zip(METRICS, (total, loss1, loss2, loss3, loss4, loss5)))
    return total, metrics


def _average_gradients(nets: nn.ModuleDict, live) -> None:
    """The gradients of the nets that train, replaced by their mean over the
    processes of a launch; a parameter without a gradient takes part as
    zeros, which is how Adam reads it."""
    grads = []
    for name in live:
        for p in nets[name].parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    distributed.all_reduce_mean_(grads)


def build_train_step(cfg: TrainConfig, nets: nn.ModuleDict,
                     opt_state: AdamState) -> Callable[[dict], dict]:
    """The joint CC train step, the counterpart of cc_tpu's build_train_step
    (cc_tpu/train/step.py:215-241): returns step(batch) -> metrics, which
    runs the four nets in train mode, the five losses, the backward and
    one Adam update, in place on `nets` (parameters and BatchNorm stats)
    and `opt_state` (from make_optimizer(cfg).init(nets)), whose `step`
    advances on every call, as cc_tpu's TrainState.step. The metrics are
    the six 0-d tensors of cc_tpu's, on the device, not synchronized.

    The state carries across phases: build one step per --fix-* config,
    all on the same nets and opt_state.

    In a multi-process launch (parallel/distributed.py, initialized before
    the step is built) `batch` holds this process's rows of the global
    batch, and the step is cc_tpu's on the global batch, with the batch
    sharded over the mesh: BatchNorm and the out-of-bounds barrier read
    global statistics, the gradients of the nets that train are averaged
    over the processes before Adam reads them (so its clip, its
    non-finite guard and its moments see the global gradient, and every
    replica takes the same update), and the metrics returned are the
    averages over the processes, still on the device.
    """
    check_ported(cfg)
    optimizer = make_optimizer(cfg)
    live = [n for n in NETS if not optimizer.frozen[n]]
    replicas = distributed.process_count()

    def step(batch: dict) -> dict:
        for p in nets.parameters():
            p.grad = None
        outputs = forward_all(cfg, nets, batch, training=True)
        total, metrics = compute_losses(cfg, outputs, batch)
        total.backward()
        if replicas > 1:
            _average_gradients(nets, live)
        optimizer.update(nets, opt_state)
        opt_state.step += 1
        if replicas > 1:
            values = torch.stack([metrics[k].detach() for k in METRICS])
            distributed.all_reduce_mean_([values])
            return dict(zip(METRICS, values.unbind()))
        return {k: v.detach() for k, v in metrics.items()}

    return step
