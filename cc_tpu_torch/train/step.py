"""The four-net forward (counterpart of cc_tpu/train/step.py).

Batch layout as in cc_tpu: {'tgt': [B,H,W,3], 'refs': [B,nref,H,W,3], ...},
NHWC, float images (0.5,0.5)-normalized, or uint8. The nets run NCHW; the
outputs come back NHWC like cc_tpu's.
"""
from __future__ import annotations

import torch
from torch import nn

from cc_tpu_torch.losses.charbonnier import spatial_normalize
from cc_tpu_torch.train.config import TrainConfig


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
    if isinstance(x, (list, tuple)):
        return [_nhwc(t) for t in x]
    return _nhwc(x)


def forward_all(cfg: TrainConfig, nets: nn.ModuleDict, batch: dict,
                training: bool = False) -> dict:
    """Run all four nets on the device of their parameters. Returns NHWC
    outputs; in training mode the per-scale outputs are lists."""
    if cfg.flownet != "Back2Future":
        raise NotImplementedError(f"flownet {cfg.flownet!r} is not ported yet")
    device = next(nets.parameters()).device
    nets.train(training)
    tgt = _device_normalize(torch.as_tensor(batch["tgt"]).to(device))
    refs_all = _device_normalize(torch.as_tensor(batch["refs"]).to(device))
    tgt_c = _nchw(tgt)
    refs_c = [_nchw(refs_all[:, i]) for i in range(refs_all.shape[1])]

    disparities = nets["disp"](tgt_c)
    pose = nets["pose"](tgt_c, refs_c)
    exp_masks = nets["mask"](tgt_c, refs_c)
    flow_fwd, flow_bwd, occ = nets["flow"](tgt_c, refs_c[1:3])
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
