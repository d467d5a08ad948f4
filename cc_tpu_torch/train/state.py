"""The four CC networks, built and initialized
(counterpart of cc_tpu/train/state.py's make_models and init)."""
from __future__ import annotations

import torch
from torch import nn

from cc_tpu_torch import models
from cc_tpu_torch.device import resolve_device
from cc_tpu_torch.train.config import TrainConfig

NETS = ("disp", "pose", "mask", "flow")


def _init_weights(net: nn.Module, generator: torch.Generator,
                  uniform_bias: bool) -> None:
    """The reference's init_weights: xavier-uniform conv and transpose-conv
    weights; zero biases, or U(0,1) for the flow nets (back2future.py:106-116)."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            if m.bias is not None:
                if uniform_bias:
                    nn.init.uniform_(m.bias, 0.0, 1.0, generator=generator)
                else:
                    nn.init.zeros_(m.bias)


def make_models(cfg: TrainConfig, device: str | torch.device | None = None,
                generator: torch.Generator | None = None) -> nn.ModuleDict:
    """Build and initialize {disp, pose, mask, flow} on `device` (CUDA unless
    the caller asks for the CPU). `generator` (a CPU generator) seeds the
    init; nets start in eval mode."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    nets = nn.ModuleDict({
        "disp": models.build(cfg.dispnet),
        "pose": models.build(cfg.posenet, nb_ref_imgs=cfg.nb_ref_imgs),
        "mask": models.build(cfg.masknet, nb_ref_imgs=cfg.nb_ref_imgs),
        "flow": models.build(cfg.flownet, nlevels=cfg.nlevels),
    })
    for name in NETS:
        _init_weights(nets[name], generator, uniform_bias=name == "flow")
    return nets.to(dev).eval()
