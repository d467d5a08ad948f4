"""The four CC networks, built and initialized, and one Adam over all of
them (counterpart of cc_tpu/train/state.py: make_models, init and
make_optimizer)."""
from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class AdamState:
    """Adam's state over the four nets: per net, one first and one second
    moment for each parameter, in `nets[name].parameters()` order; one
    count of applied updates for all nets; the number of updates dropped
    for non-finite gradients; and `step`, the number of train steps taken,
    dropped ones included (cc_tpu's TrainState.step), which
    build_train_step advances on every call. The structure is the same in
    every --fix-* phase."""
    mu: dict[str, list[torch.Tensor]]
    nu: dict[str, list[torch.Tensor]]
    count: int = 0
    notfinite: int = 0
    step: int = 0


class Adam:
    """Adam with torch semantics and per-net freezing, the counterpart of
    cc_tpu's optax chain (cc_tpu/train/state.py:48-117):

    - the gradient is clipped to a global norm (when clip_grad_norm), then
      gets the L2 weight decay added (when weight_decay), then goes through
      Adam (b1 = momentum, b2 = beta, eps 1e-8), and the update is -lr times
      that;
    - a frozen net (cfg.fix_*) keeps its parameters and its moments, but the
      step count is one for all nets and advances on every applied step, as
      optax's is: bias correction follows the global count;
    - with skip_nonfinite_updates, a step whose gradients are not all finite
      changes nothing but `notfinite`, with no limit on how many are
      dropped;
    - a frozen net's gradients are not read (cc_tpu's are zero there);
      in a net that trains, a parameter without a gradient (a head whose
      output no loss reads, as Back2Future's occlusion decoders) counts as
      a zero gradient, as JAX gives.

    The update is in place, over the parameters' `.grad`.
    """

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.frozen = {"disp": cfg.fix_dispnet, "pose": cfg.fix_posenet,
                       "mask": cfg.fix_masknet, "flow": cfg.fix_flownet}

    @staticmethod
    def init(nets: nn.ModuleDict) -> AdamState:
        zeros = lambda: {n: [torch.zeros_like(p) for p in nets[n].parameters()]
                         for n in NETS}
        return AdamState(mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, nets: nn.ModuleDict, state: AdamState) -> None:
        cfg = self.cfg
        live = [n for n in NETS if not self.frozen[n]]
        params = {n: list(nets[n].parameters()) for n in live}
        # a frozen net's gradient is zero in cc_tpu: it adds nothing to
        # the norm and is finite
        given = [p.grad for n in live for p in params[n] if p.grad is not None]
        if cfg.skip_nonfinite_updates and given:
            finite = torch.stack([torch.isfinite(g).all() for g in given]).all()
            if not bool(finite):
                state.notfinite += 1
                return
        scale = None
        if cfg.clip_grad_norm and given:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(given)))
            scale = torch.where(norm < cfg.clip_grad_norm, 1.0,
                                cfg.clip_grad_norm / norm)
        state.count += 1
        b1, b2, lr = cfg.momentum, cfg.beta, cfg.lr
        bc1 = 1.0 - b1 ** state.count
        bc2 = 1.0 - b2 ** state.count
        for n in live:
            if not params[n]:
                continue
            g = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params[n]]
            if scale is not None:
                g = torch._foreach_mul(g, scale)
            if cfg.weight_decay:
                g = torch._foreach_add(g, params[n], alpha=cfg.weight_decay)
            mu, nu = state.mu[n], state.nu[n]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, 1e-8)
            torch._foreach_addcdiv_(params[n], torch._foreach_div(mu, bc1),
                                    denom, value=-lr)


def make_optimizer(cfg: TrainConfig) -> Adam:
    """The optimizer of one --fix-* phase; its state (Adam.init) carries
    over to the other phases."""
    return Adam(cfg)
