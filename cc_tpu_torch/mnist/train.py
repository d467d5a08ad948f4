"""MNIST CC training: the counterpart of cc_tpu/mnist/train.py, with one
step per alternation phase (compete, collaborate) and the same E/M
semantics (the reference's mnist.py:324-413).

The state holds the three nets and two Adam states, one per phase: each
optimizer keeps its own moments and its own count, as cc_tpu's
opt_compete and opt_collaborate do, and the moderator is trained by both.
Each optimizer is cc_tpu's optax chain over its phase's train group: L2
weight decay added to the gradient (when weight_decay), then Adam (b1 =
momentum, b2 = beta, eps 1e-8, bias-corrected by the group's count), then
-lr. A net outside the group is frozen: no update, no moments. A net of
the group whose loss does not reach it (the moderator in a compete step)
has a zero gradient, so it still moves by the decay.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cc_tpu_torch.device import resolve_device
from cc_tpu_torch.mnist.model import LeNet

NETS = ("alice", "bob", "mod")
# flax's default kernel init, lecun_normal: a normal of variance 1/fan_in
# truncated at two standard deviations, whose std this constant restores
_TRUNC_STD = .87962566103423978


@dataclasses.dataclass(frozen=True)
class MnistConfig:
    lr: float = 2e-4
    momentum: float = 0.9
    beta: float = 0.999
    weight_decay: float = 0.0
    wr: float = 1.0           # moderator regularization weight
    fix_alice: bool = False
    fix_bob: bool = False
    fix_mod: bool = False


@dataclasses.dataclass
class AdamGroup:
    """One phase's optimizer state: Adam's first and second moments for
    each net of its train group (in `parameters()` order) and the number
    of updates it applied."""
    mu: dict[str, list[torch.Tensor]]
    nu: dict[str, list[torch.Tensor]]
    count: int = 0


@dataclasses.dataclass
class MnistState:
    """The three nets, the two optimizers' states and the steps taken."""
    nets: nn.ModuleDict
    opt_compete: AdamGroup
    opt_collaborate: AdamGroup
    step: int = 0


def compete_group(cfg: MnistConfig) -> tuple[str, ...]:
    """The nets a compete step trains: all three, minus the fixed ones."""
    fixed = {"alice": cfg.fix_alice, "bob": cfg.fix_bob, "mod": cfg.fix_mod}
    return tuple(n for n in NETS if not fixed[n])


def collaborate_group(cfg: MnistConfig) -> tuple[str, ...]:
    """The nets a collaborate step trains: the moderator, unless fixed."""
    return () if cfg.fix_mod else ("mod",)


def models(device: str | torch.device | None = None,
           generator: torch.Generator | None = None) -> nn.ModuleDict:
    """Alice and Bob (10-way) and the moderator (1 logit) on `device` (CUDA
    unless the caller asks for the CPU), initialized from `generator` (a
    CPU generator) as cc_tpu's flax init draws: LeCun-normal kernels
    truncated at 2 std, zero biases."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    nets = nn.ModuleDict({"alice": LeNet(10), "bob": LeNet(10),
                          "mod": LeNet(1)})
    with torch.no_grad():
        for name in NETS:
            for m in nets[name].modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                          2 * std, generator=generator)
                    nn.init.zeros_(m.bias)
    return nets.to(dev)


def _adam_group(nets: nn.ModuleDict, names: tuple[str, ...]) -> AdamGroup:
    zeros = lambda: {n: [torch.zeros_like(p) for p in nets[n].parameters()]
                     for n in names}
    return AdamGroup(mu=zeros(), nu=zeros())


def init_mnist_state(cfg: MnistConfig, device: str | torch.device | None
                     = None, generator: torch.Generator | None = None
                     ) -> MnistState:
    """Fresh nets (models) and both optimizers' states at zero."""
    nets = models(device, generator)
    return MnistState(nets=nets,
                      opt_compete=_adam_group(nets, compete_group(cfg)),
                      opt_collaborate=_adam_group(nets,
                                                  collaborate_group(cfg)))


@torch.no_grad()
def _adam_update(cfg: MnistConfig, group: AdamGroup, nets: nn.ModuleDict,
                 grads: dict[nn.Parameter, torch.Tensor | None]) -> None:
    """One update of the group's nets in place; a None gradient is zero."""
    group.count += 1
    b1, b2 = cfg.momentum, cfg.beta
    bc1, bc2 = 1.0 - b1 ** group.count, 1.0 - b2 ** group.count
    for n in group.mu:
        params = list(nets[n].parameters())
        g = [torch.zeros_like(p) if grads[p] is None else grads[p]
             for p in params]
        if cfg.weight_decay:
            g = torch._foreach_add(g, params, alpha=cfg.weight_decay)
        mu, nu = group.mu[n], group.nu[n]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, 1e-8)
        torch._foreach_addcdiv_(params, torch._foreach_div(mu, bc1), denom,
                                value=-cfg.lr)


def _device_of(nets: nn.ModuleDict) -> torch.device:
    return next(nets.parameters()).device


def _to_nchw(img: np.ndarray, device: torch.device) -> torch.Tensor:
    """An NHWC [B,28,28,1] float array -> an NCHW tensor on `device`."""
    t = torch.tensor(np.asarray(img, np.float32))
    return t.movedim(-1, 1).contiguous().to(device)


def _forward(nets: nn.ModuleDict, x: torch.Tensor, train: tuple[str, ...]):
    """(alice's logits, bob's, the moderator's [B]); autograd records only
    the nets in `train`."""
    out = {}
    for n in NETS:
        with torch.set_grad_enabled(n in train):
            out[n] = nets[n](x)
    return out["alice"], out["bob"], out["mod"][:, 0]


def _ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax cross-entropy with integer labels."""
    return F.cross_entropy(logits, target, reduction="none")


def mod_regularization_loss(pred_mod: torch.Tensor) -> torch.Tensor:
    """relu(|var(sigmoid(mod)) - 0.25| - 0.05), the variance with ddof 1
    (mnist.py:104-106)."""
    var = torch.var(torch.sigmoid(pred_mod), correction=1)
    return F.relu(torch.abs(var - 0.25) - 0.05)


def _make_step(cfg: MnistConfig, train: tuple[str, ...], opt: str, loss_fn):
    def step(state: MnistState, img: np.ndarray, target: np.ndarray) -> dict:
        """One step on an NHWC image batch and its integer labels; updates
        `state` in place and returns the metrics (tensors on the nets'
        device)."""
        nets = state.nets
        device = _device_of(nets)
        x = _to_nchw(img, device)
        t = torch.tensor(np.asarray(target), dtype=torch.int64,
                         device=device)
        pred_alice, pred_bob, pred_mod = _forward(nets, x, train)
        loss, metrics = loss_fn(pred_alice, pred_bob, pred_mod,
                                _ce(pred_alice, t), _ce(pred_bob, t))
        params = [p for n in train for p in nets[n].parameters()]
        # with both classifiers fixed, a compete loss reaches no net of
        # the group
        grads = (torch.autograd.grad(loss, params, allow_unused=True)
                 if loss.requires_grad else [None] * len(params))
        _adam_update(cfg, getattr(state, opt), nets, dict(zip(params, grads)))
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}
    return step


def make_compete_step(cfg: MnistConfig):
    """The compete step: Alice's and Bob's CE weighted per sample by the
    moderator's detached sigmoid (Alice's alone with fix_bob, Bob's alone
    with fix_alice), through the compete optimizer."""
    def loss_fn(pred_alice, pred_bob, pred_mod, loss_alice, loss_bob):
        if cfg.fix_bob:
            loss = loss_alice.mean()
        elif cfg.fix_alice:
            loss = loss_bob.mean()
        else:
            w = torch.sigmoid(pred_mod).detach()
            loss = (w * loss_alice + (1 - w) * loss_bob).mean()
        return loss, {"loss": loss, "loss_alice": loss_alice.mean(),
                      "loss_bob": loss_bob.mean(),
                      "mod_mean": torch.sigmoid(pred_mod).mean()}
    return _make_step(cfg, compete_group(cfg), "opt_compete", loss_fn)


def make_collaborate_step(cfg: MnistConfig):
    """The collaborate step: the moderator against the detached CE losses
    (the soft assignment's loss, the BCE to the pseudo-label la < lb and
    wr times the variance regularizer), through the collaborate
    optimizer."""
    def loss_fn(pred_alice, pred_bob, pred_mod, loss_alice, loss_bob):
        la, lb = loss_alice.detach(), loss_bob.detach()
        s = torch.sigmoid(pred_mod)
        loss1 = (s * la + (1 - s) * lb).mean()
        pseudo = (la < lb).to(pred_mod.dtype)
        loss2 = F.binary_cross_entropy_with_logits(pred_mod, pseudo)
        loss = loss1 + loss2 + cfg.wr * mod_regularization_loss(pred_mod)
        return loss, {"loss": loss, "loss_alice": loss_alice.mean(),
                      "loss_bob": loss_bob.mean(), "mod_mean": s.mean()}
    return _make_step(cfg, collaborate_group(cfg), "opt_collaborate",
                      loss_fn)


@torch.no_grad()
def logits(nets: nn.ModuleDict, img: np.ndarray):
    """(alice's [B,10], bob's [B,10], the moderator's [B]) logits of an
    NHWC image batch, on the nets' device."""
    return _forward(nets, _to_nchw(img, _device_of(nets)), ())


@torch.no_grad()
def predict(nets: nn.ModuleDict, img: np.ndarray):
    """(total, alice, bob) label predictions; total picks Alice's where
    sigmoid(mod) > 0.5 (mnist.py:432-438)."""
    pred_alice, pred_bob, pred_mod = logits(nets, img)
    la = pred_alice.argmax(1)
    lb = pred_bob.argmax(1)
    return torch.where(torch.sigmoid(pred_mod) > 0.5, la, lb), la, lb


def evaluate(nets: nn.ModuleDict, batches):
    """[1-acc_total, 1-acc_alice, 1-acc_bob] over an iterable of
    (img, target) numpy batches, and their names (mnist.py:416-463)."""
    correct = np.zeros(3)
    count = 0
    for img, target in batches:
        preds = predict(nets, img)
        correct += [np.sum(p.cpu().numpy() == target) for p in preds]
        count += len(target)
    acc = correct / count
    return [1 - a for a in acc], ["Total loss", "alice loss", "bob loss"]


def save_checkpoint(path: str, state: MnistState) -> None:
    """Write the whole state to `path` (a torch file): the nets' state
    dicts, each optimizer's moments under the keys of the parameters they
    belong to and its count, and the step count. Written to a temporary
    file first, then renamed over `path`."""
    def group(g: AdamGroup) -> dict:
        keys = lambda n: [k for k, _ in state.nets[n].named_parameters()]
        return {"count": g.count,
                **{m: {n: dict(zip(keys(n), getattr(g, m)[n]))
                       for n in g.mu} for m in ("mu", "nu")}}
    tmp = f"{path}.tmp"
    torch.save({"nets": {n: state.nets[n].state_dict() for n in NETS},
                "opt_compete": group(state.opt_compete),
                "opt_collaborate": group(state.opt_collaborate),
                "step": state.step}, tmp)
    os.replace(tmp, path)


def load_nets(path: str, nets: nn.ModuleDict) -> nn.ModuleDict:
    """Load the nets of a save_checkpoint file into `nets`, strictly, on
    whatever device they are."""
    saved = torch.load(path, map_location="cpu", weights_only=True)["nets"]
    for n in NETS:
        nets[n].load_state_dict(saved[n], strict=True)
    return nets
