"""Model registry: construction by the reference's names
(counterpart of cc_tpu/models/__init__.py)."""
from cc_tpu_torch.models.back2future import Back2Future
from cc_tpu_torch.models.dispnet import (
    DispNet, DispNetS, DispNetS6, DispResNet6, DispResNetS6,
)
from cc_tpu_torch.models.flownetc import FlowNetC6
from cc_tpu_torch.models.masknet import MaskNet6, MaskResNet6
from cc_tpu_torch.models.posenet import PoseExpNet, PoseNet6, PoseNetB6

_REGISTRY = {
    "DispNetS": DispNetS,
    "DispNetS6": DispNetS6,
    "DispResNet6": DispResNet6,
    "DispResNetS6": DispResNetS6,
    "PoseNet6": PoseNet6,
    "PoseNetB6": PoseNetB6,
    "PoseExpNet": PoseExpNet,
    "MaskNet6": MaskNet6,
    "MaskResNet6": MaskResNet6,
    "Back2Future": Back2Future,
    "FlowNetC6": FlowNetC6,
}


def build(name: str, **kwargs):
    """Construct a model by its reference-compatible name, which it keeps
    as `arch` (checkpoints and weight maps read it)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    net = _REGISTRY[name](**kwargs)
    net.arch = name
    return net


__all__ = [
    "build", "DispNet", "DispNetS", "DispNetS6", "DispResNet6",
    "DispResNetS6", "PoseNet6", "PoseNetB6", "PoseExpNet", "MaskNet6",
    "MaskResNet6", "Back2Future", "FlowNetC6",
]
