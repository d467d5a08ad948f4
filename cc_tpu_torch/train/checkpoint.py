"""Save and resume the whole train state: the counterpart of
cc_tpu/train/checkpoint.py, as one torch.save file instead of an orbax
directory.

`<save_dir>/checkpoint.pt` holds the four nets' state dicts in the
reference's key names (BatchNorm running stats included), Adam's first and
second moments under the same keys as the parameters they belong to, the
update count, the count of dropped non-finite updates, the step count and
the four architecture names. `is_best` copies it to `<save_dir>/best.pt`,
as cc_tpu promotes `<dir>/checkpoint` to `<dir>/best`. The optimizer
state's structure is the same in every --fix-* phase, so a checkpoint of
one phase resumes in another. In a multi-process launch the primary saves
and every process loads (cc_tpu/train/checkpoint.py:22-50).
"""
from __future__ import annotations

import os
import shutil

import torch
from torch import nn

from cc_tpu_torch.parallel import distributed
from cc_tpu_torch.train.state import NETS, AdamState

CHECKPOINT = "checkpoint.pt"
BEST = "best.pt"


def architectures(nets: nn.ModuleDict) -> dict[str, str]:
    """{net: the reference's architecture name} (models.build)."""
    return {n: nets[n].arch for n in NETS}


def _param_keys(net: nn.Module) -> list[str]:
    return [k for k, _ in net.named_parameters()]


def _replace_atomically(path: str, write) -> None:
    """write(tmp) then rename over `path`: a reader never sees half a file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(save_dir: str, nets: nn.ModuleDict, opt_state: AdamState,
                    is_best: bool = False) -> str:
    """Write <save_dir>/checkpoint.pt (and copy it to best.pt when
    is_best); returns its path. In a multi-process launch only the primary
    writes, since every process holds the same state; the others return
    the path at once."""
    path = os.path.join(save_dir, CHECKPOINT)
    if not distributed.is_primary():
        return path
    os.makedirs(save_dir, exist_ok=True)
    moments = lambda m: {n: dict(zip(_param_keys(nets[n]), m[n]))
                         for n in NETS}
    state = {"archs": architectures(nets),
             "nets": {n: nets[n].state_dict() for n in NETS},
             "mu": moments(opt_state.mu), "nu": moments(opt_state.nu),
             "count": opt_state.count, "notfinite": opt_state.notfinite,
             "step": opt_state.step}
    _replace_atomically(path, lambda tmp: torch.save(state, tmp))
    if is_best:
        _replace_atomically(os.path.join(save_dir, BEST),
                            lambda tmp: shutil.copyfile(path, tmp))
    return path


def load_checkpoint(path: str, nets: nn.ModuleDict,
                    opt_state: AdamState) -> AdamState:
    """Load a checkpoint (its file, or the directory that holds
    checkpoint.pt) into `nets` and `opt_state` in place, on whatever device
    they are. Every key must match (strict); raises ValueError when the
    checkpoint's architectures are not the nets'. In a multi-process launch
    every process loads the file, which raises FileNotFoundError on a
    process that cannot see it (cc_tpu/cli/train.py:386-398), rather than
    let it train from other weights than the primary's."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT)
    if distributed.process_count() > 1 and not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} is not visible to process {distributed.process_index()}"
            ": in a multi-process launch the checkpoint directory must be on "
            "a filesystem that every process sees")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if state["archs"] != architectures(nets):
        raise ValueError(f"{path} holds {state['archs']}, the nets are "
                         f"{architectures(nets)}")
    with torch.no_grad():
        for n in NETS:
            nets[n].load_state_dict(state["nets"][n], strict=True)
            keys = _param_keys(nets[n])
            for mine, saved in ((opt_state.mu[n], state["mu"][n]),
                                (opt_state.nu[n], state["nu"][n])):
                if list(saved) != keys:
                    raise ValueError(f"{path}: Adam's moments of {n} do not "
                                     "match its parameters")
                for t, k in zip(mine, keys):
                    if t.shape != saved[k].shape:
                        raise ValueError(f"{path}: moment of {n}.{k} has "
                                         f"shape {tuple(saved[k].shape)}, "
                                         f"not {tuple(t.shape)}")
                    t.copy_(saved[k])
    opt_state.count = int(state["count"])
    opt_state.notfinite = int(state["notfinite"])
    opt_state.step = int(state["step"])
    return opt_state
