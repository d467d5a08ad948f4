"""Carry weights across from cc_tpu: flax (params, batch_stats) numpy trees
-> reference-format torch state dicts -> the port's nets; and cc_tpu's
whole train state, Adam's moments and counts too (load_cc_tpu_state).

The key maps are copies of cc_tpu/train/torch_import.py's converters for the
slice's nets (the port imports nothing of cc_tpu); the transforms are the
inverses of cc_tpu/train/torch_export.py:102-109:

- conv   kernel [kh,kw,I,O] -> weight [O,I,kh,kw]
- tconv  kernel [kh,kw,I,O] -> weight [I,O,kh,kw] + spatial flip (cc_tpu's
         ConvTranspose is an input-dilated conv)
- bn     scale/bias/mean/var -> weight/bias/running_mean/running_var
         (+ num_batches_tracked = 0, which strict loading requires)
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

# (kind, torch key, flax path) triples of one architecture
Mapping = list[tuple[str, str, str]]


class _Recorder:
    def __init__(self):
        self.entries: Mapping = []

    def conv(self, tkey: str, path: str, bias: bool = True) -> None:
        self.entries.append(("conv_w", tkey + ".weight", path + "/kernel"))
        if bias:
            self.entries.append(("plain", tkey + ".bias", path + "/bias"))

    def tconv(self, tkey: str, path: str) -> None:
        self.entries.append(("tconv_w", tkey + ".weight", path + "/kernel"))
        self.entries.append(("plain", tkey + ".bias", path + "/bias"))

    def bn(self, tkey: str, path: str) -> None:
        self.entries.append(("plain", tkey + ".weight", path + "/scale"))
        self.entries.append(("plain", tkey + ".bias", path + "/bias"))
        self.entries.append(("bn_mean", tkey + ".running_mean", path + "/mean"))
        self.entries.append(("bn_var", tkey + ".running_var", path + "/var"))


def _res_layer(w: _Recorder, tpfx: str, mpfx: str, blocks: int,
               in_planes: int, planes: int, stride: int) -> None:
    for b in range(blocks):
        t, m = f"{tpfx}.{b}", f"{mpfx}/BasicBlock_{b}"
        w.conv(f"{t}.conv1", f"{m}/Conv_0/Conv_0", bias=False)
        w.conv(f"{t}.conv2", f"{m}/Conv_1/Conv_0", bias=False)
        if b == 0 and (stride != 1 or in_planes != planes):
            w.conv(f"{t}.downsample.0", f"{m}/Conv_2/Conv_0", bias=False)
            w.bn(f"{t}.downsample.1", f"{m}/BatchNorm_0")


def _dispnet(variant: str) -> Mapping:
    w = _Recorder()
    resnet = variant in ("DispResNet6", "DispResNetS6")
    enc_planes = [32, 64, 128, 256, 512, 512, 512]
    enc_blocks = {"DispResNet6": [2] * 6,
                  "DispResNetS6": [2, 2, 3, 3, 3, 3]}.get(variant)
    dec_blocks = {"DispResNet6": [1] * 7,
                  "DispResNetS6": [2, 2, 2, 2, 1, 1, 1]}.get(variant)
    dec_planes = [512, 512, 256, 128, 64, 32, 16]

    w.conv("conv1.0", "DownsampleConvBlock_0/Conv_0/Conv_0")
    w.conv("conv1.2", "DownsampleConvBlock_0/Conv_1/Conv_0")
    for i in range(2, 8):
        if resnet:
            _res_layer(w, f"conv{i}", f"ResLayer_{i - 2}", enc_blocks[i - 2],
                       enc_planes[i - 2], enc_planes[i - 1], 2)
        else:
            w.conv(f"conv{i}.0", f"DownsampleConvBlock_{i - 1}/Conv_0/Conv_0")
            w.conv(f"conv{i}.2", f"DownsampleConvBlock_{i - 1}/Conv_1/Conv_0")

    # decoder levels 7..1; the input widths only decide the projections
    enc_skip = [None, 16 + 1, 32 + 64 + 1, 64 + 128 + 1, 128 + 256,
                256 + 512, 512 + 512, 512 + 512]
    for j, lev in enumerate(range(7, 0, -1)):
        w.tconv(f"upconv{lev}.0", f"UpconvReLU_{j}/ConvTranspose_0")
        if resnet:
            _res_layer(w, f"iconv{lev}", f"_IconvRes_{j}/ResLayer_0",
                       dec_blocks[j], enc_skip[lev], dec_planes[j], 1)
        else:
            w.conv(f"iconv{lev}.0", f"_IconvPlain_{j}/ConvReLU_0/Conv_0/Conv_0")
    top = 4 if variant == "DispNetS" else 6
    for k, lev in enumerate(range(top, 0, -1)):
        w.conv(f"predict_disp{lev}.0", f"PredictDisp_{k}/Conv_0/Conv_0")
    return w.entries


def _posenet_b6() -> Mapping:
    w = _Recorder()
    for i in range(1, 9):
        w.conv(f"conv{i}.0", f"ConvReLU_{i - 1}/Conv_0/Conv_0")
    w.conv("pose_pred", "Conv_0/Conv_0")
    return w.entries


def _masknet6() -> Mapping:
    w = _Recorder()
    for i in range(1, 7):
        w.conv(f"conv{i}.0", f"ConvReLU_{i - 1}/Conv_0/Conv_0")
    for j, lev in enumerate(range(6, 0, -1)):
        w.tconv(f"deconv{lev}.0", f"Upconv4ReLU_{j}/ConvTranspose_0")
    for k in range(6):
        w.conv(f"pred_mask{k + 1}", f"Conv_{k}/Conv_0")
    return w.entries


def _back2future() -> Mapping:
    w = _Recorder()
    for lvl in range(1, 7):
        for s in "abc":
            w.conv(f"conv{lvl}{s}.0", f"conv{lvl}{s}/Conv_0/Conv_0")
            w.conv(f"conv{lvl}{s}.2", f"conv{lvl}{s}/Conv_1/Conv_0")
    for kind in ("fwd", "bwd", "occ"):
        for l in range(2, 7):
            name = f"decoder_{kind}{l}"
            for j, t_idx in enumerate((0, 2, 4, 6, 8, 10)):
                w.conv(f"{name}.{t_idx}", f"{name}/Conv_{j}/Conv_0")
    return w.entries


def _flownetc6() -> Mapping:
    w = _Recorder()
    for name in ("conv1", "conv2", "conv3", "conv_redir", "conv3_1", "conv4",
                 "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1"):
        w.conv(f"{name}.0", f"{name}/Conv_0/Conv_0")
    for lvl in range(1, 6):
        w.tconv(f"deconv{lvl}.0", f"deconv{lvl}/ConvTranspose_0")
    for lvl in range(1, 7):
        w.conv(f"predict_flow{lvl}", f"predict_flow{lvl}/Conv_0/Conv_0")
    for a in range(6, 1, -1):
        w.tconv(f"upsampled_flow{a}_to_{a - 1}",
                f"up{a}to{a - 1}/ConvTranspose_0")
    return w.entries


_MAPPINGS = {
    "DispNetS": lambda: _dispnet("DispNetS"),
    "DispNetS6": lambda: _dispnet("DispNetS6"),
    "DispResNet6": lambda: _dispnet("DispResNet6"),
    "DispResNetS6": lambda: _dispnet("DispResNetS6"),
    "PoseNetB6": _posenet_b6,
    "MaskNet6": _masknet6,
    "Back2Future": _back2future,
    "FlowNetC6": _flownetc6,
}

_INVERSE = {
    "conv_w": lambda a: np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1))),
    "tconv_w": lambda a: np.ascontiguousarray(
        np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]),
    "plain": np.asarray,
    "bn_mean": np.asarray,
    "bn_var": np.asarray,
}


def _get(tree: dict, path: str) -> np.ndarray:
    for p in path.split("/"):
        tree = tree[p]
    return np.asarray(tree)


def _mapping(arch: str) -> Mapping:
    if arch not in _MAPPINGS:
        raise KeyError(f"no weight mapping for {arch!r}; have {sorted(_MAPPINGS)}")
    return _MAPPINGS[arch]()


def state_dict_from_flax(arch: str, params: dict,
                         batch_stats: dict | None = None) -> dict:
    """flax (params, batch_stats) -> reference torch state dict (numpy)."""
    batch_stats = batch_stats or {}
    sd: dict[str, np.ndarray] = {}
    for kind, tkey, path in _mapping(arch):
        tree = batch_stats if kind in ("bn_mean", "bn_var") else params
        sd[tkey] = _INVERSE[kind](_get(tree, path))
        if kind == "bn_var":
            sd[tkey.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
                np.asarray(0, dtype=np.int64)
    return sd


def params_from_flax(arch: str, tree: dict) -> dict:
    """A tree shaped as flax params (the params, or Adam's moments of them)
    -> {torch key: numpy array} of the parameters alone."""
    return {tkey: _INVERSE[kind](_get(tree, path))
            for kind, tkey, path in _mapping(arch)
            if kind not in ("bn_mean", "bn_var")}


def load_flax_weights(net: nn.Module, arch: str, params: dict,
                      batch_stats: dict | None = None) -> nn.Module:
    """Load cc_tpu weights into a port net (strict: every key must match)."""
    sd = state_dict_from_flax(arch, params, batch_stats)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                        strict=True)
    return net


def load_cc_tpu_state(nets: nn.ModuleDict, opt_state, params: dict,
                      batch_stats: dict, mu: dict, nu: dict, count, step,
                      notfinite=0) -> None:
    """Fill the port's nets and AdamState, in place, from cc_tpu's train
    state as numpy trees: TrainState.params and .batch_stats, optax's
    ScaleByAdamState mu, nu and count, TrainState.step, and (with
    skip_nonfinite_updates) ApplyIfFiniteState.total_notfinite. Each net's
    architecture is the name models.build gave it; the moments go through
    the same key maps and layout changes as the parameters."""
    for name, net in nets.items():
        arch = net.arch
        load_flax_weights(net, arch, params[name], batch_stats.get(name))
        keys = [k for k, _ in net.named_parameters()]
        with torch.no_grad():
            for mine, tree in ((opt_state.mu[name], mu[name]),
                               (opt_state.nu[name], nu[name])):
                sd = params_from_flax(arch, tree)
                for t, k in zip(mine, keys):
                    t.copy_(torch.from_numpy(np.array(sd[k])))
    opt_state.count = int(count)
    opt_state.step = int(step)
    opt_state.notfinite = int(notfinite)
