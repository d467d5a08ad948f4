"""Carry weights across from cc_tpu: flax (params, batch_stats) numpy trees
-> reference-format torch state dicts -> the port's nets; cc_tpu's whole
train state, Adam's moments and counts too (load_cc_tpu_state); and the
reference's own .pth.tar checkpoints, the train CLI's --pretrained-*
(load_pretrained), whose keys are the port's parameter names already.

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

from cc_tpu_torch import models

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


def _posenet(variant: str, output_exp: bool = False) -> Mapping:
    w = _Recorder()
    if variant == "PoseNetB6":
        for i in range(1, 9):
            w.conv(f"conv{i}.0", f"ConvReLU_{i - 1}/Conv_0/Conv_0")
    elif variant == "PoseNet6":
        for i in range(0, 8):
            w.conv(f"conv{i}.0", f"ConvReLU_{i}/Conv_0/Conv_0")
    else:  # PoseExpNet
        for i in range(1, 8):
            w.conv(f"conv{i}.0", f"ConvReLU_{i - 1}/Conv_0/Conv_0")
    w.conv("pose_pred", "Conv_0/Conv_0")
    if output_exp:  # PoseExpNet's optional mask decoder
        for j, lev in enumerate(range(5, 0, -1)):
            w.tconv(f"upconv{lev}.0", f"Upconv4ReLU_{j}/ConvTranspose_0")
        for k, lev in enumerate((4, 3, 2, 1)):
            w.conv(f"predict_mask{lev}", f"Conv_{k + 1}/Conv_0")
    return w.entries


def _masknet(variant: str) -> Mapping:
    w = _Recorder()
    if variant == "MaskNet6":
        for i in range(1, 7):
            w.conv(f"conv{i}.0", f"ConvReLU_{i - 1}/Conv_0/Conv_0")
    else:  # MaskResNet6
        planes = [16, 32, 64, 128, 256, 256]
        w.conv("conv1.0", "ConvReLU_0/Conv_0/Conv_0")
        for i in range(2, 7):
            _res_layer(w, f"conv{i}", f"ResLayer_{i - 2}", 2, planes[i - 2],
                       planes[i - 1], 2)
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
    "PoseNet6": lambda: _posenet("PoseNet6"),
    "PoseNetB6": lambda: _posenet("PoseNetB6"),
    "PoseExpNet": lambda output_exp=False: _posenet("PoseExpNet", output_exp),
    "MaskNet6": lambda: _masknet("MaskNet6"),
    "MaskResNet6": lambda: _masknet("MaskResNet6"),
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


def _mapping(arch: str, params: dict) -> Mapping:
    """The map of `arch`; PoseExpNet's includes the mask decoder when the
    flax tree `params` has one (cc_tpu's export probes the same way)."""
    if arch not in _MAPPINGS:
        raise KeyError(f"no weight mapping for {arch!r}; have {sorted(_MAPPINGS)}")
    if arch == "PoseExpNet":
        return _MAPPINGS[arch]("Upconv4ReLU_0" in params)
    return _MAPPINGS[arch]()


def state_dict_from_flax(arch: str, params: dict,
                         batch_stats: dict | None = None) -> dict:
    """flax (params, batch_stats) -> reference torch state dict (numpy)."""
    batch_stats = batch_stats or {}
    sd: dict[str, np.ndarray] = {}
    for kind, tkey, path in _mapping(arch, params):
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
            for kind, tkey, path in _mapping(arch, tree)
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


def read_reference_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """The state dict of a reference .pth.tar ({'epoch', 'state_dict'}, or
    a bare state dict), with the first "module." of each key (a
    DataParallel prefix) taken out, as cc_tpu's importer does
    (torch_import.py:221). Loaded with weights_only: tensors and plain
    containers, no other pickled objects."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.replace("module.", "", 1): v for k, v in sd.items()}


def load_reference_weights(net: nn.Module, sd: dict[str, torch.Tensor],
                           what: str = "net") -> nn.Module:
    """Load a reference state dict into a port net, strict. BatchNorm's
    num_batches_tracked, which torch >= 0.4.1 writes and cc_tpu's importer
    never reads, is dropped: the net keeps its own. Any other missing or
    unexpected key, or a shape that differs, raises ValueError naming
    `what` and the architecture."""
    nbt = ".num_batches_tracked"
    own = {k: v for k, v in net.state_dict().items() if k.endswith(nbt)}
    sd = {k: v for k, v in sd.items() if not k.endswith(nbt)} | own
    try:
        net.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise ValueError(f"{what}: the checkpoint does not fit "
                         f"{net.arch}: {e}") from e
    return net


def without_unused_mask_decoder(net: nn.Module,
                                sd: dict[str, torch.Tensor]) -> dict:
    """`sd` for `net`: a PoseExpNet built without its mask decoder
    (output_exp=False, as test_disp builds it) takes a checkpoint that
    has one, whose decoder keys (upconv*, predict_mask*) are left out.
    cc_tpu's importer maps them into variables that its forward never
    reads (torch_import.py:139-146); the reference loads the file with
    strict=False (test_disp.py). Any other net's `sd` is returned as is."""
    if net.arch != "PoseExpNet" or net.output_exp:
        return sd
    return {k: v for k, v in sd.items()
            if not k.startswith(("upconv", "predict_mask"))}


def load_pretrained(nets: nn.ModuleDict,
                    paths: dict[str, str | None]) -> None:
    """The train CLI's --pretrained-{disp,pose,mask,flow}: load each given
    reference checkpoint into nets[name], in place. PoseExpNet is rebuilt
    with or without its mask decoder as the checkpoint has one (probed by
    an upconv5 key, torch_import.py:139-146), on the same device and in
    the same mode."""
    for name, path in paths.items():
        if path is None:
            continue
        print(f"=> loading pretrained torch weights for {name} from {path}")
        sd = read_reference_checkpoint(path)
        net = nets[name]
        if net.arch == "PoseExpNet":
            output_exp = any(k.startswith("upconv5") for k in sd)
            if output_exp != net.output_exp:
                device = next(net.parameters()).device
                net = models.build("PoseExpNet", nb_ref_imgs=net.nb_ref_imgs,
                                   output_exp=output_exp)
                net = net.to(device).train(nets[name].training)
                nets[name] = net
        load_reference_weights(net, sd, f"--pretrained-{name} {path}")
