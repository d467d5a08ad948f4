#!/usr/bin/env python3
"""Drive the cc_tpu_torch port on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero (also when CUDA is absent, or when the package is not beside it):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions; TF32 off for matmuls and cuDNN convs.
2. build: every kernel from the sources in the checkout, timed.
3. kernels vs plain, each at the shapes its paths give it: max abs error
   (fails above its tolerance), kernel and plain device times (CUDA-graph
   replays, see time_device), the bound (bytes at the card's memory rate or
   fp32 operations at its peak, whichever is larger) and, where one PyTorch
   call computes the same function, that call's time; for K1 and K1', the
   same bits on a second launch, the tiles and the bytes each stages from
   L2 into shared memory, counted from them.
   - K1, the correlation forward, and K1', its backward: Back2Future's five
     pyramid shapes (P=9, d=1), FlowNetC6's shape (P=21, d=2) and a ragged
     shape.
   - K2, the row gather, at experiment E5's [256,832].
4. gather: E5's path on the port, the row gather of E5's inputs.
5. slice: forward_eval of the four paper-default nets at 832x256, batch 4,
   fp32, seeded init: shapes, finite values, exactly 10 correlation launches
   per forward, and one sample against the same nets on the CPU.
6. timing: median of 3 windows of forwards, each ended by a synchronize;
   the operations of each net's convolutions, counted from the shapes;
   then a torch.profiler breakdown of device time by kernel and of the
   costliest convolutions by shape, and the convolutions' rate.
7. train: build_train_step at bench.py's operating point (832x256, batch 4,
   fp32): 5 warm-up steps with finite losses; exactly 10 K1 and 10
   K1' launches in one step; a fix_flownet step with 10 K1, 0 K1' and F's
   parameters bit-equal; one 128x128 batch-2 step on the card against the
   same step on the CPU (plain kernels) from the same weights and batch.
8. train timing: the median of 3 windows of 5 steps, each ended by a
   synchronize, then a torch.profiler breakdown per step.
9. flownetc6_*: phases 5-8 again with FlowNetC6 as F (--flownet
   FlowNetC6), K1 and K1' at P=21, d=2: 2 K1 launches per forward, 2 K1
   and 2 K1' per step, 2 K1 and 0 K1' per fix_flownet step.
10. data_env: what the machine has for the data path, by explicit probes:
   cv2 (the JPEG decoder of load_image; the phase fails without it), PIL,
   g++ and OpenCV's headers (so that the C++ data plane builds), and the
   CPU cores torch sees.
11. data: a synthetic KITTI-shaped scene folder (832x256 JPEGs, cam.txt,
   train.txt) through SequenceFolder + train_transform + DataLoader(4
   threads) + device_prefetch into the Back2Future train step at bench.py's
   point, with float32 batches and again with uint8 ones: the first
   prefetched batch against the host's collate (equal bits), 10 K1 and 10
   K1' launches in one loader-fed step, finite losses; step times fed from
   a resident batch and from the loader in turns (resident, loader,
   loader, resident; 5 warm-up steps, then the median of 3 windows of 3
   steps), the time the loop waited on the iterator and on the loader,
   decode + augment ms per batch, H2D bytes per step, and the copies per
   step from a torch.profiler window of one step.
12. resume: at 128x128, batch 2, two loader-fed steps, a checkpoint, then
   a step and a fix_flownet step; the same two steps again from the
   checkpoint loaded into fresh nets under cudnn.deterministic, within the
   card-vs-CPU tolerances (whether the bits were equal is recorded). Then
   save and load of the full-size four-net state, timed, with its bytes.
13. kernels: one entry per kernel; its launches, times and bound per run
   of each path that runs it (`paths`), the first path's at the top level.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import ctypes
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from cc_tpu_torch.data.loader import DataLoader, collate, device_prefetch
from cc_tpu_torch.data.native_pipeline import train_pipeline
from cc_tpu_torch.data.sequence_folders import SequenceFolder
from cc_tpu_torch.ops import _build
from cc_tpu_torch.ops import correlation as corr
from cc_tpu_torch.ops import row_gather as rg
from cc_tpu_torch.train import (
    METRICS, NETS, TrainConfig, build_train_step, forward_eval,
    load_checkpoint, make_models, make_optimizer, save_checkpoint,
)

ATOL = 1e-5          # correlation kernels vs plain, fp32 sums in another order
SLICE_RTOL = 1e-3    # GPU vs CPU forward, relative to each output's max
B = 4
# Back2Future's correlation inputs at 832x256: (H, W, C) at levels 2..6
MAIN_SHAPES = [(64, 208, 32), (32, 104, 64), (16, 52, 96), (8, 26, 128),
               (4, 13, 192)]
B2F_CASES = [((B, *s), 9, 1) for s in MAIN_SHAPES]
# FlowNetC6's correlation input at 832x256: conv3's [B,32,104,256]
C6_CASES = [((B, 32, 104, 256), 21, 2)]
RAGGED_CASES = [((2, 5, 7, 3), 9, 1)]
# per run of a path, K1 and K1' launch twice at each of its shapes:
# Back2Future's forward and backward streams at each level, FlowNetC6's
# two calls of F (tgt with refs[2], tgt with refs[1])
LAUNCHES_PER_SHAPE = 2
FLOWNETS = {"Back2Future": (B2F_CASES, ""),
            "FlowNetC6": (C6_CASES, "flownetc6_")}
GATHER_HW = (256, 832)  # scripts/exp_gather.py:43,159-160
# bench.py:80-112, the JAX package's timed train step
BENCH = dict(wssim=0.997, smoothness_type="edgeaware",
             cam_photo_loss_weight=1.0, mask_loss_weight=0.1,
             smooth_loss_weight=0.1, flow_photo_loss_weight=0.5,
             consensus_loss_weight=0.3, lr=1e-4)
# one train step on the card vs on the CPU, from the same weights and batch
TRAIN_METRIC_RTOL = 1e-3  # relative to each metric
# first moments, relative to each net's largest: the odd occlusion or
# consensus pixel on the other side of its threshold moves a decoder's
# gradient (measured 0.92e-3, F's decoder_bwd3)
TRAIN_MU_RTOL = 2e-3
TRAIN_STATS_RTOL = 1e-4   # BatchNorm running stats, relative to magnitude
# Updated parameters: besides the 2*lr bound below, the share of entries
# that may differ by more than 1e-6 (measured: 0.05%); the bound of
# tests/test_torch_train_step.py, the CPU step against cc_tpu's
PARAM_MOVED_SHARE = 0.01
# (memory bytes/s, fp32 FLOP/s outside the tensor cores), NVIDIA data sheets
PEAKS = [("H100 PCIe", (2.0e12, 51e12)), ("H100 NVL", (3.9e12, 60e12)),
         ("H100", (3.35e12, 67e12)), ("H200", (4.8e12, 67e12))]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks(name: str) -> tuple[float, float]:
    for key, value in PEAKS:
        if key in name:
            return value
    raise RuntimeError(f"no peak rates known for {name!r}")


def bound_ms(nbytes: float, ops: float, bw: float, flops: float):
    """Least time for the work: bytes at the memory rate or operations at
    the fp32 peak, whichever is larger. Returns (ms, "bytes"|"operations")."""
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def corr_work(shape, patch, backward: bool):
    """(bytes, operations) of one correlation launch, each input read once
    and each output written once. Forward: f1, f2 in, the cost volume out,
    2*P*P*C operations per pixel. Backward: f1, f2, g in, df1, df2 out,
    4*P*P*C operations per pixel."""
    b, h, w, c = shape
    pix, pp = b * h * w, patch * patch
    if backward:
        return 4 * pix * (4 * c + pp), 4 * pix * pp * c
    return 4 * pix * (2 * c + pp), 2 * pix * pp * c


def fwd_tiles(shape, patch: int, dil: int) -> tuple[int, int, int]:
    """K1's tiles as correlation.cu picks them for a shape: (pixels of one
    residue class a block, pixels a thread, channels a chunk)."""
    fn = _build.load("correlation").cc_correlation_forward_tiles
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
    tw, npx, ck = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    fn(shape[2], shape[3], patch, dil, ctypes.byref(tw), ctypes.byref(npx),
       ctypes.byref(ck))
    return tw.value, npx.value, ck.value


def live_rows(h: int, patch: int, dil: int) -> int:
    """(image row, displacement row) pairs whose displaced row lies in the
    image: the rows a correlation kernel stages."""
    r = patch // 2
    return sum(min(patch - 1, r + (h - 1 - y) // dil) - max(0, r - y // dil)
               + 1 for y in range(h))


def residue_tiles(w: int, dil: int, tw: int) -> int:
    """Column tiles of tw pixels over the residue classes of a row."""
    return sum(-(-((w - res + dil - 1) // dil) // tw) for res in range(dil))


def fwd_staged_bytes(shape, patch: int, dil: int) -> int:
    """Bytes one K1 launch copies from L2 into shared memory: for each
    block whose f2 row lies in the image, each chunk of ck channels at tw
    pixels of f1 and tw + P - 1 columns of f2."""
    b, h, w, c = shape
    tw, _, ck = fwd_tiles(shape, patch, dil)
    per_block = 4 * (2 * tw + patch - 1) * ck * -(-c // ck)
    return b * live_rows(h, patch, dil) * residue_tiles(w, dil, tw) * per_block


def bwd_tiles(shape, dil: int) -> tuple[int, int]:
    """K1''s tiles as correlation.cu picks them for a shape: (pixels of one
    residue class a block, channels a block)."""
    fn = _build.load("correlation").cc_correlation_backward_tiles
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    tw, cb = ctypes.c_int(), ctypes.c_int()
    fn(*shape, dil, ctypes.byref(tw), ctypes.byref(cb))
    return tw.value, cb.value


def bwd_staged_bytes(shape, patch: int, dil: int) -> int:
    """Bytes one K1' launch copies from L2 into shared memory: for each
    block and each displacement row whose value row lies in the image,
    tw + P - 1 columns of cb values, and P entries of g at tw pixels (df1)
    or tw + P - 1 (df2)."""
    b, h, w, c = shape
    tw, cb = bwd_tiles(shape, dil)
    span = tw + patch - 1
    per_row = 4 * (2 * span * cb + (tw + span) * patch)  # df1's and df2's
    return (b * -(-c // cb) * residue_tiles(w, dil, tw)
            * live_rows(h, patch, dil) * per_row)


def time_device(fn, n: int = 20, reps: int = 5) -> float:
    """Device ms of one call of fn: n calls captured in a CUDA graph, so
    that the host's launch overhead is not timed, replayed `reps` times
    between CUDA events; the median replay over n. The inputs stay in L2
    between calls, as the freshly written features of the forward may."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def seeded_batch(cfg: TrainConfig, device, seed: int = 0,
                 h2d: str = "float32") -> dict:
    """bench.py:102-112: images uniform in [-1, 1], KITTI-like intrinsics;
    with h2d="uint8", images uniform in 0..255 as uint8 (the compact
    host-to-device mode, normalized on the device)."""
    r = np.random.RandomState(seed)
    b, h, w = cfg.batch_size, cfg.height, cfg.width
    if h2d == "uint8":
        tgt = r.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
        refs = r.randint(0, 256, (b, cfg.nb_ref_imgs, h, w, 3)).astype(
            np.uint8)
    else:
        tgt = r.rand(b, h, w, 3).astype(np.float32) * 2 - 1
        refs = r.rand(b, cfg.nb_ref_imgs, h, w, 3).astype(np.float32) * 2 - 1
    k = np.array([[w * 0.6, 0, w / 2], [0, h * 1.2, h / 2], [0, 0, 1]],
                 dtype=np.float32)[None].repeat(b, 0)
    batch = {"tgt": tgt, "refs": refs, "intrinsics": k,
             "intrinsics_inv": np.linalg.inv(k).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def phase_correlation(bw, flops, backward: bool):
    """K1 (backward=False) or K1' against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(1 if backward else 0)
    cases = B2F_CASES + C6_CASES + RAGGED_CASES
    name = "correlation_backward" if backward else "correlation_forward"
    rows = []
    for shape, patch, dil in cases:
        f1 = torch.randn(shape, generator=gen, device="cuda")
        f2 = torch.randn(shape, generator=gen, device="cuda")
        if backward:
            g = torch.randn((*shape[:3], patch * patch), generator=gen,
                            device="cuda")
            kernel = lambda: corr.correlation_backward_cuda(f1, f2, g, patch,
                                                            dil)
            plain = lambda: corr.correlation_backward_plain(f1, f2, g, patch,
                                                            dil)
        else:
            kernel = lambda: (corr.correlation_cuda(f1, f2, patch, dil),)
            plain = lambda: (corr.correlation_plain(f1, f2, patch, dil),)
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        # sums in a fixed order, no atomics: the same bits on every launch
        if not all(map(torch.equal, kernel(), out)):
            raise AssertionError(f"{name} differs between two launches "
                                 f"at {shape} P={patch} d={dil}")
        ms = time_device(kernel)
        plain_ms = time_device(plain, n=5, reps=3)
        bnd, by = bound_ms(*corr_work(shape, patch, backward), bw, flops)
        row = {"phase": "kernel", "name": name, "shape": list(shape),
               "patch": patch, "dilation": dil, "max_abs_err": err,
               "atol": ATOL, "ms": ms, "plain_ms": plain_ms,
               "bound_us": bnd * 1e3, "bound_by": by}
        if backward:
            row["tiles"] = bwd_tiles(shape, dil)
            row["staged_mb"] = bwd_staged_bytes(shape, patch, dil) / 1e6
        else:
            row["tiles"] = fwd_tiles(shape, patch, dil)
            row["staged_mb"] = fwd_staged_bytes(shape, patch, dil) / 1e6
        emit(row)
        if not err <= ATOL:
            raise AssertionError(f"{name} disagrees at {shape} P={patch} "
                                 f"d={dil}: {err} > {ATOL}")
        rows.append(row)
    return rows


def gather_inputs(in_range: bool):
    """E5's table and indices (scripts/exp_gather.py:159-160): uniform
    in-range indices; or a check set with a quarter out of range."""
    h, w = GATHER_HW
    r = np.random.RandomState(0)
    img = torch.from_numpy(r.rand(h, w).astype(np.float32)).cuda()
    lo, hi = (0, h) if in_range else (-h // 8, h + h // 8)
    idx = torch.from_numpy(r.randint(lo, hi, (h, w)).astype(np.int32)).cuda()
    return img, idx


def phase_row_gather(bw, flops):
    """K2 against its plain version (exact), timed on E5's in-range
    indices beside torch.gather, the library call for the same function."""
    img, idx = gather_inputs(in_range=False)
    err = float((rg.row_gather_cuda(img, idx)
                 - rg.row_gather_plain(img, idx)).abs().max())
    torch.cuda.synchronize()
    img, idx = gather_inputs(in_range=True)
    idx64 = idx.long()
    if not torch.equal(rg.row_gather_cuda(img, idx),
                       torch.gather(img, 0, idx64)):
        raise AssertionError("row gather kernel disagrees with torch.gather")
    ms = time_device(lambda: rg.row_gather_cuda(img, idx))
    plain_ms = time_device(lambda: rg.row_gather_plain(img, idx))
    library_ms = time_device(lambda: torch.gather(img, 0, idx64))
    # the table entries these indices name, each read once; idx in, out out
    h, w = GATHER_HW
    cols = torch.arange(w, device="cuda")
    named = int(torch.unique(idx64 * w + cols).numel())
    bnd, by = bound_ms(4 * (named + 2 * h * w), 0.0, bw, flops)
    row = {"phase": "kernel", "name": "row_gather", "shape": [h, w],
           "max_abs_err": err, "atol": 0.0, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": "torch.gather",
           "table_entries_read": named, "bound_us": bnd * 1e3,
           "bound_by": by}
    emit(row)
    if err != 0.0:
        raise AssertionError(f"row gather kernel disagrees: {err}")
    return row


def phase_gather_path():
    """E5's path on the port: the row gather of E5's inputs, launches
    counted from 0."""
    img, idx = gather_inputs(in_range=True)
    rg.launches = 0
    out = rg.row_gather(img, idx)
    torch.cuda.synchronize()
    launches = rg.launches
    if launches != 1 or out.shape != idx.shape:
        raise AssertionError(f"row gather path: {launches} launches")
    emit({"phase": "gather", "what": "E5 row gather [256,832]",
          "row_gather_launches": launches})
    return launches


def _expect_launches(flownet: str) -> int:
    return LAUNCHES_PER_SHAPE * len(FLOWNETS[flownet][0])


def phase_slice(cfg: TrainConfig):
    """forward_eval with cfg.flownet as F: launches, shapes, finite values,
    and one sample against the same nets on the CPU."""
    prefix = FLOWNETS[cfg.flownet][1]
    nets = make_models(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    batch = seeded_batch(cfg, "cuda")
    forward_eval(cfg, nets, batch)  # warm-up: cuDNN set-up
    torch.cuda.synchronize()

    corr.launches = corr.backward_launches = 0
    out = forward_eval(cfg, nets, batch)
    torch.cuda.synchronize()
    launches = corr.launches
    expect = _expect_launches(cfg.flownet)
    if launches != expect or corr.backward_launches:
        raise AssertionError(f"{launches} correlation launches in one "
                             f"{cfg.flownet} forward, expected {expect}")

    b, h, w, n = cfg.batch_size, cfg.height, cfg.width, cfg.nb_ref_imgs
    expected = {"disp": (b, h, w, 1), "depth": (b, h, w, 1),
                "pose": (b, n, 6), "exp_mask": (b, h, w, n),
                "flow_fwd": (b, h, w, 2), "flow_bwd": (b, h, w, 2)}
    if cfg.flownet == "Back2Future":
        expected["occ"] = (b, h, w, 2)
    elif out["occ"] is not None:
        raise AssertionError(f"{cfg.flownet} gave an occlusion output")
    for k, shape in expected.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{k}: non-finite values")

    # one sample through the same nets on the CPU (plain correlation)
    nets_cpu = copy.deepcopy(nets).cpu()
    batch_cpu = {k: v[:1].cpu() for k, v in batch.items()}
    ref = forward_eval(cfg, nets_cpu, batch_cpu)
    errs = {}
    for k in expected:
        e = ref[k]
        err = float((out[k][:1].cpu() - e).abs().max())
        tol = SLICE_RTOL * max(1.0, float(e.abs().max()))
        errs[k] = {"max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"{k}: GPU vs CPU {err} > {tol}")
    emit({"phase": prefix + "slice", "config": "DispResNet6+PoseNetB6+"
          f"MaskNet6+{cfg.flownet} nlevels 6", "hw": [h, w], "batch": b,
          "correlation_launches": launches,
          "shapes": {k: list(v) for k, v in expected.items()},
          "gpu_vs_cpu_sample0": errs})
    return nets, batch, launches


def profile_breakdown(run, reps: int, wall_ms: float, what: str) -> dict:
    """Device time per call of run() by kernel (CUPTI), over `reps` calls:
    the top kernels, the correlation kernels, grid_sample forward and
    backward, the convolutions in all and the costliest by shape, the idle
    share against the wall time per call, and what the host issued per
    call (CUDA runtime calls by name, ATen op calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in ("aten::convolution", "aten::convolution_backward")]
    convs.sort(key=lambda e: e.device_time_total, reverse=True)
    per = lambda us: us / reps / 1e3
    busy = per(sum(e.self_device_time_total for e in kernels))
    conv_ms = per(sum(e.device_time_total for e in prof.key_averages()
                      if e.key in ("aten::convolution",
                                   "aten::convolution_backward")))
    # what the host does per call: its CUDA runtime calls by name (kernel
    # launches, copies, synchronizations) and its count of ATen ops
    runtime = {e.key: e.count / reps for e in prof.key_averages()
               if e.device_type != DeviceType.CUDA and e.key.startswith("cuda")}
    aten_ops = sum(e.count for e in prof.key_averages()
                   if e.key.startswith("aten::")) / reps
    named = lambda s: per(sum(e.self_device_time_total for e in kernels
                              if s in e.key))
    return {"phase": "profile", "what": what, "wall_ms": wall_ms,
            "kernel_ms": busy, "idle_share": 1 - busy / wall_ms,
            "convolution_ms": conv_ms, "cuda_runtime_calls": runtime,
            "aten_op_calls_nested": aten_ops,
            "correlation_forward_ms": named("corr_fwd_kernel"),
            "correlation_backward_ms": named("corr_bwd_kernel"),
            "grid_sampler_2d_forward_ms": named("grid_sampler_2d_kernel"),
            "grid_sampler_2d_backward_ms": named(
                "grid_sampler_2d_backward_kernel"),
            "top": [{"name": e.key[:100],
                     "ms": per(e.self_device_time_total),
                     "calls": e.count / reps} for e in kernels[:20]],
            "top_convolutions": [
                {"op": e.key, "input_shapes": e.input_shapes[:2],
                 "ms": per(e.device_time_total), "calls": e.count / reps}
                for e in convs[:12]]}


def timed_windows(run, n: int, windows: int = 3) -> list[float]:
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / n)
    return out


def conv_gflop(cfg, nets, batch) -> dict:
    """The operations of each net's convolution layers in one forward_eval,
    GFLOP: 2 x output elements x input channels per group x kernel taps
    for a convolution, 2 x input elements x output channels per group x
    taps for a transposed one. Counted from the shapes, on one forward."""
    counts = dict.fromkeys(NETS, 0)

    def hook(name):
        def count(m, inputs, out):
            taps = m.kernel_size[0] * m.kernel_size[1]
            if isinstance(m, torch.nn.ConvTranspose2d):
                n = inputs[0].numel() * m.out_channels // m.groups
            else:
                n = out.numel() * m.in_channels // m.groups
            counts[name] += 2 * n * taps
        return count

    hooks = [m.register_forward_hook(hook(name)) for name in NETS
             for m in nets[name].modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        forward_eval(cfg, nets, batch)
    finally:
        for h in hooks:
            h.remove()
    return {k: v / 1e9 for k, v in counts.items()}


def phase_timing(cfg, nets, batch, gpu: str):
    prefix = FLOWNETS[cfg.flownet][1]
    for _ in range(3):
        forward_eval(cfg, nets, batch)
    torch.cuda.synchronize()
    windows = timed_windows(lambda: forward_eval(cfg, nets, batch), 10)
    ms = statistics.median(windows)
    gflop = conv_gflop(cfg, nets, batch)
    emit({"phase": prefix + "timing",
          "what": f"forward_eval {cfg.flownet} 832x256 b4 fp32",
          "ms_per_forward": ms, "window_ms": windows,
          "frames_per_s": cfg.batch_size * 1e3 / ms, "gpu": gpu,
          "conv_gflop_per_forward": gflop})
    prof = profile_breakdown(lambda: forward_eval(cfg, nets, batch), 3, ms,
                             f"forward_eval {cfg.flownet}, per forward")
    prof["convolution_tflop_per_s"] = (sum(gflop.values())
                                       / prof["convolution_ms"])
    emit(prof)


def _count_step(step, batch) -> tuple[dict, int, int]:
    """One step with the launch counts set to 0 just before it."""
    corr.launches = corr.backward_launches = 0
    metrics = step(batch)
    torch.cuda.synchronize()
    return metrics, corr.launches, corr.backward_launches


def _finite(metrics: dict) -> dict:
    values = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in values.values()):
        raise AssertionError(f"non-finite metrics: {values}")
    return values


def phase_train(gpu: str, flownet: str):
    """The train path at bench.py's operating point with `flownet` as F,
    its launches, its frozen phase, and its timing and profile. The
    warm-up losses are reported, not held to fall: with FlowNetC6 they
    rise after the first step, in cc_tpu as in the port (see
    tests/test_torch_train_step.py, run as a script)."""
    prefix = FLOWNETS[flownet][1]
    cfg = TrainConfig(height=256, width=832, batch_size=B, flownet=flownet,
                      **BENCH)
    nets = make_models(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    opt_state = make_optimizer(cfg).init(nets)
    step = build_train_step(cfg, nets, opt_state)
    batch = seeded_batch(cfg, "cuda")

    torch.cuda.reset_peak_memory_stats()
    warm = [_finite(step(batch)) for _ in range(5)]
    torch.cuda.synchronize()
    metrics, k1, k1b = _count_step(step, batch)
    values = _finite(metrics)
    expect = _expect_launches(flownet)
    if (k1, k1b) != (expect, expect):
        raise AssertionError(f"{flownet} train step: {k1} K1 and {k1b} K1' "
                             f"launches, expected {expect} of each")

    windows = timed_windows(lambda: step(batch), 5)
    ms = statistics.median(windows)
    emit({"phase": prefix + "train_timing",
          "what": f"train step {flownet} 832x256 b4 fp32",
          "ms_per_step": ms, "window_ms": windows,
          "frames_per_s": cfg.batch_size * 1e3 / ms, "gpu": gpu,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    emit(profile_breakdown(lambda: step(batch), 3, ms,
                           f"train step {flownet}, per step"))

    # a competition phase: F frozen, on the same nets and optimizer state
    frozen = build_train_step(cfg.replace(fix_flownet=True), nets, opt_state)
    flow_before = [p.detach().clone() for p in nets["flow"].parameters()]
    fmetrics, f_k1, f_k1b = _count_step(frozen, batch)
    fvalues = _finite(fmetrics)
    flow_equal = all(torch.equal(a, p) for a, p in
                     zip(flow_before, nets["flow"].parameters()))
    if (f_k1, f_k1b) != (expect, 0) or not flow_equal:
        raise AssertionError(f"{flownet} fix_flownet step: {f_k1} K1, "
                             f"{f_k1b} K1' launches, F unchanged: "
                             f"{flow_equal}")
    emit({"phase": prefix + "train", "config": "bench.py:80-112 (wssim "
          "0.997, edge-aware, w1..w5 1/0.1/0.1/0.5/0.3, lr 1e-4), "
          f"DispResNet6+PoseNetB6+MaskNet6+{flownet}",
          "hw": [cfg.height, cfg.width], "batch": cfg.batch_size,
          "warmup_losses": [m["loss"] for m in warm],
          "step_metrics": values, "k1_launches": k1, "k1b_launches": k1b,
          "fix_flownet": {"metrics": fvalues, "k1_launches": f_k1,
                          "k1b_launches": f_k1b,
                          "flow_params_bit_equal": flow_equal},
          "adam_count": opt_state.count})
    return k1, k1b


def _state_of(nets, opt_state) -> dict:
    return {"nets": {k: v.detach().clone() for k, v in
                     nets.state_dict().items()},
            "mu": {n: [t.clone() for t in opt_state.mu[n]] for n in NETS},
            "nu": {n: [t.clone() for t in opt_state.nu[n]] for n in NETS},
            "counts": (opt_state.count, opt_state.notfinite, opt_state.step)}


def compare_train_states(metrics_ref: list[dict], metrics: list[dict],
                         ref: dict, state: dict, moments=("mu", "nu"),
                         param_bound: float | None = None
                         ) -> tuple[dict, list[str]]:
    """A train run against a reference run (states from _state_of, on any
    device): each step's metrics within TRAIN_METRIC_RTOL of the
    reference's; per net, each of `moments` within TRAIN_MU_RTOL of the
    reference's largest entry of that net, and each parameter within
    `param_bound` where one is given; BatchNorm running stats within
    TRAIN_STATS_RTOL of their magnitude; and at most PARAM_MOVED_SHARE of
    all parameter entries more than 1e-6 apart. Returns the report and the
    failures."""
    report = {"metrics": {}, "params": {}, "stats": {},
              **{g: {} for g in moments}}
    failures = []
    moved = total = 0  # parameter entries more than 1e-6 apart, of all

    def check(group, key, err, tol, **more):
        report[group][key] = {"max_abs_err": err, "tol": tol, **more}
        if tol is not None and not err <= tol:
            failures.append(f"{group} {key}: {err} > {tol}")

    for i, (m0, m1) in enumerate(zip(metrics_ref, metrics, strict=True)):
        for k in METRICS:
            check("metrics", f"{i}.{k}", abs(m1[k] - m0[k]),
                  TRAIN_METRIC_RTOL * max(abs(m0[k]), 1e-6))
    for name in NETS:
        for group in moments:
            errs = [(float((b.cpu() - a.cpu()).abs().max()),
                     float(a.abs().max()))
                    for a, b in zip(ref[group][name], state[group][name])]
            worst = max(range(len(errs)), key=lambda i: errs[i][0])
            check(group, name, errs[worst][0],
                  TRAIN_MU_RTOL * max(m for _, m in errs), worst_tensor=worst,
                  worst_tensor_max=errs[worst][1])
        perr = 0.0
        for k, v in ref["nets"].items():
            if not k.startswith(name + ".") or not v.is_floating_point():
                continue
            d = (state["nets"][k].cpu() - v.cpu()).abs()
            if k.endswith(("running_mean", "running_var")):
                check("stats", k, float(d.max()),
                      TRAIN_STATS_RTOL * max(1.0, float(v.abs().max())))
            else:
                perr = max(perr, float(d.max()))
                moved += int((d > 1e-6).sum())
                total += d.numel()
        check("params", name, perr, param_bound)
    report["params_moved"] = {"share": moved / total, "moved": moved,
                              "entries": total,
                              "max_share": PARAM_MOVED_SHARE}
    if not moved <= PARAM_MOVED_SHARE * total:
        failures.append(f"params: {moved} of {total} entries more than "
                        f"1e-6 apart, above {PARAM_MOVED_SHARE}")
    return report, failures


def phase_train_vs_cpu(flownet: str):
    """One 128x128 batch-2 step with `flownet` as F on the card and on the
    CPU (plain kernels) from the same weights and batch: the metrics, the
    first moments (which are (1-b1)*grad after one step from zero), the
    updated parameters (each within 2*lr, and the share of entries more
    than 1e-6 apart) and the BatchNorm running stats."""
    cfg = TrainConfig(height=128, width=128, batch_size=2, flownet=flownet,
                      **BENCH)
    nets = make_models(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(1))
    nets_cpu = copy.deepcopy(nets).cpu()
    batch = seeded_batch(cfg, "cuda", seed=1)
    results = []
    for n, dev in ((nets, "cuda"), (nets_cpu, "cpu")):
        st = make_optimizer(cfg).init(n)
        m = build_train_step(cfg, n, st)({k: v.to(dev)
                                          for k, v in batch.items()})
        results.append((_finite(m), st, n))
    (m_gpu, st_gpu, _), (m_cpu, st_cpu, _) = results
    # Adam's first step is about lr*sign(grad): a near-zero gradient of the
    # other sign moves a parameter up to 2*lr apart, so this bound holds
    # whatever the gradients are; the share bound does not
    report, failures = compare_train_states(
        [m_cpu], [m_gpu], _state_of(nets_cpu, st_cpu), _state_of(nets, st_gpu),
        moments=("mu",), param_bound=2 * cfg.lr + 1e-6)
    emit({"phase": FLOWNETS[flownet][1] + "train_vs_cpu", "hw": [128, 128],
          "batch": 2, "flownet": flownet,
          "metrics_gpu": m_gpu, "metrics_cpu": m_cpu, **report})
    if failures:
        raise AssertionError(f"{flownet} train step, card vs CPU: "
                             + "; ".join(failures))


def phase_data_env() -> None:
    """What the machine has for the data path, by explicit probes: cv2
    (load_image's JPEG decoder, which the data phases need), PIL, g++ and
    OpenCV's headers where cc_tpu_torch/native's build looks for them
    (pkg-config's opencv4, or the default include directory), and the CPU
    cores torch sees."""
    has = lambda mod: importlib.util.find_spec(mod) is not None
    pkg_config = (shutil.which("pkg-config") is not None and subprocess.run(
        ["pkg-config", "--exists", "opencv4"]).returncode == 0)
    headers = pkg_config or os.path.isfile(
        "/usr/include/opencv4/opencv2/core.hpp")
    env = {"phase": "data_env", "cv2": has("cv2"), "PIL": has("PIL"),
           "gxx": shutil.which("g++") is not None,
           "opencv_headers": headers, "opencv4_pkg_config": pkg_config,
           "cpu_cores": len(os.sched_getaffinity(0)),
           "torch_threads": torch.get_num_threads()}
    env["native_plane_can_build"] = env["gxx"] and headers
    emit(env)
    if not env["cv2"]:
        raise AssertionError("no cv2 here: load_image has no JPEG decoder")


def synthetic_scenes(root: str, h: int, w: int, scenes: int, frames: int):
    """KITTI-shaped scene folders in the manner of the ETL's output: scenes
    of `frames` h x w JPEGs, each a window sliding over one smooth random
    image, with cam.txt; all listed in train.txt. Returns root."""
    import cv2
    r = np.random.RandomState(0)
    names = [f"2011_09_26_drive_{i:04d}_sync_02" for i in range(scenes)]
    for name in names:
        d = os.path.join(root, name)
        os.makedirs(d)
        with open(os.path.join(d, "cam.txt"), "w") as f:
            f.write(f"{0.87 * w:.1f},0.,{w / 2:.1f},0.,{2.8 * h:.1f},"
                    f"{h / 2:.1f},0.,0.,1.")
        base = cv2.GaussianBlur(
            (r.rand(h + frames, w + 2 * frames, 3) * 255).astype(np.uint8),
            (21, 21), 8)
        for i in range(frames):
            cv2.imwrite(os.path.join(d, f"{i:07d}.jpg"),
                        base[i:i + h, 2 * i:2 * i + w])
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return root


def train_dataset(root: str, cfg: TrainConfig, h2d: str):
    """(dataset, what feeds it): the scene folders under `root` through the
    train pipeline of --loader auto, the C++ plane where it builds, named
    as such."""
    tf, plane = train_pipeline(emit=h2d, loader="auto")
    ds = SequenceFolder(root, seed=0, train=True,
                        sequence_length=cfg.sequence_length, transform=tf)
    return ds, f"JPEG scene folders, {plane} pipeline"


class Epochs:
    """The loader's batches, epoch after epoch; `seconds` sums the host
    time spent waiting for them."""

    def __init__(self, loader: DataLoader):
        self.loader, self.it, self.seconds = loader, iter(loader), 0.0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        t0 = time.perf_counter()
        try:
            return next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            return next(self.it)
        finally:
            self.seconds += time.perf_counter() - t0


def memcpy_breakdown(prof, reps: int) -> dict:
    """Per step: the device's copies by kind (count and ms), the host's
    cudaMemcpyAsync calls, and those calls by the outermost and innermost
    ATen op that issued them."""
    from torch.autograd import DeviceType
    per = lambda x: x / reps
    copies = {e.key: {"calls": per(e.count),
                      "ms": per(e.self_device_time_total) / 1e3}
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "Memcpy" in e.key}
    issued: dict[str, float] = {}
    n_calls = 0
    for e in prof.events():
        if e.name != "cudaMemcpyAsync":
            continue
        n_calls += 1
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                chain.append(p.name)
            p = p.cpu_parent
        key = " > ".join(dict.fromkeys([chain[-1], chain[0]])) if chain \
            else "(no ATen op)"
        issued[key] = issued.get(key, 0) + 1
    return {"device_copies": copies, "cudaMemcpyAsync": per(n_calls),
            "cudaMemcpyAsync_by_op": {k: per(v) for k, v in sorted(
                issued.items(), key=lambda kv: -kv[1])}}


def timed_feed(step, next_batch, source: Epochs | None = None,
               warmup: int = 5, n: int = 3, windows: int = 3) -> dict:
    """`warmup` steps, then `windows` windows of `n` steps each ended by a
    synchronize; the host seconds spent in next_batch() inside them, and
    the part of those spent waiting for the loader (`source`); the rest
    is device_prefetch's own: the copy into pinned memory and the copies'
    launch."""
    for _ in range(warmup):
        _finite(step(next_batch()))
    torch.cuda.synchronize()
    times, wait = [], 0.0
    loader0 = source.seconds if source is not None else 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n):
            t1 = time.perf_counter()
            batch = next_batch()
            wait += time.perf_counter() - t1
            step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / n)
    return {"ms_per_step": statistics.median(times), "window_ms": times,
            "iterator_wait_s": wait,
            "loader_wait_s": (source.seconds - loader0 if source is not None
                              else 0.0),
            "steps_timed": windows * n}


def phase_data(root: str, h2d: str, gpu: str,
               profiled=("resident", "loader")) -> tuple[int, int]:
    """The Back2Future train step at bench.py's point, fed from the scene
    folders under `root` through DataLoader and device_prefetch, with
    `h2d` ("float32" or "uint8") batches; one step of each feed in
    `profiled` under torch.profiler (about 15 s of the host's each).
    Returns the K1 and K1' launches of one loader-fed step."""
    t_start = time.perf_counter()
    cfg = TrainConfig(height=256, width=832, batch_size=B, **BENCH)
    ds, source = train_dataset(root, cfg, h2d)
    make_loader = lambda: DataLoader(ds, B, shuffle=True, num_workers=4,
                                     seed=0)

    # the first prefetched batch against the same batch collated on the host
    host = next(iter(make_loader()))
    first = next(device_prefetch(iter(make_loader()), "cuda"))
    bit_equal = all(np.array_equal(first[k].cpu().numpy(), v)
                    and first[k].dtype == torch.from_numpy(v).dtype
                    for k, v in host.items())
    if not bit_equal or set(first) != set(host):
        raise AssertionError(f"{h2d}: the prefetched batch differs from "
                             "the host's")
    h2d_bytes = sum(v.nbytes for v in host.values())

    # decode + augment on one thread, per batch of B samples
    per_batch = []
    for b in range(3):
        t0 = time.perf_counter()
        collate([ds[b * B + i] for i in range(B)])
        per_batch.append((time.perf_counter() - t0) * 1e3)

    nets = make_models(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    opt_state = make_optimizer(cfg).init(nets)
    step = build_train_step(cfg, nets, opt_state)
    resident = seeded_batch(cfg, "cuda", h2d=h2d)
    batches = Epochs(make_loader())
    fed = device_prefetch(batches, "cuda")

    for _ in range(2):  # cuDNN's set-up, outside the counted step
        _finite(step(next(fed)))
    torch.cuda.synchronize()
    metrics, k1, k1b = _count_step(step, next(fed))
    values = _finite(metrics)
    expect = _expect_launches("Back2Future")
    if (k1, k1b) != (expect, expect):
        raise AssertionError(f"loader-fed step ({h2d}): {k1} K1 and {k1b} "
                             f"K1' launches, expected {expect} of each")

    t_runs = time.perf_counter()
    runs = []
    for feed in ("resident", "loader", "loader", "resident"):
        if feed == "resident":
            row = timed_feed(step, lambda: resident)
        else:
            row = timed_feed(step, lambda: next(fed), batches)
        row["feed"] = feed
        row["frames_per_s"] = B * 1e3 / row["ms_per_step"]
        runs.append(row)

    t_profile = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile
    memcpy = {}
    feeds = {"resident": lambda: resident, "loader": lambda: next(fed)}
    for feed in profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(feeds[feed]())
            torch.cuda.synchronize()
        memcpy[feed] = memcpy_breakdown(prof, 1)
    fed.close()
    emit({"phase": "data", "h2d": h2d, "source": source,
          "config": "bench.py:80-112, Back2Future, 832x256 b4",
          "gpu": gpu, "samples": len(ds), "loader_threads": 4,
          "first_batch_bit_equal": bit_equal, "k1_launches": k1,
          "k1b_launches": k1b, "step_metrics": values,
          "h2d_bytes_per_step": h2d_bytes,
          "decode_augment_ms_per_batch_one_thread": statistics.median(
              per_batch), "runs": runs, "memcpy_per_step": memcpy,
          "seconds": {"set_up_and_checks": t_runs - t_start,
                      "timed_runs": t_profile - t_runs,
                      "profiles": time.perf_counter() - t_profile}})
    del nets, opt_state, step, resident
    torch.cuda.empty_cache()
    return k1, k1b


def phase_resume(root: str, gpu: str):
    """Train 2 loader-fed steps at 128x128 b2 and save; then a step and a
    fix_flownet step. Fresh nets and optimizer (another seed) load the
    checkpoint and take the same two steps, under cudnn.deterministic. The
    counts must be equal, and the check is compare_train_states with both
    moments: grid_sample's backward adds with atomics, so the two runs'
    bits differ even so; whether they were equal is recorded. Then the
    full-size state: save and load timed, and its bytes."""
    cfg = TrainConfig(height=128, width=128, batch_size=2, **BENCH)
    ds, source = train_dataset(root, cfg, "float32")
    feed = device_prefetch(iter(DataLoader(ds, 2, shuffle=True, seed=1)),
                           "cuda")
    batches = [next(feed) for _ in range(4)]
    feed.close()
    phases = (cfg, cfg.replace(fix_flownet=True))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            nets = make_models(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
            opt_state = make_optimizer(cfg).init(nets)
            for b in batches[:2]:
                _finite(build_train_step(cfg, nets, opt_state)(b))
            save_checkpoint(tmp, nets, opt_state)
            straight = [_finite(build_train_step(c, nets, opt_state)(b))
                        for c, b in zip(phases, batches[2:])]
            a = _state_of(nets, opt_state)
            nets = make_models(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(1))
            opt_state = make_optimizer(cfg).init(nets)
            load_checkpoint(tmp, nets, opt_state)
            resumed = [_finite(build_train_step(c, nets, opt_state)(b))
                       for c, b in zip(phases, batches[2:])]
            r = _state_of(nets, opt_state)
    finally:
        torch.backends.cudnn.deterministic = deterministic

    tensors = lambda st: ([st["nets"][k] for k in sorted(st["nets"])]
                          + [t for n in NETS for t in st["mu"][n] + st["nu"][n]])
    bits = (straight == resumed
            and all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(r))))
    report, failures = compare_train_states(straight, resumed, a, r)
    if a["counts"] != r["counts"] or a["counts"] != (4, 0, 4):
        failures.append(f"counts {a['counts']} and {r['counts']}")

    # the full-size state: 832x256 nets (their size does not depend on the
    # frames') with Adam's moments
    full = TrainConfig(**BENCH)
    nets = make_models(full, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    opt_state = make_optimizer(full).init(nets)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, nets, opt_state)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        load_checkpoint(tmp, nets, opt_state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    emit({"phase": "resume", "hw": [128, 128], "batch": 2, "source": source,
          "gpu": gpu, "cudnn_deterministic": True, "equal_bits": bits,
          "metrics_straight": straight, "metrics_resumed": resumed,
          "counts": r["counts"], **report,
          "full_size": {"nets": "DispResNet6+PoseNetB6+MaskNet6+Back2Future",
                        "parameters": sum(p.numel() for p in
                                          nets.parameters()),
                        "bytes": nbytes, "save_s": save_s,
                        "load_s": load_s}})
    del nets, opt_state
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("resumed run against the straight one: "
                             + "; ".join(failures))


def path_entry(path: str, rows, launches: int,
               per_shape: int = LAUNCHES_PER_SHAPE) -> dict:
    """A kernel's work on one run of a path: `per_shape` launches at each
    of `rows`' shapes, `launches` counted on the path's run."""
    total = lambda key, by=None: per_shape * sum(
        r[key] for r in rows if by in (None, r["bound_by"]))
    return {"path": path, "launches": launches,
            "shapes": [[*r["shape"], r["patch"], r["dilation"]] if "patch"
                       in r else r["shape"] for r in rows],
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_us") / 1e3,
            "bound_by": max(("bytes", "operations"),
                            key=lambda by: total("bound_us", by))}


def kernel_entry(name, source, replaces, rows, paths, library_ms=None):
    """One `kernels` entry: the error is the largest over all `rows`; the
    launches, times and bound at the top level are those of the first of
    `paths`, the kernel's main path."""
    main = paths[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": library_ms, "paths": paths}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    gpu = smi.stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    bw, flops = peaks(name)
    emit({"phase": "device", "nvidia_smi": gpu, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "tf32": False,
          "peak_bytes_per_s": bw, "peak_fp32_flops": flops})

    t0 = time.perf_counter()
    paths = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for src, path in paths.items():
        with open(path + ".log") as f:
            ptxas[src] = [l.strip() for l in f if "registers" in l
                          or "spill" in l]
    emit({"phase": "build", "seconds": seconds, "libraries": sorted(paths),
          "ptxas": ptxas})

    fwd_rows = phase_correlation(bw, flops, backward=False)
    bwd_rows = phase_correlation(bw, flops, backward=True)
    gather_row = phase_row_gather(bw, flops)
    gather_launches = phase_gather_path()

    launches = {}  # (flownet, "eval" | "step") -> (K1, K1') on that run
    for flownet in FLOWNETS:
        cfg = TrainConfig(flownet=flownet)
        nets, batch, k1_eval = phase_slice(cfg)
        launches[flownet, "eval"] = (k1_eval, 0)
        phase_timing(cfg, nets, batch, gpu)
        del nets, batch
        torch.cuda.empty_cache()
        launches[flownet, "step"] = phase_train(gpu, flownet)
        torch.cuda.empty_cache()
        phase_train_vs_cpu(flownet)

    phase_data_env()
    with tempfile.TemporaryDirectory() as tmp:
        roots = {hw: synthetic_scenes(os.path.join(tmp, f"{hw[0]}x{hw[1]}"),
                                      *hw, scenes=3, frames=12)
                 for hw in ((256, 832), (128, 128))}
        loader_step = phase_data(roots[256, 832], "float32", gpu)
        # the resident step's copies do not depend on the batch's dtype
        phase_data(roots[256, 832], "uint8", gpu, profiled=("loader",))
        phase_resume(roots[128, 128], gpu)

    n_b2f, n_c6 = len(B2F_CASES), len(C6_CASES)
    corr_rows = {"fwd": fwd_rows, "bwd": bwd_rows}
    corr_paths = {}
    for kind, k in (("fwd", 0), ("bwd", 1)):
        b2f, c6 = corr_rows[kind][:n_b2f], corr_rows[kind][n_b2f:n_b2f + n_c6]
        corr_paths[kind] = [
            path_entry("Back2Future train step", b2f,
                       launches["Back2Future", "step"][k]),
            path_entry("Back2Future train step fed by the loader", b2f,
                       loader_step[k]),
            path_entry("FlowNetC6 train step", c6,
                       launches["FlowNetC6", "step"][k])]
        if kind == "fwd":
            corr_paths[kind] += [
                path_entry("Back2Future eval forward", b2f,
                           launches["Back2Future", "eval"][0]),
                path_entry("FlowNetC6 eval forward", c6,
                           launches["FlowNetC6", "eval"][0])]
    emit({"kernels": [
        kernel_entry("correlation_forward",
                     "cc_tpu_torch/ops/csrc/correlation.cu",
                     "cc_tpu/ops/correlation_pallas.py:77", fwd_rows,
                     corr_paths["fwd"]),
        kernel_entry("correlation_backward",
                     "cc_tpu_torch/ops/csrc/correlation.cu",
                     "cc_tpu/ops/correlation_pallas.py:112", bwd_rows,
                     corr_paths["bwd"]),
        kernel_entry("row_gather", "cc_tpu_torch/ops/csrc/row_gather.cu",
                     "scripts/exp_gather.py:173", [gather_row],
                     [path_entry("E5 row gather", [gather_row],
                                 gather_launches, per_shape=1)],
                     library_ms=gather_row["library_ms"])]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
