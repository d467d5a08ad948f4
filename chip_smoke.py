#!/usr/bin/env python3
"""Drive the cc_tpu_torch port on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero (also when CUDA is absent, or when the package is not beside it):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions; TF32 off for matmuls and cuDNN convs.
2. build: every kernel from the sources in the checkout, timed.
3. kernel vs plain: the correlation kernel against correlation_plain on
   the same inputs at the main path's five shapes, a ragged shape and
   FlowNetC6's P=21/d=2 shape: max abs error (tolerance ATOL), kernel and
   plain device times (CUDA-graph replays, see time_device), and the bound
   (bytes at the card's memory rate or fp32 operations at its peak).
4. slice: forward_eval of the four paper-default nets at 832x256, batch 4,
   fp32, seeded init: shapes, finite values, exactly 10 correlation launches
   per forward, and one sample against the same nets on the CPU.
5. timing: median of 3 windows of forwards, each ended by a synchronize;
   then a torch.profiler breakdown of device time by kernel and of the
   costliest convolutions by shape.
6. kernels: one entry per kernel of the path.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cc_tpu_torch.ops import _build
from cc_tpu_torch.ops import correlation as corr
from cc_tpu_torch.train import TrainConfig, forward_eval, make_models

ATOL = 1e-5          # kernel vs plain, fp32 sums in another order
SLICE_RTOL = 1e-3    # GPU vs CPU forward, relative to each output's max
B = 4
# Back2Future's correlation inputs at 832x256: (H, W, C) at levels 2..6
MAIN_SHAPES = [(64, 208, 32), (32, 104, 64), (16, 52, 96), (8, 26, 128),
               (4, 13, 192)]
LAUNCHES_PER_SHAPE = 2  # forward and backward stream at each level
EXTRA_CASES = [((2, 5, 7, 3), 9, 1), ((4, 32, 104, 256), 21, 2)]
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


def bound_ms(shape, patch, bw, flops):
    """Least time for one launch: each input read once, the output written
    once, against 2*P*P*C operations per pixel. Returns (ms, "bytes"|...)."""
    b, h, w, c = shape
    nbytes = 4 * (2 * b * h * w * c + b * h * w * patch * patch)
    ops = 2 * b * h * w * patch * patch * c
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    return statistics.median(times)


def seeded_batch(cfg: TrainConfig, device, seed: int = 0) -> dict:
    r = np.random.RandomState(seed)
    b, h, w = cfg.batch_size, cfg.height, cfg.width
    tgt = r.rand(b, h, w, 3).astype(np.float32) * 2 - 1
    refs = r.rand(b, cfg.nb_ref_imgs, h, w, 3).astype(np.float32) * 2 - 1
    return {"tgt": torch.from_numpy(tgt).to(device),
            "refs": torch.from_numpy(refs).to(device)}


def phase_kernels(bw, flops):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [((B, *s), 9, 1) for s in MAIN_SHAPES] + EXTRA_CASES
    rows = []
    for shape, patch, dil in cases:
        f1 = torch.randn(shape, generator=gen, device="cuda")
        f2 = torch.randn(shape, generator=gen, device="cuda")
        out = corr.correlation_cuda(f1, f2, patch, dil)
        ref = corr.correlation_plain(f1, f2, patch, dil)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ms = time_device(lambda: corr.correlation_cuda(f1, f2, patch, dil))
        plain_ms = time_device(
            lambda: corr.correlation_plain(f1, f2, patch, dil))
        bnd, by = bound_ms(shape, patch, bw, flops)
        row = {"phase": "kernel", "name": "correlation_forward",
               "shape": list(shape), "patch": patch, "dilation": dil,
               "max_abs_err": err, "atol": ATOL, "ms": ms,
               "plain_ms": plain_ms, "bound_us": bnd * 1e3, "bound_by": by}
        emit(row)
        if not err <= ATOL:
            raise AssertionError(f"correlation kernel disagrees at {shape} "
                                 f"P={patch} d={dil}: {err} > {ATOL}")
        rows.append(row)
    return rows


def phase_slice(cfg: TrainConfig):
    nets = make_models(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    batch = seeded_batch(cfg, "cuda")
    forward_eval(cfg, nets, batch)  # warm-up: cuDNN set-up
    torch.cuda.synchronize()

    corr.launches = 0
    out = forward_eval(cfg, nets, batch)
    torch.cuda.synchronize()
    launches = corr.launches
    if launches != 2 * len(MAIN_SHAPES):
        raise AssertionError(f"{launches} correlation launches in one "
                             f"forward, expected {2 * len(MAIN_SHAPES)}")

    b, h, w, n = cfg.batch_size, cfg.height, cfg.width, cfg.nb_ref_imgs
    expected = {"disp": (b, h, w, 1), "depth": (b, h, w, 1),
                "pose": (b, n, 6), "exp_mask": (b, h, w, n),
                "flow_fwd": (b, h, w, 2), "flow_bwd": (b, h, w, 2),
                "occ": (b, h, w, 2)}
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
    emit({"phase": "slice", "config": "DispResNet6+PoseNetB6+MaskNet6+"
          "Back2Future nlevels 6", "hw": [h, w], "batch": b,
          "correlation_launches": launches,
          "shapes": {k: list(v) for k, v in expected.items()},
          "gpu_vs_cpu_sample0": errs})
    return nets, batch, launches


def phase_timing(cfg, nets, batch, gpu: str):
    for _ in range(3):
        forward_eval(cfg, nets, batch)
    torch.cuda.synchronize()
    n, windows = 10, []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            forward_eval(cfg, nets, batch)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / n)
    ms = statistics.median(windows)
    emit({"phase": "timing", "what": "forward_eval 832x256 b4 fp32",
          "ms_per_forward": ms, "window_ms": windows,
          "frames_per_s": cfg.batch_size * 1e3 / ms, "gpu": gpu})

    # device time by kernel (CUPTI), over a few forwards
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(reps):
            forward_eval(cfg, nets, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    # the costliest convolutions, by input and weight shape
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::convolution"]
    convs.sort(key=lambda e: e.device_time_total, reverse=True)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    per_fwd = lambda us: us / reps / 1e3
    busy = per_fwd(sum(e.self_device_time_total for e in kernels))
    corr_ms = per_fwd(sum(e.self_device_time_total for e in kernels
                          if "corr_fwd_kernel" in e.key))
    emit({"phase": "profile", "wall_ms_per_forward": ms,
          "kernel_ms_per_forward": busy, "idle_share": 1 - busy / ms,
          "correlation_kernel_ms_per_forward": corr_ms,
          "top": [{"name": e.key[:100],
                   "ms_per_forward": per_fwd(e.self_device_time_total),
                   "calls_per_forward": e.count / reps} for e in kernels[:20]],
          "top_convolutions": [
              {"input_weight_shapes": e.input_shapes[:2],
               "ms_per_forward": per_fwd(e.device_time_total),
               "calls_per_forward": e.count / reps} for e in convs[:10]]})


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
    with open(paths["correlation"] + ".log") as f:
        ptxas = [l.strip() for l in f if "registers" in l or "spill" in l]
    emit({"phase": "build", "seconds": seconds, "libraries": sorted(paths),
          "ptxas": ptxas})

    rows = phase_kernels(bw, flops)
    cfg = TrainConfig()
    nets, batch, launches = phase_slice(cfg)
    phase_timing(cfg, nets, batch, gpu)

    # per forward: LAUNCHES_PER_SHAPE launches at each main-path shape
    main_rows = rows[:len(MAIN_SHAPES)]
    per_fwd = lambda key, by=None: LAUNCHES_PER_SHAPE * sum(
        r[key] for r in main_rows if by in (None, r["bound_by"]))
    bound_by = max(("bytes", "operations"),
                   key=lambda by: per_fwd("bound_us", by))
    emit({"kernels": [{
        "name": "correlation_forward", "route": "cuda",
        "source": "cc_tpu_torch/ops/csrc/correlation.cu",
        "replaces": "cc_tpu/ops/correlation_pallas.py:77",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
        "bound_ms": per_fwd("bound_us") / 1e3, "bound_by": bound_by,
        "library_ms": None, "ok": True}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
