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
     pyramid shapes (P=9, d=1), FlowNetC6's shape (P=21, d=2), a ragged
     shape, and Back2Future's at batch 2 (a process of the ddp phase); K1
     also at batch 1 (the validation forwards).
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
13. train_cli: the train CLI (cc_tpu_torch.cli.train.main) in-process, in
   a temporary directory: Back2Future at bench.py's point for 2 epochs
   with flow validation (a synthetic KITTI 2015 tree of 1242x375 frames),
   depth validation (a val.txt scene with .npy depths) and training
   images every 3 steps; the same with --resume --fix-flownet for an
   epoch; and DispNetS, PoseNet6, MaskResNet6 and FlowNetC6 for an epoch
   of 2 steps. Each run's K1 and K1' launches against what its steps,
   training-image forwards and validation forwards imply, finite losses
   and errors, its checkpoints loaded back, F bit-equal across the
   --fix-flownet run and every net moved in the last; seconds per epoch,
   the im/s the CLI printed beside the train phase's resident step,
   validation ms per item, checkpoint seconds and bytes.
14. ddp: data parallel training under torchrun, two processes sharing
   the card through gloo (not a scaling measurement): the Back2Future step
   at bench.py's point on a global batch of 4 whose rows differ, 2 rows a
   process, against one process on the card from the same weights and
   batch: a step (compare_train_states), then two steps and a fix_flownet
   step (their metrics; the state after them reported); the two
   processes bit-equal, 10 K1 and 10 K1' a step on each (0 K1' with F
   frozen), ms a step and gradient bytes all-reduced a step. Then the
   train CLI under a two-process launch against one process, an epoch of
   3 steps with flow validation (train loss within rtol 2e-3, one recorder
   line, the same files), and --resume --fix-flownet on two processes (F
   bit-equal across it).
15. eval_cli: every eval and inference CLI of the port (test_disp with
   a pose net, test_make3d, run_inference, test_pose, test_sintel_pose,
   test_back2future with Back2Future and with FlowNetC6, test_flow,
   test_mask, submit_flow, evaluate_flow) in-process on the card at its
   default size, on trees written at KITTI's widths (an Eigen drive with
   velodyne scans, an odometry and a Sintel sequence, Make3D, an image
   folder, the KITTI 2015 tree of train_cli with semantic labels), from
   reference checkpoints of the port's nets at random: 4 items each
   (Make3D: its 61). Each run's K1 launches against its items (10 an item
   for Back2Future, 1 for FlowNetC6, 0 without F), finite results,
   seconds per item and the host's share of them (a profiler of the
   card's kernels); test_disp and test_flow on the card against the same
   CLIs on the CPU.
16. etl: raw KITTI through the ETL into the train CLI, then D exported:
   a KITTI raw tree at KITTI's frame size (2 drives x 2 cameras x 10
   1242x375 PNGs, oxts at 5 m/s, velodyne scans of 100,000 points,
   KITTI's calibration files) through cc_tpu_torch.cli.prepare_train_data
   (4 threads, --with-gt) at 832x256: the scenes, JPEGs, zoomed cam.txt,
   seed 8964's split and the validation scene's GT depths checked, seconds
   per frame; the train CLI on the dump (Back2Future at bench.py's point,
   an epoch of 3 steps, depth validation, training images every step),
   its K1 and K1' launches held to what its steps and forwards imply; D of
   its checkpoint through weights.save_torch_checkpoint, loaded back
   strictly by the eval CLIs' load_net_params, its output bit-equal to the
   checkpoint's net's.
17. mnist: the MNIST CC demo on MNIST IDX files at MNIST's sizes and SVHN
   .mat files cut to 10,000/2,000: cli.mnist for an epoch of 200 steps
   compete and one collaborate (batch 64), steps/s per epoch; a profiler
   window of each step on a resident batch (the card's idle share); then
   cli.mnist_eval of mnist_best.pt on the card and on the CPU: logits
   within 1e-4 over the test sets, error rates equal but for samples
   within 1e-4 of a tie (counted).
18. bf16: compute_dtype and loss_dtype bfloat16. First, right after the
   float32 kernels (phase 3), the bf16 instantiations of K1 and K1'
   against their plain bf16 versions at Back2Future's five shapes and
   FlowNetC6's (K1 also at batch 1): one bf16 rounding plus a sum-order
   term an element, equal bits on a second launch, CUDA-graph times
   beside the float32 instantiation's and the bound (bf16 bytes or fp32
   FMA work). Then, after ddp: the guarded bf16 step (compute bfloat16,
   clip 5, non-finite guard) at bench.py's point with each flow net: 10
   steps finite, 10 bf16 K1 and 10 bf16 K1' a Back2Future step, 2 and 2 a
   FlowNetC6 step, none of float32, 0 K1' with F frozen, ms beside the
   float32 step's, peak memory and the idle share; for Back2Future with
   loss_dtype bfloat16 too, timed. The bf16 eval forwards (ms beside
   float32's, bf16 K1 launches); the bf16 step at 128x128 b2 on the card
   against the CPU's, by tests/test_torch_bf16.py's yardstick; the train
   CLI with the four bf16 flags for an epoch with flow validation, then a
   resumed step (launches all bf16, float32 master weights saved).
19. kernels: one entry per kernel; its launches, times and bound per run
   of each path that runs it (`paths`), the first path's at the top level;
   the bf16 instantiations of K1 and K1' as entries of their own.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
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

from cc_tpu_torch.cli import train as train_cli
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

REPO = os.path.dirname(os.path.abspath(__file__))
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
# the train CLI's flow validation runs the forward at batch 1
B1_CASES = {"Back2Future": [((1, *s), 9, 1) for s in MAIN_SHAPES],
            "FlowNetC6": [((1, 32, 104, 256), 21, 2)]}
# each of the ddp phase's two processes steps on half the global batch
B2_CASES = [((B // 2, *s), 9, 1) for s in MAIN_SHAPES]
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
# The eval CLIs' runs: K1 launches per item of each flow net's forward
# (Back2Future: both streams at its 5 pyramid levels; FlowNetC6, which the
# eval CLIs run once an item: 1), and the card-vs-CPU tolerances of
# tests/test_torch_kernels_cuda.py (CLI_EPE_RTOL, CLI_EDGE_PIXELS)
EVAL_K1_PER_ITEM = {"Back2Future": LAUNCHES_PER_SHAPE * len(B2F_CASES),
                    "FlowNetC6": len(C6_CASES)}
EVAL_RTOL = 1e-3
EVAL_EDGE_PIXELS = 3
EVAL_ITEMS = 4
# etl: frames a camera of each synthetic raw drive
ETL_FRAMES = 10
# mnist: SVHN's train and test sets cut to bound the phase (73,257 and
# 26,032 in full); the card's logits against the CPU's, and the width
# within which a logit counts as a tie (mnist_eval's rates may differ there)
SVHN_SIZES = (10_000, 2_000)
MNIST_LOGIT_ATOL = 1e-4
MNIST_TIE = 1e-4


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
    if not backward:
        cases = cases + B1_CASES["Back2Future"] + B1_CASES["FlowNetC6"]
    cases = cases + B2_CASES
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
    return ms


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
    tests/test_torch_train_step.py, run as a script). Returns the K1 and
    K1' launches of one step and the resident step's median ms."""
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
    return (k1, k1b), ms


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


def add_depth_val_scene(root: str, h: int, w: int, frames: int) -> None:
    """One more scene under `root`, of `frames` h x w JPEGs each with a
    .npy depth map (uniform in 1..80 m), listed in val.txt: the depth
    validation set (ValidationSet) of the train CLI's --with-depth-gt."""
    import cv2
    r = np.random.RandomState(1)
    name = "2011_09_26_drive_val_sync_02"
    d = os.path.join(root, name)
    os.makedirs(d)
    base = cv2.GaussianBlur(
        (r.rand(h + frames, w + 2 * frames, 3) * 255).astype(np.uint8),
        (21, 21), 8)
    for i in range(frames):
        cv2.imwrite(os.path.join(d, f"{i:07d}.jpg"),
                    base[i:i + h, 2 * i:2 * i + w])
        np.save(os.path.join(d, f"{i:07d}.npy"),
                r.uniform(1, 80, (h, w)).astype(np.float32))
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write(name + "\n")


def synthetic_kitti2015(root: str, items: int, h: int = 375,
                        w: int = 1242) -> str:
    """A KITTI 2015 training tree of `items` items at KITTI's frame size:
    multiview frames 08-12 (smooth random PNGs), 16-bit flow_occ PNGs
    (flow within +-30 px, 70 % valid), obj_map and the calibration's
    P_rect_02. Returns root."""
    import cv2
    from cc_tpu_torch.utils.flow_io import flow_write_png
    r = np.random.RandomState(2)
    mv = os.path.join(root, "data_scene_flow_multiview", "training",
                      "image_2")
    occ = os.path.join(root, "data_scene_flow", "training", "flow_occ")
    obj = os.path.join(root, "data_scene_flow", "training", "obj_map")
    cal = os.path.join(root, "data_scene_flow_calib", "training",
                       "calib_cam_to_cam")
    for d in (mv, occ, obj, cal):
        os.makedirs(d)
    p_rect = [721.5, 0, w / 2, 44.9, 0, 721.5, h / 2, 0.2, 0, 0, 1, 0.003]
    for i in range(items):
        i6 = f"{i:06d}"
        base = cv2.GaussianBlur(
            (r.rand(h + 10, w + 20, 3) * 255).astype(np.uint8), (21, 21), 8)
        for k, f in enumerate(range(8, 13)):
            cv2.imwrite(os.path.join(mv, f"{i6}_{f:02d}.png"),
                        base[k:k + h, 2 * k:2 * k + w])
        u = np.round(r.uniform(-30, 30, (h, w)) * 64) / 64
        v = np.round(r.uniform(-30, 30, (h, w)) * 64) / 64
        flow_write_png(os.path.join(occ, f"{i6}_10.png"), u, v,
                       (r.rand(h, w) > 0.3).astype(np.uint16))
        cv2.imwrite(os.path.join(obj, f"{i6}_10.png"),
                    r.randint(0, 3, (h, w)).astype(np.uint8))
        with open(os.path.join(cal, f"{i6}.txt"), "w") as f:
            f.write("P_rect_02: " + " ".join(f"{v:e}" for v in p_rect)
                    + "\n")
    return root


def _cli_expected(flownet: str, steps: int, f_freq: int, val_items: int,
                  f_trains: bool) -> tuple[int, int, int]:
    """The K1 and K1' launches a CLI run implies, and its training-image
    forwards: each step and each eval forward (a training-image one every
    f_freq steps, and one per flow-validation item) launch K1 as their
    flow net does; each step launches K1' as often while F trains."""
    per = _expect_launches(flownet)
    outputs = sum(n % f_freq == 0 for n in range(steps)) if f_freq else 0
    return (per * (steps + outputs + val_items),
            per * steps if f_trains else 0, outputs)


def _cli_run(name: str, argv: list[str], flownet: str, val_n: int,
             depth_n: int, f_freq: int, f_trains: bool, gpu: str,
             step_ms: float) -> dict:
    """One run of the CLI, the launch counts set to 0 just before it, with
    val_n flow-validation items and depth_n depth-validation frames an
    epoch: checks its launches, finite losses and errors, and its
    checkpoint files, which must load. Returns its JSON line."""
    corr.reset_launches()
    t0 = time.perf_counter()
    records = train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1, k1b = corr.launches, corr.backward_launches
    steps = sum(r["steps"] for r in records)
    val_items = val_n * len(records)
    e_k1, e_k1b, outputs = _cli_expected(flownet, steps, f_freq, val_items,
                                         f_trains)
    failures = []
    if (k1, k1b) != (e_k1, e_k1b):
        failures.append(f"{k1} K1 and {k1b} K1' launches, expected {e_k1} "
                        f"and {e_k1b}")
    for r in records:
        values = [r["train_loss"], *(r["flow_errors"] or []),
                  *(r["depth_errors"] or [])]
        if not all(np.isfinite(values)):
            failures.append(f"epoch {r['epoch']}: non-finite {values}")
    save = os.path.join("checkpoints", argv[argv.index("--name") + 1])
    files = {}
    for fn in ("checkpoint.pt", "best.pt"):
        path = os.path.join(save, fn)
        if not os.path.isfile(path):
            failures.append(f"no {path}")
            continue
        state = torch.load(path, map_location="cpu", weights_only=True)
        files[fn] = {"bytes": os.path.getsize(path), "step": state["step"]}
    if failures:
        raise AssertionError(f"train CLI {name}: " + "; ".join(failures))
    per_epoch = lambda key: [r["seconds"][key] for r in records]
    batch = int(argv[argv.index("-b") + 1])
    return {"phase": "train_cli", "run": name, "gpu": gpu,
            "argv": " ".join(argv), "seconds": seconds,
            "epochs": len(records), "steps": steps,
            "training_image_forwards": outputs,
            "flow_validation_items": val_items,
            "k1_launches": k1, "k1b_launches": k1b,
            "expected_k1": e_k1, "expected_k1b": e_k1b,
            "train_losses": [r["train_loss"] for r in records],
            "flow_errors": [r["flow_errors"] for r in records],
            "depth_errors": [r["depth_errors"] for r in records],
            "decisive": [r["decisive"] for r in records],
            "epoch_train_s": per_epoch("train"),
            "im_per_s_printed": [r["im_per_s_printed"] for r in records],
            "train_phase_resident_step_ms": step_ms,
            "train_phase_im_per_s": batch * 1e3 / step_ms,
            "flow_validation_ms_per_item": [
                1e3 * t / val_n for t in per_epoch("flow_validation")]
            if val_n else None,
            "depth_validation_ms_per_frame": [
                1e3 * t / depth_n for t in per_epoch("depth_validation")]
            if depth_n else None,
            "checkpoint_s": per_epoch("checkpoint"), "files": files}


def bench_cli_argv(root: str, kitti: str) -> list[str]:
    """The train CLI's flags for bench.py's point (832x256, batch 4, its
    loss weights) on the scene folders under `root`, with the KITTI 2015
    tree `kitti` for flow validation."""
    bench = lambda k: str(BENCH[k])
    return [root, "--height", "256", "--width", "832", "-b", str(B),
            "-pc", bench("cam_photo_loss_weight"),
            "-m", bench("mask_loss_weight"),
            "-s", bench("smooth_loss_weight"),
            "-pf", bench("flow_photo_loss_weight"),
            "-c", bench("consensus_loss_weight"),
            "-wssim", bench("wssim"), "--lr", bench("lr"),
            "--smoothness-type", BENCH["smoothness_type"],
            "-j", "4", "--kitti-dir", kitti, "--seed", "0"]


def phase_train_cli(root: str, gpu: str, step_ms: dict) -> dict:
    """The train CLI in-process, in a temporary working directory: three
    runs over the scene folders under `root` (832x256 JPEGs with train.txt
    and val.txt) and a synthetic KITTI 2015 tree. Back2Future at bench.py's
    point, 2 epochs with both validations and training images; the same
    resumed with --fix-flownet for an epoch; DispNetS + PoseNet6 +
    MaskResNet6 + FlowNetC6 for an epoch of 2 steps with flow validation.
    The depth validation set is the 8 frames of add_depth_val_scene.
    Returns {run: (K1, K1', steps, training-image forwards, validation
    items), each per epoch}."""
    has = lambda mod: importlib.util.find_spec(mod) is not None
    cwd = os.getcwd()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        kitti = synthetic_kitti2015(os.path.join(tmp, "kitti2015"), 4)
        os.makedirs(os.path.join(tmp, "run"))
        os.chdir(os.path.join(tmp, "run"))
        try:
            base = bench_cli_argv(root, kitti)
            b2f = base + ["--name", "b2f", "--epoch-size", "3",
                          "--with-depth-gt", "--with-flow-gt",
                          "--val-flow-N", "4", "-f", "3", "--log-output",
                          "--print-freq", "2"]
            rows.append(_cli_run("Back2Future", b2f + ["--epochs", "2"],
                                 "Back2Future", 4, 8, 3, True, gpu,
                                 step_ms["Back2Future"]))
            load = lambda name: torch.load(
                f"checkpoints/{name}/checkpoint.pt", map_location="cpu",
                weights_only=True)
            first = load("b2f")
            rows.append(_cli_run("Back2Future --resume --fix-flownet",
                                 b2f + ["--epochs", "1", "--resume",
                                        "--fix-flownet"],
                                 "Back2Future", 4, 8, 3, False, gpu,
                                 step_ms["Back2Future"]))
            second = load("b2f")
            flow_equal = all(
                torch.equal(first[g]["flow"][k], second[g]["flow"][k])
                for g in ("nets", "mu", "nu") for k in first[g]["flow"])
            rows[-1].update(flow_bit_equal_to_run_1=flow_equal,
                            steps_before_after=[first["step"],
                                                second["step"]])
            if not flow_equal or second["step"] != first["step"] + 3:
                raise AssertionError(
                    f"--resume --fix-flownet: F bit-equal {flow_equal}, "
                    f"step {first['step']} -> {second['step']}")
            del first, second

            # DispNetS predicts 4 scales and M 6: the consensus loss takes
            # one of each per scale and asserts as many (in cc_tpu and the
            # reference alike), so this run trains without it (-c 0)
            nets = dict(dispnet="DispNetS", posenet="PoseNet6",
                        masknet="MaskResNet6", flownet="FlowNetC6")
            rows.append(_cli_run(
                "+".join(nets.values()),
                base + [a for k, v in nets.items() for a in (f"--{k}", v)]
                + ["-c", "0", "--name", "others", "--epochs", "1",
                   "--epoch-size", "2", "--with-flow-gt", "--val-flow-N",
                   "2", "--print-freq", "1"],
                "FlowNetC6", 2, 0, 0, True, gpu, step_ms["FlowNetC6"]))
            # the CLI's init is make_models' from --seed 0, on the CPU
            init = make_models(TrainConfig(**nets), device="cpu",
                               generator=torch.Generator().manual_seed(0))
            trained = load("others")["nets"]
            moved = {n: any(not torch.equal(p, trained[n][k])
                            for k, p in init[n].named_parameters())
                     for n in NETS}
            rows[-1]["every_net_moved"] = moved
            if not all(moved.values()):
                raise AssertionError(f"nets that did not train: {moved}")
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    launches = {}
    for key, row in zip(("Back2Future", "Back2Future fix_flownet",
                         "FlowNetC6"), rows):
        row.update(tensorboardX=has("tensorboardX"),
                   matplotlib=has("matplotlib"))
        emit(row)
        n = row["epochs"]
        launches[key] = (row["k1_launches"] // n, row["k1b_launches"] // n,
                         row["steps"] // n,
                         row["training_image_forwards"] // n,
                         row["flow_validation_items"] // n)
    return launches


def _port_util():
    """tests/torch_port_util.py, imported by its path (an installed package
    named `tests` would hide it): the train steps of a spec, on one process
    or as each process of a torchrun launch, and the launcher."""
    path = os.path.join(REPO, "tests", "torch_port_util.py")
    spec = importlib.util.spec_from_file_location("torch_port_util", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rows_differ(batch: dict) -> dict:
    """A copy of seeded_batch's host batch whose rows also differ in their
    intrinsics (the images of seeded_batch already do): row i's focal
    lengths and principal point moved by 5 % of the frame times i."""
    out = {k: v.cpu().numpy().copy() for k, v in batch.items()}
    for i, k in enumerate(out["intrinsics"]):
        k[0, 0] *= 1.0 - 0.05 * i
        k[1, 1] *= 1.0 + 0.05 * i
        k[0, 2] += 0.05 * i * out["tgt"].shape[2]
        k[1, 2] -= 0.05 * i * out["tgt"].shape[1]
    out["intrinsics_inv"] = np.linalg.inv(out["intrinsics"]).astype(
        np.float32)
    return out


def phase_ddp(root: str, gpu: str) -> list:
    """Data parallel training of two processes sharing the card (torchrun,
    gloo, which all-reduces CUDA tensors through host memory): not a
    scaling measurement, one card cannot give one.
    (a) The step at bench.py's point, a global batch of 4 whose rows
    differ (images and intrinsics), 2 rows a process
    (tests/torch_port_util.py's run_steps, the script of each process),
    against one process on the card from the same weights and batch: a
    step, compared by compare_train_states; then, from the same weights
    again, two steps and a fix_flownet step, whose metrics are compared
    step by step (the state after them is reported: Adam's later steps
    carry the first step's sign flips of near-zero gradients on). The two
    processes bit-equal; 10 K1 and 10 K1' a step on each, 0 K1' with F
    frozen. Each step's ms and the gradient bytes averaged a step.
    (b) The train CLI on the scene folders under `root`, an epoch of 3
    steps with flow validation, under torchrun with two processes and in
    this process: the epoch's train loss within cc_tpu's rtol 2e-3
    (tests/test_distributed_2proc.py), one recorder line, the same files;
    then --resume --fix-flownet on two processes for a step, F bit-equal
    across it. Returns the launches a step of (a)'s second run, per
    process."""
    util = _port_util()
    cfg = TrainConfig(height=256, width=832, batch_size=B, **BENCH)
    nets = make_models(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    spec = {"device": "cuda", "config": dataclasses.asdict(cfg),
            "nets": nets.state_dict(),
            "batch": _rows_differ(seeded_batch(cfg, "cpu", seed=2)),
            "runs": [[{}], [{}, {}, {"fix_flownet": True}]]}
    del nets
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(spec, os.path.join(tmp, "spec.pt"))
        one = util.run_steps(spec, "cuda")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        util.torchrun(["tests/torch_port_util.py", "steps",
                       os.path.join(tmp, "spec.pt"), tmp])
        launch_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{i}.pt"))
                 for i in range(2)]
    failures = []
    expected = [[(10, 10)], [(10, 10), (10, 10), (10, 0)]]
    for name, runs in [("one process", one),
                       *((f"process {i}", r["runs"])
                         for i, r in enumerate(ranks))]:
        if [run["launches"] for run in runs] != expected:
            failures.append(f"{name}: launches "
                            f"{[run['launches'] for run in runs]}, expected "
                            f"{expected}")
    a, b = (r["runs"][1]["state"] for r in ranks)
    equal = all(torch.equal(v, b["nets"][k]) for k, v in a["nets"].items())
    if not equal or a["counts"] != b["counts"]:
        failures.append(f"the two processes differ: nets bit-equal {equal},"
                        f" counts {a['counts']} and {b['counts']}")
    first, more = compare_train_states(
        one[0]["metrics"], ranks[0]["runs"][0]["metrics"], one[0]["state"],
        ranks[0]["runs"][0]["state"])
    failures += more
    three, more = compare_train_states(
        one[1]["metrics"], ranks[0]["runs"][1]["metrics"], one[1]["state"],
        a)
    failures += [f for f in more if f.startswith("metrics ")]
    emit({"phase": "ddp", "part": "step", "gpu": gpu,
          "what": "2 processes sharing one card through gloo (host-memory "
                  "all-reduce): not a scaling number",
          "hw": [cfg.height, cfg.width], "global_batch": cfg.batch_size,
          "rows_a_process": cfg.batch_size // 2,
          "backend": ranks[0]["backend"],
          "devices": [r["device"] for r in ranks],
          "runs": [["step"], ["step", "step", "fix_flownet step"]],
          "launches_one_process": [run["launches"] for run in one],
          "launches_a_process": [[run["launches"] for run in r["runs"]]
                                 for r in ranks],
          "ms_a_step_two_processes": [[run["ms"] for run in r["runs"]]
                                      for r in ranks],
          "ms_a_step_one_process": [run["ms"] for run in one],
          "grad_bytes_all_reduced_a_step":
              ranks[0]["runs"][1]["grad_bytes"],
          "launch_s": launch_s, "nets_bit_equal_across_processes": equal,
          "metrics_one_process": [run["metrics"] for run in one],
          "metrics_two_processes": [run["metrics"]
                                    for run in ranks[0]["runs"]],
          "after_one_step": first,
          "after_three_steps": {**three, "state_checks_failed": [
              f for f in more if not f.startswith("metrics ")]}})
    if failures:
        raise AssertionError("ddp step: " + "; ".join(failures))
    cli_row = _ddp_cli(root, util)
    emit({"phase": "ddp", "part": "cli", "gpu": gpu, **cli_row})
    return [r["runs"][1]["launches"][0] for r in ranks]


def _ddp_cli(root: str, util) -> dict:
    """Part (b) of phase_ddp."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        kitti = synthetic_kitti2015(os.path.join(tmp, "kitti2015"), 2)
        argv = bench_cli_argv(root, kitti) + [
            "--name", "ddp", "--epochs", "1", "--epoch-size", "3",
            "--with-flow-gt", "--val-flow-N", "2", "--print-freq", "1"]
        runs = {n: os.path.join(tmp, n) for n in ("one", "two")}
        for d in runs.values():
            os.makedirs(d)
        os.chdir(runs["one"])
        try:
            t0 = time.perf_counter()
            train_cli.main(argv)
            one_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        log = util.torchrun(["-m", "cc_tpu_torch.cli.train", *argv],
                            cwd=runs["two"])
        two_s = time.perf_counter() - t0
        save = {n: os.path.join(d, "checkpoints", "ddp")
                for n, d in runs.items()}
        loss = {}
        for n in runs:
            with open(os.path.join(save[n], "progress_log_summary.csv")) as f:
                loss[n] = float(f.read().splitlines()[1].split("\t")[0])
        # a tensorboardX event file's name holds its time of creation
        files = {n: sorted("events" if f.startswith("events.out.tfevents")
                           else f for f in os.listdir(save[n]))
                 for n in runs}
        with open(os.path.join(runs["two"], "experiment_recorder.md")) as f:
            recorder_lines = f.read().count("python3 ")
        first = torch.load(os.path.join(save["two"], "checkpoint.pt"),
                           map_location="cpu", weights_only=True)
        resume = argv + ["--resume", "--fix-flownet"]
        resume[resume.index("--epoch-size") + 1] = "1"
        t0 = time.perf_counter()
        util.torchrun(["-m", "cc_tpu_torch.cli.train", *resume],
                      cwd=runs["two"])
        resume_s = time.perf_counter() - t0
        second = torch.load(os.path.join(save["two"], "checkpoint.pt"),
                            map_location="cpu", weights_only=True)
    flow_equal = all(torch.equal(first[g]["flow"][k], second[g]["flow"][k])
                     for g in ("nets", "mu", "nu") for k in first[g]["flow"])
    rel = abs(loss["two"] - loss["one"]) / abs(loss["one"])
    row = {"argv": " ".join(argv), "train_loss": loss,
           "train_loss_rel_diff": rel, "rtol": 2e-3,
           "printed": [l for l in log.splitlines() if l.startswith("=> ")
                       and ("process" in l)],
           "files": files, "recorder_lines": recorder_lines,
           "seconds_one_process": one_s, "seconds_two_processes": two_s,
           "resume_fix_flownet_s": resume_s,
           "steps_before_after_resume": [first["step"], second["step"]],
           "flow_bit_equal_across_resume": flow_equal}
    failures = []
    if not (np.isfinite(list(loss.values())).all() and rel <= 2e-3):
        failures.append(f"train loss {loss}")
    if files["one"] != files["two"] or recorder_lines != 1:
        failures.append(f"files {files}, {recorder_lines} recorder lines")
    if "=> 2 process(es) on gloo" not in log:
        failures.append("no '=> 2 process(es) on gloo' printed")
    if not flow_equal or second["step"] != first["step"] + 1:
        failures.append(f"--resume --fix-flownet: F bit-equal {flow_equal},"
                        f" step {first['step']} -> {second['step']}")
    if failures:
        raise AssertionError("ddp CLI: " + "; ".join(failures))
    return row


def _png(path: str, img: np.ndarray) -> None:
    import cv2
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not cv2.imwrite(path, img):
        raise AssertionError(f"could not write {path}")


def _smooth(r, h: int, w: int) -> np.ndarray:
    import cv2
    return cv2.GaussianBlur((r.rand(h, w, 3) * 255).astype(np.uint8),
                            (21, 21), 8)


def synthetic_eigen(root: str, items: int, h: int = 375,
                    w: int = 1242) -> str:
    """A KITTI raw drive for the Eigen protocol at KITTI's frame size:
    items + 2 frames of image_02, a velodyne scan for each of the `items`
    middle ones (points back-projected from a pixel grid of the lower
    60% of the frame at depths of 5-60 m), KITTI's calibration layout (fx
    721.5) and oxts timestamps and speeds. Writes test_files.txt (the middle frames). Returns root."""
    r = np.random.RandomState(3)
    date, drive = "2011_09_26", "2011_09_26_drive_0002_sync"
    fx, cx, cy = 721.5377, w / 2, h / 2
    os.makedirs(os.path.join(root, date, drive, "velodyne_points", "data"))
    os.makedirs(os.path.join(root, date, drive, "oxts", "data"))
    with open(os.path.join(root, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        f.write(f"P_rect_02: {fx} 0 {cx} 44.9 0 {fx} {cy} 0.2 0 0 1 "
                "0.003\n")
    r_vc = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    with open(os.path.join(root, date, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: " + " ".join(map(str, r_vc.ravel())) + "\nT: 0 0 0\n")
    base = _smooth(r, h + items + 2, w + 2 * (items + 2))
    # about 18,600 points in view, as a KITTI scan has some 20,000
    us, vs = np.meshgrid(np.arange(4, w - 4, 5.0), np.arange(150, h - 2, 3.0))
    us, vs = us.ravel(), vs.ravel()
    with open(os.path.join(root, date, drive, "oxts", "timestamps.txt"),
              "w") as f:
        for i in range(items + 2):
            f.write(f"2011-09-26 13:02:25.{100000000 * i:09d}\n")
    names = []
    for i in range(items + 2):
        _png(os.path.join(root, date, drive, "image_02", "data",
                          f"{i:010d}.png"), base[i:i + h, 2 * i:2 * i + w])
        row = [0.0] * 30
        row[8:11] = [9.0 + i, 0.2, 0.0]  # forward, left, up m/s
        with open(os.path.join(root, date, drive, "oxts", "data",
                               f"{i:010d}.txt"), "w") as f:
            f.write(" ".join(map(str, row)) + "\n")
        if 0 < i <= items:
            z = r.uniform(5.0, 60.0, us.shape)
            cam = np.stack([(us - cx) * z / fx, (vs - cy) * z / fx, z], 1)
            pts = np.concatenate([cam @ r_vc, np.ones((len(z), 1))], 1)
            pts.astype(np.float32).tofile(os.path.join(
                root, date, drive, "velodyne_points", "data",
                f"{i:010d}.bin"))
            names.append(f"{date}/{drive}/image_02/data/{i:010d}.png")
    with open(os.path.join(root, "test_files.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return root


def synthetic_pose_trees(root: str, snippets: int) -> tuple[str, str]:
    """A KITTI odometry sequence (09, 1241x376 frames, poses of a camera
    driving forward and turning) and an MPI-Sintel sequence (alley_1,
    1024x436 frames, .cam files), each of snippets + 4 frames: `snippets`
    5-frame snippets. Returns (odometry root, Sintel root)."""
    r = np.random.RandomState(4)
    odo, sintel = os.path.join(root, "odometry"), os.path.join(root, "sintel")
    n = snippets + 4
    t = np.eye(4)
    os.makedirs(os.path.join(odo, "poses"))
    os.makedirs(os.path.join(sintel, "camdata_left", "alley_1"))
    base = _smooth(r, 436 + n, 1241 + 2 * n)
    k = np.array([[1120.0, 0, 511.5], [0, 1120.0, 217.5], [0, 0, 1]])
    with open(os.path.join(odo, "poses", "09.txt"), "w") as f:
        for i in range(n):
            f.write(" ".join(map(str, t[:3].ravel())) + "\n")
            _png(os.path.join(odo, "sequences", "09", "image_2",
                              f"{i:06d}.png"), base[i:i + 376, 2 * i:2 * i + 1241])
            _png(os.path.join(sintel, "clean", "alley_1",
                              f"frame_{i + 1:04d}.png"),
                 base[i:i + 436, 2 * i:2 * i + 1024])
            with open(os.path.join(sintel, "camdata_left", "alley_1",
                                   f"frame_{i + 1:04d}.cam"), "wb") as c:
                c.write(np.float32(202021.25).tobytes())
                c.write(k.tobytes() + t[:3].tobytes())
            step = np.eye(4)
            a = 0.01 * (i % 3 - 1)
            step[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]
            step[:3, 3] = [0.02, 0.0, 0.8]
            t = t @ step
    return odo, sintel


def synthetic_make3d(root: str) -> str:
    """Make3D's layout at its own sizes: 62 Test134 JPEGs of 2272x1704 and
    Gridlaserdata .mat files with Position3DGrid [55, 305, 4] (depths of
    2-75 m); the framework drops sample 61, which is corrupt in the real
    set, so this makes 61 items. Returns root."""
    import cv2
    from scipy.io import savemat
    r = np.random.RandomState(5)
    os.makedirs(os.path.join(root, "Test134"))
    os.makedirs(os.path.join(root, "Gridlaserdata"))
    base = _smooth(r, 2272 + 62, 1704)
    for i in range(62):
        cv2.imwrite(os.path.join(root, "Test134", f"img-{i:03d}.jpg"),
                    base[i:i + 2272])
        grid = np.zeros((55, 305, 4))
        grid[..., 3] = r.uniform(2.0, 75.0, (55, 305))
        savemat(os.path.join(root, "Gridlaserdata", f"depth-{i:03d}.mat"),
                {"Position3DGrid": grid})
    return root


def add_semantic_labels(root: str, items: int, h: int = 375,
                        w: int = 1242) -> None:
    """test_mask's semantic maps beside a synthetic_kitti2015 tree: the
    bottom half labelled car (26, KITTI's class), the rest road (7)."""
    for i in range(items):
        sem = np.full((h, w), 7, np.uint8)
        sem[h // 2:] = 26
        _png(os.path.join(root, "semantic_labels", "training", "semantic",
                          f"{i:06d}_10.png"), sem)


def reference_checkpoints(root: str) -> dict:
    """.pth.tar files in the reference's format ({'epoch', 'state_dict'},
    the reference's parameter names) of the port's nets, initialized at
    random from torch seed 0: the paper's four, named as submit_flow reads
    them, and FlowNetC6, PoseExpNet (2 references, as test_disp builds it)
    and DispNetS (run_inference's default)."""
    from cc_tpu_torch import models
    torch.manual_seed(0)
    specs = {"dispnet_model_best": ("DispResNet6", {}),
             "posenet_model_best": ("PoseNetB6", {"nb_ref_imgs": 4}),
             "masknet_model_best": ("MaskNet6", {"nb_ref_imgs": 4}),
             "flownet_model_best": ("Back2Future", {"nlevels": 6}),
             "flownetc6": ("FlowNetC6", {"nlevels": 6}),
             "poseexpnet": ("PoseExpNet", {"nb_ref_imgs": 2}),
             "dispnets": ("DispNetS", {})}
    os.makedirs(root)
    paths = {}
    for name, (arch, kw) in specs.items():
        paths[name] = os.path.join(root, name + ".pth.tar")
        torch.save({"epoch": 0,
                    "state_dict": models.build(arch, **kw).state_dict()},
                   paths[name])
    return paths


def _numbers(out) -> list[float]:
    """Every number of an eval CLI's return value."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], list) \
            and all(isinstance(n, str) for n in out[1]):
        out = out[0]  # test_flow's (errors, names)
    return [float(v) for v in np.ravel(np.asarray(out, dtype=np.float64))]


def _eval_run(name: str, main, argv: list[str], items: int, k1_per_item: int,
              gpu: str, device: str = "cuda") -> tuple[dict, object]:
    """One eval CLI's main on `device`, the launch counts set to 0 just
    before it, under a profiler of the card's kernels: its K1 launches
    against k1_per_item x items, finite results, seconds per item and the
    share of them in which the card ran no kernel (the host's). Returns its
    JSON row and what main returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    corr.launches = corr.backward_launches = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = main(argv + ["--device", device])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1, k1b = corr.launches, corr.backward_launches
    busy_s = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e6
    numbers = _numbers(out) if out is not None else []
    row = {"phase": "eval_cli", "run": name, "device": device, "gpu": gpu,
           "argv": " ".join(argv), "items": items, "seconds": seconds,
           "s_per_item": seconds / items,
           "device_s_per_item": busy_s / items,
           "host_share": 1 - busy_s / seconds,
           "k1_launches": k1, "expected_k1": k1_per_item * items,
           "k1b_launches": k1b, "result": numbers}
    failures = []
    if (k1, k1b) != (k1_per_item * items, 0):
        failures.append(f"{k1} K1 and {k1b} K1' launches, expected "
                        f"{k1_per_item * items} and 0")
    if not all(np.isfinite(numbers)):
        failures.append(f"non-finite results {numbers}")
    if failures:
        emit(row)
        raise AssertionError(f"eval CLI {name}: " + "; ".join(failures))
    return row, out


def _card_vs_cpu(name: str, names: list[str], card, cpu,
                 tols: dict) -> dict:
    """An eval CLI's results on the card against the CPU's, each within
    its tolerance in `tols` (by name), else within EVAL_RTOL."""
    report, failures = {}, []
    for n, a, e in zip(names, card, cpu):
        tol = float(tols.get(n, EVAL_RTOL * abs(e)))
        report[n] = {"card": float(a), "cpu": float(e),
                     "abs_diff": float(abs(a - e)), "tol": tol}
        if not abs(a - e) <= tol:
            failures.append(f"{n}: card {a}, CPU {e}, tolerance {tol}")
    if failures:
        raise AssertionError(f"eval CLI {name}, card vs CPU: "
                             + "; ".join(failures))
    return report


def _largest_flow(argv: list[str], items: int) -> float:
    """The largest component of F's and of the rigid flow over test_flow's
    items on the card, in pixels of the frames' own size."""
    from cc_tpu_torch.cli import test_flow
    from cc_tpu_torch.data import transforms
    from cc_tpu_torch.data.validation import ValidationFlow
    args = test_flow.parser.parse_args(argv)
    dev = torch.device("cuda")
    nets = test_flow.load_four_nets(args, dev, {
        "disp": args.pretrained_disp, "pose": args.pretrained_pose,
        "mask": args.pretrained_mask, "flow": args.pretrained_flow})
    val = ValidationFlow(args.kitti_dir, transform=transforms.
                         valid_flow_transform(args.img_height,
                                              args.img_width), N=items)
    top = 0.0
    for i in range(items):
        s = val[i]
        out = test_flow.four_net_forward(nets, s, dev)
        scale = max(s["flow_gt"].shape[1] / args.img_width,
                    s["flow_gt"].shape[0] / args.img_height)
        top = max(top, scale * float(max(out["flow_fwd"].abs().max(),
                                         out["flow_cam"].abs().max())))
    return top


def phase_eval_cli(gpu: str) -> dict:
    """Every eval and inference CLI of the port, in-process on the card,
    on trees at KITTI's widths written here (KITTI 2015's is the train CLI
    phase's synthetic_kitti2015, with semantic labels added), from
    reference checkpoints of the port's nets at random: test_disp with a
    pose net, test_make3d, run_inference, test_pose, test_sintel_pose,
    test_back2future (Back2Future, and FlowNetC6), test_flow, test_mask,
    submit_flow (--DEBUG: KITTI 2015's training split) and evaluate_flow
    on its output. Each run's K1 launches against its items, its results
    finite, and test_disp and test_flow on the card against the same CLIs
    on the CPU. Returns {flow net run: (K1 launches, items, flow net)}."""
    from cc_tpu_torch.cli import (
        evaluate_flow, run_inference, submit_flow, test_back2future,
        test_disp, test_flow, test_make3d, test_mask, test_pose,
        test_sintel_pose,
    )
    from cc_tpu_torch.eval.kitti_depth import KittiEigenFramework
    from cc_tpu_torch.utils.flow_io import flow_read_png
    n = EVAL_ITEMS
    b2f, c6 = EVAL_K1_PER_ITEM["Back2Future"], EVAL_K1_PER_ITEM["FlowNetC6"]
    rows, k1_paths = [], {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ck = reference_checkpoints(os.path.join(tmp, "ckpts"))
        kitti = synthetic_kitti2015(os.path.join(tmp, "kitti2015"), n)
        add_semantic_labels(kitti, n)
        eigen = synthetic_eigen(os.path.join(tmp, "eigen"), n)
        odo, sintel = synthetic_pose_trees(os.path.join(tmp, "pose"), n)
        make3d = synthetic_make3d(os.path.join(tmp, "make3d"))
        imgs = os.path.join(tmp, "images")
        r = np.random.RandomState(6)
        for i in range(n):
            _png(os.path.join(imgs, f"{i:06d}.png"), _smooth(r, 375, 1242))
        trees_s = time.perf_counter() - t0

        disp_argv = ["--pretrained-dispnet", ck["dispnet_model_best"],
                     "--pretrained-posenet", ck["poseexpnet"],
                     "--dataset-dir", eigen, "--dataset-list",
                     os.path.join(eigen, "test_files.txt")]
        four = ["--kitti-dir", kitti, "-N", str(n),
                "--pretrained-disp", ck["dispnet_model_best"],
                "--pretrained-pose", ck["posenet_model_best"],
                "--pretrained-mask", ck["masknet_model_best"],
                "--pretrained-flow", ck["flownet_model_best"]]
        runs = [
            ("test_disp", test_disp.main, disp_argv, n, 0),
            ("test_make3d", test_make3d.main,
             ["--pretrained-dispnet", ck["dispnet_model_best"],
              "--dataset-dir", make3d], 61, 0),
            ("run_inference", run_inference.main,
             ["--pretrained", ck["dispnets"], "--dataset-dir", imgs,
              "--output-dir", os.path.join(tmp, "inference"),
              "--output-disp", "--output-depth"], n, 0),
            ("test_pose", test_pose.main,
             [ck["posenet_model_best"], "--dataset-dir", odo], n, 0),
            ("test_sintel_pose", test_sintel_pose.main,
             [ck["posenet_model_best"], "--dataset-dir", sintel], n, 0),
            ("test_back2future", test_back2future.main,
             ["--kitti-dir", kitti, "-N", str(n), "--pretrained-flow",
              ck["flownet_model_best"]], n, b2f),
            ("test_back2future --flownet FlowNetC6", test_back2future.main,
             ["--kitti-dir", kitti, "-N", str(n), "--pretrained-flow",
              ck["flownetc6"], "--flownet", "FlowNetC6"], n, c6),
            ("test_flow", test_flow.main,
             four + ["--output-dir", os.path.join(tmp, "flow_card")], n,
             b2f),
            ("test_mask", test_mask.main, four, n, b2f),
            ("submit_flow --DEBUG", submit_flow.main,
             [os.path.join(tmp, "ckpts"), "--kitti-dir", kitti, "-N", str(n),
              "--DEBUG", "--output-dir", os.path.join(tmp, "submission")],
             n, b2f)]
        outs = {}
        for name, main, argv, items, per in runs:
            row, outs[name] = _eval_run(name, main, argv, items, per, gpu)
            rows.append(row)
            if per:
                flownet = "FlowNetC6" if "FlowNetC6" in name else \
                    "Back2Future"
                k1_paths[name] = (row["k1_launches"], items, flownet)
        written = sorted(os.listdir(os.path.join(tmp, "inference")))
        if len(written) != 2 * n:
            raise AssertionError(f"run_inference wrote {written}")
        # evaluate_flow on the submission's PNGs against the tree's GT
        t1 = time.perf_counter()
        ev = evaluate_flow.main([
            "--output-dir", os.path.join(tmp, "submission", "testing"),
            "--gt-dir", os.path.join(kitti, "data_scene_flow", "training",
                                     "flow_occ"), "-N", str(n)])
        seconds = time.perf_counter() - t1
        rows.append({"phase": "eval_cli", "run": "evaluate_flow",
                     "device": "host", "gpu": gpu, "items": n,
                     "seconds": seconds, "s_per_item": seconds / n,
                     "host_share": 1.0, "k1_launches": 0,
                     "result": [float(v) for v in ev]})
        if not all(np.isfinite(ev)):
            raise AssertionError(f"evaluate_flow: non-finite {ev}")

        # the card against the CPU: test_disp and test_flow
        with open(os.path.join(eigen, "test_files.txt")) as f:
            files = f.read().splitlines()
        depth_valid = min(int(KittiEigenFramework(eigen, files, 0, 1e-3, 80)
                              [i]["mask"].sum()) for i in range(n))
        flow_valid = min(int(flow_read_png(os.path.join(
            kitti, "data_scene_flow", "training", "flow_occ",
            f"{i:06d}_10.png"))[2].sum()) for i in range(n))
        t1 = time.perf_counter()
        cpu_disp = test_disp.main(disp_argv + ["--device", "cpu"])
        cpu_flow, flow_names = test_flow.main(
            four + ["--output-dir", os.path.join(tmp, "flow_cpu"),
                    "--device", "cpu"])
        cpu_s = time.perf_counter() - t1
        card_flow, _ = outs["test_flow"]
        # combined masks that differ (a pixel within rounding of a mask's
        # threshold) move it between the partitions: each moves epe_sp and
        # epe_mv by at most its endpoint error, |gt| (under 42.5 px here)
        # plus the larger of the two flows, over the valid pixels
        flips = [int((np.load(os.path.join(tmp, "flow_card", "mask",
                                           f"{i:03d}.npy"))
                      != np.load(os.path.join(tmp, "flow_cpu", "mask",
                                              f"{i:03d}.npy"))).sum())
                 for i in range(n)]
        if max(flips) > EVAL_EDGE_PIXELS:
            raise AssertionError(f"test_flow: combined masks, card vs CPU, "
                                 f"differ at {flips} pixels")
        pixel_epe = 42.5 + 2 ** 0.5 * _largest_flow(four, n)
        edge = lambda valid: EVAL_EDGE_PIXELS / valid
        disp_names = ["abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2",
                      "a3"]
        report = {
            "test_disp": _card_vs_cpu(
                "test_disp", disp_names, outs["test_disp"][1], cpu_disp[1],
                dict.fromkeys(("a1", "a2", "a3"), edge(depth_valid))),
            "test_flow": _card_vs_cpu(
                "test_flow", flow_names, card_flow, cpu_flow, {
                    **dict.fromkeys(("Fl", "Fl_gt_mask"), edge(flow_valid)),
                    **{k: EVAL_RTOL * abs(e) + max(flips) * pixel_epe
                       / flow_valid for k, e in zip(flow_names, cpu_flow)
                       if k.startswith(("epe_sp", "epe_mv"))}}),
            "test_flow_mask_pixels_differing": flips,
            "test_flow_pixel_epe_bound": pixel_epe}
        # the pose-scaled row divides by PoseExpNet's translation norms,
        # which nets at random make small: recorded, not held
        pose_row = [{"card": float(a), "cpu": float(e)} for a, e in
                    zip(outs["test_disp"][0], cpu_disp[0])]
    torch.cuda.empty_cache()
    for row in rows:
        emit(row)
    emit({"phase": "eval_cli_vs_cpu", "gpu": gpu, "rtol": EVAL_RTOL,
          "edge_pixels": EVAL_EDGE_PIXELS, "depth_valid_pixels": depth_valid,
          "flow_valid_pixels": flow_valid, "trees_s": trees_s,
          "cpu_runs_s": cpu_s, "phase_s": time.perf_counter() - t_phase,
          **report, "test_disp_pose_scaled_row": pose_row})
    return k1_paths


def synthetic_kitti_raw(root: str, frames: int, h: int = 375,
                        w: int = 1242) -> str:
    """A KITTI raw tree at KITTI's frame size for the ETL: one date, 2
    drives x 2 cameras of `frames` PNGs (windows sliding over a smooth
    random image), oxts at 5 m/s forward (every frame passes the 2 m/s
    filter), KITTI's calibration files (2011_09_26's P_rect) and a
    velodyne scan a frame of about 100,000 points: some 18,600 back-
    projected from a pixel grid of the lower 60% of the frame at depths of
    5-60 m, the rest around the car out of the camera's view. Returns root."""
    r = np.random.RandomState(5)
    date = "2011_09_26"
    fx, cx, cy = 721.5377, 609.5593, 172.854
    os.makedirs(os.path.join(root, date))
    with open(os.path.join(root, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        for cid, tx in (("02", 44.85728), ("03", -339.5242)):
            f.write(f"P_rect_{cid}: {fx} 0 {cx} {tx} 0 {fx} {cy} 0.2163791 "
                    "0 0 1 0.002745884\n")
    r_vc = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    t_vc = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01])
    with open(os.path.join(root, date, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: " + " ".join(map(str, r_vc.ravel())) + "\nT: "
                + " ".join(map(str, t_vc)) + "\n")
    us, vs = np.meshgrid(np.arange(4, w - 4, 5.0), np.arange(150, h - 2, 3.0))
    us, vs = us.ravel(), vs.ravel()
    around = 100_000 - len(us)
    for drive in ("0001", "0005"):
        d = os.path.join(root, date, f"{date}_drive_{drive}_sync")
        os.makedirs(os.path.join(d, "oxts", "data"))
        os.makedirs(os.path.join(d, "velodyne_points", "data"))
        bases = {cid: _smooth(r, h + frames, w + 2 * frames)
                 for cid in ("02", "03")}
        for i in range(frames):
            for cid, base in bases.items():
                _png(os.path.join(d, f"image_{cid}", "data", f"{i:010d}.png"),
                     base[i:i + h, 2 * i:2 * i + w])
            row = [0.0] * 30
            row[8:11] = [5.0, 0.1, 0.0]  # forward, left, up m/s
            with open(os.path.join(d, "oxts", "data", f"{i:010d}.txt"),
                      "w") as f:
                f.write(" ".join(map(str, row)) + "\n")
            z = r.uniform(5.0, 60.0, us.shape)
            cam = np.stack([(us - cx) * z / fx, (vs - cy) * z / fx, z], 1)
            # velodyne x forward, y left, z up: 60-300 degrees off the
            # heading is behind the car or beside the camera's view
            az = np.deg2rad(r.uniform(60, 300, around))
            rng = r.uniform(5.0, 80.0, around)
            side = np.stack([rng * np.cos(az), rng * np.sin(az),
                             r.uniform(-1.7, 2.0, around)], 1)
            velo = np.concatenate([(cam - t_vc) @ r_vc, side])
            pts = np.concatenate([velo, r.uniform(0, 1, (len(velo), 1))], 1)
            pts.astype(np.float32).tofile(os.path.join(
                d, "velodyne_points", "data", f"{i:010d}.bin"))
    return root


def phase_etl(gpu: str, step_ms: float, h: int = 256,
              w: int = 832) -> tuple[int, int, int, int, int]:
    """Raw KITTI through the ETL into the train CLI, then D exported in the
    reference's format. The ETL (cc_tpu_torch.cli.prepare_train_data,
    4 threads, --with-gt) dumps synthetic_kitti_raw's 2 drives x 2 cameras
    of 1242x375 frames at w x h (832x256): 4 scenes of ETL_FRAMES JPEGs with the
    zoomed cam.txt; seed 8964's split puts the second sorted scene alone in
    val.txt, with its GT depths (projected velodyne points), the train
    scenes without. The train CLI at bench.py's point on the dump: an epoch
    of 3 steps with depth validation and training images every step, its
    K1 and K1' launches held to _cli_expected's. Then D of the checkpoint
    through weights.save_torch_checkpoint, loaded back by the eval CLIs'
    load_net_params: its output on a dumped image equals, bit for bit, the
    output of the net the checkpoint held. Returns the epoch's (K1, K1',
    steps, training-image forwards, validation items)."""
    import cv2
    from cc_tpu_torch.cli import prepare_train_data
    from cc_tpu_torch.cli.test_disp import load_net_params
    from cc_tpu_torch.weights import save_torch_checkpoint
    n, drives = ETL_FRAMES, 2
    cwd = os.getcwd()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        raw = synthetic_kitti_raw(os.path.join(tmp, "raw"), n)
        tree_s = time.perf_counter() - t0
        dump = os.path.join(tmp, "dump")
        t0 = time.perf_counter()
        prepare_train_data.main([raw, "--dataset-format", "kitti",
                                 "--dump-root", dump, "--with-gt",
                                 "--width", str(w), "--height", str(h),
                                 "--num-threads", "4"])
        etl_s = time.perf_counter() - t0
        scenes = sorted(e for e in os.listdir(dump)
                        if os.path.isdir(os.path.join(dump, e)))
        val = open(os.path.join(dump, "val.txt")).read().split()
        failures = []
        if len(scenes) != 2 * drives or val != scenes[1:2]:
            failures.append(f"scenes {scenes}, val.txt {val}")
        points, cams = [], {}
        for s in scenes:
            d = os.path.join(dump, s)
            jpgs = sorted(f for f in os.listdir(d) if f.endswith(".jpg"))
            npys = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
            shapes = {cv2.imread(os.path.join(d, f)).shape for f in jpgs}
            if len(jpgs) != n or shapes != {(h, w, 3)}:
                failures.append(f"{s}: {len(jpgs)} JPEGs of {shapes}")
            cams[s] = [float(v) for v in
                       open(os.path.join(d, "cam.txt")).read().split(",")]
            if s in val:
                points = [int((np.load(os.path.join(d, f)) > 0).sum())
                          for f in npys]
                # 18,600 grid points, fewer where they share a pixel
                if len(npys) != n or min(points) < min(10_000, h * w // 4):
                    failures.append(f"{s}: GT {len(npys)} .npy files, "
                                    f"points {points}")
            elif npys:
                failures.append(f"train scene {s} kept {len(npys)} GT files")
        zx, zy = w / 1242, h / 375
        want = [721.5377 * zx, 0, 609.5593 * zx, 0, 721.5377 * zy,
                172.854 * zy, 0, 0, 1]
        if any(not np.allclose(c, want, atol=1e-5) for c in cams.values()):
            failures.append(f"cam.txt {cams}, expected {want}")
        if failures:
            raise AssertionError("etl: " + "; ".join(failures))

        os.makedirs(os.path.join(tmp, "run"))
        os.chdir(os.path.join(tmp, "run"))
        try:
            bench = lambda k: str(BENCH[k])
            argv = [dump, "--name", "etl", "--height", str(h), "--width",
                    str(w), "-b", str(B), "--epochs", "1", "--epoch-size",
                    "3", "--with-depth-gt", "-f", "1", "-j", "4",
                    "--seed", "0", "--print-freq", "1",
                    "-pc", bench("cam_photo_loss_weight"),
                    "-m", bench("mask_loss_weight"),
                    "-s", bench("smooth_loss_weight"),
                    "-pf", bench("flow_photo_loss_weight"),
                    "-c", bench("consensus_loss_weight"),
                    "-wssim", bench("wssim"), "--lr", bench("lr"),
                    "--smoothness-type", BENCH["smoothness_type"]]
            row = _cli_run("Back2Future on the ETL dump", argv,
                           "Back2Future", 0, n, 1, True, gpu, step_ms)

            cfg = TrainConfig(height=h, width=w)
            nets = make_models(cfg, device="cuda")
            load_checkpoint("checkpoints/etl", nets, make_optimizer(cfg)
                            .init(nets))
            path = os.path.abspath("dispnet_exported.pth.tar")
            t0 = time.perf_counter()
            save_torch_checkpoint(path, nets["disp"], epoch=1)
            export_s = time.perf_counter() - t0
            loaded = load_net_params(path, cfg.dispnet, torch.device("cuda"))
            img = cv2.cvtColor(cv2.imread(os.path.join(
                dump, val[0], "0000000000.jpg")), cv2.COLOR_BGR2RGB)
            x = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0)
            x = x.permute(2, 0, 1)[None].contiguous().cuda()
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                with torch.no_grad():
                    held = nets["disp"].eval()(x)
                    back = loaded(x)
            finally:
                torch.backends.cudnn.deterministic = deterministic
            sd = torch.load(path, map_location="cpu",
                            weights_only=True)["state_dict"]
            nbt = [k for k in sd if k.endswith("num_batches_tracked")]
            export = {"file_bytes": os.path.getsize(path),
                      "export_s": export_s, "keys": len(sd),
                      "num_batches_tracked_all_0": all(
                          int(sd[k]) == 0 for k in nbt),
                      "disp_shape": list(held.shape),
                      "bit_equal": bool(torch.equal(held, back)),
                      "max_abs_diff": float((held - back).abs().max())}
            if not (export["bit_equal"] and export["num_batches_tracked_all_0"]
                    and sd.keys() == nets["disp"].state_dict().keys()):
                raise AssertionError(f"etl: D exported: {export}")
        finally:
            os.chdir(cwd)
        del nets, loaded
    torch.cuda.empty_cache()
    row.update(phase="etl", raw_tree_s=tree_s, etl_s=etl_s,
               etl_s_per_frame=etl_s / (2 * drives * n),
               etl_frames=2 * drives * n, etl_threads=4, scenes=scenes,
               val=val, val_gt_points_per_frame=points,
               cam_txt=cams[scenes[0]], export_disp=export,
               phase_s=time.perf_counter() - t_phase)
    emit(row)
    return (row["k1_launches"], row["k1b_launches"], row["steps"],
            row["training_image_forwards"], row["flow_validation_items"])


def synthetic_mnist(root: str) -> str:
    """MNIST as IDX files at its real sizes (60,000 / 10,000) and SVHN .mat
    files cut to SVHN_SIZES (73,257 / 26,032 in full), from a seeded
    generator: each digit a class-dependent bright square on noise, so that
    the nets learn something and their logits are not all near a tie."""
    import struct
    from scipy.io import savemat
    r = np.random.RandomState(11)

    def digits(n, size):
        labels = r.randint(0, 10, n)
        img = r.randint(0, 80, (n, size, size)).astype(np.uint8)
        for k in range(10):
            img[labels == k, 2 + 2 * k:10 + 2 * k, 4:12] = 255
        return img, labels

    os.makedirs(os.path.join(root, "mnist"))
    os.makedirs(os.path.join(root, "svhn"))
    for prefix, n in (("train", 60_000), ("t10k", 10_000)):
        img, labels = digits(n, 28)
        with open(os.path.join(root, "mnist", f"{prefix}-images-idx3-ubyte"),
                  "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
        with open(os.path.join(root, "mnist", f"{prefix}-labels-idx1-ubyte"),
                  "wb") as f:
            f.write(struct.pack(">II", 2049, n)
                    + labels.astype(np.uint8).tobytes())
    for split, n in zip(("train", "test"), SVHN_SIZES):
        img, labels = digits(n, 32)
        labels[labels == 0] = 10  # SVHN's 0
        savemat(os.path.join(root, "svhn", f"{split}_32x32.mat"),
                {"X": np.repeat(img.transpose(1, 2, 0)[:, :, None], 3, 2),
                 "y": labels.astype(np.uint8)[:, None]})
    return root


def _near_ties(alice, bob, mod) -> dict:
    """Per rate (total, alice, bob), the samples whose prediction a change
    of MNIST_TIE in a logit could flip: the top two of Alice's or Bob's
    logits, or the moderator's logit against 0, within MNIST_TIE."""
    gap = lambda z: np.diff(np.sort(z, 1)[:, -2:], axis=1)[:, 0] < MNIST_TIE
    a, b, m = gap(alice), gap(bob), np.abs(mod) < MNIST_TIE
    return {"total": int((a | b | m).sum()), "alice": int(a.sum()),
            "bob": int(b.sum())}


def phase_mnist(gpu: str) -> None:
    """The MNIST CC demo on the card: cli.mnist on synthetic_mnist's files
    (--dataset both, batch 64, 2 epochs of 200 steps: compete, then
    collaborate), steps/s per epoch; a profiler window of each step on a
    resident batch (its idle share); then cli.mnist_eval of mnist_best.pt
    on the card and at --device cpu: the error rates equal but for the
    samples within MNIST_TIE of a tie (counted), and the logits of the
    checkpoint's nets on the card within MNIST_LOGIT_ATOL of the CPU's
    over the whole test set."""
    from cc_tpu_torch.cli import mnist as mnist_cli
    from cc_tpu_torch.cli import mnist_eval
    from cc_tpu_torch.mnist import train as mnist
    from cc_tpu_torch.mnist.data import iterate_batches
    cwd = os.getcwd()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = synthetic_mnist(os.path.join(tmp, "data"))
        data_s = time.perf_counter() - t0
        os.makedirs(os.path.join(tmp, "run"))
        os.chdir(os.path.join(tmp, "run"))
        try:
            t0 = time.perf_counter()
            records = mnist_cli.main([data, "--name", "mnist", "--dataset",
                                      "both", "-b", "64", "--epochs", "2",
                                      "--epoch-size", "200"])
            cli_s = time.perf_counter() - t0
            best = os.path.abspath("checkpoints/mnist/mnist_best.pt")
            t0 = time.perf_counter()
            errors = {d: mnist_eval.main([data, "--checkpoint", best,
                                          "--device", d])
                      for d in ("cuda", "cpu")}
            eval_s = time.perf_counter() - t0
            args = mnist_cli.parser.parse_args([data, "--name", "x"])
            test_x, test_y = mnist_cli.load_dataset(args, train=False)
            train_x, train_y = mnist_cli.load_dataset(args, train=True)
            out = {}
            for d in ("cuda", "cpu"):
                nets = mnist.load_nets(best, mnist.models(d))
                parts = [mnist.logits(nets, img) for img, _ in
                         iterate_batches(test_x, test_y, 64, shuffle=False,
                                         drop_last=False)]
                out[d] = [torch.cat(p).cpu().numpy() for p in zip(*parts)]
        finally:
            os.chdir(cwd)

    logit_err = max(float(np.abs(a - b).max())
                    for a, b in zip(out["cuda"], out["cpu"]))
    ties = _near_ties(*out["cpu"])
    n_test = len(test_y)
    rate_diff = {k: abs(a - b) * n_test for k, a, b in
                 zip(("total", "alice", "bob"), errors["cuda"],
                     errors["cpu"])}
    failures = []
    if logit_err > MNIST_LOGIT_ATOL:
        failures.append(f"logits differ by {logit_err}")
    if any(rate_diff[k] > ties[k] + 1e-6 for k in ties):
        failures.append(f"error rates {errors} differ by {rate_diff} "
                        f"samples, near ties {ties}")
    if [r["mode"] for r in records] != ["compete", "collaborate"] or \
            any(r["steps"] != 200 or not np.isfinite(r["loss"])
                for r in records):
        failures.append(f"epochs {records}")

    # a profiler window of each step on a resident batch, from a fresh
    # state: the card's idle share of the CLI's steps
    cfg = mnist.MnistConfig()
    state = mnist.init_mnist_state(cfg, "cuda")
    img, tgt = train_x[:64], train_y[:64]
    window = {}
    for name, step in (("compete", mnist.make_compete_step(cfg)),
                       ("collaborate", mnist.make_collaborate_step(cfg))):
        run = lambda: step(state, img, tgt)
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        ms = statistics.median(timed_windows(run, 50))
        prof = profile_breakdown(run, 10, ms, f"MNIST {name} step, b64")
        window[name] = {"ms_per_step": ms, "steps_per_s": 1e3 / ms,
                        "kernel_ms": prof["kernel_ms"],
                        "idle_share": prof["idle_share"],
                        "cuda_runtime_calls": prof["cuda_runtime_calls"],
                        "top": prof["top"][:5]}
    row = {"phase": "mnist", "gpu": gpu,
           "data": "MNIST IDX 60000/10000 at its real sizes; SVHN .mat "
                   f"cut to {SVHN_SIZES[0]}/{SVHN_SIZES[1]} of 73257/26032",
           "argv": "--dataset both -b 64 --epochs 2 --epoch-size 200",
           "epochs": [{"mode": r["mode"], "steps": r["steps"],
                       "seconds": r["seconds"],
                       "steps_per_s": r["steps"] / r["seconds"],
                       "loss": r["loss"], "errors": r["errors"]}
                      for r in records],
           "cli_s": cli_s, "data_s": data_s, "eval_s_card_and_cpu": eval_s,
           "eval_errors": errors, "test_samples": n_test,
           "rate_diff_samples": rate_diff, "near_ties": ties,
           "tie_width": MNIST_TIE, "logits_max_abs_diff": logit_err,
           "logit_atol": MNIST_LOGIT_ATOL, "resident_step_window": window,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if failures:
        raise AssertionError("mnist: " + "; ".join(failures))


# bf16: the guarded recipe a user trains with (tests/test_bf16_step.py)
GUARDED = dict(compute_dtype="bfloat16", clip_grad_norm=5.0,
               skip_nonfinite_updates=True)
BF16_FLAGS = ["--compute-dtype", "bfloat16", "--loss-dtype", "bfloat16",
              "--clip-grad-norm", "5", "--skip-nonfinite-updates"]
BF16 = torch.bfloat16
# a bf16 kernel against its plain version before the plain version's one
# rounding: one bf16 rounding (2**-8 of the value) plus an fp32 sum-order
# term, 2**-20 of the sum of the terms' magnitudes (mean_c |f1*f2| for K1)
BF16_RTOL, BF16_SUM_TOL = 2.0 ** -8, 2.0 ** -20
# the steps of the guarded bf16 step held finite
BF16_FINITE_STEPS = 10


def phase_correlation_bf16(bw, flops):
    """The bf16 instantiations of K1 and K1' against their plain bf16
    versions at the main paths' shapes (Back2Future's five, FlowNetC6's, and
    for K1 Back2Future's at batch 1, the validation forwards): each output
    element within BF16_RTOL of the plain version's float32 sum before its
    rounding plus BF16_SUM_TOL of the sum of the terms' magnitudes; the
    elements where it differs from the rounded plain version counted; the
    same bits on a second launch; the CUDA-graph time beside the float32
    instantiation's on the same values, and the bound: the bytes at bf16
    width or the float32 FMA work (the kernel widens), the larger."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {"fwd": [], "bwd": []}
    failures = []
    for kind in ("fwd", "bwd"):
        cases = B2F_CASES + C6_CASES
        if kind == "fwd":
            cases = cases + B1_CASES["Back2Future"]
        for shape, patch, dil in cases:
            f1 = torch.randn(shape, generator=gen, device="cuda").to(BF16)
            f2 = torch.randn(shape, generator=gen, device="cuda").to(BF16)
            g = torch.randn((*shape[:3], patch * patch), generator=gen,
                            device="cuda").to(BF16)
            w1, w2, wg = f1.float(), f2.float(), g.float()
            if kind == "fwd":
                kernel = lambda: (corr.correlation_cuda(f1, f2, patch, dil),)
                kernel32 = lambda: corr.correlation_cuda(w1, w2, patch, dil)
                plain = lambda: (corr.correlation_plain(f1, f2, patch, dil),)
                wide = (corr.correlation_plain(w1, w2, patch, dil),)
                scale = (corr.correlation_plain(w1.abs(), w2.abs(), patch,
                                                dil),)
            else:
                kernel = lambda: corr.correlation_backward_cuda(
                    f1, f2, g, patch, dil)
                kernel32 = lambda: corr.correlation_backward_cuda(
                    w1, w2, wg, patch, dil)
                plain = lambda: corr.correlation_backward_plain(
                    f1, f2, g, patch, dil)
                wide = corr.correlation_backward_plain(w1, w2, wg, patch, dil)
                scale = corr.correlation_backward_plain(
                    w1.abs(), w2.abs(), wg.abs(), patch, dil)
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            excess = max(float(((o.float() - w).abs()
                                - BF16_RTOL * w.abs() - BF16_SUM_TOL * a)
                               .max()) for o, w, a in zip(out, wide, scale))
            err = max(float((o.float() - r.float()).abs().max())
                      for o, r in zip(out, ref))
            differ = sum(int((o != r).sum()) for o, r in zip(out, ref))
            where = f"{kind} bf16 at {shape} P={patch} d={dil}"
            if any(o.dtype != BF16 for o in out):
                failures.append(f"{where}: {[o.dtype for o in out]} out")
            if not all(map(torch.equal, kernel(), out)):
                failures.append(f"{where}: two launches differ")
            if not excess <= 0:
                failures.append(f"{where}: {excess} beyond the bound")
            nbytes, ops = corr_work(shape, patch, kind == "bwd")
            bnd, by = bound_ms(nbytes / 2, ops, bw, flops)
            row = {"phase": "kernel_bf16",
                   "name": ("correlation_backward" if kind == "bwd"
                            else "correlation_forward") + "_bf16",
                   "shape": list(shape), "patch": patch, "dilation": dil,
                   "max_abs_err": err, "elements_differing": differ,
                   "elements": sum(o.numel() for o in out),
                   "excess_over_bound": excess, "ms": time_device(kernel),
                   "fp32_ms": time_device(kernel32),
                   "plain_ms": time_device(plain, n=5, reps=3),
                   "bound_us": bnd * 1e3, "bound_by": by}
            emit(row)
            rows[kind].append(row)
            del f1, f2, g, w1, w2, wg, out, ref, wide, scale
    if failures:
        raise AssertionError("bf16 kernels: " + "; ".join(failures))
    return rows


def _dtype_counts() -> dict:
    return {str(d).split(".")[-1]: [corr.dtype_launches[d],
                                    corr.dtype_backward_launches[d]]
            for d in corr.DTYPES}


def _count_bf16(run) -> tuple:
    """run() with every launch count set to 0 just before it: its result
    and (K1, K1') of the bf16 instantiations; raises if a float32 one
    launched."""
    corr.reset_launches()
    out = run()
    torch.cuda.synchronize()
    if corr.dtype_launches[torch.float32] or corr.dtype_backward_launches[
            torch.float32]:
        raise AssertionError(f"float32 correlation launches in a bf16 run: "
                             f"{_dtype_counts()}")
    return out, (corr.dtype_launches[BF16],
                 corr.dtype_backward_launches[BF16])


def phase_bf16_step(gpu: str, flownet: str, fp32_ms: float):
    """The guarded bf16 train step (GUARDED) at bench.py's operating point:
    BF16_FINITE_STEPS steps with finite metrics, the bf16 K1 and K1'
    launches of one step (as the float32 step's), a fix_flownet step with
    no K1'; ms a step (5 warm-up steps, then the median of 3 windows of 5)
    beside the float32 step's of this call, the peak memory and a profile
    (the device's idle share). For Back2Future, the same with loss_dtype
    bfloat16 too (the train CLI's four flags), timed. Returns the launches
    and the ms."""
    cfg = TrainConfig(height=256, width=832, batch_size=B, flownet=flownet,
                      **BENCH, **GUARDED)
    nets = make_models(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    opt_state = make_optimizer(cfg).init(nets)
    step = build_train_step(cfg, nets, opt_state)
    batch = seeded_batch(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    seconds = {}
    t0 = time.perf_counter()
    warm = [_finite(step(batch))]
    seconds["first_step"] = time.perf_counter() - t0
    warm += [_finite(step(batch)) for _ in range(4)]
    metrics, (k1, k1b) = _count_bf16(lambda: step(batch))
    values = [*warm, _finite(metrics)]
    values += [_finite(step(batch))
               for _ in range(BF16_FINITE_STEPS - len(values))]
    expect = _expect_launches(flownet)
    if (k1, k1b) != (expect, expect):
        raise AssertionError(f"bf16 {flownet} step: {k1} K1 and {k1b} K1' "
                             f"bf16 launches, expected {expect} of each")
    seconds["steps"] = time.perf_counter() - t0
    windows = timed_windows(lambda: step(batch), 5)
    ms = statistics.median(windows)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    seconds["windows"] = time.perf_counter() - t0
    # one step profiled: a window of three (the float32 phases') takes
    # about 85 s to summarize
    prof = profile_breakdown(lambda: step(batch), 1, ms,
                             f"bf16 train step {flownet}, per step")
    emit(prof)
    seconds["profile"] = time.perf_counter() - t0
    frozen = build_train_step(cfg.replace(fix_flownet=True), nets, opt_state)
    fmetrics, (f_k1, f_k1b) = _count_bf16(lambda: frozen(batch))
    seconds["fix_flownet"] = time.perf_counter() - t0
    _finite(fmetrics)
    if (f_k1, f_k1b) != (expect, 0):
        raise AssertionError(f"bf16 {flownet} fix_flownet step: {f_k1} K1, "
                             f"{f_k1b} K1' bf16 launches")
    row = {"phase": FLOWNETS[flownet][1] + "bf16_train",
           "what": f"guarded bf16 train step {flownet} 832x256 b4 "
                   "(compute_dtype bfloat16, clip 5, non-finite guard)",
           "gpu": gpu, "ms_per_step": ms, "window_ms": windows,
           "fp32_ms_per_step": fp32_ms, "speedup_over_fp32": fp32_ms / ms,
           "frames_per_s": cfg.batch_size * 1e3 / ms,
           "peak_memory_gib": peak, "idle_share": prof["idle_share"],
           "kernel_ms": prof["kernel_ms"],
           "losses": [v["loss"] for v in values],
           "k1_bf16_launches": k1, "k1b_bf16_launches": k1b,
           "fix_flownet_k1_k1b": [f_k1, f_k1b],
           "adam": [opt_state.count, opt_state.notfinite]}
    if flownet == "Back2Future":
        both = build_train_step(cfg.replace(loss_dtype="bfloat16"), nets,
                                opt_state)
        for _ in range(3):
            _finite(both(batch))
        loss_windows = timed_windows(lambda: both(batch), 5)
        row["loss_bf16_ms_per_step"] = statistics.median(loss_windows)
        row["loss_bf16_window_ms"] = loss_windows
        seconds["loss_bf16"] = time.perf_counter() - t0
    row["seconds_since_start"] = seconds
    emit(row)
    del nets, opt_state, step, frozen, batch
    torch.cuda.empty_cache()
    return (k1, k1b), ms


def phase_bf16_eval(gpu: str, flownet: str, fp32_ms: float):
    """forward_eval with compute_dtype bfloat16 at 832x256 b4: its bf16 K1
    launches, finite float32 outputs, ms (median of 3 windows of 10)
    beside the float32 forward's of this call."""
    cfg = TrainConfig(flownet=flownet, compute_dtype="bfloat16")
    nets = make_models(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    batch = seeded_batch(cfg, "cuda")
    forward_eval(cfg, nets, batch)
    out, (k1, k1b) = _count_bf16(lambda: forward_eval(cfg, nets, batch))
    if (k1, k1b) != (_expect_launches(flownet), 0):
        raise AssertionError(f"bf16 {flownet} forward: {k1} K1, {k1b} K1'")
    for k, v in out.items():
        if v is not None and (v.dtype != torch.float32
                              or not bool(torch.isfinite(v).all())):
            raise AssertionError(f"bf16 forward {k}: {v.dtype}, finite "
                                 f"{bool(torch.isfinite(v).all())}")
    windows = timed_windows(lambda: forward_eval(cfg, nets, batch), 10)
    ms = statistics.median(windows)
    emit({"phase": FLOWNETS[flownet][1] + "bf16_timing", "gpu": gpu,
          "what": f"forward_eval {flownet} 832x256 b4 bf16",
          "ms_per_forward": ms, "window_ms": windows, "fp32_ms": fp32_ms,
          "k1_bf16_launches": k1})
    del nets, batch, out
    torch.cuda.empty_cache()
    return k1, ms


def phase_bf16_vs_cpu() -> None:
    """The guarded bf16 step at 128x128 batch 2 on the card against the
    same step on the CPU (plain kernels), from the same weights and batch,
    by tests/test_torch_bf16.py's yardstick (torch_port_util.check_bf16)
    with the CPU's float32 step as the reference distance: the metrics (one
    vector), each BatchNorm running stat, and each net's update
    (check_bf16_update: the yardstick on the update, and its sign where the
    CPU's gradients lie far above Adam's eps, which fails masters left as
    they are); every parameter within 2*lr of the CPU's."""
    util = _port_util()
    cfg16 = TrainConfig(height=128, width=128, batch_size=2, **BENCH,
                        **GUARDED)
    cfg32 = cfg16.replace(compute_dtype="float32")
    nets = make_models(cfg16, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    theta0 = {k: v.detach().clone() for k, v in nets.state_dict().items()}
    batch = seeded_batch(cfg16, "cpu", seed=1)
    runs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        for key, cfg in (("bf16", cfg16), ("fp32", cfg32)):
            n = copy.deepcopy(nets).to(dev)
            st = make_optimizer(cfg).init(n)
            m = build_train_step(cfg, n, st)(
                {k: v.to(dev) for k, v in batch.items()})
            runs[dev, key] = (torch.tensor([float(m[k]) for k in METRICS]),
                              {k: v.detach().cpu() for k, v in
                               n.state_dict().items()})
            if dev == "cpu":
                grads[key] = {
                    f"{name}.{k}": mu.cpu() / (1.0 - cfg.momentum)
                    for name in st.mu for (k, _), mu in zip(
                        n[name].named_parameters(), st.mu[name])}
            del n, st
    failures = []

    def yardstick(check, name, *runs_of):
        try:
            return check(name, *runs_of)
        except AssertionError as e:
            failures.append(str(e))
            return {"failed": str(e)}
    vec = lambda dev, key: runs[dev, key][0]
    report = {"metrics": yardstick(
        util.check_bf16, "metrics", vec("cuda", "bf16"), vec("cuda", "fp32"),
        vec("cpu", "bf16"), vec("cpu", "fp32"))}
    card, cpu = runs["cuda", "bf16"][1], runs["cpu", "bf16"][1]
    param_err, stats = 0.0, {}
    for k, v in cpu.items():
        if not v.is_floating_point():
            continue
        if k.endswith(("running_mean", "running_var")):
            stats[k] = yardstick(util.check_bf16, k, card[k],
                                 runs["cuda", "fp32"][1][k], v,
                                 runs["cpu", "fp32"][1][k])
        else:
            param_err = max(param_err, float((card[k] - v).abs().max()))
    if not param_err <= 2 * cfg16.lr + 1e-6:
        failures.append(f"params {param_err} > 2*lr")
    updates = {}
    for name in NETS:
        pick = lambda d: {k: d[k] for k in grads["bf16"]
                          if k.startswith(name + ".")}
        updates[name] = yardstick(
            util.check_bf16_update, name, pick(theta0), pick(card),
            pick(runs["cuda", "fp32"][1]), pick(cpu),
            pick(runs["cpu", "fp32"][1]), pick(grads["bf16"]),
            pick(grads["fp32"]))
    report.update(param_max_abs_err=param_err, param_tol=2 * cfg16.lr + 1e-6,
                  updates=updates,
                  worst_stats=sorted(
                      stats.items(),
                      key=lambda kv: -kv[1].get("rel_port_cc", 1.0))[:3])
    emit({"phase": "bf16_vs_cpu", "hw": [128, 128], "batch": 2,
          "metrics_card": vec("cuda", "bf16").tolist(),
          "metrics_cpu": vec("cpu", "bf16").tolist(), **report})
    if failures:
        raise AssertionError("bf16 step, card vs CPU: " + "; ".join(failures))


def phase_bf16(root: str, gpu: str, step_ms: dict, eval_ms: dict) -> dict:
    """bf16 mixed precision on the card (compute_dtype and loss_dtype
    bfloat16): the guarded step and the eval forward with each flow net,
    the step against the CPU's, and the train CLI with the four flags.
    Returns the bf16 K1 and K1' launches of each path's run."""
    t0 = time.perf_counter()
    launches = {}
    for flownet in FLOWNETS:
        launches["step", flownet], _ = phase_bf16_step(gpu, flownet,
                                                       step_ms[flownet])
        launches["eval", flownet], _ = phase_bf16_eval(gpu, flownet,
                                                       eval_ms[flownet])
    phase_bf16_vs_cpu()
    launches["cli"] = phase_bf16_cli(root, gpu, step_ms["Back2Future"])
    emit({"phase": "bf16", "seconds": time.perf_counter() - t0})
    return launches


def phase_bf16_cli(root: str, gpu: str, step_ms: float) -> tuple:
    """The train CLI with the four bf16 flags (BF16_FLAGS) at bench.py's
    point: an epoch of 2 steps with flow validation on 2 items of a
    synthetic KITTI 2015 tree, then --resume for a step; every K1 and K1'
    launch the bf16 instantiation's, as many as the runs imply, the
    checkpoint's master weights float32. Returns (K1, K1', steps, training
    image forwards, validation items) of the first run's epoch."""
    cwd = os.getcwd()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        kitti = synthetic_kitti2015(os.path.join(tmp, "kitti2015"), 2)
        os.makedirs(os.path.join(tmp, "run"))
        os.chdir(os.path.join(tmp, "run"))
        try:
            argv = bench_cli_argv(root, kitti) + [
                "--name", "bf16", "--epochs", "1", "--with-flow-gt",
                "--val-flow-N", "2", "--print-freq", "1", *BF16_FLAGS]
            for name, more in (("bf16", ["--epoch-size", "2"]),
                               ("bf16 --resume", ["--epoch-size", "1",
                                                  "--resume"])):
                row = _cli_run(name, argv + more, "Back2Future", 2, 0, 0,
                               True, gpu, step_ms)
                row["launches_by_dtype"] = counts = _dtype_counts()
                if counts["bfloat16"] != [row["k1_launches"],
                                          row["k1b_launches"]]:
                    raise AssertionError(f"train CLI {name}: {counts}")
                rows.append(row)
            state = torch.load("checkpoints/bf16/checkpoint.pt",
                               map_location="cpu", weights_only=True)
            dtypes = {str(t.dtype) for g in ("nets", "mu", "nu")
                      for n in NETS for t in state[g][n].values()}
            rows[-1]["checkpoint_dtypes"] = sorted(dtypes)
            if "torch.bfloat16" in dtypes or state["step"] != 3:
                raise AssertionError(f"bf16 checkpoint: {dtypes}, step "
                                     f"{state['step']}")
        finally:
            os.chdir(cwd)
    for row in rows:
        row["phase"] = "bf16_train_cli"
        emit(row)
    first = rows[0]
    return (first["k1_launches"], first["k1b_launches"], first["steps"],
            first["training_image_forwards"], first["flow_validation_items"])


def path_entry(path: str, rows, launches: int,
               per_shape: int = LAUNCHES_PER_SHAPE, more=()) -> dict:
    """A kernel's work on one run of a path: `per_shape` launches at each
    of `rows`' shapes, and the same for each (rows, per_shape) of `more`;
    `launches` counted on the path's run."""
    groups = [(rows, per_shape), *more]
    total = lambda key, by=None: sum(
        n * r[key] for rs, n in groups for r in rs
        if by in (None, r["bound_by"]))
    return {"path": path, "launches": launches,
            "shapes": [[*r["shape"], r["patch"], r["dilation"]] if "patch"
                       in r else r["shape"] for rs, _ in groups for r in rs],
            "launches_per_shape": [n for rs, n in groups for _ in rs],
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
    bf16_rows = phase_correlation_bf16(bw, flops)
    gather_row = phase_row_gather(bw, flops)
    gather_launches = phase_gather_path()

    launches = {}  # (flownet, "eval" | "step") -> (K1, K1') on that run
    step_ms = {}  # flownet -> the resident train step's median ms
    eval_ms = {}  # flownet -> the eval forward's median ms
    for flownet in FLOWNETS:
        cfg = TrainConfig(flownet=flownet)
        nets, batch, k1_eval = phase_slice(cfg)
        launches[flownet, "eval"] = (k1_eval, 0)
        eval_ms[flownet] = phase_timing(cfg, nets, batch, gpu)
        del nets, batch
        torch.cuda.empty_cache()
        launches[flownet, "step"], step_ms[flownet] = phase_train(
            gpu, flownet)
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
        add_depth_val_scene(roots[256, 832], 256, 832, frames=8)
        cli = phase_train_cli(roots[256, 832], gpu, step_ms)
        ddp_launches = phase_ddp(roots[256, 832], gpu)
        bf16 = phase_bf16(roots[256, 832], gpu, step_ms, eval_ms)
    eval_k1 = phase_eval_cli(gpu)
    cli["Back2Future ETL dump"] = phase_etl(gpu, step_ms["Back2Future"])
    phase_mnist(gpu)

    n_b2f, n_c6 = len(B2F_CASES), len(C6_CASES)
    corr_rows = {"fwd": fwd_rows, "bwd": bwd_rows}
    start = n_b2f + n_c6 + len(RAGGED_CASES)
    b1 = {"Back2Future": fwd_rows[start:start + n_b2f],
          "FlowNetC6": fwd_rows[start + n_b2f:start + n_b2f + 1]}
    corr_paths = {}
    for kind, k in (("fwd", 0), ("bwd", 1)):
        b2f, c6 = corr_rows[kind][:n_b2f], corr_rows[kind][n_b2f:n_b2f + n_c6]
        rows_of = {"Back2Future": b2f, "FlowNetC6": c6}

        def cli_entry(path, key, flownet):
            """One epoch of a CLI run: each step launches at the batch-4
            shapes, each training-image forward too (K1 only), each
            flow-validation forward at the batch-1 shapes (K1 only)."""
            k1, k1b, steps, outputs, items = cli[key]
            if kind == "bwd":
                n = LAUNCHES_PER_SHAPE * steps if k1b else 0
                return path_entry(path, rows_of[flownet], k1b, n)
            return path_entry(path, rows_of[flownet], k1,
                              LAUNCHES_PER_SHAPE * (steps + outputs),
                              more=[(b1[flownet],
                                     LAUNCHES_PER_SHAPE * items)])

        corr_paths[kind] = [
            path_entry("Back2Future train step", b2f,
                       launches["Back2Future", "step"][k]),
            path_entry("Back2Future train step fed by the loader", b2f,
                       loader_step[k]),
            path_entry("FlowNetC6 train step", c6,
                       launches["FlowNetC6", "step"][k]),
            cli_entry("Back2Future train CLI epoch", "Back2Future",
                      "Back2Future"),
            cli_entry("Back2Future train CLI epoch, --fix-flownet",
                      "Back2Future fix_flownet", "Back2Future"),
            cli_entry("FlowNetC6 train CLI epoch", "FlowNetC6",
                      "FlowNetC6"),
            cli_entry("Back2Future train CLI epoch on an ETL dump",
                      "Back2Future ETL dump", "Back2Future"),
            path_entry("Back2Future train step on each of 2 processes "
                       "sharing the card, 2 rows each",
                       corr_rows[kind][-len(B2_CASES):],
                       ddp_launches[0][k])]
        if kind == "fwd":
            corr_paths[kind] += [
                path_entry("Back2Future eval forward", b2f,
                           launches["Back2Future", "eval"][0]),
                path_entry("FlowNetC6 eval forward", c6,
                           launches["FlowNetC6", "eval"][0])]
            # an eval CLI run: each item's forward at the batch-1 shapes
            corr_paths[kind] += [
                path_entry(f"eval CLI {name}, {items} items", b1[flownet],
                           k1, EVAL_K1_PER_ITEM[flownet]
                           // len(b1[flownet]) * items)
                for name, (k1, items, flownet) in eval_k1.items()]
    # the bf16 instantiations: their rows at Back2Future's shapes,
    # FlowNetC6's, then (K1) Back2Future's at batch 1
    for kind, k in (("fwd", 0), ("bwd", 1)):
        rows = bf16_rows[kind]
        b2f, c6 = rows[:n_b2f], rows[n_b2f:n_b2f + n_c6]
        k1, k1b, steps, outputs, items = bf16["cli"]
        corr_paths[kind + "_bf16"] = [
            path_entry("Back2Future train step, guarded bf16", b2f,
                       bf16["step", "Back2Future"][k]),
            path_entry("FlowNetC6 train step, guarded bf16", c6,
                       bf16["step", "FlowNetC6"][k]),
            path_entry("Back2Future train CLI epoch, four bf16 flags", b2f,
                       k1b, LAUNCHES_PER_SHAPE * steps) if kind == "bwd"
            else path_entry("Back2Future train CLI epoch, four bf16 flags",
                            b2f, k1, LAUNCHES_PER_SHAPE * (steps + outputs),
                            more=[(rows[n_b2f + n_c6:],
                                   LAUNCHES_PER_SHAPE * items)])]
        if kind == "fwd":
            corr_paths[kind + "_bf16"] += [
                path_entry(f"{flownet} eval forward, bf16", rows_of,
                           bf16["eval", flownet])
                for flownet, rows_of in (("Back2Future", b2f),
                                         ("FlowNetC6", c6))]
    emit({"kernels": [
        kernel_entry("correlation_forward",
                     "cc_tpu_torch/ops/csrc/correlation.cu",
                     "cc_tpu/ops/correlation_pallas.py:77", fwd_rows,
                     corr_paths["fwd"]),
        kernel_entry("correlation_backward",
                     "cc_tpu_torch/ops/csrc/correlation.cu",
                     "cc_tpu/ops/correlation_pallas.py:112", bwd_rows,
                     corr_paths["bwd"]),
        kernel_entry("correlation_forward_bf16",
                     "cc_tpu_torch/ops/csrc/correlation.cu",
                     "cc_tpu/ops/correlation_pallas.py:77",
                     bf16_rows["fwd"], corr_paths["fwd_bf16"]),
        kernel_entry("correlation_backward_bf16",
                     "cc_tpu_torch/ops/csrc/correlation.cu",
                     "cc_tpu/ops/correlation_pallas.py:112",
                     bf16_rows["bwd"], corr_paths["bwd_bf16"]),
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
