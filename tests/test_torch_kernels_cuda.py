"""The port's CUDA kernels against their plain PyTorch versions, on a card:
the correlation forward (K1) and backward (K1'), the autograd Function that
joins them, and the row gather (K2); and FlowNetC6 through them: its
gradients on the card against the CPU's, and its train step's launches.
Besides the kernels: device_prefetch's batches against the host's under a
busy consumer, checkpoints moved between the card and the CPU, the train
CLI on the card against the same CLI on the CPU, a train step with a NaN
pixel (dropped, not crashed), and the MNIST demo's steps on the card
against the CPU's.

Every test here carries the `cuda` marker and skips without a CUDA device.
The file imports no JAX, so on a machine without JAX it runs without the
suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""
import ast
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cc_tpu_torch import models
from cc_tpu_torch.data import loader
from cc_tpu_torch.data.loader import device_prefetch
from cc_tpu_torch.ops import correlation as tc
from cc_tpu_torch.ops import row_gather as rg
from cc_tpu_torch.train import (
    NETS, TrainConfig, build_train_step, load_checkpoint, make_models,
    make_optimizer, save_checkpoint,
)
# Imported through tests/ itself, which pytest puts on the path: where an
# installed package is named `tests`, that package hides tests.torch_port_util.
from torch_port_util import assert_close

# fp32 sums of C products taken in another order than the plain version's
ATOL = 1e-5
# FlowNetC6 on the card against the CPU: cuDNN and oneDNN convs sum in
# other orders; relative to each gradient's largest entry
NET_RTOL = 1e-3
CORR_CASES = [
    ((2, 5, 7, 3), 9, 1),          # ragged: W and C below one tile
    ((2, 16, 80, 32), 9, 1),       # several w-tiles, one partial
    ((1, 12, 20, 20), 21, 2),      # FlowNetC6's patch and dilation
    ((1, 6, 9, 17), 3, 3),
]
# Each tile configuration of the backward (correlation.cu, launch_bwd: 16
# or 56 pixels of one residue class a block, 32 to 256 channels, the
# channel block halved while the grid has fewer than 132 blocks) and its
# ragged edges, beside CORR_CASES' 16-pixel tiles of 32 channels
BWD_CASES = [
    ((1, 5, 70, 20), 9, 1),       # 56 pixels, 32 channels: W off the tile
    ((1, 5, 40, 17), 3, 1),       # C not a multiple of 4: 4-byte copies
    ((2, 12, 61, 72), 7, 1),      # 64 channels, C not a multiple of them
    ((2, 20, 66, 64), 9, 1),      # 64 channels, C = 64
    ((2, 17, 75, 128), 5, 2),     # 128 channels, d=2 with odd W
    ((3, 11, 26, 100), 9, 1),     # 16 pixels, 64 channels, ragged C
    ((4, 4, 13, 192), 9, 1),      # Back2Future's coarsest level: 16
                                  # pixels, 32 channels (halved twice)
    ((4, 32, 104, 256), 21, 2),   # FlowNetC6's: 256 channels
]
# The forward's tile configurations (correlation.cu, fwd_shape: 56 pixels
# of one residue class a block, 8 a thread up to P = 9 and 4 above; 16
# pixels, 2 a thread, on rows of at most 32 a residue; chunks of 32
# channels, 64 on narrow rows of more than 64) that CORR_CASES and
# BWD_CASES leave out, and their ragged edges
FWD_CASES = [
    ((1, 6, 90, 36), 21, 1),      # 56 x 4: W off the tile, C off the chunk,
                                  # H under the reach
    ((2, 9, 83, 30), 21, 2),      # 56 x 4: d=2 with odd W, 4-byte copies
    ((1, 4, 30, 64), 9, 1),       # 16 x 2, two 32-channel chunks
    ((1, 5, 100, 8), 3, 3),       # 56 x 8 over three residue classes
]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, device, seed=0):
    r = np.random.RandomState(seed)
    return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("shape,patch,dilation",
                         CORR_CASES + BWD_CASES + FWD_CASES)
def test_correlation_kernel_matches_plain(cuda, shape, patch, dilation):
    a, b = _randn(shape, cuda, 0), _randn(shape, cuda, 7)
    before = tc.launches
    out = tc.correlation(a, b, patch, dilation)
    ref = tc.correlation_plain(a, b, patch, dilation)
    torch.cuda.synchronize()
    assert tc.launches == before + 1
    assert_close(out, ref, ATOL, f"{shape} P={patch} d={dilation}")
    # sums in a fixed order, no atomics: the same bits on every run
    assert torch.equal(tc.correlation_cuda(a, b, patch, dilation), out)


def _one_bf16_rounding(out, wide, scale, where: str) -> None:
    """A bf16 kernel's output against its plain version's float32 sum
    before the one rounding (`wide`): one bf16 rounding, 2**-8 of the
    value, plus a sum-order term, 2**-20 of the sum of the terms'
    magnitudes (`scale`)."""
    assert out.dtype == torch.bfloat16, where
    excess = float(((out.float() - wide).abs() - 2.0 ** -8 * wide.abs()
                    - 2.0 ** -20 * scale).max())
    assert excess <= 0, f"{where}: {excess} beyond one bf16 rounding"


def _bf16_kernels_against_plain(a, b, g, patch, dilation, where) -> None:
    wa, wb, wg = a.float(), b.float(), g.float()
    before = (tc.dtype_launches[torch.bfloat16],
              tc.dtype_backward_launches[torch.bfloat16])
    out = tc.correlation_cuda(a, b, patch, dilation)
    dfs = tc.correlation_backward_cuda(a, b, g, patch, dilation)
    torch.cuda.synchronize()
    assert (tc.dtype_launches[torch.bfloat16],
            tc.dtype_backward_launches[torch.bfloat16]) == (
        before[0] + 1, before[1] + 1)
    _one_bf16_rounding(out, tc.correlation_plain(wa, wb, patch, dilation),
                       tc.correlation_plain(wa.abs(), wb.abs(), patch,
                                            dilation), where + " K1")
    wide = tc.correlation_backward_plain(wa, wb, wg, patch, dilation)
    scale = tc.correlation_backward_plain(wa.abs(), wb.abs(), wg.abs(),
                                          patch, dilation)
    for i in range(2):
        _one_bf16_rounding(dfs[i], wide[i], scale[i], f"{where} K1' df{i + 1}")
    # sums in a fixed order, no atomics: the same bits on every run
    assert torch.equal(tc.correlation_cuda(a, b, patch, dilation), out)
    assert all(map(torch.equal, tc.correlation_backward_cuda(
        a, b, g, patch, dilation), dfs))


@pytest.mark.parametrize("shape,patch,dilation",
                         CORR_CASES + BWD_CASES + FWD_CASES)
def test_bf16_correlation_kernels_match_plain(cuda, shape, patch, dilation):
    """The bf16 instantiations of K1 and K1' at every tile configuration
    and ragged edge of the float32 ones (C off 8 stages element by
    element), each launch counted as bf16."""
    bf = lambda t: t.to(torch.bfloat16)
    a, b = bf(_randn(shape, cuda, 0)), bf(_randn(shape, cuda, 7))
    g = bf(_randn((*shape[:3], patch * patch), cuda, 3))
    _bf16_kernels_against_plain(a, b, g, patch, dilation,
                                f"{shape} P={patch} d={dilation}")


def test_bf16_correlation_kernels_take_unaligned_inputs(cuda):
    """bf16 inputs that start 2 bytes off a 16-byte boundary: both kernels
    then stage element by element."""
    shape, patch = (2, 6, 70, 32), 9
    n = int(np.prod(shape))
    views = []
    for seed in (0, 7):
        t = torch.zeros(n + 1, device=cuda, dtype=torch.bfloat16)[1:]
        views.append(t.view(shape))
        views[-1].copy_(_randn(shape, cuda, seed))
    a, b = views
    assert a.is_contiguous() and a.data_ptr() % 16 == 2
    g = _randn((*shape[:3], patch * patch), cuda, 3).to(torch.bfloat16)
    _bf16_kernels_against_plain(a, b, g, patch, 1, "unaligned")


def test_bf16_correlation_autograd_runs_the_bf16_kernels(cuda):
    """`correlation` on bf16 CUDA tensors: a bf16 cost volume from K1 and
    bf16 gradients from K1', equal to the kernels' own outputs; a dtype
    the kernels lack raises rather than fall back."""
    shape, patch = (2, 8, 30, 64), 9
    a = _randn(shape, cuda, 0).to(torch.bfloat16).requires_grad_()
    b = _randn(shape, cuda, 7).to(torch.bfloat16).requires_grad_()
    g = _randn((*shape[:3], patch * patch), cuda, 3).to(torch.bfloat16)
    out = tc.correlation(a, b, patch)
    out.backward(g)
    assert out.dtype == a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert torch.equal(out, tc.correlation_cuda(a.detach(), b.detach(),
                                                patch))
    df1, df2 = tc.correlation_backward_cuda(a.detach(), b.detach(), g, patch)
    assert torch.equal(a.grad, df1) and torch.equal(b.grad, df2)
    with pytest.raises(TypeError):
        tc.correlation(a.detach().half(), b.detach().half(), patch)


def test_correlation_kernel_takes_unaligned_inputs(cuda):
    """Contiguous inputs that start 4 bytes off a 16-byte boundary: the
    forward then stages by 4-byte copies."""
    shape, patch = (2, 6, 70, 32), 9
    n = int(np.prod(shape))
    a = torch.zeros(n + 1, device=cuda)[1:].view(shape)
    b = torch.zeros(n + 1, device=cuda)[1:].view(shape)
    a.copy_(_randn(shape, cuda, 0))
    b.copy_(_randn(shape, cuda, 7))
    assert a.is_contiguous() and a.data_ptr() % 16 == 4
    out = tc.correlation_cuda(a, b, patch)
    assert_close(out, tc.correlation_plain(a, b, patch), ATOL, "unaligned")


def test_correlation_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros(1, 4, 4, 8, device=cuda)
    with pytest.raises(TypeError):
        tc.correlation_cuda(a.double(), a.double(), 9)
    with pytest.raises(ValueError):
        tc.correlation_cuda(a, a, 8)
    with pytest.raises(ValueError):
        tc.correlation_cuda(a.transpose(1, 2), a.transpose(1, 2), 9)
    g = torch.zeros(1, 4, 4, 81, device=cuda)
    with pytest.raises(ValueError):
        tc.correlation_backward_cuda(a, a, g[..., :80], 9)
    with pytest.raises(ValueError):
        tc.correlation_backward_cuda(a, a, g.transpose(1, 2), 9)


@pytest.mark.parametrize("shape,patch,dilation", CORR_CASES + BWD_CASES)
def test_correlation_backward_kernel_matches_plain(cuda, shape, patch,
                                                   dilation):
    a, b = _randn(shape, cuda, 1), _randn(shape, cuda, 2)
    g = _randn((*shape[:3], patch * patch), cuda, 3)
    before = tc.backward_launches
    df1, df2 = tc.correlation_backward_cuda(a, b, g, patch, dilation)
    ref1, ref2 = tc.correlation_backward_plain(a, b, g, patch, dilation)
    torch.cuda.synchronize()
    assert tc.backward_launches == before + 1
    # sums of up to P*P*... products taken in another order
    assert_close(df1, ref1, ATOL, f"df1 {shape} P={patch} d={dilation}")
    assert_close(df2, ref2, ATOL, f"df2 {shape} P={patch} d={dilation}")
    # gathers only, no atomics: the same bits on every run
    again = tc.correlation_backward_cuda(a, b, g, patch, dilation)
    assert torch.equal(again[0], df1) and torch.equal(again[1], df2)


@pytest.mark.parametrize("shape,patch,dilation", CORR_CASES[:3])
def test_correlation_function_gradients_match_autograd_of_plain(
        cuda, shape, patch, dilation):
    """Autograd through `correlation` (K1 and K1') against autograd through
    correlation_plain, with a non-contiguous output gradient as
    Back2Future's reorder-and-permute gives."""
    a, b = _randn(shape, cuda, 4), _randn(shape, cuda, 5)
    cot = _randn((*shape[:3], patch * patch), cuda, 6)
    perm = torch.randperm(patch * patch, device=cuda)
    grads = []
    for fn in (tc.correlation, tc.correlation_plain):
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        out = fn(x, y, patch, dilation)[..., perm].permute(0, 3, 1, 2)
        (out * cot[..., perm].permute(0, 3, 1, 2)).sum().backward()
        grads.append((x.grad, y.grad))
    assert_close(grads[0][0], grads[1][0], ATOL, "df1")
    assert_close(grads[0][1], grads[1][1], ATOL, "df2")


@pytest.mark.parametrize("rows,n,w", [(256, 256, 832), (9, 5, 7)])
def test_row_gather_kernel_matches_plain(cuda, rows, n, w):
    r = np.random.RandomState(rows)
    img = torch.from_numpy(r.rand(rows, w).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(r.randint(-rows // 4, rows + rows // 4, (n, w))
                           .astype(np.int32)).to(cuda)
    before = rg.launches
    out = rg.row_gather(img, idx)
    ref = rg.row_gather_plain(img, idx)
    torch.cuda.synchronize()
    assert rg.launches == before + 1
    assert_close(out, ref, 0.0, f"[{rows},{w}] by [{n},{w}]")


def test_row_gather_kernel_rejects_what_it_does_not_take(cuda):
    img = torch.zeros(4, 6, device=cuda)
    idx = torch.zeros(4, 6, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        rg.row_gather_cuda(img, idx.long())
    with pytest.raises(ValueError):
        rg.row_gather_cuda(img, idx[:, :5])
    with pytest.raises(ValueError):
        rg.row_gather_cuda(img.t(), idx.t())


def _flownetc6_inputs():
    """Two 128x128 frames and a cotangent for each of the six flows."""
    x1, x2 = _randn((1, 3, 128, 128), "cpu", 8), _randn((1, 3, 128, 128),
                                                         "cpu", 9)
    cots = [_randn((1, 2, 128 >> k, 128 >> k), "cpu", 10 + k)
            for k in range(6)]
    return x1, x2, cots


def flownetc6_layer_errors(net, device) -> list[dict]:
    """FlowNetC6 run as flownetc6_gradients runs it, on the CPU and on
    `device`, compared call by call: for each call of each leaf module in
    order, and for the cost volume before its LeakyReLU, the largest error
    of the output and of its gradient on `device`, relative to the largest
    entry of the CPU's; and the output's entries whose sign differs, with
    the largest of them relative to the same entry."""
    torch.backends.cudnn.allow_tf32 = False
    x1, x2, cots = _flownetc6_inputs()
    runs = []
    for dev in ("cpu", device):
        n = net.to(dev)
        n.zero_grad()
        calls = []

        def keep(name, out):
            out.retain_grad()
            calls.append((name, out))
            return out

        hooks = [m.register_forward_hook(
                     lambda m, i, o, name=name: keep(name, o))
                 for name, m in n.named_modules() if not list(m.children())]
        correlate = n._correlate
        n._correlate = lambda a, b: keep("cost_volume", correlate(a, b))
        try:
            flows = n(x1.to(dev), x2.to(dev))
            sum((c.to(dev) * f).sum() for c, f in zip(cots, flows)).backward()
        finally:
            del n._correlate
            for h in hooks:
                h.remove()
        runs.append([(k, o.detach().cpu(), o.grad.cpu()) for k, o in calls])
    rows = []
    for (k, oc, gc), (_, o, g) in zip(*runs):
        top = float(oc.abs().max())
        flips = (oc > 0) != (o > 0)
        rows.append({"call": k, "output": float((o - oc).abs().max()) / top,
                     "gradient": float((g - gc).abs().max()
                                       / gc.abs().max()),
                     "sign_flips": int(flips.sum()),
                     "largest_flipped": float(oc[flips].abs().max()) / top
                     if flips.any() else 0.0})
    return rows


@contextlib.contextmanager
def leaky_relu_slopes(masks: list, record: bool):
    """F.leaky_relu with each call's slope chosen by a sign mask: with
    `record`, the input's own (x > 0), appended to `masks` in call order,
    which is leaky_relu itself; else the masks recorded before, taken in
    the same order. Every LeakyReLU of the nets and FlowNetC6's functional
    one on the cost volume go through F.leaky_relu."""
    plain = torch.nn.functional.leaky_relu
    recorded = iter(masks)

    def leaky_relu(x, negative_slope=0.01, inplace=False):
        if record:
            mask = x.detach() > 0
            masks.append(mask.cpu())
        else:
            mask = next(recorded).to(x.device)
        return torch.where(mask, x, x * negative_slope)

    torch.nn.functional.leaky_relu = leaky_relu
    try:
        yield
    finally:
        torch.nn.functional.leaky_relu = plain


def flownetc6_gradients(net, device) -> tuple[dict, dict, tuple]:
    """FlowNetC6 in training mode at 128x128, the six flows weighted by a
    fixed random cotangent: the gradients of both frames and of two stem
    layers on the CPU (plain correlation) and on `device`, and the K1 and
    K1' launches of the second run.

    Both runs take the CPU's LeakyReLU slopes (leaky_relu_slopes): cuDNN's
    and the CPU's fp32 convolutions round apart by about 3e-6 of a layer's
    largest entry, and a pre-activation within that of zero would
    otherwise take the other slope on one device (FlowNetC6's conv3 at
    torch seed 14: 8.5e-8 from zero, the gradient 0.284 off)."""
    torch.backends.cudnn.allow_tf32 = False
    x1, x2, cots = _flownetc6_inputs()
    grads, masks = [], []
    for dev in ("cpu", device):
        n = net.to(dev)
        n.zero_grad()
        a = x1.to(dev).detach().requires_grad_()
        b = x2.to(dev).detach().requires_grad_()
        tc.launches = tc.backward_launches = 0
        with leaky_relu_slopes(masks, record=dev == "cpu"):
            flows = n(a, b)
        sum((c.to(dev) * f).sum() for c, f in zip(cots, flows)).backward()
        grads.append({"x1": a.grad.cpu(), "x2": b.grad.cpu(),
                      "conv3": n.conv3[0].weight.grad.cpu().clone(),
                      "conv3_1": n.conv3_1[0].weight.grad.cpu().clone()})
    return grads[0], grads[1], (tc.launches, tc.backward_launches)


def test_flownetc6_gradients_match_cpu(cuda):
    """FlowNetC6's gradients (see flownetc6_gradients) on the card against
    the CPU's, both with the CPU's LeakyReLU slopes: the second frame
    reaches the flows only through K1 and K1', whose output gradient is a
    channel slice of a concatenation, permuted to NHWC."""
    cpu, card, launches = flownetc6_gradients(
        models.build("FlowNetC6").train(), cuda)
    assert launches == (1, 1)
    for k, e in cpu.items():
        assert_close(card[k], e, NET_RTOL * float(e.abs().max()), k)


TESTS = os.path.dirname(os.path.abspath(__file__))


def test_nan_pixel_step_on_the_card_is_dropped(cuda):
    """The CPU test's batch with one NaN pixel
    (torch_port_util.nan_pixel_step) through a train step on the card:
    CUDA's border-padded warps (the CPU's stand-in is not used on the
    card) give non-finite gradients and skip_nonfinite_updates drops the
    step; the process does not crash. In a subprocess, as on the CPU."""
    script = ("from torch_port_util import nan_pixel_step; "
              "print(nan_pixel_step('cuda'))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(TESTS), TESTS]))
    res = subprocess.run([sys.executable, "-c", script], cwd=TESTS, env=env,
                         capture_output=True, text=True, timeout=600)
    print(res.returncode, res.stdout[-500:], res.stderr[-2000:])
    assert res.returncode == 0, res.returncode
    got = ast.literal_eval(res.stdout.strip().splitlines()[-1])
    assert got == {"count": 0, "notfinite": 1, "step": 1,
                   "loss_finite": False, "unchanged": True}, got


def test_flownetc6_train_step_launches(cuda):
    """FlowNetC6's train step makes 2 K1 and 2 K1' launches (F runs once
    per direction); a fix_flownet step on the same nets and state makes 2
    K1 and 0 K1', and leaves F bit-equal."""
    cfg = TrainConfig(height=128, width=128, batch_size=2,
                      flownet="FlowNetC6")
    nets = make_models(cfg, device=cuda)
    opt_state = make_optimizer(cfg).init(nets)
    r = np.random.RandomState(0)
    k = np.array([[128, 0, 64], [0, 128, 64], [0, 0, 1]], np.float32)
    batch = {"tgt": r.rand(2, 128, 128, 3).astype(np.float32) * 2 - 1,
             "refs": r.rand(2, 4, 128, 128, 3).astype(np.float32) * 2 - 1,
             "intrinsics": np.stack([k, k]),
             "intrinsics_inv": np.stack([np.linalg.inv(k)] * 2)}
    counts = []
    for fixed in (False, True):
        step = build_train_step(cfg.replace(fix_flownet=fixed), nets,
                                opt_state)
        before = [p.detach().clone() for p in nets["flow"].parameters()]
        tc.launches = tc.backward_launches = 0
        metrics = step(batch)
        torch.cuda.synchronize()
        counts.append((tc.launches, tc.backward_launches))
        assert all(torch.isfinite(v) for v in metrics.values())
        same = all(torch.equal(a, p) for a, p in
                   zip(before, nets["flow"].parameters()))
        assert same == fixed
    assert counts == [(2, 2), (2, 0)]


def _host_batch(i: int, dtype) -> dict:
    """Batch i of a stream, in the train step's layout, from seed i."""
    r = np.random.RandomState(i)
    draw = lambda *shape: (r.randint(0, 256, shape).astype(dtype)
                           if dtype == np.uint8
                           else r.rand(*shape).astype(dtype))
    k = r.rand(4, 3, 3).astype(np.float32)
    return {"tgt": draw(4, 128, 416, 3), "refs": draw(4, 4, 128, 416, 3),
            "intrinsics": k, "intrinsics_inv": k + 1}


def _spin(ms: float):
    """Keep the current stream busy for at least `ms` (cycles at 2 GHz, an
    H100's highest clock or above)."""
    torch.cuda._sleep(int(ms * 2_000_000))


# (side stream's delay before each batch's copies, consumer stream's spin
# before it reads each batch), in ms. "reuse": copies run ahead of reads
# that are still queued, so a pinned buffer refilled before its copy ran,
# or device memory handed to the next copy while the consumer's read of it
# is queued, shows in a batch. "wait": the copies come after the consumer
# would read at once, so a read that does not wait for its copy shows.
PREFETCH_TIMING = {"reuse": (5.0, 20.0), "wait": (20.0, 0.0)}


@pytest.mark.parametrize("timing", sorted(PREFETCH_TIMING))
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_device_prefetch_batches_equal_the_hosts_under_a_busy_consumer(
        cuda, dtype, timing, monkeypatch):
    """50 batches, drawn beforehand so that they are put back to back,
    through the smallest ring (size 1: two pinned buffers). The side stream
    is held back before each batch's copies, and the consumer's stream spins
    before it reads each batch; each batch is dropped once read. Each
    batch's copy, read at once and read after the spin, must equal the
    host's bits."""
    side_ms, consumer_ms = PREFETCH_TIMING[timing]
    stage = loader._PinnedSlot.stage

    def held_back_stage(slot, batch):
        host = stage(slot, batch)
        # staged under the side stream: delay its copies
        assert torch.cuda.current_stream() != torch.cuda.default_stream()
        _spin(side_ms)
        return host

    monkeypatch.setattr(loader._PinnedSlot, "stage", held_back_stage)
    n = 50
    host = [_host_batch(i, dtype) for i in range(n)]
    copies = []
    for batch in device_prefetch(iter(host), cuda, size=1):
        assert all(t.device.type == "cuda" for t in batch.values())
        first = {k: v.clone() for k, v in batch.items()}
        _spin(consumer_ms)
        copies.append((first, {k: v.clone() for k, v in batch.items()}))
        del batch
    torch.cuda.synchronize()
    assert len(copies) == n
    for i, got in enumerate(copies):
        for k, v in host[i].items():
            for when, c in zip(("at once", "after the spin"), got):
                mine = c[k].cpu().numpy()
                assert mine.dtype == v.dtype and np.array_equal(mine, v), \
                    (i, k, when)


def _scene_folders(root) -> str:
    """Two scenes of 6 smooth 128x128 JPEGs with cam.txt, in train.txt."""
    import cv2
    r = np.random.RandomState(0)
    for s in ("drive_a_02", "drive_b_02"):
        (root / s).mkdir(parents=True)
        (root / s / "cam.txt").write_text("115.,0.,64.,0.,115.,64.,0.,0.,1.")
        base = cv2.GaussianBlur((r.rand(144, 144, 3) * 255).astype(np.uint8),
                                (21, 21), 8)
        for i in range(6):
            cv2.imwrite(str(root / s / f"{i:07d}.jpg"),
                        base[i:i + 128, 2 * i:2 * i + 128])
    (root / "train.txt").write_text("drive_a_02\ndrive_b_02\n")
    return str(root)


def _kitti2015(root, items: int = 2, h: int = 40, w: int = 100) -> str:
    """A KITTI 2015 training tree: frames 08-12, flow_occ (flow within
    +-30 px, 70 % valid), obj_map and calibration."""
    import cv2
    from cc_tpu_torch.utils.flow_io import flow_write_png
    r = np.random.RandomState(2)
    mv = root / "data_scene_flow_multiview" / "training" / "image_2"
    occ = root / "data_scene_flow" / "training" / "flow_occ"
    obj = root / "data_scene_flow" / "training" / "obj_map"
    cal = root / "data_scene_flow_calib" / "training" / "calib_cam_to_cam"
    for d in (mv, occ, obj, cal):
        d.mkdir(parents=True)
    for i in range(items):
        i6 = f"{i:06d}"
        for f in range(8, 13):
            cv2.imwrite(str(mv / f"{i6}_{f:02d}.png"), cv2.GaussianBlur(
                (r.rand(h, w, 3) * 255).astype(np.uint8), (7, 7), 2))
        u, v = (np.round(r.uniform(-30, 30, (h, w)) * 64) / 64
                for _ in range(2))
        flow_write_png(str(occ / f"{i6}_10.png"), u, v,
                       (r.rand(h, w) > 0.3).astype(np.uint16))
        cv2.imwrite(str(obj / f"{i6}_10.png"),
                    r.randint(0, 3, (h, w)).astype(np.uint8))
        (cal / f"{i6}.txt").write_text(
            f"P_rect_02: 70 0 {w / 2} 1 0 71 {h / 2} 2 0 0 1 0\n")
    return str(root)


# The train CLI's flow validation on the card against the CPU's after the
# same 2 steps: the EPEs within CLI_EPE_RTOL (the card-vs-CPU forward
# tolerance of chip_smoke.py, whose steps also leave parameters up to
# 2*lr apart per step), and the outlier shares within CLI_EDGE_PIXELS
# pixels of the valid ones
CLI_EPE_RTOL = 1e-3
CLI_EDGE_PIXELS = 3


def test_train_cli_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """python -m cc_tpu_torch.cli.train at 128x128 batch 2, 2 steps with
    flow validation over 2 KITTI items, on the card (10 K1 and 10 K1' per
    step, 10 K1 per validation item) and on the CPU (no launch) from the
    same seed: the validation errors agree."""
    from cc_tpu_torch.cli import train as cli
    argv = [_scene_folders(tmp_path / "scenes"), "--name", "x", "--height",
            "128", "--width", "128", "-b", "2", "--epochs", "1",
            "--epoch-size", "2", "-j", "2", "--loader", "python",
            "--with-flow-gt", "--kitti-dir", _kitti2015(tmp_path / "kitti"),
            "--val-flow-height", "128", "--val-flow-width", "128",
            "--val-flow-N", "2", "--lr", "1e-4"]
    records, launches = {}, {}
    for dev in ("cuda", "cpu"):
        (tmp_path / dev).mkdir()
        monkeypatch.chdir(tmp_path / dev)
        tc.launches = tc.backward_launches = 0
        records[dev], = cli.main(argv + ["--device", dev])
        launches[dev] = (tc.launches, tc.backward_launches)
    assert launches == {"cuda": (2 * 10 + 2 * 10, 2 * 10), "cpu": (0, 0)}
    gpu, cpu = records["cuda"], records["cpu"]
    assert gpu["steps"] == cpu["steps"] == 2
    n_valid = 0.7 * 40 * 100 * 0.9  # well under each item's valid pixels
    print({n: abs(a - e) for n, a, e in
           zip(cli.FLOW_NAMES, gpu["flow_errors"], cpu["flow_errors"])})
    for n, a, e in zip(cli.FLOW_NAMES, gpu["flow_errors"],
                       cpu["flow_errors"]):
        tol = (CLI_EDGE_PIXELS / n_valid if n.startswith("outliers")
               else CLI_EPE_RTOL * abs(e))
        assert abs(a - e) <= tol, (n, a, e)


def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """A checkpoint saved from nets on the card loads into nets on the CPU
    and the other way round, every tensor and count equal."""
    cfg = TrainConfig(height=128, width=128, batch_size=2)

    def state(device, seed):
        nets = make_models(cfg, device=device,
                           generator=torch.Generator().manual_seed(seed))
        opt_state = make_optimizer(cfg).init(nets)
        gen = torch.Generator().manual_seed(seed)
        for n in NETS:
            for t in opt_state.mu[n] + opt_state.nu[n]:
                t.copy_(torch.rand(t.shape, generator=gen))
        opt_state.count, opt_state.notfinite, opt_state.step = seed, 1, 7
        return nets, opt_state

    def same(a, b):
        (na, sa), (nb, sb) = a, b
        assert all(torch.equal(x.cpu(), y.cpu()) for x, y in
                   zip(na.state_dict().values(), nb.state_dict().values()))
        for n in NETS:
            assert all(torch.equal(x.cpu(), y.cpu()) for x, y in
                       zip(sa.mu[n] + sa.nu[n], sb.mu[n] + sb.nu[n]))
        assert (sa.count, sa.notfinite, sa.step) == \
            (sb.count, sb.notfinite, sb.step)

    for src, dst in ((cuda, "cpu"), ("cpu", cuda)):
        saved = state(src, 3)
        path = save_checkpoint(str(tmp_path / str(src)), *saved)
        loaded = state(dst, 4)
        load_checkpoint(path, *loaded)
        assert next(loaded[0].parameters()).device.type == \
            torch.device(dst).type
        same(saved, loaded)


# The MNIST demo's steps on the card against the CPU's: fp32 losses of
# LeNets summed in another order by cuDNN and oneDNN, relative to each
# metric; Adam moves a parameter by about lr*sign(grad) a step, so the two
# may differ by 2*lr a step where a near-zero gradient takes the other sign
MNIST_METRIC_RTOL = 1e-4
MNIST_LR = 1e-3


def test_mnist_steps_on_the_card_match_the_cpu(cuda):
    """4 MNIST CC steps, compete and collaborate in turns, from the same
    weights and batches on the card and on the CPU: the metrics, both
    optimizers' counts, and every parameter."""
    from cc_tpu_torch.mnist import train as mnist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mnist.MnistConfig(lr=MNIST_LR)
    states = [mnist.init_mnist_state(cfg, d, torch.Generator().manual_seed(0))
              for d in (cuda, "cpu")]
    steps = (mnist.make_compete_step(cfg), mnist.make_collaborate_step(cfg))
    r = np.random.RandomState(0)
    for i in range(4):
        target = r.randint(0, 10, 64)
        img = r.rand(64, 28, 28, 1).astype(np.float32) * 0.1
        for j, t in enumerate(target):  # a class-dependent square
            img[j, t:t + 8, t:t + 8, 0] += 1.0
        card, cpu = (steps[i % 2](st, img, target) for st in states)
        for k, e in cpu.items():
            e = float(e)
            assert abs(float(card[k]) - e) <= MNIST_METRIC_RTOL * max(1, abs(e)), (i, k)
    a, b = states
    assert (a.opt_compete.count, a.opt_collaborate.count, a.step) == \
        (b.opt_compete.count, b.opt_collaborate.count, b.step) == (2, 2, 4)
    for n in mnist.NETS:
        for (k, x), y in zip(a.nets[n].state_dict().items(),
                             b.nets[n].state_dict().values()):
            assert_close(x, y, 2 * MNIST_LR * 4 + 1e-6, f"{n}.{k}")


# Two processes on the card against one, both on the card: the metrics
# relative to each; Adam's moments relative to each net's largest entry
# (a moment near zero may take the other sign); BatchNorm stats relative
# to their magnitude; parameters within 2*lr after a step, and at most
# DDP_MOVED_SHARE of their entries more than 1e-6 apart (chip_smoke.py's
# compare_train_states holds the bench-size run to the same)
DDP_METRIC_RTOL = 1e-3
# bench.py:80-112's loss weights (chip_smoke.py's BENCH). At 128x128 the
# nets' gradients are ill-conditioned (ReLU pre-activations within
# rounding of zero in maps of 1x1 to 8x8): with the default weights one
# process on the card against the CPU is 8.9x this test's moment bound
# for F, and with these two processes against one 1.15x for D
BENCH = dict(wssim=0.997, smoothness_type="edgeaware",
             cam_photo_loss_weight=1.0, mask_loss_weight=0.1,
             smooth_loss_weight=0.1, flow_photo_loss_weight=0.5,
             consensus_loss_weight=0.3, lr=1e-4)
DDP_MOMENT_RTOL = 2e-3
DDP_STATS_RTOL = 1e-4
DDP_MOVED_SHARE = 0.01


def test_two_processes_on_one_card_match_one_process(cuda, tmp_path):
    """Two processes under torchrun sharing the card through gloo, 2 rows
    each of a global batch of 4 whose rows differ
    (torch_port_util.rows_differ_batch) at bench.py's point (832x256, its
    loss weights), against one process with all 4 rows, from the same
    weights: after a step, the metrics, moments,
    parameters and BatchNorm stats; then, from the same weights again, a
    step and a fix_flownet step: their metrics, 10 K1 and 10 K1' launches
    on each process in the step and 10 and 0 in the fix_flownet step, as
    one process makes, and the two processes bit-equal. (Adam's second
    step carries the first one's sign flips of near-zero gradients on, so
    the state after it is not held to the one process's.)"""
    from torch_port_util import rows_differ_batch, run_steps, torchrun
    cfg = TrainConfig(height=256, width=832, batch_size=4, **BENCH)
    nets = make_models(cfg, device="cpu")
    spec = {"device": "cuda", "config": {k: getattr(cfg, k) for k in
                                         cfg.__dataclass_fields__},
            "nets": nets.state_dict(),
            "batch": rows_differ_batch(256, 832, b=4),
            "runs": [[{}], [{}, {"fix_flownet": True}]]}
    one = run_steps(spec, cuda)
    files = [tmp_path / n for n in ("spec.pt", "rank0.pt", "rank1.pt")]
    try:
        torch.save(spec, files[0])
        out = torchrun(["tests/torch_port_util.py", "steps", str(files[0]),
                        str(tmp_path)])
        ranks = [torch.load(f) for f in files[1:]]
    finally:  # about 2.7 GB of weights and moments
        for f in files:
            f.unlink(missing_ok=True)
    launches = [run["launches"] for run in one]
    assert launches == [[(10, 10)], [(10, 10), (10, 0)]]
    for r in ranks:
        assert (r["world"], r["backend"], r["device"]) == (2, "gloo",
                                                           "cuda:0"), out
        assert [run["launches"] for run in r["runs"]] == launches
        for m0, m1 in zip(one[0]["metrics"] + one[1]["metrics"],
                          r["runs"][0]["metrics"] + r["runs"][1]["metrics"]):
            for k, e in m0.items():
                assert abs(m1[k] - e) <= DDP_METRIC_RTOL * abs(e), (k, m1, e)
    a, b = (r["runs"][1]["state"] for r in ranks)
    assert a["counts"] == b["counts"] == (2, 0, 2)
    assert all(torch.equal(v, b["nets"][k]) for k, v in a["nets"].items())

    ref, mine = one[0]["state"], ranks[0]["runs"][0]["state"]
    for group in ("mu", "nu"):
        for n in NETS:
            scale = max(float(t.abs().max()) for t in ref[group][n])
            for i, (x, e) in enumerate(zip(mine[group][n], ref[group][n])):
                assert_close(x, e, DDP_MOMENT_RTOL * scale, f"{group} {n}.{i}")
    moved = total = 0
    for k, e in ref["nets"].items():
        if not e.is_floating_point():
            continue
        if k.endswith(("running_mean", "running_var")):
            assert_close(mine["nets"][k], e,
                         DDP_STATS_RTOL * max(1.0, float(e.abs().max())), k)
        else:
            assert_close(mine["nets"][k], e, 2 * cfg.lr + 1e-6, k)
            moved += int(((mine["nets"][k] - e).abs() > 1e-6).sum())
            total += e.numel()
    assert moved <= DDP_MOVED_SHARE * total, (moved, total)


if __name__ == "__main__":
    # FlowNetC6's gradients on the card against the CPU's, for the nets of
    # torch seeds 0..n-1: each error over its tolerance (NET_RTOL of the
    # largest entry); or, with --layers, for the net of one seed, call by
    # call (flownetc6_layer_errors). Run from the repository root:
    #   PYTHONPATH=. python tests/test_torch_kernels_cuda.py 15
    #   PYTHONPATH=. python tests/test_torch_kernels_cuda.py --layers 14
    import json
    import sys
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:2] == ["--layers"]:
        torch.manual_seed(int(sys.argv[2]))
        for row in flownetc6_layer_errors(models.build("FlowNetC6").train(),
                                          torch.device("cuda")):
            print(json.dumps({"seed": int(sys.argv[2]), **row}))
        sys.exit(0)
    for seed in range(int(sys.argv[1]) if len(sys.argv) > 1 else 15):
        torch.manual_seed(seed)
        cpu, card, _ = flownetc6_gradients(
            models.build("FlowNetC6").train(), torch.device("cuda"))
        print(json.dumps({"seed": seed, "error_over_tolerance": {
            k: float((card[k] - e).abs().max())
            / (NET_RTOL * float(e.abs().max())) for k, e in cpu.items()}}),
            flush=True)
