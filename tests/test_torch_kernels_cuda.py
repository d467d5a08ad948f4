"""The port's CUDA kernels against their plain PyTorch versions, on a card:
the correlation forward (K1) and backward (K1'), the autograd Function that
joins them, and the row gather (K2); and FlowNetC6 through them: its
gradients on the card against the CPU's, and its train step's launches.

Every test here carries the `cuda` marker and skips without a CUDA device.
The file imports no JAX, so on a machine without JAX it runs without the
suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from cc_tpu_torch import models
from cc_tpu_torch.ops import correlation as tc
from cc_tpu_torch.ops import row_gather as rg
from cc_tpu_torch.train import (
    TrainConfig, build_train_step, make_models, make_optimizer,
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


@pytest.mark.parametrize("shape,patch,dilation", CORR_CASES)
def test_correlation_kernel_matches_plain(cuda, shape, patch, dilation):
    a, b = _randn(shape, cuda, 0), _randn(shape, cuda, 7)
    before = tc.launches
    out = tc.correlation(a, b, patch, dilation)
    ref = tc.correlation_plain(a, b, patch, dilation)
    torch.cuda.synchronize()
    assert tc.launches == before + 1
    assert_close(out, ref, ATOL, f"{shape} P={patch} d={dilation}")


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


def flownetc6_gradients(net, device) -> tuple[dict, dict, tuple]:
    """FlowNetC6 in training mode at 128x128, the six flows weighted by a
    fixed random cotangent: the gradients of both frames and of two stem
    layers on the CPU (plain correlation) and on `device`, and the K1 and
    K1' launches of the second run."""
    torch.backends.cudnn.allow_tf32 = False
    x1, x2 = _randn((1, 3, 128, 128), "cpu", 8), _randn((1, 3, 128, 128),
                                                         "cpu", 9)
    cots = [_randn((1, 2, 128 >> k, 128 >> k), "cpu", 10 + k)
            for k in range(6)]
    grads = []
    for dev in ("cpu", device):
        n = net.to(dev)
        n.zero_grad()
        a = x1.to(dev).detach().requires_grad_()
        b = x2.to(dev).detach().requires_grad_()
        tc.launches = tc.backward_launches = 0
        sum((c.to(dev) * f).sum() for c, f in zip(cots, n(a, b))).backward()
        grads.append({"x1": a.grad.cpu(), "x2": b.grad.cpu(),
                      "conv3": n.conv3[0].weight.grad.cpu().clone(),
                      "conv3_1": n.conv3_1[0].weight.grad.cpu().clone()})
    return grads[0], grads[1], (tc.launches, tc.backward_launches)


def test_flownetc6_gradients_match_cpu(cuda):
    """FlowNetC6's gradients (see flownetc6_gradients) on the card against
    the CPU's: the second frame reaches the flows only through K1 and K1',
    whose output gradient is a channel slice of a concatenation, permuted
    to NHWC."""
    cpu, card, launches = flownetc6_gradients(
        models.build("FlowNetC6").train(), cuda)
    assert launches == (1, 1)
    for k, e in cpu.items():
        assert_close(card[k], e, NET_RTOL * float(e.abs().max()), k)


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


if __name__ == "__main__":
    # FlowNetC6's gradients on the card against the CPU's, for the nets of
    # torch seeds 0..n-1: each error over its tolerance (NET_RTOL of the
    # largest entry). Run from the repository root:
    #   PYTHONPATH=. python tests/test_torch_kernels_cuda.py 15
    import json
    import sys
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in range(int(sys.argv[1]) if len(sys.argv) > 1 else 15):
        torch.manual_seed(seed)
        cpu, card, _ = flownetc6_gradients(
            models.build("FlowNetC6").train(), torch.device("cuda"))
        print(json.dumps({"seed": seed, "error_over_tolerance": {
            k: float((card[k] - e).abs().max())
            / (NET_RTOL * float(e.abs().max())) for k, e in cpu.items()}}),
            flush=True)
