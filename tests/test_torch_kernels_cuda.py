"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs a CUDA device and skips without one. It imports no JAX, so on a
machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from cc_tpu_torch.ops import correlation as tc
# Imported through tests/ itself, which pytest puts on the path: where an
# installed package is named `tests`, that package hides tests.torch_port_util.
from torch_port_util import assert_close

# fp32 sums of C products taken in another order than the plain version's
ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,patch,dilation", [
    ((2, 5, 7, 3), 9, 1),          # ragged: W and C below one tile
    ((2, 16, 80, 32), 9, 1),       # several w-tiles, one partial
    ((1, 12, 20, 20), 21, 2),      # FlowNetC6's patch and dilation
    ((1, 6, 9, 17), 3, 3),
])
def test_correlation_kernel_matches_plain(cuda, shape, patch, dilation):
    r = np.random.RandomState(0)
    a, b = (torch.from_numpy(r.randn(*shape).astype(np.float32)).to(cuda)
            for _ in range(2))
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
    with pytest.raises(RuntimeError):
        tc.correlation_cuda(a.requires_grad_(), a, 9)
