"""cc_tpu_torch correlation vs cc_tpu: the plain PyTorch version against
correlation_xla and against the Pallas kernel in interpret mode (values and
gradients), the channel permutations, and the CUDA wrapper's contract."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import cc_tpu.ops.correlation_pallas as cp
from cc_tpu.ops.correlation import (
    b2f_channel_permutations as jax_perms, correlation_xla,
)
from cc_tpu_torch.ops import correlation as tc
from tests.torch_port_util import assert_close

torch.set_num_threads(2)

CASES = [(3, 1), (9, 1), (5, 2), (21, 2)]
SHAPE = (2, 8, 12, 4)
# fp32 sums of C=4 products of randn values, taken in another order
ATOL = 1e-6


@pytest.fixture
def interpret_mode():
    old = cp.INTERPRET
    cp.INTERPRET = True
    yield
    cp.INTERPRET = old


def _inputs(shape, seed):
    r = np.random.RandomState(seed)
    return (r.randn(*shape).astype(np.float32),
            r.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("patch,dilation", CASES)
def test_plain_matches_xla(patch, dilation):
    a, b = _inputs(SHAPE, 0)
    ref = correlation_xla(jnp.asarray(a), jnp.asarray(b), patch, dilation)
    out = tc.correlation_plain(torch.from_numpy(a), torch.from_numpy(b),
                               patch, dilation)
    assert_close(out, ref, ATOL, f"P={patch} d={dilation}")


@pytest.mark.parametrize("patch,dilation", CASES)
def test_plain_matches_pallas_interpret(interpret_mode, patch, dilation):
    a, b = _inputs(SHAPE, 1)
    ref = cp.correlation_pallas(jnp.asarray(a), jnp.asarray(b), patch,
                                dilation)
    out = tc.correlation(torch.from_numpy(a), torch.from_numpy(b), patch,
                         dilation)
    assert_close(out, ref, ATOL, f"P={patch} d={dilation}")


@pytest.mark.parametrize("patch,dilation", [(3, 1), (9, 1), (5, 2)])
def test_plain_gradients_match_pallas_vjp(interpret_mode, patch, dilation):
    """Autograd through the plain version vs jax.grad through the Pallas
    kernel's custom_vjp (_corr_bwd): the oracle for a future backward kernel."""
    a, b = _inputs((1, 8, 8, 4), 2)
    loss = lambda x, y: jnp.sum(jnp.sin(cp.correlation_pallas(
        x, y, patch, dilation)))
    ga, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))

    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    torch.sin(tc.correlation_plain(ta, tb, patch, dilation)).sum().backward()
    # gradient sums take up to P*P terms of O(1) in another order
    assert_close(ta.grad, ga, 1e-5, "df1")
    assert_close(tb.grad, gb, 1e-5, "df2")


@pytest.mark.parametrize("patch", [3, 9, 21])
def test_channel_permutations_match(patch):
    for mine, ref in zip(tc.b2f_channel_permutations(patch), jax_perms(patch)):
        np.testing.assert_array_equal(mine, ref)


def test_cpu_tensors_take_plain_version_without_launch():
    a, b = _inputs(SHAPE, 3)
    before = tc.launches
    out = tc.correlation(torch.from_numpy(a), torch.from_numpy(b), 9)
    assert out.shape == (*SHAPE[:3], 81)
    assert tc.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    a, b = _inputs(SHAPE, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tc.correlation_cuda(torch.from_numpy(a), torch.from_numpy(b), 9)



@pytest.mark.parametrize("patch,dilation", [(3, 1), (9, 1), (21, 2)])
def test_backward_plain_matches_corr_bwd(interpret_mode, patch, dilation):
    """correlation_backward_plain against cc_tpu's _corr_bwd, reached
    through jax.vjp of the Pallas kernel (interpret mode), on one g."""
    a, b = _inputs((2, 8, 12, 4), 5)
    g = np.random.RandomState(6).randn(2, 8, 12, patch * patch).astype(
        np.float32)
    _, vjp = jax.vjp(lambda x, y: cp.correlation_pallas(x, y, patch,
                                                        dilation),
                     jnp.asarray(a), jnp.asarray(b))
    ga, gb = vjp(jnp.asarray(g))
    df1, df2 = tc.correlation_backward_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(g), patch,
        dilation)
    # sums of up to P*P products of randn values, in another order
    assert_close(df1, ga, 1e-5, "df1")
    assert_close(df2, gb, 1e-5, "df2")


@pytest.mark.parametrize("patch,dilation", [(9, 1), (5, 3)])
def test_backward_plain_equals_autograd_of_plain(patch, dilation):
    """On CPU tensors `correlation` is the plain version under autograd;
    its gradients are what correlation_backward_plain gives."""
    a, b = _inputs((1, 7, 10, 5), 7)
    g = torch.from_numpy(np.random.RandomState(8).randn(
        1, 7, 10, patch * patch).astype(np.float32))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    before = (tc.launches, tc.backward_launches)
    tc.correlation(ta, tb, patch, dilation).backward(g)
    assert (tc.launches, tc.backward_launches) == before
    df1, df2 = tc.correlation_backward_plain(torch.from_numpy(a),
                                             torch.from_numpy(b), g, patch,
                                             dilation)
    assert_close(ta.grad, df1, 1e-5, "df1")
    assert_close(tb.grad, df2, 1e-5, "df2")


def test_backward_wrapper_rejects_cpu_tensors():
    a, b = _inputs(SHAPE, 9)
    g = torch.zeros(*SHAPE[:3], 81)
    with pytest.raises(ValueError, match="CUDA"):
        tc.correlation_backward_cuda(torch.from_numpy(a), torch.from_numpy(b),
                                     g, 9)
