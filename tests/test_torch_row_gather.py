"""cc_tpu_torch's row gather (K2) vs the TPU kernel it replaces: the body
k2 of experiment E5 in scripts/exp_gather.py (:162-170), copied here and
run through pl.pallas_call in interpret mode, without the TPU memory spaces
of its BlockSpecs; and the wrapper's contract on the CPU."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

from cc_tpu_torch.ops import row_gather as rg
from tests.torch_port_util import assert_close

torch.set_num_threads(2)


def _k2_interpret(img: np.ndarray, idx: np.ndarray) -> np.ndarray:
    rows = img.shape[0]

    def k2(img_ref, idx_ref, out_ref):  # scripts/exp_gather.py:162-170
        idxv = idx_ref[:]
        acc = jnp.zeros_like(out_ref)

        def body(h, acc):
            row = img_ref[h, :]
            return jnp.where(idxv == h, row[None, :], acc)
        acc = jax.lax.fori_loop(0, rows, body, acc)
        out_ref[:] = acc

    return np.asarray(pl.pallas_call(
        k2, out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.float32),
        interpret=True)(jnp.asarray(img), jnp.asarray(idx)))


@pytest.mark.parametrize("rows,n,w", [(16, 16, 24), (9, 5, 7)])
def test_plain_matches_select_loop_kernel(rows, n, w):
    r = np.random.RandomState(rows)
    img = r.rand(rows, w).astype(np.float32)
    # a third of the indices out of range, negative or >= rows
    idx = r.randint(-rows // 2, rows + rows // 2, (n, w)).astype(np.int32)
    assert (idx < 0).any() and (idx >= rows).any()
    ref = _k2_interpret(img, idx)
    out = rg.row_gather(torch.from_numpy(img), torch.from_numpy(idx))
    assert out.dtype == torch.float32
    assert_close(out, ref, 0.0, "row gather")  # a copy: exact
    assert (out.numpy()[(idx < 0) | (idx >= rows)] == 0).all()


def test_cpu_tensors_take_plain_version_without_launch():
    img = torch.rand(4, 6)
    idx = torch.tensor([[0, 1, 2, 3, 4, -1]] * 3, dtype=torch.int32)
    before = rg.launches
    out = rg.row_gather(img, idx)
    assert rg.launches == before
    assert_close(out[:, :4], img[[0, 1, 2, 3], [0, 1, 2, 3]].expand(3, 4), 0.0)
    assert not out[:, 4:].any()


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rg.row_gather_cuda(torch.rand(4, 6), torch.zeros(4, 6, dtype=torch.int32))
