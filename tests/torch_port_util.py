"""Shared helpers for the cc_tpu_torch parity tests (tests/test_torch_*.py).

The port's nets are NCHW and cc_tpu's are NHWC; these convert numpy arrays
and torch tensors between the two, compare with a stated tolerance, and
fill flax variable trees with seeded numpy values.
"""
from __future__ import annotations

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def nhwc_to_nchw(x) -> torch.Tensor:
    """NHWC array -> contiguous NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(to_numpy(x), (0, 3, 1, 2))))


def nchw_to_nhwc(x) -> np.ndarray:
    """NCHW tensor or array -> NHWC numpy array."""
    return np.transpose(to_numpy(x), (0, 2, 3, 1))


def assert_close(actual, expected, atol: float, name: str = "") -> float:
    """Assert max |actual - expected| <= atol; the message names the error
    and the tolerance. Returns the max abs error."""
    a, e = to_numpy(actual), to_numpy(expected)
    assert a.shape == e.shape, f"{name}: shape {a.shape} != {e.shape}"
    err = float(np.max(np.abs(a.astype(np.float64) - e.astype(np.float64)))) \
        if a.size else 0.0
    assert err <= atol, f"{name}: max abs error {err:.3g} > tolerance {atol:.3g}"
    return err


def draw_flax_variables(tree: dict, r: np.random.RandomState) -> dict:
    """Random numpy values for every leaf of a flax variable tree (whose
    leaves need only a shape, e.g. from jax.eval_shape): xavier-uniform
    kernels; biases, BN scales and shifts and running stats away from their
    init values, so that every weight mapping and eval-mode BN matter."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = draw_flax_variables(v, r)
            continue
        if k == "kernel":
            *rf, ci, co = v.shape
            a = np.sqrt(6.0 / (np.prod(rf) * (ci + co)))
            lo, hi = -a, a
        else:  # bias, mean: centred; scale, var: positive
            lo, hi = (0.5, 1.5) if k in ("scale", "var") else (-0.5, 0.5)
        out[k] = r.uniform(lo, hi, v.shape).astype(np.float32)
    return out
