"""Shared helpers for the cc_tpu_torch parity tests (tests/test_torch_*.py).

The port's nets are NCHW and cc_tpu's are NHWC; these convert numpy arrays
and torch tensors between the two, compare with a stated tolerance, fill
flax variable trees with seeded numpy values, write reference checkpoints
of such values, and run a train step on a batch with a NaN pixel.
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


def nan_pixel_step(device: str) -> dict:
    """One train step of the port (Back2Future, skip_nonfinite_updates, a
    128x128 batch of 2) on `device`, on a batch with one NaN pixel in a
    reference frame: F's feature warps, which sample with border padding,
    then meet NaN locations in the forward and the backward. Returns the
    optimizer's counts and whether every parameter stayed as it was.
    Run it in a subprocess: where a backward crashes, the process dies."""
    from cc_tpu_torch.train import (
        TrainConfig, build_train_step, make_models, make_optimizer,
    )
    torch.manual_seed(0)
    cfg = TrainConfig(height=128, width=128, batch_size=2,
                      skip_nonfinite_updates=True)
    nets = make_models(cfg, device=device)
    opt_state = make_optimizer(cfg).init(nets)
    r = np.random.RandomState(0)
    k = np.array([[115.0, 0, 64], [0, 115.0, 64], [0, 0, 1]], np.float32)
    batch = {"tgt": r.rand(2, 128, 128, 3).astype(np.float32) * 2 - 1,
             "refs": r.rand(2, 4, 128, 128, 3).astype(np.float32) * 2 - 1,
             "intrinsics": np.stack([k, k]),
             "intrinsics_inv": np.stack([np.linalg.inv(k)] * 2)}
    batch["refs"][0, 2, 60, 70, 1] = np.nan
    batch = {key: torch.from_numpy(v).to(device) for key, v in batch.items()}
    before = [p.detach().clone() for p in nets.parameters()]
    metrics = build_train_step(cfg, nets, opt_state)(batch)
    return {"count": opt_state.count, "notfinite": opt_state.notfinite,
            "step": opt_state.step,
            "loss_finite": bool(torch.isfinite(metrics["loss"])),
            "unchanged": all(torch.equal(a, p) for a, p in
                             zip(before, nets.parameters()))}


def save_drawn_checkpoint(path: str, arch: str, r: np.random.RandomState,
                          **kw) -> None:
    """A reference-format .pth.tar of cc_tpu's `arch` built with `kw`,
    written by cc_tpu's exporter (save_torch_checkpoint): the variables'
    structure from jax.eval_shape of the flax init (traced, not compiled),
    their values drawn with numpy (draw_flax_variables). Imports JAX, which
    the card's tests do not."""
    import jax
    import jax.numpy as jnp
    from cc_tpu import models as jmodels
    from cc_tpu.train.torch_export import save_torch_checkpoint
    net = jmodels.build(arch, **kw)
    img = jax.ShapeDtypeStruct((1, 64, 128, 3), jnp.float32)
    if arch == "FlowNetC6":
        args = (img, img)
    else:
        nref = 2 if arch == "Back2Future" else kw.get("nb_ref_imgs", 0)
        args = (img, [img] * nref) if nref else (img,)
    v = jax.eval_shape(lambda k, *a: net.init(k, *a, training=True),
                       jax.random.PRNGKey(0), *args)
    save_torch_checkpoint(path, arch, draw_flax_variables(v["params"], r),
                          draw_flax_variables(v.get("batch_stats", {}), r))
