"""Shared helpers for the cc_tpu_torch parity tests (tests/test_torch_*.py).

The port's nets are NCHW and cc_tpu's are NHWC; these convert numpy arrays
and torch tensors between the two, compare with a stated tolerance, fill
flax variable trees with seeded numpy values, write reference checkpoints
of such values, and run a train step on a batch with a NaN pixel.

Run as a script under torchrun, the file is one process of a data-parallel
launch of the port (it imports no JAX, so that it runs where there is
none):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/torch_port_util.py steps|layers SPEC OUT

`steps` takes train steps on this process's rows of a global batch
(run_steps; processes other than 0 keep no moments), `layers` runs the global-batch BatchNorm, the out-of-bounds
barrier and the collective helpers on its rows; each process writes what
it got to OUT/rank<i>.pt. `torchrun` launches it.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def rows_differ_batch(h: int, w: int, b: int = 2, nref: int = 4,
                      seed: int = 0) -> dict:
    """A global batch (numpy, NHWC) whose rows differ in their images and
    their intrinsics, so that statistics over the batch (BatchNorm's, the
    out-of-bounds barrier's) differ from each row's: row i is a smooth
    scene of its own, its refs shifted by i + 1 times test_train_step's
    shifts, with its own contrast and offset, and its own focal lengths
    and principal point."""
    r = np.random.RandomState(seed)
    tgts, refs, ks = [], [], []
    for i in range(b):
        s = 2 * (i + 1)
        base = r.rand(h + 2 * s + 8, w + 2 * s + 8, 3).astype(np.float32)
        base = (1.0 - 0.2 * i) * (base * 2 - 1) + 0.1 * i
        crop = lambda dx: base[s + 4:s + 4 + h, s + 4 + dx:s + 4 + dx + w]
        tgts.append(crop(0))
        refs.append(np.stack([crop(dx * (i + 1)) for dx in (-2, -1, 1, 2)]
                             [:nref]))
        ks.append([[w * (1.0 - 0.15 * i), 0, w * (0.5 + 0.05 * i)],
                   [0, h * (1.0 + 0.1 * i), h * (0.5 - 0.05 * i)], [0, 0, 1]])
    k = np.asarray(ks, np.float32)
    return {"tgt": np.stack(tgts), "refs": np.stack(refs), "intrinsics": k,
            "intrinsics_inv": np.linalg.inv(k).astype(np.float32)}


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


def torchrun(args: list[str], nproc: int = 2, cwd: str | None = None,
             timeout: float = 600) -> str:
    """`python -m torch.distributed.run --standalone --nproc-per-node nproc
    *args` from `cwd` (the repo by default), with the repo on PYTHONPATH and
    one thread a process; returns what it printed, and raises with it when
    the launch fails."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, env.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", *args], cwd=cwd or REPO, env=env,
        capture_output=True, text=True, timeout=timeout)
    out = res.stdout + res.stderr
    if res.returncode != 0:
        raise AssertionError(f"torchrun {' '.join(args)}: exit "
                             f"{res.returncode}\n{out}")
    return out


def train_state(nets, opt_state) -> dict:
    """The nets' state dict, Adam's moments and counts, on the CPU."""
    from cc_tpu_torch.train import NETS
    cpu = lambda ts: [t.detach().cpu().clone() for t in ts]
    return {"nets": {k: v.detach().cpu().clone()
                     for k, v in nets.state_dict().items()},
            "mu": {n: cpu(opt_state.mu[n]) for n in NETS},
            "nu": {n: cpu(opt_state.nu[n]) for n in NETS},
            "counts": (opt_state.count, opt_state.notfinite, opt_state.step)}


def run_steps(spec: dict, device) -> list[dict]:
    """The train runs of `spec` on `device`. Each entry of spec["runs"] is a
    run: nets of spec["config"] (a dict of TrainConfig fields) holding
    spec["nets"] (a state dict) and a fresh Adam state take one step for
    each of its entries (the config's changes for that step, e.g.
    {"fix_flownet": True}), each on this process's rows of spec["batch"]
    (a global batch of numpy arrays; all of it outside a launch). Returns,
    for each run, each step's metrics, K1 and K1' launches, ms (ended by a
    synchronize) and the gradient bytes averaged over the processes, and
    the state after its last step (train_state). The steps run in fp32
    with TF32 off, as the train CLI runs them."""
    from cc_tpu_torch.ops import correlation as corr
    from cc_tpu_torch.parallel import distributed, shard_batch
    from cc_tpu_torch.train import (
        NETS, TrainConfig, build_train_step, make_models, make_optimizer,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TrainConfig(**spec["config"])
    batch = shard_batch(spec["batch"], device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    runs = []
    for phases in spec["runs"]:
        nets = make_models(cfg, device=device)
        nets.load_state_dict(spec["nets"])
        distributed.broadcast_([*nets.parameters(), *nets.buffers()])
        opt_state = make_optimizer(cfg).init(nets)
        out = {"metrics": [], "launches": [], "ms": [], "grad_bytes": []}
        for changes in phases:
            phase = cfg.replace(**changes)
            step = build_train_step(phase, nets, opt_state)
            sync()
            corr.launches = corr.backward_launches = 0
            t0 = time.perf_counter()
            metrics = step(batch)
            sync()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["launches"].append((corr.launches, corr.backward_launches))
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            frozen = {"disp": phase.fix_dispnet, "pose": phase.fix_posenet,
                      "mask": phase.fix_masknet, "flow": phase.fix_flownet}
            out["grad_bytes"].append(
                sum(p.numel() * p.element_size() for n in NETS
                    if not frozen[n] for p in nets[n].parameters())
                if distributed.process_count() > 1 else 0)
        out["state"] = train_state(nets, opt_state)
        runs.append(out)
        del nets, opt_state
    return runs


def _layers(spec: dict, device) -> dict:
    """The global-batch BatchNorm, the out-of-bounds barrier and the
    collective helpers on this process's rows of spec's inputs."""
    from cc_tpu_torch.losses.photometric import _oob_norm
    from cc_tpu_torch.models.layers import BatchNorm2d
    from cc_tpu_torch.parallel import distributed
    rank = distributed.process_index()
    rows = lambda a: torch.from_numpy(
        a[distributed.process_batch_slice(len(a))]).to(device)
    out = {"bn": [], "oob": []}
    for case in spec["bn"]:
        bn = BatchNorm2d(case["x"].shape[1], eps=1e-5, momentum=0.1)
        bn = bn.to(device).train()
        with torch.no_grad():
            for name in ("weight", "bias", "running_mean", "running_var"):
                getattr(bn, name).copy_(torch.from_numpy(case[name]))
        x = rows(case["x"]).requires_grad_()
        y = bn(x)
        (y * rows(case["g"])).sum().backward()
        out["bn"].append({
            "y": y.detach().cpu(), "x_grad": x.grad.cpu(),
            "weight_grad": distributed.all_reduce_sum(bn.weight.grad).cpu(),
            "bias_grad": distributed.all_reduce_sum(bn.bias.grad).cpu(),
            **{k: getattr(bn, k).cpu() for k in
               ("running_mean", "running_var", "num_batches_tracked")}})
    for valid in spec["oob"]:
        out["oob"].append([t.cpu() for t in _oob_norm(rows(valid))])
    shapes = [(3,), (5, 7), (1,), (4, 2)]
    mean = [torch.arange(float(np.prod(s)), device=device).reshape(s)
            + rank + 1 for s in shapes]
    distributed.all_reduce_mean_(mean, bucket_bytes=64)
    out["mean"] = [t.cpu() for t in mean]
    cast = [torch.full((3,), rank, dtype=torch.int64, device=device),
            torch.full((2, 2), float(rank + 1), device=device)]
    distributed.broadcast_(cast)
    out["broadcast"] = [t.cpu() for t in cast]
    x = torch.full((3,), rank + 1.0, device=device, requires_grad=True)
    total = distributed.all_reduce_sum(x)
    (total * (rank + 1)).sum().backward()
    out["sum"] = (total.detach().cpu(), x.grad.cpu())
    return out


def _worker(mode: str, spec_path: str, out_dir: str) -> None:
    from cc_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    distributed.initialize(spec["device"])
    device = distributed.local_device(spec["device"])
    distributed.warmup_collectives(device)
    out = ({"runs": run_steps(spec, device)} if mode == "steps"
           else _layers(spec, device))
    if mode == "steps" and not distributed.is_primary():
        # only process 0's moments are compared: the others' files hold
        # their nets (for equality) and counts, a third of the bytes
        for run in out["runs"]:
            del run["state"]["mu"], run["state"]["nu"]
    out.update(device=str(device), backend=torch.distributed.get_backend(),
               world=distributed.process_count())
    torch.save(out, os.path.join(out_dir,
                                 f"rank{distributed.process_index()}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    _worker(*sys.argv[1:])
