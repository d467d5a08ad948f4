"""The port's joint train step against cc_tpu's build_train_step, from the
same weights and batch: the six metrics, the gradients (as Adam's first
moments after one step from zero moments, which are exactly (1-b1)*grad),
the updated parameters and the updated BatchNorm running stats; a
frozen-phase step; and the BatchNorm running-variance rule. With FlowNetC6
as F: the four-net forward against cc_tpu's forward_all, and a step and a
fix_flownet step on the port alone.

Run as a script, the file compares several FlowNetC6 steps of the port and
of cc_tpu from cc_tpu's init, a second JAX train-step compile that tier-1
does not pay for (a few minutes on the CPU):

    JAX_PLATFORMS=cpu python -m tests.test_torch_train_step [steps]

The JAX step is compiled once, with test_train_step's config, batch and
donate=False: its program is the same as test_train_step's, so the
persistent compile cache can serve both files. The variables' structure
comes from jax.eval_shape of init_state and their values are drawn with
numpy: init_state itself is not run. The compile and the steps it takes run
once per test run, however many pytest-xdist workers run this module's
tests or tests/test_torch_bf16.py's (torch_port_util.computed_once).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from cc_tpu.train import build_train_step as jax_build_train_step
from cc_tpu.train.step import forward_all as jax_forward_all
from cc_tpu.train import init_state, make_models as jax_make_models
from cc_tpu.train.state import TrainState, make_optimizer as jax_make_optimizer
from cc_tpu.train.torch_export import export_state_dict
from cc_tpu_torch.models.layers import BatchNorm2d
from cc_tpu_torch.train import (
    METRICS, NETS, TrainConfig, build_train_step, forward_eval, make_models,
    make_optimizer,
)
from cc_tpu_torch.train.step import compute_losses, forward_all
from cc_tpu_torch.weights import (
    load_cc_tpu_state, load_flax_weights, state_dict_from_flax,
)
from cc_tpu_torch.losses import photometric
from tests.test_train_step import synth_batch, tiny_config
from tests.torch_port_util import (
    assert_close, check_bf16, check_bf16_update, computed_once,
    draw_flax_variables, rows_differ_batch, torchrun,
)

torch.set_num_threads(2)

# Metrics: fp32 losses summed in another order through four nets and the
# loss stack; relative to each metric's magnitude.
METRIC_RTOL = 1e-4
# First moments, (1-b1)*grad: backward sums in another order through up to
# ~40 layers, and the odd occlusion-mask pixel on the other side of its
# threshold; relative to the largest entry of each tensor, plus a floor of
# MU_FLOOR times the net's largest entry for a tensor whose gradient is
# rounding noise (DispResNet6's conv7 projection: BatchNorm over 2 values
# at 1x1, whose output does not depend on its input).
MU_RTOL = 2e-3
MU_FLOOR = 1e-6
# Updated parameters: besides the 2*lr bound below, the share of entries
# that may differ by more than 1e-6 (measured: 0.05%)
PARAM_MOVED_SHARE = 0.01
# BatchNorm running stats after one step: a batch mean and variance of
# activations that agree to ~1e-5; relative to each tensor's magnitude.
STATS_RTOL = 1e-4
# The four nets' training-mode outputs: fp32 convs summed in another order;
# relative to each output's largest magnitude
FORWARD_RTOL = 1e-4


def _archs(cfg):
    return {"disp": cfg.dispnet, "pose": cfg.posenet, "mask": cfg.masknet,
            "flow": cfg.flownet}


def _adam_state(opt_state):
    """The ScaleByAdamState inside an optax chain's state."""
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s
    raise AssertionError("no ScaleByAdamState")


def drawn_state(cfg) -> TrainState:
    """A cc_tpu TrainState for cfg of drawn variables (numpy, seed 3) and
    zero moments and counts."""
    shapes = jax.eval_shape(lambda k: init_state(cfg, k),
                            jax.random.PRNGKey(0))
    r = np.random.RandomState(3)
    params = draw_flax_variables(shapes.params, r)
    stats = draw_flax_variables(shapes.batch_stats, r)
    # zero moments and count, without running optax's init op by op
    opt_state = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(jax_make_optimizer(cfg).init, params))
    return TrainState(params=params, batch_stats=stats, opt_state=opt_state,
                      step=np.zeros((), np.int32))


def cc_tpu_steps() -> dict:
    """cc_tpu's jitted train step on test_train_step's config (the one
    compile), from drawn_state, on synth_batch and on rows_differ_batch:
    {"params", "stats": the drawn variables; "synth": (batch, new state,
    metrics); "rows": (batch, (new params, new stats), metrics)}."""
    cfg = tiny_config()
    state = drawn_state(cfg)
    step = jax_build_train_step(cfg, jax_make_models(cfg), donate=False)
    synth = {k: np.array(v) for k, v in synth_batch(cfg).items()}
    rows = rows_differ_batch(cfg.height, cfg.width, cfg.batch_size)
    out = {"params": state.params, "stats": state.batch_stats}
    new_state, metrics = jax.device_get(step(state, synth))
    out["synth"] = (synth, new_state, metrics)
    new_state, metrics = jax.device_get(step(state, rows))
    out["rows"] = (rows, (new_state.params, new_state.batch_stats), metrics)
    return out


@pytest.fixture(scope="module")
def jax_train(tmp_path_factory):
    """cc_tpu_steps, computed once per run; with the config."""
    return tiny_config(), computed_once(tmp_path_factory, "cc_tpu_steps",
                                        cc_tpu_steps)


@pytest.fixture(scope="module")
def jax_step(jax_train):
    """One cc_tpu train step on test_train_step's config and batch."""
    cfg, steps = jax_train
    batch, new_state, metrics = steps["synth"]
    return cfg, steps["params"], steps["stats"], batch, new_state, metrics


def _port(jcfg, params, stats, **changes):
    cfg = TrainConfig(**{f: getattr(jcfg, f)
                         for f in TrainConfig.__dataclass_fields__})
    cfg = cfg.replace(**changes)
    nets = make_models(cfg, device="cpu")
    for name, arch in _archs(cfg).items():
        load_flax_weights(nets[name], arch, params[name], stats[name])
    return cfg, nets


def _by_name(net, tensors):
    return {k: t for (k, _), t in zip(net.named_parameters(), tensors)}


def port_fp32_step(jcfg, params, stats, batch) -> tuple:
    """The port's float32 step on jcfg from cc_tpu's variables on batch:
    (cfg, nets, opt_state, metrics)."""
    cfg, nets = _port(jcfg, params, stats)
    opt_state = make_optimizer(cfg).init(nets)
    metrics = build_train_step(cfg, nets, opt_state)(batch)
    return cfg, nets, opt_state, metrics


@pytest.fixture(scope="module")
def port_step(jax_step, tmp_path_factory):
    """port_fp32_step from jax_step's variables on its batch, computed once
    per run (tests/test_torch_bf16.py takes it as its float32 step)."""
    jcfg, params, stats, batch, _, _ = jax_step
    return computed_once(
        tmp_path_factory, "port_fp32_step",
        lambda: port_fp32_step(jcfg, params, stats, batch))


def check_metrics(ref: dict, out: dict) -> None:
    """A step's six metrics against cc_tpu's, within METRIC_RTOL."""
    assert set(out) == set(ref) == set(METRICS)
    for k in METRICS:
        e = float(ref[k])
        assert np.isfinite(e) and e != 0.0, (k, e)
        assert_close(out[k], np.float32(e), METRIC_RTOL * abs(e), k)


def check_first_moments(jcfg, new_state, nets, mu: dict) -> None:
    """Adam's first moments after one step from zero, (1-b1)*grad, per net
    (lists in nets[name].parameters() order) against cc_tpu's."""
    ref_mu = _adam_state(new_state.opt_state).mu
    for name, arch in _archs(jcfg).items():
        ref = state_dict_from_flax(arch, ref_mu[name],
                                   new_state.batch_stats[name])
        mine = _by_name(nets[name], mu[name])
        assert set(mine) <= set(ref)
        net_max = max(float(np.max(np.abs(ref[k]))) for k in mine)
        for k, t in mine.items():
            tol = (MU_RTOL * float(np.max(np.abs(ref[k])))
                   + MU_FLOOR * net_max)
            assert_close(t, ref[k], tol, f"{name}.{k}")


def check_params_and_stats(jcfg, new_state, state_dict: dict) -> None:
    """The four nets' parameters and BatchNorm running stats after one step
    (a state dict of the ModuleDict of nets) against cc_tpu's."""
    # Adam's first step moves each parameter by about lr*sign(grad): where
    # a near-zero gradient takes the other sign, the two differ by up to
    # 2*lr
    tol = 2 * jcfg.lr + 1e-6
    n_far = n_all = 0
    for name, arch in _archs(jcfg).items():
        ref = state_dict_from_flax(arch, new_state.params[name],
                                   new_state.batch_stats[name])
        mine = {k[len(name) + 1:]: v for k, v in state_dict.items()
                if k.startswith(name + ".")}
        assert set(mine) == set(ref)
        for k, t in mine.items():
            if k.endswith("num_batches_tracked"):
                continue
            e = np.asarray(ref[k])
            if k.endswith(("running_mean", "running_var")):
                assert_close(t, e, STATS_RTOL * max(1.0, np.abs(e).max()),
                             f"{name}.{k}")
            else:
                assert_close(t, e, tol, f"{name}.{k}")
                n_far += int((np.abs(t.numpy() - e) > 1e-6).sum())
                n_all += e.size
    assert n_far <= PARAM_MOVED_SHARE * n_all, (n_far, n_all)


def test_metrics_match(jax_step, port_step):
    check_metrics(jax_step[5], port_step[3])


def test_first_moments_match_gradients(jax_step, port_step):
    jcfg, _, _, _, new_state, _ = jax_step
    _, nets, opt_state, _ = port_step
    assert opt_state.count == int(_adam_state(new_state.opt_state).count) == 1
    check_first_moments(jcfg, new_state, nets, opt_state.mu)


def test_updated_params_and_batchnorm_stats_match(jax_step, port_step):
    jcfg, _, _, _, new_state, _ = jax_step
    _, nets, _, _ = port_step
    check_params_and_stats(jcfg, new_state, nets.state_dict())


def test_cc_tpu_state_carries_into_the_port(jax_step):
    """cc_tpu's whole state after its step, as numpy trees, into the port's
    nets and AdamState (load_cc_tpu_state, over nets that hold other
    weights): every parameter, BatchNorm stat and moment equals cc_tpu's own
    export of those trees to the reference's layout (export_state_dict) bit
    for bit, and the counts are cc_tpu's."""
    jcfg, params, stats, _, new_state, _ = jax_step
    cfg, nets = _port(jcfg, params, stats)
    opt_state = make_optimizer(cfg).init(nets)
    adam = _adam_state(new_state.opt_state)
    load_cc_tpu_state(nets, opt_state, new_state.params,
                      new_state.batch_stats, adam.mu, adam.nu, adam.count,
                      new_state.step)
    assert (opt_state.count, opt_state.step, opt_state.notfinite) == (1, 1, 0)
    for name, arch in _archs(jcfg).items():
        bn = new_state.batch_stats[name]
        ref = export_state_dict(arch, new_state.params[name], bn)
        mine = nets[name].state_dict()
        assert set(mine) == set(ref)
        for k, t in mine.items():
            assert t.dtype == torch.from_numpy(np.asarray(ref[k])).dtype, k
            assert np.array_equal(t.numpy(), ref[k]), f"{name}.{k}"
        keys = {k for k, _ in nets[name].named_parameters()}
        for group, tree in (("mu", adam.mu), ("nu", adam.nu)):
            ref = export_state_dict(arch, tree[name], bn)
            moments = _by_name(nets[name], getattr(opt_state, group)[name])
            assert set(moments) == keys and keys <= set(ref)
            for k, t in moments.items():
                assert np.array_equal(t.numpy(), ref[k]), f"{group} {name}.{k}"


def test_frozen_phase_step(jax_step):
    """fix_flownet and fix_masknet, as test_train_step.py:82: the frozen
    nets' parameters and moments stay bit-equal, the others move, and
    DispResNet6's running stats move (every net runs in train mode)."""
    jcfg, params, stats, batch, _, _ = jax_step
    cfg, nets = _port(jcfg, params, stats, fix_flownet=True,
                      fix_masknet=True)
    before = {k: v.clone() for k, v in nets.state_dict().items()}
    opt_state = make_optimizer(cfg).init(nets)
    metrics = build_train_step(cfg, nets, opt_state)(batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert opt_state.count == 1
    after = nets.state_dict()
    for name in NETS:
        moved = [k for k in after if k.startswith(name + ".")
                 and not torch.equal(after[k], before[k])]
        if name in ("flow", "mask"):
            assert not moved, moved
            assert all(not m.any() for m in opt_state.mu[name])
            assert all(not v.any() for v in opt_state.nu[name])
        else:
            assert moved
    stats_keys = [k for k in after if k.startswith("disp.")
                  and k.endswith(("running_mean", "running_var"))]
    assert stats_keys
    assert all(not torch.equal(after[k], before[k]) for k in stats_keys)


def _row_statistics(cfg, nets, batch) -> tuple[list, torch.Tensor]:
    """Each row's statistics that a step over the batch shares across rows:
    the valid pixels' sum of every out-of-bounds barrier of the losses,
    and the channel means at DispResNet6's first BatchNorm."""
    sums, means = [], []
    oob_norm = photometric._oob_norm

    def record(valid):
        sums.append(valid.sum(dim=(1, 2, 3)))
        return oob_norm(valid)

    first_bn = next(m for m in nets["disp"].modules()
                    if isinstance(m, BatchNorm2d))
    hook = first_bn.register_forward_hook(
        lambda m, args, out: means.append(args[0].mean(dim=(2, 3))))
    photometric._oob_norm = record
    try:
        with torch.no_grad():
            compute_losses(cfg, forward_all(cfg, nets, batch, training=True),
                           batch)
    finally:
        photometric._oob_norm = oob_norm
        hook.remove()
    return sums, means[0]


# the guarded bf16 recipe, tests/test_bf16_step.py's _bf16_cfg
BF16 = dict(compute_dtype="bfloat16", clip_grad_norm=5.0,
            skip_nonfinite_updates=True)


def _two_process_steps(jcfg, steps, tmp) -> list[dict]:
    """The port's step on two processes under torchrun (gloo, the CPU), a
    row each, from cc_tpu_steps' drawn weights on its rows_differ_batch:
    one launch, two runs of a step each, in float32 and in the guarded
    bf16 recipe. For each run: each process's backend, world, counts and
    metrics, process 0's state dict, and whether process 1's equals it."""
    batch = steps["rows"][0]
    cfg, nets = _port(jcfg, steps["params"], steps["stats"])
    spec = {"device": "cpu", "config": dataclasses.asdict(cfg),
            "nets": nets.state_dict(), "batch": batch,
            "runs": [[{}], [BF16]], "moments": False}
    files = [tmp / n for n in ("spec.pt", "rank0.pt", "rank1.pt")]
    try:
        torch.save(spec, files[0])
        torchrun(["tests/torch_port_util.py", "steps", str(files[0]),
                  str(tmp)])
        ranks = [torch.load(f) for f in files[1:]]
    finally:  # about 1.5 GB of weights
        for f in files:
            f.unlink(missing_ok=True)
    runs = []
    for i in range(2):
        mine, other = (r["runs"][i]["state"]["nets"] for r in ranks)
        runs.append({
            "launch": [(r["world"], r["backend"]) for r in ranks],
            "counts": [r["runs"][i]["state"]["counts"] for r in ranks],
            "metrics": [r["runs"][i]["metrics"][0] for r in ranks],
            "nets": mine,
            "equal": all(torch.equal(v, other[k]) for k, v in mine.items())})
    return runs


@pytest.fixture(scope="module")
def two_process_steps(jax_train, tmp_path_factory):
    """_two_process_steps, computed once per run."""
    jcfg, steps = jax_train
    return computed_once(
        tmp_path_factory, "two_process_steps",
        lambda: _two_process_steps(jcfg, steps,
                                   tmp_path_factory.mktemp("two_processes")))


def test_two_processes_take_cc_tpus_global_batch_step(jax_train,
                                                      two_process_steps):
    """The port's step on two processes under torchrun (gloo, the CPU), a
    row each, against cc_tpu's step on the two rows, on a batch whose rows
    differ: metrics, parameters and BatchNorm stats at the module's
    tolerances, and the two processes' parameters and buffers equal bit
    for bit. The batch can tell a step over each process's rows from the
    global one: its rows' out-of-bounds sums and first BatchNorm means
    differ by more than ten times the tolerances.

    The first moments are not held to cc_tpu's at MU_RTOL here: on this
    batch the one-process step misses that too, by 19x in DispResNet6,
    whose ReLU pre-activations lie within fp32 rounding of zero (ROADMAP,
    Queue C). The parameters' 2*lr bound holds through such a flip."""
    jcfg, steps = jax_train
    batch, (new_params, new_stats), ref_metrics = steps["rows"]
    new_state = TrainState(params=new_params, batch_stats=new_stats,
                           opt_state=None, step=None)
    cfg, nets = _port(jcfg, steps["params"], steps["stats"])

    sums, means = _row_statistics(cfg, _port(jcfg, steps["params"],
                                             steps["stats"])[1], batch)
    oob_gap = max(float((s[0] - s[1]).abs() / s.max()) for s in sums)
    assert oob_gap > 10 * METRIC_RTOL, oob_gap
    bn_gap = float((means[0] - means[1]).abs().max())
    assert bn_gap > 10 * STATS_RTOL * max(1.0, float(means.abs().max())), \
        bn_gap

    run = two_process_steps[0]
    assert run["launch"] == [(2, "gloo")] * 2
    assert run["counts"] == [(1, 0, 1)] * 2
    for metrics in run["metrics"]:
        check_metrics(ref_metrics, metrics)
    check_params_and_stats(jcfg, new_state, run["nets"])
    assert run["equal"]


def test_two_processes_take_one_process_bf16_step(jax_train,
                                                  two_process_steps):
    """The guarded bf16 step (compute_dtype bfloat16, clip 5, non-finite
    guard) on two processes, a row each, against the port's bf16 step on
    the whole batch in this process, from the same weights; the processes
    equal bit for bit. The global-batch BatchNorm and out-of-bounds sums
    take bf16 activations and sum in float32.

    Held, with one process's float32 step as the reference distance and
    the two processes' float32 run (the launch's first) as their own: the
    six metrics (one vector) and each BatchNorm running stat by the bf16
    yardstick (torch_port_util.check_bf16), within 2 d + 2**-8 of one
    process's bf16 and at least 0.1 d from their float32; each net's
    update by torch_port_util.check_bf16_update (the yardstick on the
    update, and its sign where one process's gradients lie far above
    Adam's eps), which fails a step that leaves the masters as they are;
    and the parameters to 2*lr. Not to the float32 step's METRIC_RTOL,
    STATS_RTOL and PARAM_MOVED_SHARE: bf16 rounds every convolution's and
    BatchNorm's float32 sums, which two processes take in another order
    (a row a process), so elements land on the other side of a rounding
    and thresholded targets flip (the consensus loss 1.4e-3 apart on this
    batch), and where a gradient lies near Adam's eps one bf16 step of it
    moves the first update by more than 1e-6 (12.5% of the entries)."""
    jcfg, steps = jax_train
    batch = steps["rows"][0]
    one = {}
    for key, changes in (("bf16", BF16), ("fp32", {})):
        cfg, nets = _port(jcfg, steps["params"], steps["stats"], **changes)
        theta0 = {k: v.clone() for k, v in nets.state_dict().items()}
        opt_state = make_optimizer(cfg).init(nets)
        metrics = build_train_step(cfg, nets, opt_state)(batch)
        grads = {f"{n}.{k}": g / (1.0 - cfg.momentum)
                 for n in opt_state.mu
                 for k, g in _by_name(nets[n], opt_state.mu[n]).items()}
        one[key] = ({k: float(v) for k, v in metrics.items()},
                    nets.state_dict(), grads)
    (m16, ref, g16), (m32, ref32, g32) = one["bf16"], one["fp32"]
    two32, run = two_process_steps
    assert run["launch"] == [(2, "gloo")] * 2
    assert run["counts"] == [(1, 0, 1)] * 2
    vector = lambda m: np.array([m[k] for k in METRICS])
    for metrics, metrics32 in zip(run["metrics"], two32["metrics"]):
        check_bf16("metrics", vector(metrics), vector(metrics32),
                   vector(m16), vector(m32))
    for k, v in ref.items():
        if k.endswith(("running_mean", "running_var")):
            check_bf16(k, run["nets"][k], two32["nets"][k], v, ref32[k])
        elif v.is_floating_point():
            assert_close(run["nets"][k], v, 2 * jcfg.lr + 1e-6, k)
    for name in _archs(jcfg):
        pick = lambda d: {k: d[k] for k in g16 if k.startswith(name + ".")}
        print(name, check_bf16_update(
            name, pick(theta0), pick(run["nets"]), pick(two32["nets"]),
            pick(ref), pick(ref32), pick(g16), pick(g32)))
    assert run["equal"]


def test_batchnorm_running_stats_follow_flax():
    """The port's BatchNorm2d against flax's nn.BatchNorm (momentum 0.9) as
    DispResNet6's projection shortcut uses it: output and updated running
    mean and (biased) running variance, at batch 2."""
    import flax.linen as fnn
    r = np.random.RandomState(7)
    x = r.randn(2, 3, 5, 4).astype(np.float32) * 2 + 1  # NHWC
    scale = r.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = r.uniform(-0.5, 0.5, 4).astype(np.float32)
    mean = r.uniform(-0.5, 0.5, 4).astype(np.float32)
    var = r.uniform(0.5, 1.5, 4).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    out, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": mean, "var": var}},
                        jnp.asarray(x), mutable=["batch_stats"])

    mine = BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        mine.weight.copy_(torch.from_numpy(scale))
        mine.bias.copy_(torch.from_numpy(bias))
        mine.running_mean.copy_(torch.from_numpy(mean))
        mine.running_var.copy_(torch.from_numpy(var))
    y = mine(torch.from_numpy(x).permute(0, 3, 1, 2))
    # single-layer fp32 statistics over 30 values
    assert_close(y.permute(0, 2, 3, 1), out, 1e-5, "output")
    assert_close(mine.running_mean, upd["batch_stats"]["mean"], 1e-6, "mean")
    assert_close(mine.running_var, upd["batch_stats"]["var"], 1e-6, "var")
    # torch's own rule would have moved it toward the unbiased variance
    n = x.shape[0] * x.shape[1] * x.shape[2]
    unbiased = 0.9 * var + 0.1 * x.reshape(-1, 4).var(0) * n / (n - 1)
    assert np.abs(mine.running_var.detach().numpy() - unbiased).max() > 1e-3


def test_forward_all_flownetc6_matches():
    """The four nets with FlowNetC6 as F, training mode, against cc_tpu's
    forward_all (one jit of the forward, no train-step compile): F runs
    once per direction, flow_fwd on (tgt, refs[2]) and flow_bwd on
    (tgt, refs[1]), and gives no occlusion."""
    jcfg = tiny_config(flownet="FlowNetC6")
    batch = {k: np.array(v) for k, v in synth_batch(jcfg).items()}
    shapes = jax.eval_shape(lambda k: init_state(jcfg, k),
                            jax.random.PRNGKey(0))
    r = np.random.RandomState(4)
    params = draw_flax_variables(shapes.params, r)
    stats = draw_flax_variables(shapes.batch_stats, r)
    mods = jax_make_models(jcfg)
    ref = jax.device_get(jax.jit(lambda p, s, b: jax_forward_all(
        jcfg, mods, p, s, b, training=True)[0])(params, stats, batch))
    assert ref["occ"] is None

    cfg, nets = _port(jcfg, params, stats)
    with torch.no_grad():
        out = forward_all(cfg, nets, batch, training=True)
    assert out["occ"] is None
    for key in ("disparities", "pose", "exp_masks", "flow_fwd", "flow_bwd"):
        mine, exp = out[key], ref[key]
        if key == "pose":
            mine, exp = [mine], [exp]
        assert len(mine) == len(exp) == (1 if key == "pose" else 6), key
        for i, (o, e) in enumerate(zip(mine, exp)):
            e = np.asarray(e)
            tol = FORWARD_RTOL * max(1.0, float(np.max(np.abs(e))))
            assert_close(o, e, tol, f"{key}[{i}]")
    # F's flows depend on the second frame only through the correlation,
    # weakly at these random weights (the two directions differ by ~1e-4
    # of the flows' magnitude), so the tolerance above cannot tell them
    # apart: the port's finest flows must lie 10x closer to cc_tpu's of
    # the same direction than the two directions lie apart
    gap = float(np.max(np.abs(ref["flow_fwd"][0] - ref["flow_bwd"][0])))
    assert gap > 0
    for key in ("flow_fwd", "flow_bwd"):
        assert_close(out[key][0], ref[key][0], 0.1 * gap, f"{key} direction")


@pytest.fixture(scope="module")
def flownetc6_steps():
    """A step and then a fix_flownet step, both with FlowNetC6 as F, on one
    set of nets and optimizer state (seeded init), on the CPU."""
    cfg = TrainConfig(**{f: getattr(tiny_config(), f)
                         for f in TrainConfig.__dataclass_fields__})
    cfg = cfg.replace(flownet="FlowNetC6")
    nets = make_models(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    batch = {k: np.array(v) for k, v in synth_batch(cfg).items()}
    opt_state = make_optimizer(cfg).init(nets)
    snaps = [[p.detach().clone() for p in nets["flow"].parameters()]]
    metrics = []
    for fixed in (False, True):
        step = build_train_step(cfg.replace(fix_flownet=fixed), nets,
                                opt_state)
        metrics.append({k: float(v) for k, v in step(batch).items()})
        snaps.append([p.detach().clone() for p in nets["flow"].parameters()])
    return metrics, snaps, opt_state


def test_flownetc6_train_step_moves_f(flownetc6_steps):
    metrics, (before, after, _), _ = flownetc6_steps
    metrics = metrics[0]
    assert set(metrics) == set(METRICS)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert metrics["photo_flow_loss"] > 0 and metrics["consensus_loss"] > 0
    moved = [not torch.equal(a, b) for a, b in zip(before, after)]
    assert all(moved), sum(moved)


def test_flownetc6_fix_flownet_step_keeps_f(flownetc6_steps):
    metrics, (_, before, after), opt_state = flownetc6_steps
    assert all(np.isfinite(v) for v in metrics[1].values()), metrics[1]
    assert opt_state.count == 2
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("change", [
    dict(compute_dtype="bfloat16"), dict(loss_dtype="bfloat16"),
    dict(flownet="PWCNet"), dict(posenet="PoseExpNet"),
    dict(compute_dtype="float16"), dict(loss_dtype="float16")])
def test_unported_configs_raise(change):
    """The configurations the port does not run raise; the two bf16 dtypes,
    once refused, build a step and run the eval forward (finite, float32
    outputs; tests/test_torch_bf16.py holds them to cc_tpu)."""
    cfg = TrainConfig(height=128, width=128, batch_size=1,
                      flownet="FlowNetC6").replace(**change)
    if "bfloat16" in change.values():
        nets = make_models(cfg, device="cpu")
        build_train_step(cfg, nets, make_optimizer(cfg).init(nets))
        batch = {k: v[:1] for k, v in synth_batch(tiny_config()).items()}
        out = forward_eval(cfg, nets, batch)
        for key in ("disp", "pose", "flow_fwd"):
            assert out[key].dtype == torch.float32, key
            assert bool(torch.isfinite(out[key]).all()), key
        return
    with pytest.raises(NotImplementedError):
        build_train_step(cfg, None, None)
    with pytest.raises(NotImplementedError):
        forward_eval(cfg, None, {})


def compare_flownetc6_losses(steps: int = 8) -> None:
    """The loss of `steps` train steps on one batch, FlowNetC6 as F, at
    128x128 batch 2 with bench.py's loss weights, from cc_tpu's init
    (init_state, seed 0): cc_tpu's build_train_step and the port's."""
    bench = dict(wssim=0.997, smoothness_type="edgeaware",
                 cam_photo_loss_weight=1.0, mask_loss_weight=0.1,
                 smooth_loss_weight=0.1, flow_photo_loss_weight=0.5,
                 consensus_loss_weight=0.3, lr=1e-4)
    jcfg = tiny_config(flownet="FlowNetC6", **bench)
    state = init_state(jcfg, jax.random.PRNGKey(0))
    batch = {k: np.array(v) for k, v in synth_batch(jcfg).items()}
    cfg, nets = _port(jcfg, jax.device_get(state.params),
                      jax.device_get(state.batch_stats))
    step = build_train_step(cfg, nets, make_optimizer(cfg).init(nets))
    port = [float(step(batch)["loss"]) for _ in range(steps)]
    jstep = jax_build_train_step(jcfg, jax_make_models(jcfg), donate=False)
    ref = []
    for _ in range(steps):
        state, metrics = jstep(state, batch)
        ref.append(float(metrics["loss"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(port, ref))
    print(f"port:    {port}\ncc_tpu:  {ref}\nlargest relative difference {rel:.3g}")


if __name__ == "__main__":
    import sys
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    compare_flownetc6_losses(*(int(a) for a in sys.argv[1:]))
