"""bf16 mixed precision of the port against cc_tpu's (compute_dtype and
loss_dtype "bfloat16"): the correlation's plain versions, BatchNorm,
sampling and pooling, the losses alone, and one guarded train step; and
loss_dtype bf16 with float32 nets.

cc_tpu's bf16 path itself moves away from its float32, so each comparison
uses the yardstick of torch_port_util.check_bf16: with d = rel(cc_tpu bf16,
cc_tpu float32), the port's bf16 lies within 2 d + 2**-8 of cc_tpu's bf16
(relative L2 over the whole tensor), and at least 0.1 d from the port's own
float32, which a port that quietly ran float32 would miss. The relative L2
norm, not the largest error: in bf16 a ReLU or LeakyReLU mask flips near
zero, and one flip dominates a max-abs error.

cc_tpu's one bf16 train-step compile (tests/test_bf16_step.py's config,
donate=False, so that the persistent compile cache can serve both files),
its float32 step and the port's float32 step (tests/test_torch_train_step.py's)
run once per test run, however many pytest-xdist workers run these tests
(computed_once).
Nets, each in train and eval mode, are held in bf16 by
tests/test_torch_models.py::test_forward_matches_in_bf16; two processes'
bf16 step by tests/test_torch_train_step.py; the NaN-pixel bf16 step by
tests/test_torch_geometry.py; the train CLI by tests/test_torch_cli.py.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import cc_tpu.ops.correlation_pallas as cp
from cc_tpu.geometry.sampling import grid_sample as jax_grid_sample
from cc_tpu.ops.correlation import correlation_xla
from cc_tpu.ops.image import adaptive_avg_pool as jax_pool
from cc_tpu.train import build_train_step as jax_build_train_step
from cc_tpu.train import make_models as jax_make_models
from cc_tpu.train.step import compute_losses as jax_compute_losses
from cc_tpu_torch.geometry.sampling import grid_sample_nhwc
from cc_tpu_torch.losses import ssim as tssim
from cc_tpu_torch.models.layers import BatchNorm2d
from cc_tpu_torch.ops import correlation as tc
from cc_tpu_torch.ops.image import adaptive_avg_pool
from cc_tpu_torch.train import (
    METRICS, TrainConfig, build_train_step, make_models, make_optimizer,
)
from cc_tpu_torch.train.step import apply_net, compute_losses, forward_all
from cc_tpu_torch.weights import state_dict_from_flax
from tests.test_torch_train_step import (
    BF16, _adam_state, _archs, _port, cc_tpu_steps, drawn_state,
    port_fp32_step,
)
from tests.test_train_step import synth_batch, tiny_config
from tests.torch_port_util import (
    check_bf16, check_bf16_update, computed_once, rel, to_numpy,
)

torch.set_num_threads(2)

BF = torch.bfloat16
CORR_CASES = [(9, 1), (21, 2)]
CORR_SHAPE = (2, 8, 12, 32)


def _bf16_values(shape, seed, scale=1.0) -> np.ndarray:
    """Seeded normal values that bf16 holds exactly, as float32."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(BF).float().numpy()


def _jax(x, dtype):
    return jnp.asarray(x, dtype=dtype)


@pytest.fixture
def interpret_mode():
    old = cp.INTERPRET
    cp.INTERPRET = True
    yield
    cp.INTERPRET = old


def _cc_correlation(impl: str):
    return {"xla": correlation_xla, "pallas": cp.correlation_pallas}[impl]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("patch,dilation", CORR_CASES)
def test_correlation_plain_in_bf16(interpret_mode, impl, patch, dilation):
    """correlation_plain and correlation_backward_plain on bf16 inputs
    (widened, summed in float32, rounded once), and autograd through
    `correlation` on the CPU, against cc_tpu's correlation_xla and its
    Pallas kernel (interpret mode) on the same bf16 values, which round
    each product (and the Pallas kernel's custom_vjp sums its bf16
    products in bf16), through jax.vjp: the yardstick's upper bound for
    the cost volume and both gradients, each bf16 as cc_tpu's."""
    a, b = _bf16_values(CORR_SHAPE, 0), _bf16_values(CORR_SHAPE, 1)
    g = _bf16_values((*CORR_SHAPE[:3], patch * patch), 4)
    fn = _cc_correlation(impl)

    def value_and_grads(x, y, dy):
        out, vjp = jax.vjp(lambda u, v: fn(u, v, patch, dilation), x, y)
        return (out, *vjp(dy))
    run = jax.jit(value_and_grads)
    refs = {dtype: run(_jax(a, dtype), _jax(b, dtype), _jax(g, dtype))
            for dtype in (jnp.bfloat16, jnp.float32)}
    assert all(r.dtype == jnp.bfloat16 for r in refs[jnp.bfloat16])
    ta = torch.from_numpy(a).to(BF).requires_grad_()
    tb = torch.from_numpy(b).to(BF).requires_grad_()
    tg = torch.from_numpy(g).to(BF)
    out = tc.correlation(ta, tb, patch, dilation)
    out.backward(tg)
    plain = tc.correlation_backward_plain(ta.detach(), tb.detach(), tg,
                                          patch, dilation)
    where = f"{impl} P={patch} d={dilation}"
    got = {"out": [(0, out), (0, tc.correlation_plain(
        ta.detach(), tb.detach(), patch, dilation))],
        "df1": [(1, plain[0]), (1, ta.grad)],
        "df2": [(2, plain[1]), (2, tb.grad)]}
    for name, pairs in got.items():
        for i, mine in pairs:
            assert mine.dtype == BF, (where, name)
            check_bf16(f"{where} {name}", mine, None, refs[jnp.bfloat16][i],
                       refs[jnp.float32][i], lower=False)


def test_correlation_kernels_take_float32_and_bfloat16_only():
    """The kernels' dtype contract, checked before any launch: a pair of one
    dtype, float32 or bfloat16 (which, on the CPU, then fails the device
    check); mixed or other dtypes raise TypeError."""
    x = torch.zeros(1, 2, 3, 8)
    for a, b in ((x.half(), x.half()), (x, x.to(BF)), (x.double(),
                                                       x.double())):
        with pytest.raises(TypeError):
            tc._check(a, b, 9, 1)
    for dtype in tc.DTYPES:
        with pytest.raises(ValueError, match="CUDA"):
            tc._check(x.to(dtype), x.to(dtype), 9, 1)


def test_bf16_weight_gradients_on_the_cpu_are_exact_zeros_on_padding():
    """A 3x3 convolution on a 1x1 input with padding 1 (PoseNetB6's conv8
    at 128x128) in bf16 through apply_net on the CPU, a hundred times: the
    weight gradient of every tap that reads only padding is exactly 0, and
    all of it finite. torch 2.13's oneDNN bf16 backward leaves garbage
    there, at times NaN (which the non-finite guard then drops), in about
    one call in ten; apply_net sums the CPU's bf16 convolutions in
    float32 and rounds once instead."""
    torch.manual_seed(0)
    net = torch.nn.Conv2d(256, 256, 3, 2, 1)
    for _ in range(100):
        net.zero_grad()
        apply_net(net, "bfloat16", torch.randn(1, 256, 1, 1)).sum().backward()
        g = net.weight.grad
        assert bool(torch.isfinite(g).all())
        border = g.clone()
        border[:, :, 1, 1] = 0
        assert not border.any()


def test_batchnorm_in_bf16_follows_flax():
    """BatchNorm2d on a bf16 input with bf16 copies of its weight and bias
    (as apply_net gives it) against flax's nn.BatchNorm on the same: the
    statistics and the normalization in float32, the output bf16, the
    running stats float32 and moved by the float32 statistics; training
    and eval mode."""
    import flax.linen as fnn
    r = np.random.RandomState(7)
    x = _bf16_values((2, 3, 5, 8), 5, 2.0) + 1  # NHWC
    x = torch.from_numpy(x).to(BF).float().numpy()
    scale = _bf16_values((8,), 6, 0.3) + 1
    bias = _bf16_values((8,), 7, 0.3)
    mean = r.uniform(-0.5, 0.5, 8).astype(np.float32)
    var = r.uniform(0.5, 1.5, 8).astype(np.float32)
    params = {"scale": _jax(scale, jnp.bfloat16),
              "bias": _jax(bias, jnp.bfloat16)}
    for training in (True, False):
        bn = fnn.BatchNorm(use_running_average=not training, momentum=0.9,
                           epsilon=1e-5)
        out, upd = bn.apply({"params": params,
                             "batch_stats": {"mean": mean, "var": var}},
                            _jax(x, jnp.bfloat16), mutable=["batch_stats"])
        mine = BatchNorm2d(8, eps=1e-5, momentum=0.1).train(training)
        with torch.no_grad():
            mine.running_mean.copy_(torch.from_numpy(mean))
            mine.running_var.copy_(torch.from_numpy(var))
        y = torch.func.functional_call(
            mine, {"weight": torch.from_numpy(scale).to(BF),
                   "bias": torch.from_numpy(bias).to(BF)},
            (torch.from_numpy(x).to(BF).permute(0, 3, 1, 2),))
        assert out.dtype == jnp.bfloat16 and y.dtype == BF
        assert mine.running_var.dtype == torch.float32
        # one bf16 rounding of float32 values that agree to ~1e-6
        yo = to_numpy(y.permute(0, 2, 3, 1))
        assert rel(yo, out) <= 2.0 ** -8, (training, rel(yo, out))
        np.testing.assert_allclose(mine.running_mean.numpy(),
                                   upd["batch_stats"]["mean"], atol=1e-6)
        np.testing.assert_allclose(mine.running_var.numpy(),
                                   upd["batch_stats"]["var"], atol=1e-6)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_in_bf16(padding_mode):
    """grid_sample of a bf16 payload at float32 locations (some beyond the
    image, which border mode clamps; on the CPU by the clamped grid)
    against cc_tpu's, value and gradients with respect to the payload and
    the grid, by the yardstick, with float32 coordinate math on both
    sides."""
    img = _bf16_values((2, 9, 11, 3), 8)
    r = np.random.RandomState(9)
    grid = r.uniform(-1.2, 1.2, (2, 7, 10, 2)).astype(np.float32)
    w = r.randn(2, 7, 10, 3).astype(np.float32)

    def cc(dtype):
        def loss(i, gr):
            out = jax_grid_sample(i, gr, padding_mode)
            return jnp.sum(out.astype(jnp.float32) * w), out
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(_jax(img, dtype),
                                                           jnp.asarray(grid))
        return out, *grads

    def port(dtype):
        i = torch.from_numpy(img).to(dtype).requires_grad_()
        gr = torch.from_numpy(grid).requires_grad_()
        out = grid_sample_nhwc(i, gr, padding_mode)
        (out.float() * torch.from_numpy(w)).sum().backward()
        return out, i.grad, gr.grad

    cc16, cc32 = cc(jnp.bfloat16), cc(jnp.float32)
    p16, p32 = port(BF), port(torch.float32)
    assert p16[0].dtype == p16[1].dtype == BF and cc16[0].dtype == jnp.bfloat16
    for k, name in enumerate(("value", "d_img", "d_grid")):
        check_bf16(f"{padding_mode} {name}", p16[k], p32[k], cc16[k],
                   cc32[k])


def test_adaptive_avg_pool_in_bf16():
    """The losses' pyramid pooling in the images' dtype against cc_tpu's
    (repeated halving in bf16), divisible and not."""
    img = _bf16_values((2, 32, 48, 3), 10)
    for hw in ((8, 12), (5, 7)):
        cc16 = jax_pool(_jax(img, jnp.bfloat16), hw)
        cc32 = jax_pool(_jax(img, jnp.float32), hw)
        p16 = adaptive_avg_pool(torch.from_numpy(img).to(BF), hw)
        p32 = adaptive_avg_pool(torch.from_numpy(img), hw)
        assert p16.dtype == BF and cc16.dtype == jnp.bfloat16
        check_bf16(f"pool to {hw}", p16, p32, cc16, cc32)


def test_ssim_in_bf16():
    """The SSIM map of two bf16 images (both blurs in bf16) against
    cc_tpu's."""
    from cc_tpu.losses.ssim import ssim as jax_ssim
    a, b = _bf16_values((2, 24, 32, 3), 11), _bf16_values((2, 24, 32, 3), 12)
    cc16 = jax_ssim(_jax(a, jnp.bfloat16), _jax(b, jnp.bfloat16))
    cc32 = jax_ssim(_jax(a, jnp.float32), _jax(b, jnp.float32))
    p16 = tssim.ssim(torch.from_numpy(a).to(BF), torch.from_numpy(b).to(BF))
    p32 = tssim.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert p16.dtype == BF and cc16.dtype == jnp.bfloat16
    check_bf16("ssim", p16, p32, cc16, cc32)


def _port_config(jcfg) -> TrainConfig:
    """cc_tpu's TrainConfig as the port's."""
    return TrainConfig(**{f: getattr(jcfg, f)
                          for f in TrainConfig.__dataclass_fields__})


def _seeded(cfg):
    """The port's four nets for cfg from a seeded init, on the CPU, and
    test_train_step's synth_batch as numpy."""
    nets = make_models(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    return nets, {k: np.array(v) for k, v in synth_batch(cfg).items()}


def test_compute_losses_in_bf16():
    """compute_losses with loss_dtype "bfloat16" (images and masks cast to
    bf16 at the loss boundary, geometry float32, every scalar reduced in
    float32) against cc_tpu's (one jit of both dtypes) on the same float32
    net outputs, the port's nets' on synth_batch: each of the six losses
    by the yardstick, with the float32 losses of both packages as the
    references. test_train_step's config with edge-aware smoothness, so
    that the images reach the smoothness loss too."""
    cfgs = {dt: tiny_config(smoothness_type="edgeaware", loss_dtype=dt)
            for dt in ("float32", "bfloat16")}
    nets, batch = _seeded(_port_config(cfgs["float32"]))
    with torch.no_grad():
        out = forward_all(_port_config(cfgs["float32"]), nets, batch,
                          training=True)
        losses = {dt: compute_losses(_port_config(cfg), out, batch)[1]
                  for dt, cfg in cfgs.items()}
    as_numpy = lambda x: (x if x is None else [to_numpy(t) for t in x]
                          if isinstance(x, list) else to_numpy(x))
    cc = jax.device_get(jax.jit(lambda o, b: {
        dt: jax_compute_losses(cfg, o, b)[1] for dt, cfg in cfgs.items()})(
        {k: as_numpy(v) for k, v in out.items()}, batch))
    for k in METRICS:
        assert losses["bfloat16"][k].dtype == torch.float32, k
        check_bf16(k, losses["bfloat16"][k], losses["float32"][k],
                   cc["bfloat16"][k], cc["float32"][k])


def _cc_bf16_step() -> dict:
    """cc_tpu's jitted guarded bf16 step (tests/test_bf16_step.py's
    _bf16_cfg, with donate=False: the file's one step compile) from
    drawn_state's variables, which are cc_tpu_steps', on synth_batch: its
    metrics, new params and stats, and first moments."""
    cfg = tiny_config(**BF16)
    state = drawn_state(cfg)
    step = jax_build_train_step(cfg, jax_make_models(cfg), donate=False)
    batch = {k: np.array(v) for k, v in synth_batch(cfg).items()}
    new_state, metrics = jax.device_get(step(state, batch))
    return {"metrics": metrics, "params": new_state.params,
            "stats": new_state.batch_stats,
            "mu": _adam_state(new_state.opt_state).mu,
            "count": int(new_state.step)}


def _stats_of(state_dict, name):
    return {k[len(name) + 1:]: v for k, v in state_dict.items()
            if k.startswith(name + ".")
            and k.endswith(("running_mean", "running_var"))}


def test_guarded_bf16_step_matches_cc_tpu(tmp_path_factory):
    """The port's guarded bf16 step (compute_dtype bfloat16, clip 5,
    non-finite guard) against cc_tpu's jitted one from the same weights on
    the same batch, with cc_tpu's float32 step (test_train_step's config:
    the same forward and losses, which the optimizer does not change) as
    the reference distance; every convolution ran in bf16, the master
    weights stay float32. Held:

    - the six metrics by the yardstick: the upper bound for each metric,
      the lower bound over the six as one vector. A scalar loss averages
      the port's zero-mean bf16 roundings over all its pixels, while
      cc_tpu's repeated roundings (nine bf16 partial sums a tap-matmul
      conv) add a bias, so one loss alone can move 38 times less in the
      port than in cc_tpu (photo_cam_loss here: 1.9e-5 against 7.3e-4
      relative) though bf16 ran;
    - each net's update (parameters after the step less those before) by
      torch_port_util.check_bf16_update: the yardstick, with cc_tpu's
      float32 update as the reference distance, and the update's sign
      on the entries whose gradient lies far above Adam's eps in both of
      cc_tpu's steps. Masters that the step left as they are fail the
      sign share (0); an update of the wrong sign fails both;
    - every parameter within 2*lr of cc_tpu's bf16 step's (Adam's first
      step moves each by about lr*sign(grad));
    - each BatchNorm running stat by the yardstick.

    The flow net's update agrees in sign on fewer entries (89%) than the
    other nets' (98.5-100%): its finest decoder learns mostly from the
    full-resolution photometric loss, whose derivative at a sample point
    that lands exactly on a pixel row or column (about 9% of them with
    bf16 flows, almost none in float32) takes the neighbour on one side in
    the port and in cc_tpu's arithmetic run op by op, and on the other
    side at a tenth of those points in cc_tpu's jitted step.

    Adam's moments are not held by the yardstick: the update's sign share
    holds the gradients' directions, while a moment's error here is a sum
    of such one-sided derivatives and of ReLU flips (ROADMAP Queue C), not
    of rounding."""
    # the bf16 compile first: the float32 step may still be compiling on
    # another worker, which holds its lock
    cc16 = computed_once(tmp_path_factory, "cc_tpu_bf16_step", _cc_bf16_step)
    cc_steps = computed_once(tmp_path_factory, "cc_tpu_steps", cc_tpu_steps)
    jcfg = tiny_config()
    batch, cc32_state, cc32 = cc_steps["synth"]
    _, nets32, _, m32 = computed_once(
        tmp_path_factory, "port_fp32_step",
        lambda: port_fp32_step(jcfg, cc_steps["params"], cc_steps["stats"],
                               batch))
    state32 = nets32.state_dict()
    cfg, nets = _port(jcfg, cc_steps["params"], cc_steps["stats"], **BF16)
    opt_state = make_optimizer(cfg).init(nets)
    dtypes16 = set()
    for m in nets.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(lambda m, a, o: dtypes16.add(a[0].dtype))
    m16 = build_train_step(cfg, nets, opt_state)(batch)
    state16 = nets.state_dict()
    assert dtypes16 == {BF}
    assert (opt_state.count, opt_state.notfinite) == (1, 0)
    assert cc16["count"] == 1
    assert all(v.dtype == torch.float32 for v in state16.values()
               if v.is_floating_point())
    for k in METRICS:
        check_bf16(k, m16[k], m32[k], cc16["metrics"][k], cc32[k],
                   lower=False)
    vector = lambda m: np.array([float(m[k]) for k in METRICS])
    check_bf16("metrics", vector(m16), vector(m32), vector(cc16["metrics"]),
               vector(cc32))

    tol = 2 * jcfg.lr + 1e-6
    grad = lambda mu, name, arch: {
        k: v / (1.0 - jcfg.momentum) for k, v in state_dict_from_flax(
            arch, mu[name], cc_steps["stats"][name]).items()}
    cc32_mu = _adam_state(cc32_state.opt_state).mu
    for name, arch in _archs(jcfg).items():
        ref = state_dict_from_flax(arch, cc16["params"][name],
                                   cc16["stats"][name])
        ref32 = state_dict_from_flax(arch, cc32_state.params[name],
                                     cc32_state.batch_stats[name])
        mine = {k[len(name) + 1:]: v for k, v in state16.items()
                if k.startswith(name + ".")}
        assert set(mine) == set(ref)
        params = [k for k in mine if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked"))]
        for k in params:
            err = float(np.max(np.abs(mine[k].numpy() - np.asarray(ref[k]))))
            assert err <= tol, f"{name}.{k}: {err} > {tol}"
        theta0 = state_dict_from_flax(arch, cc_steps["params"][name],
                                      cc_steps["stats"][name])
        mine32 = {k[len(name) + 1:]: v for k, v in state32.items()
                  if k.startswith(name + ".")}
        g16, g32 = grad(cc16["mu"], name, arch), grad(cc32_mu, name, arch)
        pick = lambda d: {k: d[k] for k in params}
        print(name, check_bf16_update(
            name, pick(theta0), pick(mine), pick(mine32), pick(ref),
            pick(ref32), pick(g16), pick(g32)))
        stats32 = _stats_of(state32, name)
        for k, t in _stats_of(state16, name).items():
            check_bf16(f"{name}.{k}", t, stats32[k], ref[k], ref32[k])


def test_loss_dtype_alone_runs_float32_nets(monkeypatch):
    """loss_dtype "bfloat16" with compute_dtype "float32": the dtypes are
    independent, as in cc_tpu. The nets run in float32 (every convolution
    takes float32) and the loss stack in bf16 (SSIM takes bf16 images);
    the metrics move away from the float32 step's, but by less than the
    loss stack's bf16 rounding allows (2**-6 relative)."""
    import cc_tpu_torch.losses.consensus as cs
    import cc_tpu_torch.losses.photometric as ph
    metrics, seen = {}, {}
    ssim = tssim.ssim
    ssim_in = set()

    def spy(a, b, *args, **kw):
        ssim_in.add(a.dtype)
        return ssim(a, b, *args, **kw)
    monkeypatch.setattr(ph, "ssim", spy)
    monkeypatch.setattr(cs, "ssim", spy)
    for loss_dtype in ("float32", "bfloat16"):
        cfg = _port_config(tiny_config(loss_dtype=loss_dtype))
        nets, batch = _seeded(cfg)
        conv = set()
        ssim_in.clear()
        for m in nets.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.register_forward_hook(lambda m, a, o: conv.add(a[0].dtype))
        opt_state = make_optimizer(cfg).init(nets)
        metrics[loss_dtype] = build_train_step(cfg, nets, opt_state)(batch)
        seen[loss_dtype] = (conv, set(ssim_in))
    assert seen["float32"] == ({torch.float32}, {torch.float32})
    assert seen["bfloat16"] == ({torch.float32}, {BF})
    moved = [rel(metrics["bfloat16"][k], metrics["float32"][k])
             for k in METRICS]
    assert max(moved) > 0 and max(moved) <= 2.0 ** -6, moved
