"""cc_tpu_torch nets vs cc_tpu's, in eval and train mode, on weights carried
across; and FlowNetC6's gradients against jax.grad, which carry the
correlation's backward at P=21, d=2 through the net.

Each net's variables have the structure of its flax init (at the size of
tests/test_models.py) and values drawn with numpy, BatchNorm running stats
included, so that eval-mode BN is exercised; the weights go to the port
through cc_tpu_torch.weights, whose state dict must equal cc_tpu's
export_state_dict exactly.
"""
import io
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cc_tpu import models as jmodels
from cc_tpu.train.torch_export import export_state_dict, save_torch_checkpoint
from cc_tpu_torch import models as tmodels
from cc_tpu_torch.weights import (
    load_flax_weights, load_pretrained, state_dict_from_flax,
)
from cc_tpu_torch.weights import save_torch_checkpoint as save_port_checkpoint
from tests.torch_port_util import (
    assert_close, draw_flax_variables, nchw_to_nhwc, nhwc_to_nchw,
)

torch.set_num_threads(2)

B, H, W = 1, 128, 128
ARCHS = ["DispResNet6", "PoseNetB6", "MaskNet6", "Back2Future", "FlowNetC6"]
# the rest of the zoo, which the train CLI's --dispnet, --posenet and
# --masknet offer; PoseExpNet+exp is PoseExpNet with its mask decoder
VARIANTS = ["DispNetS", "DispNetS6", "DispResNetS6", "PoseNet6", "PoseExpNet",
            "PoseExpNet+exp", "MaskResNet6"]
NREF = {"PoseNetB6": 4, "MaskNet6": 4, "Back2Future": 2, "FlowNetC6": 1,
        "PoseNet6": 4, "PoseExpNet": 4, "PoseExpNet+exp": 4,
        "MaskResNet6": 4}
# case -> (architecture, constructor arguments) where they differ
BUILD = {"PoseExpNet+exp": ("PoseExpNet", {"output_exp": True})}
# fp32 convs summed in another order by XLA and oneDNN, through up to ~40
# layers; relative to each output's largest magnitude
RTOL = 1e-4
# FlowNetC6's gradients, fp32 backward sums in another order through ~20
# layers and the 441-tap correlation; relative to each tensor's largest
# entry (measured: 1.5e-5)
GRAD_RTOL = 1e-4
# cc_tpu's FlowNetC6 tree. The reference file's docstring says 39,175,298
# (tests/test_models.py:166): it predates the sixth level, deconv1 +
# predict_flow1 + upsampled_flow2_to_1 = 101,192 parameters.
FLOWNETC6_PARAMS = 39_276_490


def _arch(case):
    """(architecture, constructor arguments) of a test case."""
    return BUILD.get(case, (case, {}))


def _inputs(arch, b=B):
    r = np.random.RandomState(0)
    tgt = (r.rand(b, H, W, 3) * 2 - 1).astype(np.float32)
    refs = [(r.rand(b, H, W, 3) * 2 - 1).astype(np.float32)
            for _ in range(NREF.get(arch, 0))]
    return tgt, refs


def _args(arch, tgt, refs):
    """The net's positional inputs: FlowNetC6 takes two frames, the others
    the target and (if any) the list of refs."""
    if arch == "FlowNetC6":
        return tgt, refs[0]
    return (tgt,) if not refs else (tgt, refs)


@pytest.fixture(scope="module")
def flax_vars():
    """arch -> (module, params, batch_stats) as numpy. The flax init gives
    the variable trees' structure (traced, not compiled); the values are
    drawn with numpy."""
    r = np.random.RandomState(1)
    out = {}
    for arch in ARCHS + VARIANTS:
        name, kw = _arch(arch)
        net = jmodels.build(name, **kw)
        args = _args(arch, *_inputs(arch))
        v = jax.eval_shape(lambda k: net.init(k, *args, training=True),
                           jax.random.PRNGKey(0))
        out[arch] = (net, draw_flax_variables(v["params"], r),
                     draw_flax_variables(v.get("batch_stats", {}), r))
    return out


@pytest.mark.parametrize("arch", ARCHS + VARIANTS)
def test_state_dict_equals_export(flax_vars, arch):
    _, params, stats = flax_vars[arch]
    name, kw = _arch(arch)
    mine = state_dict_from_flax(name, params, stats)
    ref = export_state_dict(name, params, stats)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    net = tmodels.build(name, **kw)
    load_flax_weights(net, name, params, stats)  # strict
    assert set(net.state_dict()) == set(ref)


def _assert_same_weights(net, ref):
    mine, expected = net.state_dict(), ref.state_dict()
    assert mine.keys() == expected.keys()
    for k in expected:
        assert torch.equal(mine[k], expected[k]), k


@pytest.mark.parametrize("arch", ARCHS + VARIANTS)
def test_pretrained_checkpoint_loads_bit_for_bit(flax_vars, arch, tmp_path):
    """--pretrained-*: a reference .pth.tar written by cc_tpu's exporter
    loads into the port's net as load_flax_weights loads the same
    variables. PoseExpNet starts without its mask decoder, as make_models
    builds it, and is rebuilt with one when the checkpoint has it."""
    _, params, stats = flax_vars[arch]
    name, kw = _arch(arch)
    path = str(tmp_path / "net.pth.tar")
    save_torch_checkpoint(path, name, params, stats)
    nets = torch.nn.ModuleDict({"net": tmodels.build(name)})
    load_pretrained(nets, {"net": path})
    os.remove(path)
    _assert_same_weights(nets["net"], load_flax_weights(
        tmodels.build(name, **kw), name, params, stats))


@pytest.mark.parametrize("arch", ARCHS + VARIANTS)
def test_save_torch_checkpoint_equals_cc_tpus(flax_vars, arch):
    """weights.save_torch_checkpoint of a net loaded from drawn variables
    writes what cc_tpu's save_torch_checkpoint writes of those variables:
    the same epoch, keys, dtypes and values (num_batches_tracked 0, though
    the net counted batches), so it loads as test_pretrained_checkpoint_
    loads_bit_for_bit loads cc_tpu's. The files are written to memory."""
    _, params, stats = flax_vars[arch]
    name, kw = _arch(arch)
    net = load_flax_weights(tmodels.build(name, **kw), name, params, stats)
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            v.fill_(7)
    mine, ref = io.BytesIO(), io.BytesIO()
    save_port_checkpoint(mine, net, epoch=3)
    save_torch_checkpoint(ref, name, params, stats, epoch=3)
    a, b = (torch.load(io.BytesIO(f.getvalue()), map_location="cpu",
                       weights_only=True) for f in (mine, ref))
    assert a["epoch"] == b["epoch"] == 3
    sa, sb = a["state_dict"], b["state_dict"]
    assert sa.keys() == sb.keys()
    for k in sb:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def test_pretrained_drops_prefix_and_batch_counts(flax_vars, tmp_path):
    """A DataParallel prefix and BatchNorm's num_batches_tracked, as a
    torch >= 0.4.1 reference run saves them, in a bare state dict."""
    _, params, stats = flax_vars["DispResNet6"]
    sd = export_state_dict("DispResNet6", params, stats)
    counts = [k for k in sd if k.endswith("num_batches_tracked")]
    assert counts
    sd = {"module." + k: torch.tensor(7) if k in counts
          else torch.from_numpy(np.array(v)) for k, v in sd.items()}
    path = str(tmp_path / "dp.pth.tar")
    torch.save(sd, path)
    nets = torch.nn.ModuleDict({"disp": tmodels.build("DispResNet6")})
    load_pretrained(nets, {"disp": path})
    _assert_same_weights(nets["disp"], load_flax_weights(
        tmodels.build("DispResNet6"), "DispResNet6", params, stats))


@pytest.mark.parametrize("saved,into", [("MaskNet6", "MaskResNet6"),
                                        ("DispNetS6", "DispNetS"),
                                        ("PoseNetB6", "PoseNet6")])
def test_pretrained_wrong_architecture_raises(flax_vars, tmp_path, saved,
                                              into):
    _, params, stats = flax_vars[saved]
    path = str(tmp_path / "net.pth.tar")
    save_torch_checkpoint(path, saved, params, stats)
    nets = torch.nn.ModuleDict({"mask": tmodels.build(into)})
    with pytest.raises(ValueError, match=f"--pretrained-mask .*{into}"):
        load_pretrained(nets, {"mask": path})


def test_dispresnet6_has_perturbed_batchnorm(flax_vars):
    _, _, stats = flax_vars["DispResNet6"]
    sd = state_dict_from_flax("DispResNet6", *flax_vars["DispResNet6"][1:])
    running = [k for k in sd if k.endswith("running_var")]
    assert running and not any(np.allclose(sd[k], 1.0) for k in running)


def _flat(x):
    """The outputs in order; None (PoseExpNet's masks without the
    decoder) is left out, on both sides."""
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [y for z in x for y in _flat(z)]
    return [x]


@pytest.mark.parametrize("arch,training", [
    (a, t) for a in ARCHS + VARIANTS for t in (False, True)])
def test_forward_matches(flax_vars, arch, training):
    """Eval mode: running BN stats, finest outputs. Train mode: batch BN
    stats, every scale (the running-stat update is the training slice's),
    at batch 2: at 128x128 the coarsest BN sees one value per channel at
    batch 1, which torch refuses in training."""
    net_j, params, stats = flax_vars[arch]
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    args = _args(arch, *_inputs(arch, 2 if training else B))
    ref = jax.jit(lambda v: net_j.apply(v, *args, training=training,
                                        mutable=["batch_stats"])[0])(variables)

    name, kw = _arch(arch)
    net_t = load_flax_weights(tmodels.build(name, **kw), name, params, stats)
    net_t.train(training)
    t_args = [nhwc_to_nchw(a) if isinstance(a, np.ndarray)
              else [nhwc_to_nchw(x) for x in a] for a in args]
    with torch.inference_mode():
        out = net_t(*t_args)

    outs, refs_out = _flat(out), _flat(ref)
    assert len(outs) == len(refs_out)
    for i, (o, e) in enumerate(zip(outs, refs_out)):
        e = np.asarray(e)
        o = o.numpy() if o.dim() == 3 else nchw_to_nhwc(o)  # pose is [B,n,6]
        tol = RTOL * max(1.0, float(np.max(np.abs(e))))
        assert_close(o, e, tol, f"{arch} output {i}")


def test_flownetc6_parameter_count(flax_vars):
    _, params, _ = flax_vars["FlowNetC6"]
    flax_count = sum(a.size for a in jax.tree_util.tree_leaves(params))
    net = tmodels.build("FlowNetC6")
    assert flax_count == FLOWNETC6_PARAMS
    assert sum(p.numel() for p in net.parameters()) == FLOWNETC6_PARAMS


def test_flownetc6_gradients_match_jax_grad(flax_vars):
    """The gradient of one scalar, a fixed random weighting of the six
    training-mode flows, over every parameter and both input frames."""
    net_j, params, _ = flax_vars["FlowNetC6"]
    x1, (x2,) = _inputs("FlowNetC6")
    r = np.random.RandomState(2)
    weights = [r.randn(B, H >> k, W >> k, 2).astype(np.float32)
               for k in range(6)]

    def scalar(p, a, b):
        flows = net_j.apply({"params": p}, a, b, training=True)
        return sum(jnp.sum(w * f) for w, f in zip(weights, flows))

    g_params, g_x1, g_x2 = jax.jit(jax.grad(scalar, argnums=(0, 1, 2)))(
        params, x1, x2)
    ref = state_dict_from_flax("FlowNetC6", jax.device_get(g_params))

    net_t = load_flax_weights(tmodels.build("FlowNetC6"), "FlowNetC6",
                              params).train()
    t1, t2 = nhwc_to_nchw(x1).requires_grad_(), nhwc_to_nchw(x2).requires_grad_()
    flows = net_t(t1, t2)
    sum((nhwc_to_nchw(w) * f).sum()
        for w, f in zip(weights, flows)).backward()

    mine = {k: p.grad for k, p in net_t.named_parameters()}
    mine.update(x1=nchw_to_nhwc(t1.grad), x2=nchw_to_nhwc(t2.grad))
    ref.update(x1=np.asarray(g_x1), x2=np.asarray(g_x2))
    assert mine.keys() == ref.keys()
    for k, e in ref.items():
        assert float(np.max(np.abs(e))) > 0, k
        assert_close(mine[k], e, GRAD_RTOL * float(np.max(np.abs(e))), k)
