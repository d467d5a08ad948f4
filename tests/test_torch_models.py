"""cc_tpu_torch nets vs cc_tpu's, in eval and train mode, on weights carried
across.

Each net's variables have the structure of its flax init (at the size of
tests/test_models.py) and values drawn with numpy, BatchNorm running stats
included, so that eval-mode BN is exercised; the weights go to the port
through cc_tpu_torch.weights, whose state dict must equal cc_tpu's
export_state_dict exactly.
"""
import numpy as np
import pytest
import jax
import torch

from cc_tpu import models as jmodels
from cc_tpu.train.torch_export import export_state_dict
from cc_tpu_torch import models as tmodels
from cc_tpu_torch.weights import load_flax_weights, state_dict_from_flax
from tests.torch_port_util import (
    assert_close, draw_flax_variables, nchw_to_nhwc, nhwc_to_nchw,
)

torch.set_num_threads(2)

B, H, W = 1, 128, 128
ARCHS = ["DispResNet6", "PoseNetB6", "MaskNet6", "Back2Future"]
# the rest of the DispNet family, off the main path
VARIANTS = ["DispNetS", "DispNetS6", "DispResNetS6"]
NREF = {"PoseNetB6": 4, "MaskNet6": 4, "Back2Future": 2}
# fp32 convs summed in another order by XLA and oneDNN, through up to ~40
# layers; relative to each output's largest magnitude
RTOL = 1e-4


def _inputs(arch, b=B):
    r = np.random.RandomState(0)
    tgt = (r.rand(b, H, W, 3) * 2 - 1).astype(np.float32)
    refs = [(r.rand(b, H, W, 3) * 2 - 1).astype(np.float32)
            for _ in range(NREF.get(arch, 0))]
    return tgt, refs


@pytest.fixture(scope="module")
def flax_vars():
    """arch -> (module, params, batch_stats) as numpy. The flax init gives
    the variable trees' structure (traced, not compiled); the values are
    drawn with numpy."""
    r = np.random.RandomState(1)
    out = {}
    for arch in ARCHS + VARIANTS:
        net = jmodels.build(arch)
        tgt, refs = _inputs(arch)
        args = (tgt,) if not refs else (tgt, refs)
        v = jax.eval_shape(lambda k: net.init(k, *args, training=True),
                           jax.random.PRNGKey(0))
        out[arch] = (net, draw_flax_variables(v["params"], r),
                     draw_flax_variables(v.get("batch_stats", {}), r))
    return out


@pytest.mark.parametrize("arch", ARCHS + VARIANTS)
def test_state_dict_equals_export(flax_vars, arch):
    _, params, stats = flax_vars[arch]
    mine = state_dict_from_flax(arch, params, stats)
    ref = export_state_dict(arch, params, stats)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    net = tmodels.build(arch)
    load_flax_weights(net, arch, params, stats)  # strict
    assert set(net.state_dict()) == set(ref)


def test_dispresnet6_has_perturbed_batchnorm(flax_vars):
    _, _, stats = flax_vars["DispResNet6"]
    sd = state_dict_from_flax("DispResNet6", *flax_vars["DispResNet6"][1:])
    running = [k for k in sd if k.endswith("running_var")]
    assert running and not any(np.allclose(sd[k], 1.0) for k in running)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for z in x for y in _flat(z)]
    return [x]


@pytest.mark.parametrize("arch,training", [
    *[(a, t) for a in ARCHS for t in (False, True)],
    *[(a, False) for a in VARIANTS]])
def test_forward_matches(flax_vars, arch, training):
    """Eval mode: running BN stats, finest outputs. Train mode: batch BN
    stats, every scale (the running-stat update is the training slice's),
    at batch 2: at 128x128 the coarsest BN sees one value per channel at
    batch 1, which torch refuses in training."""
    net_j, params, stats = flax_vars[arch]
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    tgt, refs = _inputs(arch, 2 if training else B)
    args = (tgt,) if not refs else (tgt, refs)
    ref = jax.jit(lambda v: net_j.apply(v, *args, training=training,
                                        mutable=["batch_stats"])[0])(variables)

    net_t = load_flax_weights(tmodels.build(arch), arch, params, stats)
    net_t.train(training)
    t_args = [nhwc_to_nchw(tgt)]
    if refs:
        t_args.append([nhwc_to_nchw(x) for x in refs])
    with torch.inference_mode():
        out = net_t(*t_args)

    outs, refs_out = _flat(out), _flat(ref)
    assert len(outs) == len(refs_out)
    for i, (o, e) in enumerate(zip(outs, refs_out)):
        e = np.asarray(e)
        o = o.numpy() if o.dim() == 3 else nchw_to_nhwc(o)  # pose is [B,n,6]
        tol = RTOL * max(1.0, float(np.max(np.abs(e))))
        assert_close(o, e, tol, f"{arch} output {i}")
