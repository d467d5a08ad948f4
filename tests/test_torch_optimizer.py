"""The port's Adam against cc_tpu's make_optimizer (optax) on a toy
four-net parameter tree, through a phase switch: a free step, a
fix_flownet step, a step with a NaN gradient (dropped), and a free step,
with global-norm clipping and weight decay on. After every step: each net's
parameters and both moments, the step count and the dropped-step count."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from torch import nn

from cc_tpu.train.config import TrainConfig as JaxConfig
from cc_tpu.train.state import make_optimizer as jax_make_optimizer
from cc_tpu_torch.train import NETS, TrainConfig, make_optimizer
from tests.torch_port_util import assert_close

torch.set_num_threads(2)

# fp32 Adam arithmetic in another order: a few ulps of values of O(1)
ATOL = 2e-6
SHAPES = {"w": (3, 4), "b": (4,)}
HYPER = dict(lr=1e-2, momentum=0.9, beta=0.999, weight_decay=0.01,
             clip_grad_norm=1.0, skip_nonfinite_updates=True)
# (phase changes, gradient scale, whether disp's gradient holds a NaN)
STEPS = [({}, 3.0, False), ({"fix_flownet": True}, 0.1, False),
         ({}, 1.0, True), ({}, 0.05, False)]


def _adam_state(state):
    for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s
    raise AssertionError("no ScaleByAdamState")


def _grads(r, scale, nan, frozen_flow):
    g = {n: {k: (r.randn(*s) * scale).astype(np.float32)
             for k, s in SHAPES.items()} for n in NETS}
    if frozen_flow:  # stop_gradient in cc_tpu gives exact zeros
        g["flow"] = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    if nan:
        g["disp"]["w"][1, 2] = np.nan
    return g


def _snapshot(nets, state):
    return ({k: v.detach().clone() for k, v in nets.state_dict().items()},
            {n: [m.clone() for m in state.mu[n]] for n in NETS},
            {n: [v.clone() for v in state.nu[n]] for n in NETS})


def test_adam_matches_optax_across_phases():
    r = np.random.RandomState(0)
    params = {n: {k: r.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
              for n in NETS}
    nets = nn.ModuleDict({n: nn.ParameterDict(
        {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in p.items()})
        for n, p in params.items()})
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_make_optimizer(JaxConfig(**HYPER)).init(jparams)
    state = make_optimizer(TrainConfig(**HYPER)).init(nets)

    counts = []
    for i, (changes, scale, nan) in enumerate(STEPS):
        frozen_flow = changes.get("fix_flownet", False)
        g = _grads(r, scale, nan, frozen_flow)
        jopt = jax_make_optimizer(JaxConfig(**HYPER, **changes))
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

        for n in NETS:
            for k, p in nets[n].items():
                # a frozen net gets no gradient in the port (its outputs are
                # detached)
                p.grad = (None if n == "flow" and frozen_flow
                          else torch.from_numpy(g[n][k]))
        before = _snapshot(nets, state)
        make_optimizer(TrainConfig(**HYPER, **changes)).update(nets, state)
        after = _snapshot(nets, state)

        adam = _adam_state(jstate)
        assert state.count == int(adam.count), i
        assert state.notfinite == int(jstate.total_notfinite), i
        counts.append(state.count)
        for n in NETS:
            # the moments follow nets[n].parameters() order
            keys = [k for k, _ in nets[n].named_parameters()]
            for j, k in enumerate(keys):
                assert_close(nets[n][k], jparams[n][k], ATOL, f"step {i} {n}.{k}")
                assert_close(state.mu[n][j], adam.mu[n][k], ATOL,
                             f"step {i} mu {n}.{k}")
                assert_close(state.nu[n][j], adam.nu[n][k], ATOL,
                             f"step {i} nu {n}.{k}")
            # frozen, or the whole step dropped: bit-equal
            if nan or (n == "flow" and frozen_flow):
                assert all(torch.equal(before[0][f"{n}.{k}"],
                                       after[0][f"{n}.{k}"]) for k in SHAPES)
                assert all(torch.equal(a, b) for a, b in
                           zip(before[1][n] + before[2][n],
                               after[1][n] + after[2][n]))
            else:
                assert not torch.equal(before[0][f"{n}.w"], after[0][f"{n}.w"])
    assert counts == [1, 2, 2, 3]

    # The last step's update of the flow net, which took 2 of the 3 applied
    # steps, is bias-corrected by the global count 3 (a count per parameter
    # would use 2)
    b1, b2, lr = HYPER["momentum"], HYPER["beta"], HYPER["lr"]
    j = [k for k, _ in nets["flow"].named_parameters()].index("w")
    mu, nu = state.mu["flow"][j], state.nu["flow"][j]
    delta = after[0]["flow.w"] - before[0]["flow.w"]

    def step_with(count):
        return -lr * (mu / (1 - b1 ** count)) / (
            torch.sqrt(nu / (1 - b2 ** count)) + 1e-8)

    assert_close(delta, step_with(3), ATOL, "global count")
    assert (delta - step_with(2)).abs().max() > 100 * ATOL


def test_state_has_one_structure_in_every_phase():
    nets = nn.ModuleDict({n: nn.Linear(3, 2) for n in NETS})
    shapes = []
    for changes in ({}, {"fix_flownet": True}, {"fix_dispnet": True,
                                               "fix_posenet": True}):
        st = make_optimizer(TrainConfig(**changes)).init(nets)
        shapes.append({n: [tuple(m.shape) for m in st.mu[n] + st.nu[n]]
                       for n in NETS})
    assert shapes[0] == shapes[1] == shapes[2]


@pytest.mark.parametrize("skip", [False, True])
def test_nonfinite_gradient_is_dropped_only_with_skip(skip):
    """Without skip_nonfinite_updates a NaN gradient goes through, as in
    optax without apply_if_finite; with it the step is dropped."""
    nets = nn.ModuleDict({n: nn.Linear(2, 2) for n in NETS})
    cfg = TrainConfig(skip_nonfinite_updates=skip)
    state = make_optimizer(cfg).init(nets)
    for p in nets.parameters():
        p.grad = torch.ones_like(p)
    nets["pose"].weight.grad[0, 0] = float("inf")
    make_optimizer(cfg).update(nets, state)
    finite = bool(torch.isfinite(nets["pose"].weight).all())
    assert finite == skip
    assert (state.count, state.notfinite) == ((0, 1) if skip else (1, 0))
