"""The port's MNIST CC demo (cc_tpu_torch.mnist, cli.mnist, cli.mnist_eval)
against cc_tpu's, on the CPU: LeNet on carried weights, the loaders and
the batch iterator, alternating compete and collaborate steps (the two
Adam states, frozen nets, weight decay on a zero gradient), evaluate, and
the two CLIs end to end.

cc_tpu's steps are compiled with tests/test_mnist_cc.py's
MnistConfig(lr=1e-3) and batch 64 where a case allows, so that the
persistent compile cache serves both files.
"""
import os
import struct

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from cc_tpu import mnist as jmnist
from cc_tpu.cli import mnist as jcli
from cc_tpu.cli import mnist_eval as jeval
from cc_tpu.mnist import data as jdata
from cc_tpu_torch.cli import mnist as tcli
from cc_tpu_torch.cli import mnist_eval as teval
from cc_tpu_torch.mnist import data as tdata
from cc_tpu_torch.mnist import train as tmnist
from cc_tpu_torch.mnist.model import LeNet
from cc_tpu_torch.weights import lenet_state_from_flax, load_cc_tpu_mnist_state
from tests.test_mnist_cc import synth_batch
from tests.torch_port_util import assert_close, draw_flax_variables

torch.set_num_threads(2)

LR = 1e-3
# fp32 losses of two LeNets summed in another order (XLA, oneDNN), after
# up to 6 Adam steps; relative to each metric (measured: 1.9e-6)
METRIC_RTOL = 1e-4
# Adam's moments after 3 updates, relative to the largest of each net's:
# conv1's bias gradient sums 64*26*26 terms a channel, which cancel
# (measured: 7.7e-4 there, 1.1e-4 elsewhere)
MU_RTOL = 5e-3
# logits of one LeNet on the same weights (measured: 3.6e-7)
LOGIT_ATOL = 1e-5
VARIANTS = {"default": {}, "fix_alice": {"fix_alice": True},
            "fix_bob": {"fix_bob": True}, "fix_mod": {"fix_mod": True},
            "decay_fix_bob": {"weight_decay": 1e-2, "fix_bob": True}}
STEPS = 6


def _port_state(cfg, params):
    """The port's state at zero moments, with cc_tpu's params carried."""
    state = tmnist.init_mnist_state(tmnist.MnistConfig(**vars(cfg)), "cpu")
    load_cc_tpu_mnist_state(state.nets, params)
    return state


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_lenet_matches_flax():
    """lenet_state_from_flax: the port's LeNet on cc_tpu's weights gives
    cc_tpu's logits. The weights and input are drawn (no symmetry), so a
    wrong flatten order of fc1 shows."""
    r = np.random.RandomState(0)
    x = r.randn(5, 28, 28, 1).astype(np.float32)
    for nout in (10, 1):
        net = jmnist.LeNet(nout)
        shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 28, 28, 1)))["params"]
        params = draw_flax_variables(shapes, r)
        ref = np.asarray(jax.jit(net.apply)({"params": params}, x))
        mine = LeNet(nout)
        mine.load_state_dict(lenet_state_from_flax(params), strict=True)
        with torch.no_grad():
            out = mine(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert_close(out, ref, LOGIT_ATOL, f"LeNet({nout})")


def _write_idx(d, prefix, images, labels, gz):
    import gzip
    op = (lambda p: gzip.open(p + ".gz", "wb")) if gz else (
        lambda p: open(p, "wb"))
    with op(os.path.join(d, f"{prefix}-images-idx3-ubyte")) as f:
        f.write(struct.pack(">IIII", 2051, len(images), 28, 28))
        f.write(images.tobytes())
    with op(os.path.join(d, f"{prefix}-labels-idx1-ubyte")) as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.tobytes())


def write_mnist_tree(root, n_train, n_test, rng, gz=False):
    """<root>/mnist (IDX) and <root>/svhn (.mat) of digits drawn from
    `rng`; SVHN's labels run 1..10, 10 standing for 0."""
    from scipy.io import savemat
    os.makedirs(os.path.join(root, "mnist"))
    os.makedirs(os.path.join(root, "svhn"))
    for prefix, split, n in (("train", "train", n_train),
                             ("t10k", "test", n_test)):
        _write_idx(os.path.join(root, "mnist"), prefix,
                   rng.integers(0, 255, (n, 28, 28), dtype=np.uint8),
                   rng.integers(0, 10, n, dtype=np.uint8), gz)
        savemat(os.path.join(root, "svhn", f"{split}_32x32.mat"),
                {"X": rng.integers(0, 255, (32, 32, 3, n // 2),
                                   dtype=np.uint8),
                 "y": rng.integers(1, 11, (n // 2, 1), dtype=np.uint8)})
    return root


@pytest.mark.parametrize("gz", [False, True])
def test_loaders_and_batches_match(tmp_path, gz):
    root = write_mnist_tree(str(tmp_path), 70, 30, np.random.default_rng(3),
                            gz)
    for train in (True, False):
        for load in ("load_mnist", "load_svhn"):
            sub = os.path.join(root, "mnist" if load == "load_mnist"
                               else "svhn")
            (xi, yi), (xr, yr) = (getattr(m, load)(sub, train)
                                  for m in (tdata, jdata))
            assert xi.dtype == xr.dtype and np.array_equal(xi, xr), load
            assert yi.dtype == yr.dtype and np.array_equal(yi, yr), load
    x, y = tdata.load_mnist(os.path.join(root, "mnist"), True)
    for kw in ({}, {"shuffle": False, "drop_last": False},
               {"seed": 5, "drop_last": False}):
        mine = list(tdata.iterate_batches(x, y, 16, **kw))
        ref = list(jdata.iterate_batches(x, y, 16, **kw))
        assert len(mine) == len(ref) == (4 if kw.get("drop_last", 1) else 5)
        for (a, b), (c, d) in zip(mine, ref):
            assert np.array_equal(a, c) and np.array_equal(b, d)


def _adam(opt_state):
    """The ScaleByAdamState inside an optax multi_transform state."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


@pytest.mark.parametrize("variant", VARIANTS)
def test_alternating_steps_match(variant):
    """6 steps, compete and collaborate in turns, from carried params and
    the same batches: the metrics, each optimizer's count and moments (for
    its train group only: a frozen net keeps none), and the parameters.
    Adam moves a parameter by about lr*sign(grad) a step, so where a
    near-zero gradient takes the other sign the two differ by up to 2*lr a
    step. A net outside a step's group keeps its bits; with weight decay
    and fix_bob the moderator still moves in compete steps, whose loss
    does not reach it."""
    cfg = jmnist.MnistConfig(lr=LR, **VARIANTS[variant])
    jstate = jmnist.init_mnist_state(cfg, jax.random.PRNGKey(0))
    state = _port_state(cfg, _numpy_tree(jstate.params))
    jsteps = (jmnist.make_compete_step(cfg), jmnist.make_collaborate_step(cfg))
    tcfg = tmnist.MnistConfig(**vars(cfg))
    steps = (tmnist.make_compete_step(tcfg),
             tmnist.make_collaborate_step(tcfg))
    groups = (tmnist.compete_group(tcfg), tmnist.collaborate_group(tcfg))
    for i in range(STEPS):
        phase = i % 2
        img, target = (np.asarray(a) for a in synth_batch(64, seed=i))
        before = {n: {k: v.clone() for k, v in state.nets[n].state_dict()
                      .items()} for n in tmnist.NETS}
        jstate, jm = jsteps[phase](jstate, img, target)
        m = steps[phase](state, img, target)
        assert set(m) == set(jm)
        for k in jm:
            ref = float(jm[k])
            assert_close(m[k], ref, METRIC_RTOL * max(1.0, abs(ref)), k)
        for n in tmnist.NETS:
            if n not in groups[phase]:
                after = state.nets[n].state_dict()
                assert all(torch.equal(after[k], before[n][k])
                           for k in after), (i, n)
        if variant == "decay_fix_bob" and phase == 0:
            assert not torch.equal(state.nets["mod"].fc2.weight,
                                   before["mod"]["fc2.weight"])
    assert state.step == int(jstate.step) == STEPS
    for opt, group in zip(("opt_compete", "opt_collaborate"), groups):
        jadam = _adam(getattr(jstate, opt))
        mine = getattr(state, opt)
        assert mine.count == int(jadam.count) == STEPS // 2
        assert set(mine.mu) == set(group)
        for n in tmnist.NETS:
            leaf = jadam.mu[n]
            assert isinstance(leaf, dict) == (n in group), (opt, n)
        for n in group:
            keys = [k for k, _ in state.nets[n].named_parameters()]
            for mom in ("mu", "nu"):
                ref = lenet_state_from_flax(_numpy_tree(getattr(jadam, mom)[n]))
                top = max(float(v.abs().max()) for v in ref.values())
                for k, t in zip(keys, getattr(mine, mom)[n]):
                    assert_close(t, ref[k], MU_RTOL * top, f"{opt}.{mom}.{n}.{k}")
    for n in tmnist.NETS:
        ref = lenet_state_from_flax(_numpy_tree(jstate.params[n]))
        for k, t in state.nets[n].state_dict().items():
            assert_close(t, ref[k], 2 * LR * STEPS + 1e-6, f"{n}.{k}")


def test_evaluate_matches():
    """evaluate's three error rates, exactly, over batches of 64 with a
    ragged last one, on the state after a compete step (so that the
    moderator picks both Alice and Bob)."""
    cfg = jmnist.MnistConfig(lr=LR)
    jstate = jmnist.init_mnist_state(cfg, jax.random.PRNGKey(1))
    img, target = (np.asarray(a) for a in synth_batch(64, seed=7))
    jstate, _ = jmnist.make_compete_step(cfg)(jstate, img, target)
    nets = tmnist.models("cpu")
    load_cc_tpu_mnist_state(nets, _numpy_tree(jstate.params))
    x, y = (np.asarray(a) for a in synth_batch(150, seed=8))
    batches = lambda: jdata.iterate_batches(x, y, 64, shuffle=False,
                                            drop_last=False)
    ref, names = jmnist.evaluate(jstate.params, batches())
    mine, my_names = tmnist.evaluate(nets, batches())
    assert my_names == names and mine == ref
    _, la, lb = (p.numpy() for p in tmnist.predict(nets, x))
    assert (la != lb).any()


@pytest.fixture
def mnist_tree(tmp_path):
    return write_mnist_tree(str(tmp_path / "data"), 256, 96,
                            np.random.default_rng(8))


def test_cli_matches_cc_tpu(mnist_tree, tmp_path, monkeypatch, capsys):
    """cli.mnist for 2 epochs (compete, collaborate) on each side, the
    port's from cc_tpu's init_mnist_state(cfg, PRNGKey(seed)): the same
    printed lines; then mnist_eval of each side's best checkpoint gives the
    same error rates."""
    argv = [mnist_tree, "--name", "cc", "--epochs", "2", "-b", "64",
            "--lr", str(LR), "--print-freq", "1"]
    monkeypatch.chdir(tmp_path)
    jcli.main(argv)
    ref = capsys.readouterr().out

    def carried_init(cfg, device=None, generator=None):
        jcfg = jmnist.MnistConfig(**vars(cfg))
        params = jmnist.init_mnist_state(jcfg, jax.random.PRNGKey(0)).params
        state = tmnist.init_mnist_state(cfg, device, generator)
        load_cc_tpu_mnist_state(state.nets, _numpy_tree(params))
        return state

    monkeypatch.setattr(tcli, "init_mnist_state", carried_init)
    records = tcli.main(argv[:2] + ["torch"] + argv[3:] + ["--device", "cpu"])
    mine = capsys.readouterr().out
    assert mine.splitlines() == ref.splitlines()
    assert [r["mode"] for r in records] == ["compete", "collaborate"]
    assert [r["steps"] for r in records] == [6, 6]  # (256 + 128) // 64
    assert "epoch 1 [collaborate] Total loss: " in mine
    errors = [float(w.strip(",")) for w in mine.splitlines()[-1].split()[5::3]]
    assert errors == pytest.approx(records[-1]["errors"], abs=5e-5)

    save = tmp_path / "checkpoints"
    assert (save / "torch" / "mnist_checkpoint.pt").is_file()
    ref_errors = jeval.main([mnist_tree, "--checkpoint",
                             str(save / "cc" / "mnist_best")])
    my_errors = teval.main([mnist_tree, "--checkpoint",
                            str(save / "torch" / "mnist_best.pt"),
                            "--device", "cpu"])
    assert my_errors == ref_errors
    out = capsys.readouterr().out.splitlines()
    assert out[-3:] == out[-6:-3]  # the same three accuracy lines


@pytest.mark.parametrize("mine,ref", [(tcli.parser, jcli.parser),
                                      (teval.parser, jeval.parser)])
def test_parsers_match_cc_tpu(mine, ref):
    actions = lambda p: {a.dest: (a.option_strings, type(a), a.default,
                                  a.type, a.choices, a.required, a.nargs)
                         for a in p._actions}
    a = actions(mine)
    device = a.pop("device")
    assert device[0] == ["--device"] and device[2] == "cuda"
    assert a == actions(ref)


@pytest.mark.parametrize("cli", [tcli, teval])
def test_cuda_default_raises_before_any_file(cli, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ([str(tmp_path), "--name", "x"] if cli is tcli
            else [str(tmp_path), "--checkpoint", "none.pt"])
    if torch.cuda.is_available():
        assert cli.parser.parse_args(argv).device == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    assert os.listdir(tmp_path) == []
