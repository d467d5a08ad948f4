"""Checkpoints of the port's train state (cc_tpu_torch/train/checkpoint.py),
on the CPU: save and load round trips every tensor and count exactly;
best.pt only when is_best; a strict load raises on another architecture;
and a run resumed from a checkpoint, across a switch to the fix_flownet
phase, equals the uninterrupted run bit for bit. The step count advances
on every step, a dropped one too. No JAX: cc_tpu's counterpart is orbax's
format, which the port does not read (tests/test_torch_train_step.py
carries cc_tpu's state across as numpy trees).
"""
import os

import numpy as np
import pytest
import torch

from cc_tpu_torch.train import (
    NETS, TrainConfig, build_train_step, load_checkpoint, make_models,
    make_optimizer, save_checkpoint,
)
from cc_tpu_torch.train.checkpoint import BEST, CHECKPOINT

torch.set_num_threads(2)

# The smallest shape the nets train at: H and W multiples of 64 and at least
# 128 with smoothness on; batch 2, since DispResNet6's BatchNorm sees one
# value a channel at 1x1 with batch 1. The loss weights of bench.py:80-112.
CFG = TrainConfig(height=128, width=128, batch_size=2, wssim=0.997,
                  smoothness_type="edgeaware", cam_photo_loss_weight=1.0,
                  mask_loss_weight=0.1, smooth_loss_weight=0.1,
                  flow_photo_loss_weight=0.5, consensus_loss_weight=0.3,
                  lr=1e-4)
# the phases of the four steps after the first two
PHASES = (CFG, CFG.replace(fix_flownet=True))


def _batch(seed: int) -> dict:
    r = np.random.RandomState(seed)
    b, h, w = CFG.batch_size, CFG.height, CFG.width
    k = np.array([[w * 0.6, 0, w / 2], [0, h * 1.2, h / 2], [0, 0, 1]],
                 np.float32)[None].repeat(b, 0)
    return {"tgt": r.rand(b, h, w, 3).astype(np.float32) * 2 - 1,
            "refs": r.rand(b, CFG.nb_ref_imgs, h, w, 3).astype(np.float32)
            * 2 - 1,
            "intrinsics": k,
            "intrinsics_inv": np.linalg.inv(k).astype(np.float32)}


def _fresh(cfg=CFG, seed=1):
    nets = make_models(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    return nets, make_optimizer(cfg).init(nets)


def _snapshot(nets, opt_state) -> dict:
    return {"nets": {k: v.clone() for k, v in nets.state_dict().items()},
            "mu": {n: [t.clone() for t in opt_state.mu[n]] for n in NETS},
            "nu": {n: [t.clone() for t in opt_state.nu[n]] for n in NETS},
            "counts": (opt_state.count, opt_state.notfinite, opt_state.step)}


def _assert_equal_state(nets, opt_state, snap: dict):
    sd = nets.state_dict()
    assert set(sd) == set(snap["nets"])
    for k, v in snap["nets"].items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    for group in ("mu", "nu"):
        for n in NETS:
            mine = getattr(opt_state, group)[n]
            assert len(mine) == len(snap[group][n])
            assert all(torch.equal(a, b) for a, b in zip(mine, snap[group][n]))
    assert (opt_state.count, opt_state.notfinite, opt_state.step) == \
        snap["counts"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The uninterrupted run: two steps, a save (is_best), then a step and a
    fix_flownet step. Returns the checkpoint's directory, the state it
    holds, the last two steps' metrics and the final state."""
    nets, opt_state = _fresh(seed=0)
    for i in range(2):
        build_train_step(CFG, nets, opt_state)(_batch(i))
    save_dir = str(tmp_path_factory.mktemp("run"))
    save_checkpoint(save_dir, nets, opt_state, is_best=True)
    saved = _snapshot(nets, opt_state)
    metrics = [build_train_step(cfg, nets, opt_state)(_batch(2 + i))
               for i, cfg in enumerate(PHASES)]
    return save_dir, saved, metrics, _snapshot(nets, opt_state)


@pytest.mark.parametrize("where", ["directory", CHECKPOINT, BEST])
def test_save_and_load_round_trip_exactly(run, where):
    save_dir, saved, _, _ = run
    assert saved["counts"] == (2, 0, 2)
    nets, opt_state = _fresh()
    path = save_dir if where == "directory" else os.path.join(save_dir, where)
    assert load_checkpoint(path, nets, opt_state) is opt_state
    _assert_equal_state(nets, opt_state, saved)


def test_best_is_written_only_when_best(run, tmp_path):
    save_dir = run[0]
    with open(os.path.join(save_dir, CHECKPOINT), "rb") as a, \
            open(os.path.join(save_dir, BEST), "rb") as b:
        assert a.read() == b.read()
    nets, opt_state = _fresh()
    path = save_checkpoint(str(tmp_path), nets, opt_state)
    assert path == str(tmp_path / CHECKPOINT)
    assert sorted(os.listdir(tmp_path)) == [CHECKPOINT]  # no temporary left
    assert sorted(os.listdir(save_dir)) == [BEST, CHECKPOINT]


@pytest.mark.parametrize("change,error", [
    (dict(flownet="FlowNetC6"), ValueError),  # another architecture name
    (dict(sequence_length=3), RuntimeError),  # same names, other shapes
])
def test_strict_load_raises_on_another_architecture(run, change, error):
    cfg = CFG.replace(**change)
    nets, opt_state = _fresh(cfg)
    with pytest.raises(error):
        load_checkpoint(run[0], nets, opt_state)


def test_resume_across_fix_flownet_equals_the_uninterrupted_run(run):
    """Fresh nets and optimizer from another seed, the checkpoint loaded,
    then the same step and fix_flownet step: metrics, parameters,
    BatchNorm stats, Adam's state and the counts equal bit for bit."""
    save_dir, _, metrics, final = run
    nets, opt_state = _fresh(seed=2)
    load_checkpoint(save_dir, nets, opt_state)
    for i, (cfg, expected) in enumerate(zip(PHASES, metrics)):
        got = build_train_step(cfg, nets, opt_state)(_batch(2 + i))
        assert set(got) == set(expected)
        assert all(torch.equal(got[k], expected[k]) for k in got), i
    _assert_equal_state(nets, opt_state, final)
    assert final["counts"] == (4, 0, 4)


def test_step_counts_dropped_steps_and_count_does_not():
    """skip_nonfinite_updates: a step whose gradients are not all finite
    changes nothing but notfinite and step, as cc_tpu's TrainState.step
    advances on every call. A hook makes one parameter's gradient NaN; the
    forward stays finite."""
    cfg = CFG.replace(skip_nonfinite_updates=True)
    nets, opt_state = _fresh(cfg)
    before = _snapshot(nets, opt_state)
    next(nets["pose"].parameters()).register_hook(
        lambda g: torch.full_like(g, float("nan")))
    build_train_step(cfg, nets, opt_state)(_batch(0))
    assert (opt_state.count, opt_state.notfinite, opt_state.step) == (0, 1, 1)
    params = dict(nets.named_parameters())
    assert all(torch.equal(params[k], before["nets"][k]) for k in params)
