"""The port's train CLI (cc_tpu_torch/cli/train.py) against cc_tpu's: the
flags and the configs they make, flow and depth validation on the same
weights and batches, the decisive error, and the CLI end to end on the
CPU (two epochs with both validations, then a --resume --fix-flownet
epoch), with the flag errors raised before any file is written.

The validation parity runs cc_tpu's build_forward_eval at
tests/test_train_step.tiny_config()'s size and batch, the program that
tests/test_torch_slice.py compiles, and one small jit of cc_tpu's disp
net; no JAX train step is compiled here.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cc_tpu.cli import train as jcli
from cc_tpu.data import DataLoader as JLoader
from cc_tpu.train import build_forward_eval, init_state, make_models as jmake
from cc_tpu.train.state import apply_net
from cc_tpu_torch.cli import train as tcli
from cc_tpu_torch.data import DataLoader, ValidationSet, transforms
from cc_tpu_torch.data.validation import ValidationFlow
from cc_tpu_torch.train import NETS, TrainConfig, make_models
from cc_tpu_torch.train.checkpoint import BEST, CHECKPOINT
from cc_tpu_torch.weights import load_flax_weights
from tests.test_torch_data import write_kitti
from tests.test_train_step import H, W, tiny_config
from tests.torch_port_util import draw_flax_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The EPEs: the forwards agree to 1e-4 relative (tests/test_torch_slice.py)
EPE_RTOL = 1e-4
# The shares (outliers, depth's a1-a3) and the partitions by the rigidity
# masks count pixels against thresholds (THRESH, 3 px and 5 %, 1.25^k),
# which a pixel within rounding of one may cross in one package and not in
# the other: at most this many pixels of each item's valid ones
EDGE_PIXELS = 3
# One pixel's endpoint error in the KITTI fixture: its GT flows lie within
# +-30 px a component (|gt| < 42.5 px) and the drawn nets' flows within
# 9 px (measured: largest EPE 45.5 px); a pixel that changes partition
# moves that partition's mean EPE by at most this over its valid pixels
MAX_PIXEL_EPE = 60.0
SCENES = ("drive_a_02", "drive_b_02")
FRAMES = 6
# the CSV headers cc_tpu's CLI writes (cc_tpu/cli/train.py:426-431)
SUMMARY_HEADER = ["train_loss", "validation_loss"]
FULL_HEADER = ["train_loss", "photo_cam_loss", "photo_flow_loss",
               "explainability_loss", "smooth_loss"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two scenes of FRAMES smooth H x W JPEGs sliding over one image, with
    cam.txt and a .npy depth per frame; both in train.txt and val.txt."""
    import cv2
    root = tmp_path_factory.mktemp("scenes")
    r = np.random.RandomState(0)
    for s in SCENES:
        d = root / s
        d.mkdir()
        (d / "cam.txt").write_text(f"{0.9 * W},0.,{W / 2},0.,{0.9 * H},"
                                   f"{H / 2},0.,0.,1.")
        base = cv2.GaussianBlur(
            (r.rand(H + 16, W + 16, 3) * 255).astype(np.uint8), (21, 21), 8)
        for i in range(FRAMES):
            cv2.imwrite(str(d / f"{i:07d}.jpg"),
                        base[i:i + H, 2 * i:2 * i + W])
            np.save(d / f"{i:07d}.npy",
                    r.uniform(1, 80, (H, W)).astype(np.float32))
    for name in ("train.txt", "val.txt"):
        (root / name).write_text("\n".join(SCENES) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    return write_kitti(tmp_path_factory.mktemp("kitti"))


# ------------------------------------------------------------ flags


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_matches_cc_tpu():
    mine, ref = _actions(tcli.build_parser()), _actions(jcli.build_parser())
    assert set(mine) - set(ref) == {"device"}
    assert set(ref) <= set(mine)
    for dest, a in ref.items():
        b = mine[dest]
        got = (b.option_strings, type(b), b.default, b.type, b.choices,
               b.required, b.nargs)
        assert got == (a.option_strings, type(a), a.default, a.type,
                       a.choices, a.required, a.nargs), dest
    assert mine["device"].option_strings == ["--device"]
    assert mine["device"].default == "cuda"


BASE = ["DATA", "--name", "EXP", "--height", "128", "--width", "128", "-b",
        "2", "-j", "2", "--loader", "python", "--epochs", "6", "--lr", "2e-4",
        "--seed", "0", "--smoothness-type", "edgeaware", "-wssim", "0.3",
        "--print-freq", "100"]
# The protocol's phases (README.md:59-96 of the reference), as
# tests/test_cc_alternation.py runs them, and the README's full command
PHASES = {
    "A": BASE + ["--fix-masknet", "--fix-flownet", "--pretrained-flow",
                 "F.pth.tar", "-pc", "1.0", "-pf", "0", "-m", "0", "-s",
                 "0.05", "-c", "0"],
    "B": BASE + ["--fix-dispnet", "--fix-posenet", "--fix-masknet", "-pc",
                 "0", "-pf", "1.0", "-m", "0", "-s", "0.05", "-c", "0",
                 "--resume"],
    "C": BASE + ["--fix-dispnet", "--fix-posenet", "--fix-flownet", "-pc",
                 "1.0", "-pf", "0.5", "-m", "0.2", "-s", "0.05", "-c", "0.3",
                 "--resume"],
    "readme": ["DATA", "--name", "EXP", "--dispnet", "DispResNet6",
               "--posenet", "PoseNetB6", "--masknet", "MaskNet6",
               "--flownet", "Back2Future", "-b4", "-m0.1", "-pf", "0.5",
               "-pc", "1.0", "-s0.1", "-c0.3", "--nlevels", "6", "--lr",
               "1e-4", "-wssim", "0.997", "--smoothness-type", "edgeaware",
               "--fix-masknet", "--fix-flownet", "--with-depth-gt",
               "--with-flow-gt"],
    "posemask": BASE + ["--fix-posemasknet", "--flownet", "FlowNetC6",
                        "--dispnet", "DispNetS", "--masknet", "MaskResNet6",
                        "--posenet", "PoseNet6"],
}


@pytest.mark.parametrize("phase", PHASES)
def test_config_from_args_matches(phase):
    argv = PHASES[phase]
    mine = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    ref = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


_IMPORT_AND_COUNT_COMPILES = r"""
import jax
jax.config.update("jax_platforms", "cpu")
events = []
jax.monitoring.register_event_duration_secs_listener(
    lambda name, secs, **kw: events.append(name))
import cc_tpu.cli.train
print(sum("compile" in e for e in events))
"""


def test_importing_cc_tpu_cli_train_compiles_nothing():
    res = subprocess.run([sys.executable, "-c", _IMPORT_AND_COUNT_COMPILES],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "0"


# ------------------------------------------------------------ validation


@pytest.fixture(scope="module")
def weights():
    """cc_tpu's variables at test_train_step's config (the structure from
    jax.eval_shape, the values drawn with numpy) and the port's nets with
    the same weights, on the CPU."""
    jcfg = tiny_config()
    state = jax.eval_shape(lambda k: init_state(jcfg, k),
                           jax.random.PRNGKey(0))
    r = np.random.RandomState(7)
    params = draw_flax_variables(state.params, r)
    stats = draw_flax_variables(state.batch_stats, r)
    cfg = TrainConfig(**{f: getattr(jcfg, f)
                         for f in TrainConfig.__dataclass_fields__})
    nets = make_models(cfg, device="cpu")
    for name in NETS:
        load_flax_weights(nets[name], nets[name].arch, params[name],
                          stats[name])
    return jcfg, types.SimpleNamespace(params=params, batch_stats=stats), \
        cfg, nets


def _edge_bound(n_valid):
    return EDGE_PIXELS / n_valid


def test_validate_flow_matches_cc_tpu(weights, kitti):
    jcfg, state, cfg, nets = weights
    ds = ValidationFlow(kitti, transform=transforms.valid_flow_transform(
        H, W), N=2)
    batches = list(DataLoader(ds, 2, num_workers=1))
    assert len(batches) == 1
    mine, names = tcli.validate_flow(cfg, nets, batches)
    ref, ref_names = jcli.validate_flow(
        jcfg, None, state, batches, build_forward_eval(jcfg, jmake(jcfg)))
    assert names == ref_names
    # the fewest valid GT pixels of an item: a share moves by 1/n_valid
    # per pixel (averaged over the batch, so at most that)
    n_valid = int(batches[0]["flow_gt"][..., 2].sum(axis=(1, 2)).min())
    diffs = {n: abs(a - e) for n, a, e in zip(names, mine, ref)}
    print("validate_flow |port - cc_tpu|:", diffs)
    for n, a, e in zip(names, mine, ref):
        if n.startswith("outliers"):
            assert abs(a - e) <= _edge_bound(n_valid), (n, a, e)
        elif n in ("epe_total", "epe_total_with_gt_mask"):
            assert abs(a - e) <= EPE_RTOL * abs(e), (n, a, e)
        else:  # the rigid and non-rigid partitions
            assert abs(a - e) <= (EPE_RTOL * abs(e) + MAX_PIXEL_EPE
                                  * _edge_bound(n_valid)), (n, a, e)


def test_validate_depth_matches_cc_tpu(weights, scenes):
    jcfg, state, cfg, nets = weights
    ds = ValidationSet(scenes, transform=transforms.valid_transform())
    batches = list(DataLoader(ds, 2, num_workers=1))[:2]
    mods = jmake(jcfg)

    @jax.jit
    def fwd_disp(params, batch_stats, tgt):
        out, _ = apply_net(mods.disp, params["disp"], batch_stats["disp"],
                           jnp.asarray(tgt), training=False)
        return out

    mine, names = tcli.validate_depth(cfg, nets, batches)
    ref, ref_names = jcli.validate_depth(jcfg, mods, state, batches, fwd_disp)
    assert names == ref_names
    print("validate_depth |port - cc_tpu|:",
          {n: abs(a - e) for n, a, e in zip(names, mine, ref)})
    n_valid = H * W // 4  # fewer than the Garg crop's share of the frame
    for n, a, e in zip(names, mine, ref):
        tol = (_edge_bound(n_valid) if n in ("a1", "a2", "a3")
               else EPE_RTOL * abs(e))
        assert abs(a - e) <= tol, (n, a, e)


# The best-checkpoint rule of cc_tpu/cli/train.py:547-556, case by case:
# (fixed nets, flow validated, depth validated) -> the value chosen
FLOW = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0, 16.0, 17.0]
DEPTH = [20.0, 21.0, 22.0, 23.0, 24.0, 25.0]
LOSS = 1.5
DECISIVE = [
    ((), True, True, FLOW[-2]),
    ((), False, True, DEPTH[0]),
    ((), False, False, LOSS),
    (("pose",), True, True, DEPTH[0]),
    (("pose",), True, False, FLOW[-1]),
    (("pose", "disp"), True, True, FLOW[-1]),
    (("pose", "disp"), False, True, LOSS),
    (("pose", "disp", "flow"), True, True, FLOW[3]),
    (("pose", "disp", "flow", "mask"), True, True, LOSS),
    (("pose", "flow", "mask"), True, True, DEPTH[0]),
    (("pose", "disp", "mask"), True, False, FLOW[-1]),
]


@pytest.mark.parametrize("fixed,flow,depth,expected", DECISIVE)
def test_decisive_error(fixed, flow, depth, expected):
    cfg = TrainConfig(**{f"fix_{n}net": True for n in fixed})
    got = tcli.decisive_error(cfg, LOSS, FLOW if flow else None,
                              DEPTH if depth else None)
    assert got == expected


# ------------------------------------------------------------ end to end


def _cli_argv(scenes, kitti, *extra):
    return [scenes, "--name", "exp", "--height", str(H), "--width", str(W),
            "-b", "2", "--epoch-size", "2", "-j", "2", "--loader", "python",
            "--device", "cpu", "--kitti-dir", kitti, "--val-flow-height",
            str(H), "--val-flow-width", str(W), "--val-flow-N", "2",
            "--print-freq", "1", *extra]


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def _run_two_epochs_then_resume(scenes, kitti, save):
    records = tcli.main(_cli_argv(scenes, kitti, "--epochs", "2",
                                  "--with-depth-gt", "--with-flow-gt", "-f",
                                  "1", "--log-output"))
    assert [r["steps"] for r in records] == [2, 2]
    for r in records:
        values = [r["train_loss"], *r["flow_errors"], *r["depth_errors"]]
        assert all(np.isfinite(values)), r
        # every net trains: C's GT-mask non-rigid EPE decides
        assert r["decisive"] == r["flow_errors"][-2]
    assert records[0]["is_best"]
    assert (save / CHECKPOINT).is_file() and (save / BEST).is_file()
    summary = _rows(save / "progress_log_summary.csv")
    assert summary[0] == SUMMARY_HEADER and len(summary) == 3
    assert [float(x) for x in summary[1]] == [records[0]["train_loss"],
                                              records[0]["decisive"]]
    full = _rows(save / "progress_log_full.csv")
    assert full[0] == FULL_HEADER and len(full) == 3  # step 1 of each epoch
    first = torch.load(save / CHECKPOINT, weights_only=True)
    assert first["step"] == first["count"] == 4

    records = tcli.main(_cli_argv(scenes, kitti, "--epochs", "1",
                                  "--resume", "--fix-flownet"))
    assert np.isfinite(records[0]["train_loss"])
    return first, torch.load(save / CHECKPOINT, weights_only=True)


def test_cli_runs_validates_and_resumes(scenes, kitti, tmp_path,
                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    save = tmp_path / "checkpoints" / "exp"
    try:
        first, second = _run_two_epochs_then_resume(scenes, kitti, save)
    finally:  # two checkpoint files of 891.5 MB each
        shutil.rmtree(save, ignore_errors=True)
    assert (tmp_path / "experiment_recorder.md").is_file()
    # the step count and Adam's moments came from the checkpoint
    assert second["step"] == second["count"] == 6
    for group in ("nets", "mu", "nu"):
        flow1, flow2 = first[group]["flow"], second[group]["flow"]
        assert flow1.keys() == flow2.keys()
        assert all(torch.equal(flow1[k], flow2[k]) for k in flow1), group
    assert any(float(t.abs().max()) > 0 for t in second["mu"]["flow"].values())
    assert not all(torch.equal(first["nets"]["disp"][k], v)
                   for k, v in second["nets"]["disp"].items())


@pytest.mark.parametrize("extra,env,error", [
    (["--h2d", "uint8", "--data-normalization", "local"], {}, ValueError),
    (["--compute-dtype", "bfloat16"], {}, NotImplementedError),
    (["--loss-dtype", "bfloat16"], {}, NotImplementedError),
    (["--posenet", "PoseExpNet"], {}, NotImplementedError),
    # a launch without torchrun's RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT
    ([], {"WORLD_SIZE": "2"}, ValueError),
])
def test_flag_errors_before_any_file(scenes, kitti, tmp_path, monkeypatch,
                                     extra, env, error):
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(error):
        tcli.main(_cli_argv(scenes, kitti, *extra))
    assert os.listdir(tmp_path) == []


def test_device_defaults_to_cuda(scenes, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = tcli.build_parser().parse_args([scenes, "--name", "exp"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main([scenes, "--name", "exp"])
    assert os.listdir(tmp_path) == []
