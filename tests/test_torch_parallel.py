"""The port's data parallelism (cc_tpu_torch/parallel) against cc_tpu's and
against one process: the batch split's arithmetic against cc_tpu's
process_batch_slice; the launch helpers outside a launch; then two
processes under torchrun with gloo on the CPU (tests/torch_port_util.py
as their script, which imports no JAX): BatchNorm2d over the global batch
against the one-process layer on the whole batch (outputs, input and
parameter gradients, running stats, also with one row a process at 1x1),
the out-of-bounds barrier against the whole batch's, the collective
helpers; and the train CLI under a two-process launch against a
one-process run of the same flags, then resumed on two processes for a
--fix-flownet step.
"""
import csv
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cc_tpu.parallel.distributed import (
    process_batch_slice as jax_process_batch_slice,
)
from cc_tpu_torch.cli import train as tcli
from cc_tpu_torch.losses.photometric import _oob_norm
from cc_tpu_torch.models.layers import BatchNorm2d
from cc_tpu_torch.parallel import batch_slice, distributed
from cc_tpu_torch.train.checkpoint import BEST, CHECKPOINT
from tests.torch_port_util import assert_close, torchrun

torch.set_num_threads(2)

H = W = 128
# BatchNorm over the global batch against F.batch_norm over the whole
# batch: fp32 sums in another order, relative to each output's magnitude
BN_RTOL = 1e-5
# Running stats move by 0.1 of a batch mean and variance (flax's rule)
STATS_ATOL = 1e-6
# The epoch's train loss of two processes against one: cc_tpu's tolerance
# for the same comparison (tests/test_distributed_2proc.py)
LOSS_RTOL = 2e-3
LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")


def _no_launch(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------ one process


@pytest.mark.parametrize("b", range(1, 9))
def test_process_batch_slice_matches_cc_tpu(b):
    """Over 1-4 processes: the same rows as cc_tpu's, or the same error for
    a batch they do not divide; and the launch's batch_slice, which raises
    as cc_tpu's CLI does for such a batch."""
    for n in range(1, 5):
        for p in range(n):
            launch = distributed.Launch(n, p, p, n)
            if b % n:
                for f in (distributed.process_batch_slice,
                          jax_process_batch_slice):
                    with pytest.raises(ValueError,
                                       match=f"global batch {b} not divisible"):
                        f(b, p, n)
                with pytest.raises(ValueError, match=f"multiple of the {n}"):
                    batch_slice(b, launch)
                continue
            mine = distributed.process_batch_slice(b, p, n)
            assert mine == jax_process_batch_slice(b, p, n), (b, n, p)
            assert batch_slice(b, launch) == mine


def test_initialize_is_a_no_op_without_a_launch(monkeypatch):
    _no_launch(monkeypatch)
    assert distributed.launch_from_env() is None
    assert distributed.initialize("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize("cpu") is False
    assert not dist.is_initialized()
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    assert distributed.is_primary()
    assert batch_slice(3) is None
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK, LOCAL_RANK, MASTER_ADDR"):
        distributed.launch_from_env()


def test_helpers_are_identities_outside_a_launch(monkeypatch):
    _no_launch(monkeypatch)
    ts = [torch.arange(6.0).reshape(2, 3), torch.ones(4, dtype=torch.int64)]
    before = [t.clone() for t in ts]
    distributed.all_reduce_mean_(ts)
    distributed.broadcast_(ts)
    assert all(torch.equal(a, b) for a, b in zip(ts, before))
    x = torch.ones(3, requires_grad=True)
    assert distributed.all_reduce_sum(x) is x
    assert not dist.is_initialized()


# ------------------------------------------------------------ two processes


def _bn_case(r, shape):
    c = shape[1]
    return dict(x=(r.randn(*shape) * 2 + 1).astype(np.float32),
                g=r.randn(*shape).astype(np.float32),
                weight=r.uniform(0.5, 1.5, c).astype(np.float32),
                bias=r.uniform(-0.5, 0.5, c).astype(np.float32),
                running_mean=r.uniform(-0.5, 0.5, c).astype(np.float32),
                running_var=r.uniform(0.5, 1.5, c).astype(np.float32))


BN_SHAPES = {"2 rows a process": (4, 3, 5, 4),
             "one row a process at 1x1": (2, 4, 1, 1)}


@pytest.fixture(scope="module")
def two_process_layers(tmp_path_factory):
    """BatchNorm2d, _oob_norm and the helpers on two processes; the spec and
    each process's results."""
    tmp = tmp_path_factory.mktemp("layers")
    r = np.random.RandomState(0)
    valid = (r.rand(4, 6, 7, 1) > 0.3).astype(np.float32)
    # the first process's rows are wholly out of bounds, the other's not
    half = valid.copy()
    half[:2] = 0
    spec = {"device": "cpu",
            "bn": [_bn_case(r, s) for s in BN_SHAPES.values()],
            "oob": [valid, half]}
    torch.save(spec, tmp / "spec.pt")
    torchrun(["tests/torch_port_util.py", "layers", str(tmp / "spec.pt"),
              str(tmp)])
    return spec, [torch.load(tmp / f"rank{i}.pt") for i in range(2)]


@pytest.mark.parametrize("case", range(len(BN_SHAPES)),
                         ids=list(BN_SHAPES))
def test_batchnorm_over_two_processes_matches_the_whole_batch(
        two_process_layers, case):
    spec, ranks = two_process_layers
    c = spec["bn"][case]
    bn = BatchNorm2d(c["x"].shape[1], eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(c[name]))
    x = torch.from_numpy(c["x"]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(c["g"])).sum().backward()

    got = lambda k: torch.cat([r["bn"][case][k] for r in ranks])
    scale = lambda t: BN_RTOL * max(1.0, float(t.detach().abs().max()))
    assert_close(got("y"), y, scale(y), "output")
    assert_close(got("x_grad"), x.grad, scale(x.grad), "input gradient")
    for name in ("weight", "bias"):
        ref = getattr(bn, name).grad
        for r in ranks:
            assert_close(r["bn"][case][f"{name}_grad"], ref, scale(ref),
                         f"{name} gradient")
    for name in ("running_mean", "running_var"):
        assert_close(ranks[0]["bn"][case][name], getattr(bn, name),
                     STATS_ATOL, name)
        assert torch.equal(ranks[0]["bn"][case][name],
                           ranks[1]["bn"][case][name]), name
    assert all(int(r["bn"][case]["num_batches_tracked"]) == 1 for r in ranks)


def test_batchnorm_of_one_row_alone_would_fail():
    """What the 1x1 case holds the global statistics against: one process's
    row alone, normalized by itself, is refused."""
    bn = BatchNorm2d(4).train()
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        bn(torch.ones(1, 4, 1, 1))


def test_oob_norm_over_two_processes_matches_the_whole_batch(
        two_process_layers):
    spec, ranks = two_process_layers
    for i, valid in enumerate(spec["oob"]):
        ref = _oob_norm(torch.from_numpy(valid))
        for rank, r in enumerate(ranks):
            for got, want, what in zip(r["oob"][i], ref, ("norm", "gate")):
                assert torch.equal(got, want), (i, rank, what, got, want)
    # the case with no valid pixel in the first process's rows: its gate is
    # the whole batch's, open
    assert float(ranks[0]["oob"][1][1]) == 1.0
    assert float(_oob_norm(torch.from_numpy(spec["oob"][1][:2]))[1]) == 0.0


def test_collective_helpers_over_two_processes(two_process_layers):
    _, ranks = two_process_layers
    shapes = [(3,), (5, 7), (1,), (4, 2)]
    for r in ranks:
        assert (r["world"], r["backend"], r["device"]) == (2, "gloo", "cpu")
        for got, s in zip(r["mean"], shapes):
            want = torch.arange(float(np.prod(s))).reshape(s) + 1.5
            assert torch.equal(got, want), (got, want)
        assert torch.equal(r["broadcast"][0], torch.zeros(3, dtype=torch.int64))
        assert torch.equal(r["broadcast"][1], torch.ones(2, 2))
        total, grad = r["sum"]
        # (1 + 2) on each; the gradient: the sum of the processes' weights
        assert torch.equal(total, torch.full((3,), 3.0))
        assert torch.equal(grad, torch.full((3,), 3.0))


# ------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two scenes of 6 smooth H x W JPEGs with cam.txt, both in train.txt."""
    import cv2
    root = tmp_path_factory.mktemp("scenes")
    r = np.random.RandomState(1)
    for s in ("drive_a_02", "drive_b_02"):
        (root / s).mkdir()
        (root / s / "cam.txt").write_text(
            f"{0.9 * W},0.,{W / 2},0.,{0.9 * H},{H / 2},0.,0.,1.")
        base = cv2.GaussianBlur(
            (r.rand(H + 16, W + 16, 3) * 255).astype(np.uint8), (21, 21), 8)
        for i in range(6):
            cv2.imwrite(str(root / s / f"{i:07d}.jpg"),
                        base[i:i + H, 2 * i:2 * i + W])
    (root / "train.txt").write_text("drive_a_02\ndrive_b_02\n")
    (root / "val.txt").write_text("drive_b_02\n")
    return str(root)


def _argv(scenes, kitti, *extra):
    return [scenes, "--name", "dp", "--height", str(H), "--width", str(W),
            "-b", "2", "--epochs", "1", "--epoch-size", "2", "-j", "1",
            "--loader", "python", "--device", "cpu", "--seed", "0",
            "--kitti-dir", str(kitti), "--with-flow-gt", "--val-flow-N", "1",
            "--val-flow-height", str(H), "--val-flow-width", str(W),
            "-wssim", "0.3", "-m", "0.1", "--print-freq", "1", *extra]


def _summary(run):
    with open(os.path.join(run, "checkpoints", "dp",
                           "progress_log_summary.csv")) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    assert rows[0] == ["train_loss", "validation_loss"] and len(rows) == 2
    return [float(v) for v in rows[1]]


def test_cli_raises_before_any_file_when_the_batch_does_not_divide(
        scenes, kitti2015_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for k, v in dict(WORLD_SIZE="2", RANK="0", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                     MASTER_PORT="29400").items():
        monkeypatch.setenv(k, v)
    argv = _argv(scenes, kitti2015_dir)
    argv[argv.index("-b") + 1] = "3"
    with pytest.raises(ValueError, match="multiple of the 2 processes"):
        tcli.main(argv)
    assert os.listdir(tmp_path) == []
    assert not dist.is_initialized()


def _files(run):
    """The run's checkpoint directory's files; a tensorboardX event file's
    name, which holds its time of creation, as `events`."""
    return sorted("events" if f.startswith("events.out.tfevents") else f
                  for f in os.listdir(run / "checkpoints" / "dp"))


@pytest.fixture(scope="module")
def cli_runs(scenes, kitti2015_dir, tmp_path_factory):
    """The train CLI with the same flags in this process and under torchrun
    with two processes, each in its own directory: for each run its files,
    recorder lines, summary row and checkpoint's step, and the one
    process's records and the two processes' output. Only the two
    processes' checkpoint.pt is kept (for the resumed run), since each
    checkpoint is 891.5 MB."""
    mp = pytest.MonkeyPatch()
    _no_launch(mp)
    runs = {"one": tmp_path_factory.mktemp("one_process"),
            "two": tmp_path_factory.mktemp("two_processes")}
    seen = {}

    def look(name):
        run = runs[name]
        state = torch.load(run / "checkpoints" / "dp" / CHECKPOINT,
                           weights_only=True)
        seen[name] = {
            "files": _files(run), "summary": _summary(run),
            "step": state["step"],
            "recorder": (run / "experiment_recorder.md").read_text().count(
                "python3 ")}
        (run / "checkpoints" / "dp" / BEST).unlink()

    try:
        mp.chdir(runs["one"])
        records = tcli.main(_argv(scenes, kitti2015_dir))
        look("one")
        (runs["one"] / "checkpoints" / "dp" / CHECKPOINT).unlink()
        out = torchrun(["-m", "cc_tpu_torch.cli.train",
                        *_argv(scenes, kitti2015_dir)], cwd=str(runs["two"]))
        look("two")
        yield runs["two"], seen, records, out
    finally:
        mp.undo()
        for run in runs.values():
            shutil.rmtree(run / "checkpoints", ignore_errors=True)


def test_cli_on_two_processes_matches_one(cli_runs):
    """Only the primary writes (one recorder line, its logs and
    checkpoints) and validates, and the epoch's train loss, the global
    batch's, is the one process's."""
    _, seen, records, out = cli_runs
    one, two = seen["one"], seen["two"]
    assert "=> 2 process(es) on gloo" in out, out
    assert out.count("=> process ") == 2, out
    assert one["files"] == two["files"], (one["files"], two["files"])
    assert {CHECKPOINT, BEST} <= set(two["files"])
    assert one["recorder"] == two["recorder"] == 1
    (loss_one, decisive_one), (loss_two, decisive_two) = (
        one["summary"], two["summary"])
    assert records[0]["train_loss"] == loss_one
    assert np.isfinite([loss_one, loss_two, decisive_two]).all()
    np.testing.assert_allclose(loss_two, loss_one, rtol=LOSS_RTOL)
    # validation ran on the primary: the decisive error is C's EPE
    assert decisive_two != loss_two and decisive_one != loss_one
    assert one["step"] == two["step"] == 2


def test_cli_resumes_a_competition_phase_on_two_processes(
        cli_runs, scenes, kitti2015_dir):
    """--resume --fix-flownet for a step on two processes, from the two
    processes' checkpoint: every process loads it; F and its moments stay
    bit-equal, D moves."""
    two = cli_runs[0]
    path = two / "checkpoints" / "dp" / CHECKPOINT
    before = torch.load(path, weights_only=True)
    argv = _argv(scenes, kitti2015_dir, "--resume", "--fix-flownet")
    argv[argv.index("--epoch-size") + 1] = "1"
    torchrun(["-m", "cc_tpu_torch.cli.train", *argv], cwd=str(two))
    after = torch.load(path, weights_only=True)
    assert (before["step"], after["step"]) == (2, 3)
    for group in ("nets", "mu", "nu"):
        old, new = before[group]["flow"], after[group]["flow"]
        assert all(torch.equal(old[k], new[k]) for k in old), group
    assert not all(torch.equal(v, after["nets"]["disp"][k])
                   for k, v in before["nets"]["disp"].items())
