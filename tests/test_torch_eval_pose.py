"""The port's pose evaluation against cc_tpu's: the KITTI odometry and
MPI-Sintel frameworks and readers (equal bits), the pose errors and the
snippet poses on seeded arrays, and the test_pose and test_sintel_pose
CLIs end to end from the same reference checkpoint on the same trees, the
port on the CPU.

The trees are the session fixtures of tests/cli_fixtures.py (odometry_dir,
sintel_dir: 64x128 frames); the checkpoint is cc_tpu's export of drawn
weights (torch_port_util.save_drawn_checkpoint). Each cc_tpu CLI runs once.
"""
import numpy as np
import pytest
import torch

from cc_tpu.cli import test_pose as jpose_cli
from cc_tpu.cli import test_sintel_pose as jsintel_cli
from cc_tpu.eval import kitti_pose as jkp
from cc_tpu.eval import sintel as jsintel
from cc_tpu_torch.cli import test_pose as tpose_cli
from cc_tpu_torch.cli import test_sintel_pose as tsintel_cli
from cc_tpu_torch.eval import kitti_pose as tkp
from cc_tpu_torch.eval import sintel as tsintel
from tests.cli_fixtures import H, W
from tests.torch_port_util import save_drawn_checkpoint

torch.set_num_threads(2)

# float64 host algebra on equal inputs, in the same order: round-off only
F64_RTOL = 1e-12
# the snippet poses: fp32 Euler or quaternion matrices (cc_tpu's jnp and
# the port's torch, in another order), then float64 inversions
SNIPPET_ATOL = 1e-6
# the CLIs' means: the nets agree to 1e-4 of each output's largest entry
# (tests/test_torch_models.py); ATE and RE follow the poses smoothly
CLI_RTOL = 1e-4


@pytest.fixture(scope="module")
def posenet(tmp_path_factory):
    """PoseNetB6 with 4 references, drawn weights, as a .pth.tar."""
    path = str(tmp_path_factory.mktemp("ckpt") / "posenet.pth.tar")
    save_drawn_checkpoint(path, "PoseNetB6", np.random.RandomState(21),
                          nb_ref_imgs=4)
    return path


def _assert_samples_equal(mine, ref):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.keys() == b.keys()
        assert a["path"] == b["path"]
        for x, y in zip(a["imgs"], b["imgs"]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert a["poses"].dtype == b["poses"].dtype
        assert np.array_equal(a["poses"], b["poses"])


@pytest.mark.parametrize("seq_length", [3, 5])
def test_kitti_odom_framework_equals_cc_tpu(odometry_dir, seq_length):
    mine = tkp.KittiOdomFramework(str(odometry_dir), ["09"], seq_length)
    ref = jkp.KittiOdomFramework(str(odometry_dir), ["09"], seq_length)
    assert len(mine) == len(ref)
    _assert_samples_equal(list(mine), list(ref))


@pytest.mark.parametrize("seq_length", [3, 5])
def test_sintel_framework_equals_cc_tpu(sintel_dir, seq_length):
    mine = tsintel.SintelPoseFramework(str(sintel_dir), ["alley_1"],
                                       seq_length)
    ref = jsintel.SintelPoseFramework(str(sintel_dir), ["alley_1"],
                                      seq_length)
    assert len(mine) == len(ref)
    _assert_samples_equal(list(mine), list(ref))


def test_sintel_readers_equal_cc_tpu(sintel_dir, tmp_path):
    """cam_read (both forms) on the fixture's .cam files; depth_read on a
    .dpt written here (the tag, width, height, then float32 rows)."""
    cam = str(sintel_dir / "camdata_left" / "alley_1" / "frame_0003.cam")
    for pose_only in (False, True):
        mine = tsintel.cam_read(cam, pose_only)
        ref = jsintel.cam_read(cam, pose_only)
        for a, b in zip(*((mine, ref) if not pose_only
                          else ((mine,), (ref,)))):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    depth = np.random.RandomState(3).uniform(0.5, 80, (H, W)).astype(
        np.float32)
    path = str(tmp_path / "frame.dpt")
    with open(path, "wb") as f:
        f.write(np.float32(202021.25).tobytes())
        f.write(np.int32(W).tobytes() + np.int32(H).tobytes())
        f.write(depth.tobytes())
    mine, ref = tsintel.depth_read(path), jsintel.depth_read(path)
    assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    assert np.array_equal(mine, depth)


def _snippet(r, n=5):
    """n 3x4 poses near the identity, chained as a moving camera's."""
    out, t = [], np.eye(4)
    for _ in range(n):
        out.append(t[:3].copy())
        step = np.eye(4)
        a = r.uniform(-0.05, 0.05, 3)
        step[:3, :3] = _rotation(a)
        step[:3, 3] = r.uniform(-0.5, 0.5, 3)
        t = t @ step
    return np.stack(out)


def _rotation(a):
    """Rx @ Ry @ Rz of Euler angles a."""
    cx, cy, cz = np.cos(a)
    sx, sy, sz = np.sin(a)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


def test_pose_errors_equal_cc_tpu():
    r = np.random.RandomState(4)
    for _ in range(5):
        gt, pred = _snippet(r), _snippet(r)
        mine = tkp.compute_pose_error(gt, pred)
        ref = jkp.compute_pose_error(gt, pred)
        np.testing.assert_allclose(mine, ref, rtol=F64_RTOL, atol=0)
        np.testing.assert_allclose(tsintel.compute_rotation_error(gt, pred),
                                   jsintel.compute_rotation_error(gt, pred),
                                   rtol=F64_RTOL, atol=0)


@pytest.mark.parametrize("mode", ["euler", "quat"])
def test_snippet_poses_match_cc_tpu(mode):
    r = np.random.RandomState(5)
    for n in (2, 4):
        poses = r.uniform(-0.2, 0.2, (n, 6)).astype(np.float32)
        mine = tkp.snippet_poses_from_prediction(poses, mode)
        ref = jkp.snippet_poses_from_prediction(poses, mode)
        assert mine.shape == ref.shape == (n + 1, 3, 4)
        assert mine.dtype == ref.dtype == np.float64
        np.testing.assert_allclose(mine, ref, rtol=0, atol=SNIPPET_ATOL)


def test_pose_cli_matches_cc_tpu(posenet, odometry_dir, tmp_path):
    """test_pose with PoseNetB6 (5-frame snippets) on the same checkpoint
    and tree: the mean ATE and RE, and the written snippet poses."""
    argv = [posenet, "--posenet", "PoseNetB6", "--dataset-dir",
            str(odometry_dir), "--sequences", "09", "--img-height", str(H),
            "--img-width", str(W)]
    ref = jpose_cli.main(argv + ["--output-dir", str(tmp_path / "ref")])
    mine = tpose_cli.main(argv + ["--output-dir", str(tmp_path / "mine"),
                                  "--device", "cpu"])
    print("test_pose (ATE, RE):", mine, ref)
    assert np.all(np.isfinite(mine)) and np.all(np.asarray(ref) > 0)
    np.testing.assert_allclose(mine, ref, rtol=CLI_RTOL, atol=0)
    pm = np.load(tmp_path / "mine" / "predictions.npy")
    pr = np.load(tmp_path / "ref" / "predictions.npy")
    assert pm.shape == pr.shape and pm.shape[1:] == (5, 3, 4)
    np.testing.assert_allclose(pm, pr, rtol=0,
                               atol=CLI_RTOL * np.abs(pr).max())


def test_sintel_pose_cli_matches_cc_tpu(posenet, sintel_dir):
    argv = [posenet, "--posenet", "PoseNetB6", "--dataset-dir",
            str(sintel_dir), "--sequences", "alley_1", "--img-height",
            str(H), "--img-width", str(W)]
    ref = jsintel_cli.main(argv)
    mine = tsintel_cli.main(argv + ["--device", "cpu"])
    print("test_sintel_pose RE:", mine, ref)
    assert np.isfinite(mine) and ref > 0
    np.testing.assert_allclose(mine, ref, rtol=CLI_RTOL, atol=0)


@pytest.mark.parametrize("cli", [tpose_cli, tsintel_cli])
def test_pose_clis_default_to_cuda(cli, tmp_path):
    """--device defaults to cuda; without a GPU the CLI raises before it
    reads a file (here, a checkpoint that does not exist)."""
    argv = [str(tmp_path / "none.pth.tar"), "--output-dir",
            str(tmp_path / "out")]
    assert cli.parser.parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    assert not (tmp_path / "out").exists()
