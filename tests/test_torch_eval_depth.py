"""The port's depth evaluation and inference against cc_tpu's: the KITTI
Eigen, stillbox and Make3D frameworks (equal bits), the protocol lists,
the depth errors on seeded arrays, and the test_disp (with and without a
pose net), test_make3d and run_inference CLIs end to end from the same
reference checkpoints on the same trees, the port on the CPU.

The Eigen trees are the session fixtures of tests/cli_fixtures.py
(eigen_dir at 64x128, eigen_dir_hires at 192x640, which the CLIs resize);
the stillbox and Make3D trees are written here. The checkpoints are
cc_tpu's export of drawn weights (torch_port_util.save_drawn_checkpoint).
Each cc_tpu CLI runs once.
"""
import json
import os

import numpy as np
import pytest
import torch

from cc_tpu.cli import run_inference as jinfer
from cc_tpu.cli import test_disp as jdisp
from cc_tpu.cli import test_make3d as jmake3d
from cc_tpu.eval import kitti_depth as jkd
from cc_tpu.eval import stillbox as jsb
from cc_tpu_torch.cli import run_inference as tinfer
from cc_tpu_torch.cli import test_disp as tdisp
from cc_tpu_torch.cli import test_make3d as tmake3d
from cc_tpu_torch.eval import kitti_depth as tkd
from cc_tpu_torch.eval import stillbox as tsb
from tests.cli_fixtures import H, W, _write_png
from tests.torch_port_util import computed_once, save_drawn_checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float64 metrics on equal inputs, in the same order: round-off only
F64_RTOL = 1e-12
# the CLIs' means of continuous errors: the nets agree to 1e-4 of each
# output's largest entry (tests/test_torch_models.py)
CLI_RTOL = 1e-4
# a1-a3 count pixels under 1.25^k, which a pixel within rounding of the
# threshold may cross in one package and not in the other: at most this
# many of an item's valid pixels
EDGE_PIXELS = 3
# The pose-scaled errors divide by the norms of PoseExpNet's translations;
# they are compared only where every norm is above this (test_disp.py:
# 149-158); drawn weights give norms of about 1e-3 to 1e-2
POSE_NORM_GUARD = 1e-3


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """_ckpts, written once per run."""
    return computed_once(tmp_path_factory, "eval_depth_ckpts",
                         lambda: _ckpts(tmp_path_factory))


def _ckpts(tmp_path_factory):
    """DispResNet6, DispNetS (run_inference's default) and PoseExpNet with
    2 references and its mask decoder, which test_disp builds without
    (output_exp=False) and so leaves unread, as cc_tpu does."""
    d = tmp_path_factory.mktemp("ckpts")
    r = np.random.RandomState(31)
    paths = {"disp": d / "dispnet.pth.tar", "dispnets": d / "dispnets.pth.tar",
             "pose": d / "posenet.pth.tar"}
    save_drawn_checkpoint(str(paths["disp"]), "DispResNet6", r)
    save_drawn_checkpoint(str(paths["dispnets"]), "DispNetS", r)
    save_drawn_checkpoint(str(paths["pose"]), "PoseExpNet", r,
                          nb_ref_imgs=2, output_exp=True)
    return {k: str(v) for k, v in paths.items()}


@pytest.fixture(scope="module")
def stillbox_dir(tmp_path_factory):
    """A stillbox tree: one folder, metadata.json with two scenes of 5
    frames (images, .npy depths, speed, time step), and the test list."""
    root = tmp_path_factory.mktemp("stillbox")
    r = np.random.default_rng(32)
    scenes, files = [], []
    for s in range(2):
        imgs, depths = [], []
        for i in range(5):
            img, dep = f"img_{s}_{i}.png", f"depth_{s}_{i}.npy"
            _write_png(root / "f0" / img,
                       r.integers(0, 255, (H, W, 3), dtype=np.uint8))
            np.save(root / "f0" / dep,
                    r.uniform(0.5, 90, (H, W)).astype(np.float32))
            imgs.append(img)
            depths.append(dep)
        scenes.append({"imgs": imgs, "depth": depths, "length": 5,
                       "speed": list(r.uniform(1, 9, 3)),
                       "time_step": 0.1 * (s + 1)})
        files += [f"f0/img_{s}_0.png", f"f0/img_{s}_3.png"]
    (root / "f0" / "metadata.json").write_text(json.dumps(
        {"scenes": scenes}))
    return root, files


@pytest.fixture(scope="module")
def make3d_dir(tmp_path_factory):
    """Make3D: Test134/*.jpg (cropped to rows 710-1561 upstream) and
    Gridlaserdata/*.mat with Position3DGrid [55, 30, 4]; the framework drops
    sample 61 (corrupt in the real set), so 62 files make 61 items."""
    from scipy.io import savemat
    root = tmp_path_factory.mktemp("make3d")
    r = np.random.default_rng(33)
    os.makedirs(root / "Gridlaserdata")
    for i in range(62):
        _write_png(root / "Test134" / f"img-{i:03d}.jpg",
                   r.integers(0, 255, (2272, 48, 3), dtype=np.uint8))
        grid = np.zeros((55, 30, 4))
        grid[:, :, 3] = r.uniform(2.0, 80.0, (55, 30))
        savemat(str(root / "Gridlaserdata" / f"depth-{i:03d}.mat"),
                {"Position3DGrid": grid})
    return root


# ------------------------------------------------------------ host code


@pytest.mark.parametrize("name", ["test_files_eigen.txt",
                                  "test_files_90.txt"])
def test_protocol_lists_equal_cc_tpu(name):
    with open(os.path.join(REPO, "cc_tpu", "data", "lists", name)) as f:
        ref = f.read()
    with open(os.path.join(tdisp.LISTS, name)) as f:
        assert f.read() == ref


def _assert_samples_equal(mine, ref):
    for k in ref:
        a, b = mine[k], ref[k]
        if isinstance(b, list):
            assert len(a) == len(b), k
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), k
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        else:
            assert a == b, k
    assert mine.keys() == ref.keys()


@pytest.mark.parametrize("hires", [False, True])
@pytest.mark.parametrize("seq_length", [0, 3, 5])
def test_kitti_eigen_framework_equals_cc_tpu(eigen_dir, eigen_dir_hires,
                                             hires, seq_length):
    """Images, references (capped at the drive's ends), velodyne depth,
    Garg mask and oxts displacements, bit for bit."""
    root = str(eigen_dir_hires if hires else eigen_dir)
    with open(os.path.join(root, "test_files.txt")) as f:
        files = f.read().splitlines()
    mine = tkd.KittiEigenFramework(root, files, seq_length, 1e-3, 80)
    ref = jkd.KittiEigenFramework(root, files, seq_length, 1e-3, 80)
    assert len(mine) == len(ref) == 1
    assert mine.samples == ref.samples
    _assert_samples_equal(mine[0], ref[0])
    assert ref[0]["mask"].any()


def test_stillbox_framework_equals_cc_tpu(stillbox_dir):
    root, files = stillbox_dir
    mine = tsb.StillboxFramework(str(root), files, 3, 1e-3, 80)
    ref = jsb.StillboxFramework(str(root), files, 3, 1e-3, 80)
    assert len(mine) == len(ref) == len(files)
    assert mine.samples == ref.samples
    for i in range(len(ref)):
        _assert_samples_equal(mine[i], ref[i])
    depth = np.random.RandomState(34).uniform(0, 100, (H, W))
    assert np.array_equal(tsb.generate_mask(depth, 1e-3, 80),
                          jsb.generate_mask(depth, 1e-3, 80))


def test_make3d_framework_equals_cc_tpu(make3d_dir):
    mine = tmake3d.Make3DFramework(str(make3d_dir))
    ref = jmake3d.Make3DFramework(str(make3d_dir))
    assert len(mine) == len(ref) == 61
    assert mine.img_files == ref.img_files
    for i in (0, 60):
        _assert_samples_equal(mine[i], ref[i])


@pytest.mark.parametrize("which", ["eigen", "make3d"])
def test_depth_errors_equal_cc_tpu(which):
    mine, ref = {"eigen": (tdisp.compute_errors_eigen,
                           jdisp.compute_errors_eigen),
                 "make3d": (tmake3d.compute_errors_make3d,
                            jmake3d.compute_errors_make3d)}[which]
    r = np.random.RandomState(35)
    for _ in range(3):
        gt = r.uniform(1e-3, 80, 5000)
        pred = gt * r.uniform(0.5, 1.8, 5000)
        np.testing.assert_allclose(mine(gt, pred), ref(gt, pred),
                                   rtol=F64_RTOL, atol=0)


# ------------------------------------------------------------ the CLIs


def _valid_pixels(root) -> int:
    """The valid pixels of the tree's one Eigen item, in the Garg crop."""
    with open(os.path.join(str(root), "test_files.txt")) as f:
        files = f.read().splitlines()
    return int(tkd.KittiEigenFramework(str(root), files, 0, 1e-3, 80)[0]
               ["mask"].sum())


def test_disp_cli_matches_cc_tpu(ckpts, eigen_dir_hires, tmp_path):
    """test_disp on the 192x640 tree (resized to 64x128), cc_tpu's once
    with the pose net: its GT-ratio row is the row of a run without one.
    The port runs with and without. a1-a3 within EDGE_PIXELS of the valid
    pixels; the other errors within CLI_RTOL; the pose-scaled row only
    where PoseExpNet's translation norms pass POSE_NORM_GUARD."""
    root = str(eigen_dir_hires)
    argv = ["--pretrained-dispnet", ckpts["disp"], "--dataset-dir", root,
            "--dataset-list", os.path.join(root, "test_files.txt"),
            "--img-height", str(H), "--img-width", str(W)]
    pose = ["--pretrained-posenet", ckpts["pose"]]
    ref = jdisp.main(argv + pose + ["--output-dir", str(tmp_path / "ref")])
    with_pose = tdisp.main(argv + pose + [
        "--output-dir", str(tmp_path / "mine"), "--device", "cpu"])
    alone = tdisp.main(argv + ["--device", "cpu"])
    print("test_disp port:", with_pose, "cc_tpu:", ref)
    assert np.all(np.isfinite(ref)) and np.all(np.isfinite(with_pose))
    assert np.array_equal(alone[1], with_pose[1]) and not alone[0].any()

    edge = EDGE_PIXELS / _valid_pixels(root)
    norms = _pose_norms(ckpts["pose"], root)
    rows = [1, 0] if norms.min() > POSE_NORM_GUARD else [1]
    for row in rows:
        for k, (a, e) in enumerate(zip(with_pose[row], ref[row])):
            tol = edge if k >= 4 else CLI_RTOL * abs(e)
            assert abs(a - e) <= tol, (row, k, a, e)
    assert rows == [1, 0], norms  # the guard holds for these weights
    pm = np.load(tmp_path / "mine" / "predictions.npy")
    pr = np.load(tmp_path / "ref" / "predictions.npy")
    assert pm.shape == pr.shape == (1, H, W)
    np.testing.assert_allclose(pm, pr, rtol=CLI_RTOL, atol=0)


def _pose_norms(path, root) -> np.ndarray:
    """The norms of the port's PoseExpNet translations on the tree's item,
    as test_disp computes them."""
    import cv2
    with open(os.path.join(root, "test_files.txt")) as f:
        files = f.read().splitlines()
    sample = tkd.KittiEigenFramework(root, files, 3, 1e-3, 80)[0]
    prep = lambda im: ((cv2.resize(im, (W, H)) / 255.0 - 0.5) / 0.5
                       ).astype(np.float32)
    net = tdisp.load_net_params(path, "PoseExpNet", torch.device("cpu"),
                                nb_ref_imgs=2, output_exp=False)
    with torch.inference_mode():
        poses = tdisp.pose_forward(
            net, tdisp.to_device(prep(sample["tgt"])[None], "cpu"),
            tdisp.to_device(np.stack([prep(r) for r in sample["ref"]])[None],
                            "cpu"))
    return np.linalg.norm(poses[0, :, :3].numpy(), axis=1)


def test_make3d_cli_matches_cc_tpu(ckpts, make3d_dir):
    """61 items at 64x128: the means; a1-a3 within EDGE_PIXELS of the
    fewest valid pixels an item can have here (every GT depth of the
    center crop's 21 rows lies in range)."""
    argv = ["--pretrained-dispnet", ckpts["disp"], "--dataset-dir",
            str(make3d_dir), "--img-height", str(H), "--img-width", str(W)]
    ref = jmake3d.main(argv)
    mine = tmake3d.main(argv + ["--device", "cpu"])
    print("test_make3d port:", mine, "cc_tpu:", ref)
    assert np.all(np.isfinite(ref))
    edge = EDGE_PIXELS / (21 * 30)
    for k, (a, e) in enumerate(zip(mine, ref)):
        tol = edge if k >= 4 else CLI_RTOL * abs(e)
        assert abs(a - e) <= tol, (k, a, e)


# a rendered colour: the disparity or depth, scaled by the image's largest
# (disp) or by 10 (depth), picks one of the colormap's 10000 (bone) or
# 1000 (rainbow) rows; values within rounding of a row's edge may pick its
# neighbour, which differs by at most this in 0..255
COLOUR_STEP = 2


def test_run_inference_matches_cc_tpu(ckpts, tmp_path):
    """DispNetS on 2 PNGs at 64x128: the same files, and each written
    image within COLOUR_STEP of cc_tpu's in every channel."""
    import cv2
    r = np.random.default_rng(36)
    for i in range(2):
        _write_png(tmp_path / "imgs" / f"{i:07d}.png",
                   r.integers(0, 255, (96, 160, 3), dtype=np.uint8))
    argv = ["--pretrained", ckpts["dispnets"], "--dataset-dir",
            str(tmp_path / "imgs"), "--output-disp", "--output-depth",
            "--img-height", str(H), "--img-width", str(W)]
    jinfer.main(argv + ["--output-dir", str(tmp_path / "ref")])
    tinfer.main(argv + ["--output-dir", str(tmp_path / "mine"),
                        "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "mine")) and len(names) == 4
    for n in names:
        a = cv2.imread(str(tmp_path / "mine" / n)).astype(int)
        e = cv2.imread(str(tmp_path / "ref" / n)).astype(int)
        assert a.shape == e.shape == (H, W, 3)
        print(n, "max |port - cc_tpu|", np.abs(a - e).max())
        assert np.abs(a - e).max() <= COLOUR_STEP, n


@pytest.mark.parametrize("cli,argv", [
    (tdisp, ["--pretrained-dispnet", "none.pth.tar", "--output-dir", "out"]),
    (tmake3d, ["--pretrained-dispnet", "none.pth.tar"]),
    (tinfer, ["--pretrained", "none.pth.tar", "--output-disp",
              "--output-dir", "out"]),
])
def test_depth_clis_default_to_cuda(cli, argv, tmp_path, monkeypatch):
    """--device defaults to cuda; without a GPU the CLI raises before it
    reads a file (here, a checkpoint that does not exist) or writes one."""
    monkeypatch.chdir(tmp_path)
    assert cli.parser.parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    assert os.listdir(tmp_path) == []
