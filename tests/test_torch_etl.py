"""The port's offline ETL (cc_tpu_torch.cli.prepare_train_data and
cc_tpu_torch.data.etl) against cc_tpu's on the same fabricated raw trees:
the dumps must be the same trees, the JPEGs, cam.txt and split lists byte
for byte and the GT depth arrays equal, whatever the port's thread count.

The KITTI raw tree follows tests/test_cli_golden2.py's kitti_raw_tree
(that file needs the reference and skips here), with frames larger than
the output so that the resize and the zoomed P_rect matter, one slow drive
that the speed filter thins, and a test scene that must be left out.
No JAX is compiled: cc_tpu's ETL is numpy and cv2.
"""
import filecmp
import glob
import json
import os

import numpy as np
import pytest
import torch

from cc_tpu.cli import prepare_train_data as jcli
from cc_tpu.data import etl as jetl
from cc_tpu_torch.cli import prepare_train_data as tcli
from cc_tpu_torch.data import etl as tetl
from tests.cli_fixtures import _write_png

torch.set_num_threads(2)

RAW_H, RAW_W = 96, 200
OUT = ["--height", "64", "--width", "128"]
DATE = "2011_09_26"
# 0002 is a test scene (data/lists/test_scenes.txt); 0005 drives at
# 1.2 m/s, so the cumulative-speed filter keeps every other frame
DRIVES = {"0001": 5.0, "0002": 5.0, "0005": 1.2}
FRAMES = 6


@pytest.fixture(scope="module")
def kitti_raw(tmp_path_factory):
    """A KITTI raw tree: one date, three drives x two cameras of 6 PNGs,
    oxts speeds, velodyne scans back-projected from a pixel grid at
    random depths, calib_cam_to_cam.txt and calib_velo_to_cam.txt."""
    root = tmp_path_factory.mktemp("kitti_raw")
    rng = np.random.default_rng(9)
    fx, fy, cx, cy = 60.0, 55.0, RAW_W / 2.0, RAW_H / 2.0
    os.makedirs(root / DATE)
    with open(root / DATE / "calib_cam_to_cam.txt", "w") as f:
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        for cid, tx in (("02", 4.5), ("03", -3.4)):
            f.write(f"P_rect_{cid}: {fx} 0 {cx} {tx} 0 {fy} {cy} 0.2 "
                    "0 0 1 0.003\n")
    r_vc = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    with open(root / DATE / "calib_velo_to_cam.txt", "w") as f:
        f.write("R: " + " ".join(map(str, r_vc.ravel())) + "\n")
        f.write("T: 0.1 -0.05 0.02\n")
    us, vs = np.meshgrid(np.arange(6, RAW_W - 6, 3), np.arange(20, RAW_H - 2, 2))
    us, vs = us.ravel().astype(np.float64), vs.ravel().astype(np.float64)
    for drive, speed in DRIVES.items():
        d = root / DATE / f"{DATE}_drive_{drive}_sync"
        for i in range(FRAMES):
            for cid in ("02", "03"):
                _write_png(d / f"image_{cid}" / "data" / f"{i:010d}.png",
                           rng.integers(0, 255, (RAW_H, RAW_W, 3),
                                        dtype=np.uint8))
            os.makedirs(d / "oxts" / "data", exist_ok=True)
            row = [0.0] * 30
            row[8:11] = [speed, 0.1, 0.0]
            with open(d / "oxts" / "data" / f"{i:010d}.txt", "w") as f:
                f.write(" ".join(map(str, row)) + "\n")
            z = rng.uniform(5.0, 30.0, us.shape)
            cam = np.stack([(us - cx) * z / fx, (vs - cy) * z / fy, z], 1)
            # some points behind the car, which the projection drops
            velo = np.concatenate([cam @ r_vc, -(cam[:50] @ r_vc)])
            pts = np.concatenate([velo, np.ones((len(velo), 1))], 1)
            os.makedirs(d / "velodyne_points" / "data", exist_ok=True)
            pts.astype(np.float32).tofile(
                str(d / "velodyne_points" / "data" / f"{i:010d}.bin"))
    return root


@pytest.fixture(scope="module")
def cityscapes_raw(tmp_path_factory):
    """Cityscapes: two cities; aachen holds a sequence of 8 frames, one of
    4 (2 after the subsample: dropped) and one of 6 without a camera file
    (dropped); bochum, in val, one of 7 frames. 1024x512 is cropped to its
    top 384 rows."""
    root = tmp_path_factory.mktemp("cityscapes")
    rng = np.random.default_rng(10)
    seqs = {("train", "aachen"): [("000042", 0, 8), ("000043", 5, 4),
                                  ("000044", 0, 6)],
            ("val", "bochum"): [("000007", 19, 7)]}
    for (split, city), runs in seqs.items():
        for seq, first, n in runs:
            for frame in range(first, first + n):
                _write_png(root / "leftImg8bit_sequence" / split / city
                           / f"{city}_{seq}_{frame:06d}_leftImg8bit.png",
                           rng.integers(0, 255, (128, 256, 3),
                                        dtype=np.uint8))
            if seq == "000044":
                continue
            cam_dir = root / "camera" / split / city
            os.makedirs(cam_dir, exist_ok=True)
            with open(cam_dir / f"{city}_{seq}_{first:06d}_camera.json",
                      "w") as f:
                json.dump({"intrinsic": {"fx": 2262.5, "fy": 2265.3,
                                         "u0": 1096.9, "v0": 513.1}}, f)
    return root


def _files(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**"), recursive=True)
                  if os.path.isfile(p))


def assert_same_dump(mine, ref):
    """The same files; .npy arrays equal in dtype and value, every other
    file (JPEG, cam.txt, train.txt, val.txt) equal byte for byte."""
    files = _files(ref)
    assert _files(mine) == files
    for rel in files:
        a, b = os.path.join(mine, rel), os.path.join(ref, rel)
        if rel.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), rel
        else:
            assert filecmp.cmp(a, b, shallow=False), rel
    return files


def _dumps(raw, tmp_path, capsys, extra):
    """cc_tpu's CLI (1 job) and the port's at 1 and 3 threads on `raw`;
    returns their dump roots after checking that they print the same."""
    ref = str(tmp_path / "ref")
    jcli.main([str(raw), "--dump-root", ref, "--num-threads", "1"] + extra)
    said = capsys.readouterr().out
    dumps = []
    for threads in (1, 3):
        mine = str(tmp_path / f"mine{threads}")
        tcli.main([str(raw), "--dump-root", mine, "--num-threads",
                   str(threads)] + extra)
        assert capsys.readouterr().out == said
        dumps.append(mine)
    return ref, dumps


def test_kitti_with_gt_speed_filter_matches(kitti_raw, tmp_path, capsys):
    ref, dumps = _dumps(kitti_raw, tmp_path, capsys,
                        ["--dataset-format", "kitti", "--with-gt"] + OUT)
    for mine in dumps:
        files = assert_same_dump(mine, ref)
    scenes = sorted({f.split(os.sep)[0] for f in files if os.sep in f})
    assert scenes == [f"{DATE}_drive_{d}_sync_{c}" for d in ("0001", "0005")
                      for c in ("02", "03")]
    jpgs = lambda s: sum(f.startswith(s + os.sep) and f.endswith(".jpg")
                         for f in files)
    assert [jpgs(s) for s in scenes] == [6, 6, 3, 3]
    val = open(os.path.join(ref, "val.txt")).read().split()
    assert val == [scenes[1]]  # seed 8964's draws: only the second
    depth = np.load(os.path.join(ref, scenes[1], "0000000000.npy"))
    assert depth.shape == (64, 128) and (depth > 0).sum() > 100
    assert not any(f.endswith(".npy") and not f.startswith(scenes[1])
                   for f in files)


def test_kitti_static_frames_matches(kitti_raw, tmp_path, capsys):
    static = tmp_path / "static_frames.txt"
    drive = f"{DATE}_drive_0001_sync"
    static.write_text("".join(f"{DATE} {drive} {i:010d}\n" for i in (1, 2, 4))
                      + f"{DATE} {DATE}_drive_0005_sync 0000000005\n\n")
    ref, dumps = _dumps(kitti_raw, tmp_path, capsys,
                        ["--dataset-format", "kitti", "--static-frames",
                         str(static)] + OUT)
    for mine in dumps:
        files = assert_same_dump(mine, ref)
    names = sorted(os.path.basename(f) for f in files
                   if f.startswith(drive + "_02") and f.endswith(".jpg"))
    assert names == ["0000000000.jpg", "0000000003.jpg", "0000000005.jpg"]
    assert sum(f.startswith(f"{DATE}_drive_0005_sync_03")
               and f.endswith(".jpg") for f in files) == 5


def test_cityscapes_matches(cityscapes_raw, tmp_path, capsys):
    ref, dumps = _dumps(cityscapes_raw, tmp_path, capsys,
                        ["--dataset-format", "cityscapes"] + OUT)
    for mine in dumps:
        files = assert_same_dump(mine, ref)
    assert sorted({f.split(os.sep)[0] for f in files if os.sep in f}) == [
        "aachen_00", "bochum_00"]
    cam = open(os.path.join(ref, "aachen_00", "cam.txt")).read()
    fx = float(cam.split(",")[0])
    assert abs(fx - 2262.5 * 128 / 256) < 1e-3


def test_write_split_matches_at_12_scenes(tmp_path):
    """The port's RandomState(8964) draws as cc_tpu's np.random.seed(8964)
    does: scenes 2, 11 and 12 go to val and keep their GT; the others
    lose it."""
    names = [f"scene_{i:02d}" for i in range(1, 13)]
    roots = {}
    for side, fn in (("ref", jetl.write_split), ("mine", tetl.write_split)):
        root = tmp_path / side
        for n in names:
            os.makedirs(root / n)
            np.save(root / n / "0000000.npy", np.zeros(2, np.float32))
        fn(str(root))
        roots[side] = root
    for fn in ("train.txt", "val.txt"):
        assert (roots["mine"] / fn).read_bytes() == (roots["ref"] / fn
                                                     ).read_bytes()
    assert (roots["mine"] / "val.txt").read_text().split() == [
        "scene_02", "scene_11", "scene_12"]
    kept = sorted(p.parent.name for p in roots["mine"].glob("*/*.npy"))
    assert kept == ["scene_02", "scene_11", "scene_12"]


@pytest.mark.parametrize("name", ["static_frames.txt", "test_scenes.txt"])
def test_lists_are_cc_tpus(name):
    mine = os.path.join(tetl.DATA_DIR, name)
    ref = os.path.join(jetl.DATA_DIR, name)
    assert filecmp.cmp(mine, ref, shallow=False)


def test_parser_matches_cc_tpu():
    actions = lambda p: {a.dest: (a.option_strings, type(a), a.default,
                                  a.type, a.choices, a.required, a.nargs)
                         for a in p._actions}
    assert actions(tcli.parser) == actions(jcli.parser)
