"""The port's data path against cc_tpu's, on image folders each test
writes: samples, transforms, loader batches, validation items, flow files
and the C++ data plane equal cc_tpu's bit for bit for the same (seed,
epoch, index); the port's C++ plane against its Python pipeline within
tests/test_native_dataplane.py's tolerance; and device_prefetch on the CPU.
No JAX is compiled: cc_tpu's data path is numpy and cv2.
"""
import os

import numpy as np
import pytest
import torch

from cc_tpu import native as jnative
from cc_tpu.data import loader as jloader
from cc_tpu.data import native_pipeline as jnp_pipe
from cc_tpu.data import sequence_folders as jsf
from cc_tpu.data import stacked_sequence_folders as jssf
from cc_tpu.data import transforms as jtf
from cc_tpu.data import validation as jval
from cc_tpu.utils import flow_io as jflow
from cc_tpu_torch import native
from cc_tpu_torch.data import loader, native_pipeline, sequence_folders
from cc_tpu_torch.data import stacked_sequence_folders, transforms, validation
from cc_tpu_torch.utils import flow_io

torch.set_num_threads(2)

H, W = 64, 128
SCENES = ("scene_a", "scene_b")
FRAMES = 7
SEED = 3


def _frame(r, h=H, w=W):
    """A smooth random colour image, so that resizes and warps blend
    distinct neighbours."""
    import cv2
    return cv2.GaussianBlur(r.integers(0, 256, (h, w, 3), np.uint8), (7, 7), 2)


def _write_cam(path, k):
    with open(path, "w") as f:
        f.write(",".join(f"{v:.1f}" for v in np.asarray(k).ravel()))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """2 scenes of 7 JPEG frames, cam.txt each, both in train.txt and
    val.txt; each frame also has a .npy depth map (ValidationSet)."""
    import cv2
    root = tmp_path_factory.mktemp("scenes")
    r = np.random.default_rng(0)
    for i, scene in enumerate(SCENES):
        d = root / scene
        d.mkdir()
        # an off-centre principal point, so that a flip moves cx
        _write_cam(d / "cam.txt", [[90.0 + i, 0, W / 2 + 5],
                                   [0, 90.0 + i, H / 2 - 3], [0, 0, 1]])
        for j in range(FRAMES):
            cv2.imwrite(str(d / f"{j:07d}.jpg"), _frame(r))
            np.save(d / f"{j:07d}.npy",
                    r.uniform(1, 80, (H, W)).astype(np.float32))
    for name in ("train.txt", "val.txt"):
        (root / name).write_text("\n".join(SCENES) + "\n")
    return str(root)


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


# (builder of the transform, args): every legal train pipeline (uint8 needs
# global normalization) and the two valid ones
TRANSFORMS = [("train_transform", (norm, rot, emit))
              for emit in ("float32", "uint8")
              for rot in (True, False)
              for norm in ("global", "local")
              if not (emit == "uint8" and norm == "local")]
TRANSFORMS += [("valid_transform", ("local",)),
               ("valid_flow_transform", (48, 96, "global"))]


@pytest.mark.parametrize("builder,args", TRANSFORMS,
                         ids=lambda v: "-".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_sequence_folder_matches_cc_tpu(scenes, builder, args):
    mine = sequence_folders.SequenceFolder(
        scenes, seed=SEED, sequence_length=5,
        transform=getattr(transforms, builder)(*args))
    ref = jsf.SequenceFolder(scenes, seed=SEED, sequence_length=5,
                             transform=getattr(jtf, builder)(*args))
    assert len(mine) == len(ref) == len(SCENES) * (FRAMES - 4)
    assert [(s["tgt"], s["ref_imgs"]) for s in mine.samples] == \
        [(s["tgt"], s["ref_imgs"]) for s in ref.samples]
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(mine)):
            _assert_same(mine[i], ref[i])


def _images(r, n=3):
    imgs = [r.uniform(0, 255, (H, W, 3)).astype(np.float32)
            for _ in range(n)]
    k = np.array([[90.0, 0, W / 2 + 5], [0, 95.0, H / 2 - 3], [0, 0, 1]],
                 np.float32)
    return imgs, k


# each transform alone, by class name and constructor arguments
SINGLE = [("ToFloat", ()), ("Normalize", ()),
          ("Normalize", ((0.4, 0.5, 0.6), (0.2, 0.3, 0.4))),
          ("NormalizeLocally", ()), ("QuantizeU8", ()),
          ("RandomHorizontalFlip", ()), ("RandomRotate", ()),
          ("RandomScaleCrop", ()), ("RandomScaleCrop", (48, 96)),
          ("Scale", (40, 100))]


@pytest.mark.parametrize("name,args", SINGLE,
                         ids=[f"{n}{a}" for n, a in SINGLE])
def test_transform_matches_cc_tpu(name, args):
    """Outputs, intrinsics and the generator's state after the call, over
    seeds that take both sides of each random branch."""
    for seed in range(6):
        imgs, k = _images(np.random.default_rng(seed))
        r_mine, r_ref = (np.random.default_rng(100 + seed) for _ in range(2))
        out, k_out = getattr(transforms, name)(*args)(
            [im.copy() for im in imgs], k.copy(), r_mine)
        exp, k_exp = getattr(jtf, name)(*args)(
            [im.copy() for im in imgs], k.copy(), r_ref)
        assert len(out) == len(exp)
        for a, b in zip(out, exp):
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, seed)
        assert np.array_equal(k_out, k_exp)
        assert r_mine.random() == r_ref.random()


def test_compose_and_dequantize_match_cc_tpu():
    imgs, k = _images(np.random.default_rng(1))
    pipe = lambda tf: tf.Compose([tf.RandomHorizontalFlip(),
                                  tf.RandomScaleCrop(), tf.QuantizeU8()])
    out, k_out = pipe(transforms)(imgs, k, np.random.default_rng(5))
    exp, k_exp = pipe(jtf)(imgs, k, np.random.default_rng(5))
    assert all(np.array_equal(a, b) for a, b in zip(out, exp))
    assert np.array_equal(k_out, k_exp)
    assert np.array_equal(transforms.dequantize_u8(out[0]),
                          jtf.dequantize_u8(exp[0]))


def test_resize_without_cv2_matches_cc_tpu(monkeypatch):
    """_resize's PIL branch, taken where cv2 is missing."""
    monkeypatch.setattr(transforms, "cv2", None)
    monkeypatch.setattr(jtf, "cv2", None)
    imgs, k = _images(np.random.default_rng(2))
    imgs = [np.rint(im) for im in imgs]
    out, k_out = transforms.Scale(40, 100)(imgs, k)
    exp, k_exp = jtf.Scale(40, 100)(imgs, k)
    assert all(np.array_equal(a, b) for a, b in zip(out, exp))
    assert np.array_equal(k_out, k_exp)


def test_load_image_and_crawl_match_cc_tpu(scenes):
    path = os.path.join(scenes, SCENES[0], "0000003.jpg")
    _assert_same({"im": sequence_folders.load_image(path)},
                 {"im": jsf.load_image(path)})
    folders = [os.path.join(scenes, s) for s in SCENES]
    mine = sequence_folders.crawl_folders(folders, 3, shuffle_seed=4)
    ref = jsf.crawl_folders(folders, 3, shuffle_seed=4)
    assert [(s["tgt"], s["ref_imgs"]) for s in mine] == \
        [(s["tgt"], s["ref_imgs"]) for s in ref]
    assert all(np.array_equal(a["intrinsics"], b["intrinsics"])
               for a, b in zip(mine, ref))
    with pytest.raises(FileNotFoundError):
        sequence_folders.load_image(os.path.join(scenes, "missing.jpg"))


def test_stacked_sequence_folder_matches_cc_tpu(tmp_path):
    """Strips of 3 frames side by side, a _cam.txt each."""
    import cv2
    r = np.random.default_rng(1)
    (tmp_path / "s0").mkdir()
    for j in range(3):
        cv2.imwrite(str(tmp_path / "s0" / f"{j:07d}.jpg"), _frame(r, H, 3 * W))
        _write_cam(tmp_path / "s0" / f"{j:07d}_cam.txt",
                   [[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]])
    (tmp_path / "train.txt").write_text(
        "".join(f"s0 {j:07d}\n" for j in range(3)))
    mine = stacked_sequence_folders.StackedSequenceFolder(
        str(tmp_path), seed=SEED, transform=transforms.train_transform())
    ref = jssf.StackedSequenceFolder(str(tmp_path), seed=SEED,
                                     transform=jtf.train_transform())
    assert len(mine) == len(ref) == 3
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(3):
            _assert_same(mine[i], ref[i])


class _Indexed:
    """Samples that name their index and the epoch they were drawn in."""

    def __init__(self, n=11):
        self.n, self.epoch = n, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2, 3), i, np.float32),
                "e": np.int64(self.epoch * 1000 + i)}


@pytest.mark.parametrize("shuffle,drop_last,batch_slice", [
    (False, True, None), (True, True, None), (True, False, None),
    (False, False, slice(1, 3)), (True, True, slice(0, 2))])
def test_loader_matches_cc_tpu(shuffle, drop_last, batch_slice):
    kw = dict(batch_size=4, shuffle=shuffle, num_workers=3,
              drop_last=drop_last, seed=9, batch_slice=batch_slice)
    mine = loader.DataLoader(_Indexed(), **kw)
    ref = jloader.DataLoader(_Indexed(), **kw)
    assert len(mine) == len(ref) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs: the shuffle follows seed + epoch
        got, exp = list(mine), list(ref)
        assert len(got) == len(exp) == len(mine)
        for a, b in zip(got, exp):
            _assert_same(a, b)


# ------------------------------------------------------------- validation

N_KITTI = 2
KH, KW = 40, 100  # KITTI-like frames, resized by valid_flow_transform


def _write_flow_png(path, r, writer):
    u = np.round(r.uniform(-30, 30, (KH, KW)) * 64) / 64
    v = np.round(r.uniform(-30, 30, (KH, KW)) * 64) / 64
    writer(str(path), u, v, (r.random((KH, KW)) > 0.3).astype(np.uint16))


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """KITTI 2015 and 2012 layouts with N_KITTI items each: multiview
    frames 08-12, flow_occ, obj_map, calib and semantic labels; 2012's
    colored_0 pairs and flow_occ."""
    import cv2
    root = tmp_path_factory.mktemp("kitti")
    r = np.random.default_rng(2)
    p_rect = " ".join(f"{v:.1f}" for v in
                      [70, 0, KW / 2, 1, 0, 71, KH / 2, 2, 0, 0, 1, 0])
    for phase in ("training", "testing"):
        mv = root / "data_scene_flow_multiview" / phase / "image_2"
        occ = root / "data_scene_flow" / phase / "flow_occ"
        obj = root / "data_scene_flow" / phase / "obj_map"
        cal = root / "data_scene_flow_calib" / phase / "calib_cam_to_cam"
        sem = root / "semantic_labels" / phase / "semantic"
        for d in (mv, occ, obj, cal, sem):
            d.mkdir(parents=True)
        for i in range(N_KITTI):
            i6 = f"{i:06d}"
            for f in range(8, 13):
                cv2.imwrite(str(mv / f"{i6}_{f:02d}.png"), _frame(r, KH, KW))
            _write_flow_png(occ / f"{i6}_10.png", r, jflow.flow_write_png)
            cv2.imwrite(str(obj / f"{i6}_10.png"),
                        r.integers(0, 4, (KH, KW), np.uint8))
            cv2.imwrite(str(sem / f"{i6}_10.png"),
                        r.integers(0, 30, (KH, KW, 3), np.uint8))
            (cal / f"{i6}.txt").write_text(
                f"calib_time: 09-Jan-2012 13:57:47\nP_rect_02: {p_rect}\n")
    base = root / "data_stereo_flow" / "training"
    (base / "colored_0").mkdir(parents=True)
    (base / "flow_occ").mkdir()
    for i in range(N_KITTI):
        for f in (10, 11):
            cv2.imwrite(str(base / "colored_0" / f"{i:06d}_{f}.png"),
                        _frame(r, KH, KW))
        _write_flow_png(base / "flow_occ" / f"{i:06d}_10.png", r,
                        jflow.flow_write_png)
    return str(root)


@pytest.mark.parametrize("name", ["ValidationFlow", "ValidationMask",
                                  "KITTI2015Test", "ValidationFlowKitti2012"])
def test_kitti_validation_sets_match_cc_tpu(kitti, name):
    mine = getattr(validation, name)(
        kitti, transform=transforms.valid_flow_transform(64, 128), N=N_KITTI)
    ref = getattr(jval, name)(
        kitti, transform=jtf.valid_flow_transform(64, 128), N=N_KITTI)
    assert len(mine) == len(ref) == N_KITTI
    for i in range(N_KITTI):
        _assert_same(mine[i], ref[i])


def test_validation_set_matches_cc_tpu(scenes):
    mine = validation.ValidationSet(scenes, transform=transforms.valid_transform())
    ref = jval.ValidationSet(scenes, transform=jtf.valid_transform())
    assert len(mine) == len(ref) == len(SCENES) * FRAMES
    for i in (0, FRAMES, len(mine) - 1):
        _assert_same(mine[i], ref[i])


@pytest.mark.parametrize("fmt", ["png", "flo", "pfm"])
def test_flow_files_match_cc_tpu(tmp_path, fmt):
    """The port writes the same bytes as cc_tpu, and both read them back
    to the same values: exactly, for values the format holds exactly."""
    r = np.random.default_rng(4)
    mine, ref = str(tmp_path / f"mine.{fmt}"), str(tmp_path / f"ref.{fmt}")
    if fmt == "png":
        u = np.round(r.uniform(-50, 50, (20, 30)) * 64) / 64
        v = np.round(r.uniform(-50, 50, (20, 30)) * 64) / 64
        valid = (r.random((20, 30)) > 0.5).astype(np.uint16)
        flow_io.flow_write_png(mine, u, v, valid)
        jflow.flow_write_png(ref, u, v, valid)
        for got in (flow_io.flow_read_png(mine), jflow.flow_read_png(mine)):
            assert all(np.array_equal(a, b) for a, b in zip(got, (u, v, valid)))
        expected = np.dstack((u, v, valid)).astype(np.float32)
    elif fmt == "flo":
        expected = r.standard_normal((16, 24, 2)).astype(np.float32)
        flow_io.flow_write_flo(mine, expected)
        jflow.flow_write_flo(ref, expected)
    else:
        image = r.standard_normal((12, 10, 3)).astype(np.float32)
        flow_io.pfm_write(mine, image, scale=2.0)
        jflow.pfm_write(ref, image, scale=2.0)
        for got, scale in (flow_io.pfm_read(mine), jflow.pfm_read(mine)):
            assert scale == 2.0 and np.array_equal(got, image)
        expected = image[..., :2]
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert np.array_equal(flow_io.flow_read(mine), expected)
    assert np.array_equal(jflow.flow_read(mine), expected)


# ------------------------------------------------------- the C++ data plane

@pytest.fixture(scope="module")
def native_libs():
    """Both C++ planes, built here with g++ against the system OpenCV."""
    if native.lib() is None or jnative.lib() is None:
        pytest.skip("the C++ data plane does not build here")
    return native.lib(), jnative.lib()


NATIVE_TRAIN = [(norm, rot, emit) for norm, rot, emit in
                (("global", True, "float32"), ("global", False, "float32"),
                 ("local", True, "float32"), ("local", False, "float32"),
                 ("global", True, "uint8"), ("global", False, "uint8"))]


@pytest.mark.parametrize("norm,rot,emit", NATIVE_TRAIN)
def test_native_pipeline_matches_cc_tpu_and_python(scenes, native_libs, norm,
                                                   rot, emit):
    """The port's C++ plane against cc_tpu's, bit for bit, and against the
    port's Python pipeline within test_native_dataplane.py's tolerance:
    decode, flip and downscales are bit-identical; the rotation warp and
    non-integer upscales differ at interpolation precision between the
    Python cv2 wheel and the system OpenCV; local normalization adds
    fp32-against-double statistics."""
    pipe = native_pipeline.NativeTrainPipeline(norm, rot, emit)
    mine = sequence_folders.SequenceFolder(scenes, seed=SEED, sequence_length=5,
                                           transform=pipe)
    ref = jsf.SequenceFolder(scenes, seed=SEED, sequence_length=5,
                             transform=jnp_pipe.NativeTrainPipeline(norm, rot,
                                                                    emit))
    python = sequence_folders.SequenceFolder(
        scenes, seed=SEED, sequence_length=5, transform=pipe.fallback)
    tol = 2e-4 if (rot or norm == "local") else 5e-5
    if emit == "uint8":  # a rounding of values that differ by tol/255
        tol = 1
    for epoch in (0, 1):
        for ds in (mine, ref, python):
            ds.set_epoch(epoch)
        for i in range(len(mine)):
            a, b, c = mine[i], ref[i], python[i]
            _assert_same(a, b)
            for k in ("tgt", "refs"):
                assert a[k].dtype == c[k].dtype
                np.testing.assert_allclose(a[k].astype(np.float32),
                                           c[k].astype(np.float32), atol=tol)
            np.testing.assert_allclose(a["intrinsics"], c["intrinsics"],
                                       rtol=1e-6)


@pytest.mark.parametrize("hw", [(0, 0), (48, 96)])
def test_native_valid_pipeline_matches_cc_tpu(scenes, native_libs, hw):
    lib, jlib = native_libs
    path = os.path.join(scenes, SCENES[1], "0000002.jpg")
    k = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    pipe = native_pipeline.NativeValidPipeline(*hw)
    aug, k_mine = pipe.draw(None, H, W, k)
    jaug, k_ref = jnp_pipe.NativeValidPipeline(*hw).draw(None, H, W, k)
    out_hw = pipe.out_hw(H, W)
    out = native_pipeline.process_sample(lib, [path], aug, *out_hw)
    exp = jnp_pipe.process_sample(jlib, [path], jaug, *out_hw)
    assert np.array_equal(out, exp) and np.array_equal(k_mine, k_ref)
    # and the port's Python valid pipeline, within test_native_dataplane.py's
    # tolerance for a pipeline without rotation or local normalization
    imgs, k_py = pipe.fallback([sequence_folders.load_image(path)], k.copy())
    np.testing.assert_allclose(out[0], imgs[0], atol=5e-5)
    np.testing.assert_allclose(k_mine, k_py, rtol=1e-6)
    with pytest.raises(FileNotFoundError):
        native_pipeline.process_sample(
            lib, [os.path.join(scenes, "missing.jpg")], aug, *out_hw)


def test_train_pipeline_picks_the_plane(native_libs, monkeypatch):
    tf, plane = native_pipeline.train_pipeline(loader="auto")
    assert plane == "native"
    assert isinstance(tf, native_pipeline.NativeTrainPipeline)
    tf, plane = native_pipeline.train_pipeline("local", False, loader="python")
    assert plane == "python" and isinstance(tf, transforms.Compose)
    with pytest.raises(ValueError):
        native_pipeline.train_pipeline(loader="fast")
    with pytest.raises(ValueError, match="global normalization"):
        native_pipeline.train_pipeline("local", emit="uint8")
    # where the plane does not build: auto takes Python, native raises
    monkeypatch.setattr(native, "lib", lambda: None)
    assert native_pipeline.train_pipeline(loader="auto")[1] == "python"
    with pytest.raises(RuntimeError, match="does not build"):
        native_pipeline.train_pipeline(loader="native")


# ---------------------------------------------------------- device_prefetch

@pytest.mark.parametrize("size", [1, 2, 3])
def test_device_prefetch_on_cpu_matches_collate(scenes, size):
    """Every batch of a 5-batch epoch (the tail drained), in order, with the
    host batches' values, dtypes and keys."""
    ds = sequence_folders.SequenceFolder(
        scenes, seed=SEED, sequence_length=3,
        transform=transforms.train_transform(emit="uint8"))
    host = list(loader.DataLoader(ds, 2, shuffle=True, seed=1))
    assert len(host) == 5
    got = list(loader.device_prefetch(
        iter(loader.DataLoader(ds, 2, shuffle=True, seed=1)), "cpu", size))
    assert len(got) == len(host)
    for a, b in zip(got, host):
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in a.values())
        _assert_same({k: v.numpy() for k, v in a.items()}, b)
    assert got[0]["tgt"].dtype == torch.uint8


def test_device_prefetch_needs_cuda_unless_asked_for_the_cpu():
    with pytest.raises(ValueError):
        loader.device_prefetch(iter([]), "cpu", size=0)
    if torch.cuda.is_available():
        return
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loader.device_prefetch(iter([]), device)
