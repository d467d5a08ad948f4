"""Offline ETL: raw KITTI / Cityscapes -> resized scene folders, the
counterpart of cc_tpu/data/etl.py (host only: numpy and cv2, no torch).

The output is the format the train CLI reads: scene dirs of NNNNNNN.jpg, a
comma-separated cam.txt and, with GT, a depth .npy per frame; the filters
are the reference's (test-scene exclusion, the static-frames list or the
cumulative-speed > 2 m/s filter, Cityscapes' bottom-25% crop and 2x frame
subsample), and the same 90/10 split with seed 8964, GT removed from train
scenes. The velodyne projection is the port's own copy
(eval/kitti_depth.py).
"""
from __future__ import annotations

import glob
import json
import os
import shutil

import numpy as np

from cc_tpu_torch.eval.kitti_depth import (
    project_velodyne, read_calib_file, velo2im_matrix,
)

KITTI_DATES = ["2011_09_26", "2011_09_28", "2011_09_29", "2011_09_30",
               "2011_10_03"]
DATA_DIR = os.path.join(os.path.dirname(__file__), "lists")


def _imread(path: str) -> np.ndarray:
    import cv2
    im = cv2.imread(path, cv2.IMREAD_COLOR)
    return cv2.cvtColor(im, cv2.COLOR_BGR2RGB)


def _imresize(im: np.ndarray, h: int, w: int) -> np.ndarray:
    import cv2
    return cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR)


def _imwrite(path: str, im: np.ndarray) -> None:
    import cv2
    cv2.imwrite(path, cv2.cvtColor(im, cv2.COLOR_RGB2BGR),
                [cv2.IMWRITE_JPEG_QUALITY, 95])


class KittiRawLoader:
    """KITTI raw drives (date/*_sync) minus the test scenes; each drive's
    two color cameras become two scenes (cc_tpu/data/etl.py:43-139)."""

    def __init__(self, dataset_dir: str, static_frames_file: str | None = None,
                 img_height: int = 128, img_width: int = 416,
                 min_speed: float = 2, get_gt: bool = False):
        with open(os.path.join(DATA_DIR, "test_scenes.txt")) as f:
            self.test_scenes = [t.strip() for t in f if t.strip()]
        self.from_speed = static_frames_file is None
        if static_frames_file is not None:
            self._collect_static_frames(static_frames_file)
        self.dataset_dir = dataset_dir
        self.img_height, self.img_width = img_height, img_width
        self.cam_ids = ["02", "03"]
        self.min_speed = min_speed
        self.get_gt = get_gt
        self.scenes = []
        for date in KITTI_DATES:
            for dr in sorted(glob.glob(os.path.join(dataset_dir, date,
                                                    "*_sync"))):
                if os.path.basename(dr)[:-5] not in self.test_scenes:
                    self.scenes.append(dr)

    def _collect_static_frames(self, static_frames_file: str) -> None:
        """{drive: [frame ids]} from lines "date drive frame"."""
        self.static_frames = {}
        with open(static_frames_file) as f:
            for line in f:
                if not line.strip():
                    continue
                date, drive, frame_id = line.split(" ")
                self.static_frames.setdefault(drive, []).append(
                    f"{int(frame_id):010d}")

    def collect_scenes(self, drive: str) -> list[dict]:
        """One scene dict per camera: the frame ids and speeds (from oxts),
        P_rect zoomed to the output size and its intrinsics; [] when the
        drive's first image is missing."""
        scenes = []
        for cid in self.cam_ids:
            oxts = sorted(glob.glob(os.path.join(drive, "oxts", "data",
                                                 "*.txt")))
            sd = {"cid": cid, "dir": drive, "speed": [], "frame_id": [],
                  "rel_path": os.path.basename(drive) + "_" + cid}
            for n, f in enumerate(oxts):
                metadata = np.genfromtxt(f)
                sd["speed"].append(metadata[8:11])
                sd["frame_id"].append(f"{n:010d}")
            sample = self._load_image(sd, 0)
            if sample is None:
                return []
            sd["P_rect"] = self._get_p_rect(sd, sample[1], sample[2])
            sd["intrinsics"] = sd["P_rect"][:, :3]
            scenes.append(sd)
        return scenes

    def get_scene_imgs(self, sd: dict):
        """Yield [image, frame id] (+ GT depth) for each frame kept: once
        the speed summed since the last kept frame exceeds min_speed, or,
        with a static-frames file, each frame it does not list."""
        def sample(i, frame_id):
            out = [self._load_image(sd, i)[0], frame_id]
            if self.get_gt:
                out.append(self._depth_map(sd, i))
            return out

        if self.from_speed:
            cum_speed = np.zeros(3)
            for i, speed in enumerate(sd["speed"]):
                cum_speed += speed
                if np.linalg.norm(cum_speed) > self.min_speed:
                    yield sample(i, sd["frame_id"][i])
                    cum_speed *= 0
        else:
            drive = os.path.basename(sd["dir"])
            for i, frame_id in enumerate(sd["frame_id"]):
                if frame_id not in self.static_frames.get(drive, []):
                    yield sample(i, frame_id)

    def _get_p_rect(self, sd: dict, zoom_x: float, zoom_y: float):
        calib = read_calib_file(os.path.join(
            os.path.dirname(sd["dir"]), "calib_cam_to_cam.txt"))
        p_rect = np.reshape(calib["P_rect_" + sd["cid"]], (3, 4)).copy()
        p_rect[0] *= zoom_x
        p_rect[1] *= zoom_y
        return p_rect

    def _load_image(self, sd: dict, idx: int):
        """(the image resized to the output size, zoom_x, zoom_y), or None
        when the file is missing."""
        path = os.path.join(sd["dir"], f"image_{sd['cid']}", "data",
                            sd["frame_id"][idx] + ".png")
        if not os.path.isfile(path):
            return None
        img = _imread(path)
        zoom_y = self.img_height / img.shape[0]
        zoom_x = self.img_width / img.shape[1]
        return _imresize(img, self.img_height, self.img_width), zoom_x, zoom_y

    def _depth_map(self, sd: dict, idx: int) -> np.ndarray:
        calib_dir = os.path.dirname(sd["dir"])
        velo = os.path.join(sd["dir"], "velodyne_points", "data",
                            sd["frame_id"][idx] + ".bin")
        p = velo2im_matrix(calib_dir, sd["P_rect"])
        return project_velodyne(p, velo, (self.img_height, self.img_width)
                                ).astype(np.float32)


class CityscapesLoader:
    """Cityscapes leftImg8bit_sequence cities: connected sequences, a 2x
    frame subsample, the bottom 25% (the car's logo) cropped, intrinsics
    from the camera json rescaled (cc_tpu/data/etl.py:142-225)."""

    def __init__(self, dataset_dir: str, img_height: int = 171,
                 img_width: int = 416, min_speed: float = 2):
        self.dataset_dir = dataset_dir
        self.img_height, self.img_width = img_height, img_width
        self.min_speed = min_speed
        self.scenes = []
        for split in ("train", "val"):
            seq_dir = os.path.join(dataset_dir, "leftImg8bit_sequence",
                                   split)
            for city in sorted(glob.glob(os.path.join(seq_dir, "*"))):
                self.scenes.append(city)

    def collect_scenes(self, city_dir: str) -> list[dict]:
        """One scene per connected sequence (same sequence id, consecutive
        frame numbers) that keeps at least 3 frames after the subsample and
        has a camera file."""
        city = os.path.basename(city_dir)
        frames = sorted(glob.glob(os.path.join(city_dir, "*.png")))
        sequences = []
        current, prev = [], None
        for f in frames:
            parts = os.path.basename(f).split("_")
            key = (parts[1], int(parts[2]))
            if prev is not None and (key[0] != prev[0]
                                     or key[1] != prev[1] + 1):
                sequences.append(current)
                current = []
            current.append(f)
            prev = key
        if current:
            sequences.append(current)

        scenes = []
        for si, seq in enumerate(sequences):
            seq = seq[::2]
            if len(seq) < 3:
                continue
            cam_file = self._camera_file(seq[0])
            if cam_file is None:
                continue
            intrinsics, speeds = self._read_camera(cam_file, seq)
            scenes.append({"frames": seq, "intrinsics": intrinsics,
                           "speed": speeds,
                           "rel_path": f"{city}_{si:02d}"})
        return scenes

    def _camera_file(self, frame_path: str) -> str | None:
        parts = os.path.basename(frame_path).split("_")
        city = parts[0]
        for split in ("train", "val", "test"):
            p = os.path.join(self.dataset_dir, "camera", split, city,
                             "_".join(parts[:3]) + "_camera.json")
            if os.path.isfile(p):
                return p
        return None

    def _read_camera(self, cam_file: str, seq: list[str]):
        with open(cam_file) as f:
            cam = json.load(f)
        fx, fy = cam["intrinsic"]["fx"], cam["intrinsic"]["fy"]
        u0, v0 = cam["intrinsic"]["u0"], cam["intrinsic"]["v0"]
        k = np.array([[fx, 0, u0], [0, fy, v0], [0, 0, 1]], np.float32)
        # zoomed to the output size of the crop without the bottom 25%
        probe = _imread(seq[0])
        in_h, in_w = probe.shape[:2]
        k[0] *= self.img_width / in_w
        k[1] *= self.img_height / int(in_h * 0.75)
        speeds = [self.min_speed + 1] * len(seq)  # no oxts: every frame
        return k, speeds

    def get_scene_imgs(self, sd: dict):
        for i, f in enumerate(sd["frames"]):
            img = _imread(f)
            crop_h = int(img.shape[0] * 0.75)
            img = _imresize(img[:crop_h], self.img_height, self.img_width)
            yield [img, f"{i:07d}"]


def dump_scene(loader, scene: str, dump_root: str) -> None:
    """Write one raw scene's camera streams under dump_root: cam.txt, the
    JPEGs and any GT .npy; a stream of fewer than 3 frames is removed."""
    for sd in loader.collect_scenes(scene):
        dump_dir = os.path.join(dump_root, sd["rel_path"])
        os.makedirs(dump_dir, exist_ok=True)
        k = sd["intrinsics"]
        with open(os.path.join(dump_dir, "cam.txt"), "w") as f:
            f.write("%f,0.,%f,0.,%f,%f,0.,0.,1." % (k[0, 0], k[0, 2],
                                                    k[1, 1], k[1, 2]))
        for sample in loader.get_scene_imgs(sd):
            img, frame_nb = sample[0], sample[1]
            _imwrite(os.path.join(dump_dir, f"{frame_nb}.jpg"), img)
            if len(sample) == 3:
                np.save(os.path.join(dump_dir, f"{frame_nb}.npy"), sample[2])
        if len(glob.glob(os.path.join(dump_dir, "*.jpg"))) < 3:
            shutil.rmtree(dump_dir)


def write_split(dump_root: str, val_frac: float = 0.1, seed: int = 8964,
                strip_train_gt: bool = True) -> None:
    """train.txt and val.txt over the sorted scene dirs: a scene goes to
    val when its draw is under val_frac. The draws are a RandomState of
    `seed`, the stream cc_tpu draws after np.random.seed(seed), so the
    lists are the same; GT is removed from train scenes."""
    rng = np.random.RandomState(seed)
    subdirs = sorted(d for d in glob.glob(os.path.join(dump_root, "*"))
                     if os.path.isdir(d))
    with open(os.path.join(dump_root, "train.txt"), "w") as tf, \
            open(os.path.join(dump_root, "val.txt"), "w") as vf:
        for s in subdirs:
            if rng.random_sample() < val_frac:
                vf.write(os.path.basename(s) + "\n")
            else:
                tf.write(os.path.basename(s) + "\n")
                if strip_train_gt:
                    for gt in glob.glob(os.path.join(s, "*.npy")):
                        os.remove(gt)
