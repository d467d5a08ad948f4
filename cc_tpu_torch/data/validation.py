"""Validation datasets: depth GT folders and KITTI 2015/2012 flow sets.

Parity: datasets/validation_folders.py (ValidationSet) and
datasets/validation_flow.py (ValidationFlow, ValidationMask, KITTI2015Test,
ValidationFlowKitti2012). Samples are numpy dicts, NHWC.

A copy of cc_tpu/data/validation.py (the port imports nothing of cc_tpu);
tests/test_torch_data.py holds the two to equal bits.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from cc_tpu_torch.data.sequence_folders import load_image
from cc_tpu_torch.utils.flow_io import flow_read_png


def read_kitti_calib(filepath: str) -> dict:
    """KITTI calib file -> dict of float arrays."""
    data = {}
    with open(filepath) as f:
        for line in f.readlines():
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def get_intrinsics(calib_file: str, cid: str = "02") -> np.ndarray:
    p_rect = np.reshape(read_kitti_calib(calib_file)["P_rect_" + cid], (3, 4))
    return p_rect[:, :3]


class ValidationSet:
    """Image + GT-depth (.npy) pairs from scene folders
    (validation_folders.py:45-76)."""

    def __init__(self, root: str, transform=None):
        self.root = root
        with open(os.path.join(root, "val.txt")) as f:
            self.scenes = [os.path.join(root, s.strip())
                           for s in f if s.strip()]
        self.imgs, self.depths = [], []
        for scene in self.scenes:
            for img in sorted(glob.glob(os.path.join(scene, "*.jpg"))):
                d = img[:-4] + ".npy"
                assert os.path.isfile(d), f"depth file {d} not found"
                self.imgs.append(img)
                self.depths.append(d)
        self.transform = transform

    def __getitem__(self, index):
        img = load_image(self.imgs[index])
        depth = np.load(self.depths[index]).astype(np.float32)
        if self.transform is not None:
            img = self.transform([img], None)[0][0]
        return {"tgt": np.asarray(img, np.float32), "depth": depth}

    def __len__(self):
        return len(self.imgs)


class _Kitti2015Base:
    def __init__(self, root: str, sequence_length: int = 5, transform=None,
                 N: int = 200, phase: str = "training"):
        self.root = root
        self.N = N
        self.transform = transform
        self.phase = phase
        seq_ids = [i for i in range(-(sequence_length // 2),
                                    sequence_length // 2 + 1) if i != 0]
        self.seq_ids = [i + 10 for i in seq_ids]

    def _paths(self, index):
        i6 = str(index).zfill(6)
        mv = os.path.join(self.root, "data_scene_flow_multiview", self.phase,
                          "image_2")
        return {
            "tgt": os.path.join(mv, f"{i6}_10.png"),
            "refs": [os.path.join(mv, f"{i6}_{str(k).zfill(2)}.png")
                     for k in self.seq_ids],
            "flow": os.path.join(self.root, "data_scene_flow", self.phase,
                                 self.occ if hasattr(self, "occ")
                                 else "flow_occ", f"{i6}_10.png"),
            "calib": os.path.join(self.root, "data_scene_flow_calib",
                                  self.phase, "calib_cam_to_cam", f"{i6}.txt"),
            "obj": os.path.join(self.root, "data_scene_flow", self.phase,
                                "obj_map", f"{i6}_10.png"),
            "semantic": os.path.join(self.root, "semantic_labels", self.phase,
                                     "semantic", f"{i6}_10.png"),
        }

    def _load_common(self, paths):
        tgt = load_image(paths["tgt"])
        refs = [load_image(p) for p in paths["refs"]]
        intrinsics = get_intrinsics(paths["calib"]).astype(np.float32)
        if self.transform is not None:
            imgs, intrinsics = self.transform([tgt] + refs,
                                              np.copy(intrinsics))
            tgt, refs = imgs[0], imgs[1:]
        return tgt, refs, intrinsics

    def __len__(self):
        return self.N


class ValidationFlow(_Kitti2015Base):
    """KITTI2015 training multiview 5-frame snippets + GT flow + obj map
    (validation_flow.py:95-140)."""

    def __init__(self, root, sequence_length=5, transform=None, N=200,
                 phase="training", occ="flow_occ"):
        super().__init__(root, sequence_length, transform, N, phase)
        self.occ = occ

    def __getitem__(self, index):
        paths = self._paths(index)
        tgt, refs, intrinsics = self._load_common(paths)
        u, v, valid = flow_read_png(paths["flow"])
        gt_flow = np.dstack((u, v, valid)).astype(np.float32)
        if os.path.isfile(paths["obj"]):
            obj_map = load_image(paths["obj"])[..., 0]
        else:
            obj_map = np.ones(gt_flow.shape[:2], np.float32)
        return {
            "tgt": np.asarray(tgt, np.float32),
            "refs": np.stack(refs).astype(np.float32),
            "intrinsics": intrinsics,
            "intrinsics_inv": np.linalg.inv(intrinsics).astype(np.float32),
            "flow_gt": gt_flow,           # [H, W, 3] (u, v, valid)
            "obj_map": obj_map.astype(np.float32),
        }


class ValidationMask(_Kitti2015Base):
    """ValidationFlow + semantic labels for moving-car IoU eval
    (validation_flow.py:142-185)."""

    def __getitem__(self, index):
        import cv2
        paths = self._paths(index)
        tgt, refs, intrinsics = self._load_common(paths)
        u, v, valid = flow_read_png(paths["flow"])
        gt_flow = np.dstack((u, v, valid)).astype(np.float32)
        obj_map = cv2.imread(paths["obj"], cv2.IMREAD_UNCHANGED)
        semantic = cv2.imread(paths["semantic"], cv2.IMREAD_UNCHANGED)
        if semantic is not None and semantic.ndim == 3:
            semantic = semantic[..., 0]
        return {
            "tgt": np.asarray(tgt, np.float32),
            "refs": np.stack(refs).astype(np.float32),
            "intrinsics": intrinsics,
            "intrinsics_inv": np.linalg.inv(intrinsics).astype(np.float32),
            "flow_gt": gt_flow,
            "obj_map": np.asarray(obj_map, np.int64),
            "semantic_map": np.asarray(semantic, np.int64),
        }


class KITTI2015Test(_Kitti2015Base):
    """Benchmark-submission split: keeps the original-res target
    (validation_flow.py:57-93)."""

    def __init__(self, root, sequence_length=5, transform=None, N=200,
                 phase="testing"):
        super().__init__(root, sequence_length, transform, N, phase)

    def __getitem__(self, index):
        paths = self._paths(index)
        tgt_original = load_image(paths["tgt"])
        tgt, refs, intrinsics = self._load_common(paths)
        return {
            "tgt": np.asarray(tgt, np.float32),
            "refs": np.stack(refs).astype(np.float32),
            "intrinsics": intrinsics,
            "intrinsics_inv": np.linalg.inv(intrinsics).astype(np.float32),
            "tgt_original": tgt_original,
        }


class ValidationFlowKitti2012:
    """2-frame KITTI2012 with identity intrinsics
    (validation_flow.py:187-225)."""

    def __init__(self, root, sequence_length=5, transform=None, N=194,
                 phase="training"):
        self.root = root
        self.N = N
        self.transform = transform
        self.phase = phase

    def __getitem__(self, index):
        i6 = str(index).zfill(6)
        base = os.path.join(self.root, "data_stereo_flow", self.phase)
        tgt = load_image(os.path.join(base, "colored_0", f"{i6}_10.png"))
        ref = load_image(os.path.join(base, "colored_0", f"{i6}_11.png"))
        u, v, valid = flow_read_png(
            os.path.join(base, "flow_occ", f"{i6}_10.png"))
        gt_flow = np.dstack((u, v, valid)).astype(np.float32)
        intrinsics = np.eye(3, dtype=np.float32)
        if self.transform is not None:
            imgs, intrinsics = self.transform([tgt, ref], np.copy(intrinsics))
            tgt, ref = imgs
        return {
            "tgt": np.asarray(tgt, np.float32),
            "ref": np.asarray(ref, np.float32),
            "intrinsics": intrinsics,
            "intrinsics_inv": np.linalg.inv(intrinsics).astype(np.float32),
            "flow_gt": gt_flow,
        }

    def __len__(self):
        return self.N
