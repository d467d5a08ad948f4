"""KITTI Eigen-split depth evaluation framework.

Parity: kitti_eval/depth_evaluation_utils.py — velodyne->image depth
projection (min-depth on duplicates, the KITTI-matlab -1 rounding), oxts
speed*dt displacements for PoseNet scaling, Garg crop mask, width->focal
table.

A copy of cc_tpu/eval/kitti_depth.py (numpy and cv2; the port imports
nothing of cc_tpu); tests/test_torch_eval_depth.py holds the two to equal
bits.
"""
from __future__ import annotations

import datetime
import os
from collections import Counter

import numpy as np

width_to_focal = {
    1242: 721.5377, 1241: 718.856, 1224: 707.0493, 1238: 718.3351,
}


def read_calib_file(path: str) -> dict:
    float_chars = set("0123456789.e+- ")
    data = {}
    with open(path) as f:
        for line in f.readlines():
            key, value = line.split(":", 1)
            value = value.strip()
            data[key] = value
            if float_chars.issuperset(value):
                try:
                    data[key] = np.array(list(map(float, value.split(" "))))
                except ValueError:
                    pass
    return data


def load_velodyne_points(file_name: str) -> np.ndarray:
    points = np.fromfile(file_name, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1
    return points


def velo2im_matrix(calib_dir: str, p_rect: np.ndarray) -> np.ndarray:
    """velodyne -> image-plane projection matrix for a given P_rect."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_f = read_calib_file(
        os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    velo2cam = np.hstack((velo2cam_f["R"].reshape(3, 3),
                          velo2cam_f["T"][..., None]))
    velo2cam = np.vstack((velo2cam, np.array([0, 0, 0, 1.0])))
    r_rect = np.eye(4)
    r_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    return p_rect @ r_rect @ velo2cam


def project_velodyne(p_velo2im: np.ndarray, velo_file: str,
                     im_shape) -> np.ndarray:
    """Sparse depth image from velodyne points (parity:
    depth_evaluation_utils.py:161-191: the KITTI-matlab -1 rounding,
    min-depth on duplicates)."""
    velo = load_velodyne_points(velo_file)
    velo = velo[velo[:, 0] >= 0, :]

    pts = (p_velo2im @ velo.T).T
    pts[:, :2] = pts[:, :2] / pts[:, -1:]
    # -1 matches the KITTI matlab code exactly
    pts[:, 0] = np.round(pts[:, 0]) - 1
    pts[:, 1] = np.round(pts[:, 1]) - 1
    valid = ((pts[:, 0] >= 0) & (pts[:, 1] >= 0)
             & (pts[:, 0] < im_shape[1]) & (pts[:, 1] < im_shape[0]))
    pts = pts[valid]

    depth = np.zeros(im_shape)
    depth[pts[:, 1].astype(int), pts[:, 0].astype(int)] = pts[:, 2]

    # duplicates -> closest depth
    h, w = depth.shape
    inds = pts[:, 1] * (w - 1) + pts[:, 0] - 1
    for dd, count in Counter(inds).items():
        if count > 1:
            where = np.where(inds == dd)[0]
            x, y = int(pts[where[0], 0]), int(pts[where[0], 1])
            depth[y, x] = pts[where, 2].min()
    depth[depth < 0] = 0
    return depth


def generate_depth_map(calib_dir: str, velo_file: str, im_shape,
                       cam: int = 2) -> np.ndarray:
    """Project velodyne points to a sparse depth image (parity:
    depth_evaluation_utils.py:148-191)."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    p_rect = cam2cam["P_rect_0" + str(cam)].reshape(3, 4)
    return project_velodyne(velo2im_matrix(calib_dir, p_rect), velo_file,
                            im_shape)


def generate_mask(gt_depth: np.ndarray, min_depth: float,
                  max_depth: float) -> np.ndarray:
    """Validity AND Garg crop (depth_evaluation_utils.py:194-206)."""
    mask = np.logical_and(gt_depth > min_depth, gt_depth < max_depth)
    h, w = gt_depth.shape
    crop = np.array([0.40810811 * h, 0.99189189 * h,
                     0.03594771 * w, 0.96405229 * w]).astype(np.int32)
    crop_mask = np.zeros_like(mask)
    crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
    return np.logical_and(mask, crop_mask)


def get_displacements(oxts_root: str, index: int, shifts) -> list:
    """speed * |dt| per ref shift (depth_evaluation_utils.py:50-56)."""
    with open(os.path.join(oxts_root, "timestamps.txt")) as f:
        timestamps = [
            datetime.datetime.strptime(ts[:-3], "%Y-%m-%d %H:%M:%S.%f"
                                       ).timestamp()
            for ts in f.read().splitlines()]
    oxts_data = np.genfromtxt(
        os.path.join(oxts_root, "data", f"{index:010d}.txt"))
    speed = np.linalg.norm(oxts_data[8:11])
    return [speed * abs(timestamps[index] - timestamps[index + s])
            for s in shifts]


class KittiEigenFramework:
    """Iterates Eigen test samples: image(s) + on-the-fly velodyne GT depth
    (depth_evaluation_utils.py:18-94)."""

    def __init__(self, root, test_files, seq_length=3, min_depth=1e-3,
                 max_depth=100, step=1):
        self.root = root
        self.min_depth, self.max_depth = min_depth, max_depth
        demi = (seq_length - 1) // 2
        shift_range = [step * i for i in
                       list(range(-demi, 0)) + list(range(1, demi + 1))]
        self.samples = []
        for sample in test_files:
            tgt_path = os.path.join(root, sample)
            if not os.path.isfile(tgt_path):
                print(f"{tgt_path} missing")
                continue
            date, scene, cam_id, _, index = sample[:-4].split("/")
            ref_paths, capped = [], []
            for shift in shift_range:
                p = os.path.join(os.path.dirname(tgt_path),
                                 f"{int(index) + shift:010d}.png")
                if os.path.isfile(p):
                    ref_paths.append(p)
                    capped.append(shift)
                else:
                    ref_paths.append(tgt_path)
                    capped.append(0)
            self.samples.append({
                "tgt_path": tgt_path, "ref_paths": ref_paths,
                "calib_dir": os.path.join(root, date),
                "velo": os.path.join(root, date, scene, "velodyne_points",
                                     "data", f"{index[:10]}.bin"),
                "cam": int(cam_id[-2:]),
                "oxts": os.path.join(root, date, scene, "oxts"),
                "index": int(index), "shifts": capped,
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from cc_tpu_torch.data.sequence_folders import load_image
        s = self.samples[i]
        tgt = load_image(s["tgt_path"])
        depth = generate_depth_map(s["calib_dir"], s["velo"], tgt.shape[:2],
                                   s["cam"])
        return {
            "tgt": tgt,
            "ref": [load_image(p) for p in s["ref_paths"]],
            "path": s["tgt_path"],
            "gt_depth": depth,
            "displacements": np.array(
                get_displacements(s["oxts"], s["index"], s["shifts"])),
            "mask": generate_mask(depth, self.min_depth, self.max_depth),
        }
