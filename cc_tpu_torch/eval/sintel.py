"""MPI-Sintel I/O + pose-eval framework.

Parity: sintel_eval/sintel_io.py (cam/.flo/depth readers, TAG_FLOAT
202021.25) and sintel_eval/pose_evaluation_utils.py (5-frame snippets from
clean/ + camdata_left/*.cam).

A copy of cc_tpu/eval/sintel.py (the port imports nothing of cc_tpu);
tests/test_torch_eval_pose.py holds the two to equal bits.
"""
from __future__ import annotations

import glob
import os

import numpy as np

TAG_FLOAT = 202021.25
TAG_CHAR = b"PIEH"


def cam_read(filename: str, pose_only: bool = False):
    """Sintel .cam -> (M intrinsics [3,3], N extrinsics [3,4]) or N only."""
    with open(filename, "rb") as f:
        check = np.frombuffer(f.read(4), np.float32)[0]
        assert abs(check - TAG_FLOAT) < 1e-3, f"bad .cam tag in {filename}"
        m = np.fromfile(f, np.float64, 9).reshape(3, 3)
        n = np.fromfile(f, np.float64, 12).reshape(3, 4)
    if pose_only:
        return n
    return m, n


def depth_read(filename: str) -> np.ndarray:
    """Sintel .dpt -> [H, W] float32."""
    with open(filename, "rb") as f:
        check = np.frombuffer(f.read(4), np.float32)[0]
        assert abs(check - TAG_FLOAT) < 1e-3, f"bad .dpt tag in {filename}"
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.fromfile(f, np.float32, w * h)
    return data.reshape(h, w)


class SintelPoseFramework:
    """5-frame snippets with first-frame-compensated GT extrinsics
    (sintel_eval/pose_evaluation_utils.py:10-61)."""

    def __init__(self, root: str, sequence_set, seq_length: int = 3,
                 step: int = 1):
        demi = (seq_length - 1) // 2
        shift_range = np.array([step * i for i in
                                range(-demi, demi + 1)]).reshape(1, -1)
        self.sequences = []
        seq_dirs = set()
        for seq in sequence_set:
            seq_dirs |= set(glob.glob(os.path.join(root, "clean", seq)))
        for seq_dir in sorted(seq_dirs):
            cams = sorted(glob.glob(os.path.join(
                seq_dir.replace("/clean/", "/camdata_left/"), "*.cam")))
            imgs = sorted(glob.glob(os.path.join(seq_dir, "*.png")))
            tgt = np.arange(demi, len(imgs) - demi).reshape(-1, 1)
            self.sequences.append((imgs, cams, shift_range + tgt))

    def __len__(self):
        # QUIRK KEPT: the reference counts IMAGES, not snippets
        # (sintel_eval/pose_evaluation_utils.py:33-34); test_sintel_pose.py
        # sizes RE with it and means over the zero-padded tail rows — the
        # published RE inherits that (same quirk as the KITTI pose eval,
        # see eval/kitti_pose.py).
        return sum(len(imgs) for imgs, _, _ in self.sequences)

    def __iter__(self):
        from cc_tpu_torch.data.sequence_folders import load_image
        for imgs, cams, indices in self.sequences:
            for snippet in indices:
                frames = [load_image(imgs[i]) for i in snippet]
                poses = np.stack([cam_read(cams[i], pose_only=True)
                                  for i in snippet]).astype(np.float32)
                first = poses[0]
                poses[:, :, -1] -= first[:, -1]
                compensated = np.linalg.inv(first[:, :3]) @ poses
                yield {"imgs": frames, "path": imgs[snippet[0]],
                       "poses": compensated}


def compute_rotation_error(gt, pred):
    """Rotation-only snippet error (test_sintel_pose.py:110-124)."""
    re = 0.0
    for gt_pose, pred_pose in zip(gt, pred):
        r = gt_pose[:, :3] @ np.linalg.inv(pred_pose[:, :3])
        s = np.linalg.norm([r[0, 1] - r[1, 0], r[1, 2] - r[2, 1],
                            r[0, 2] - r[2, 0]])
        c = np.trace(r) - 1
        re += np.arctan2(s, c)
    return re / gt.shape[0]
