"""Stacked-frame dataset format (TF-SfMLearner compatibility).

Parity: datasets/stacked_sequence_folders.py — train.txt lines are
"scene frame" pairs, each frame is a horizontally stacked strip of
sequence_length images with a per-frame NNNNNNN_cam.txt intrinsics file.

A copy of cc_tpu/data/stacked_sequence_folders.py (the port imports nothing of cc_tpu);
tests/test_torch_data.py holds the two to equal bits.
"""
from __future__ import annotations

import os

import numpy as np

from cc_tpu_torch.data.sequence_folders import load_image


def split_stack(stack: np.ndarray, sequence_length: int):
    """Stacked strip -> [target] + refs (center frame is the target)."""
    h, w, _ = stack.shape
    w_img = w // sequence_length
    imgs = [stack[:, i * w_img:(i + 1) * w_img] for i in
            range(sequence_length)]
    tgt = sequence_length // 2
    return [imgs[tgt]] + imgs[:tgt] + imgs[tgt + 1:]


class StackedSequenceFolder:
    def __init__(self, root: str, seed=None, train: bool = True,
                 sequence_length: int = 3, transform=None):
        self.root = root
        self.sequence_length = sequence_length
        self.transform = transform
        self.seed = seed
        list_file = os.path.join(root, "train.txt" if train else "val.txt")
        self.scenes = [d for d in os.listdir(root)
                       if os.path.isdir(os.path.join(root, d))]
        self.samples = []
        with open(list_file) as f:
            for line in f:
                if not line.strip():
                    continue
                a, b = line.strip().split(" ")
                base = os.path.join(root, a, b)
                intrinsics = np.genfromtxt(
                    base + "_cam.txt", delimiter=",",
                ).astype(np.float32).reshape(3, 3)
                self.samples.append({"intrinsics": intrinsics,
                                     "img_stack": base + ".jpg"})

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __getitem__(self, index):
        sample = self.samples[index]
        imgs = split_stack(load_image(sample["img_stack"]),
                           self.sequence_length)
        intrinsics = np.copy(sample["intrinsics"])
        if self.transform is not None:
            rng = np.random.default_rng(
                None if self.seed is None
                else [self.seed, getattr(self, "_epoch", 0), index])
            imgs, intrinsics = self.transform(imgs, intrinsics, rng)
        return {
            "tgt": np.asarray(imgs[0], np.float32),
            "refs": np.stack(imgs[1:]).astype(np.float32),
            "intrinsics": intrinsics.astype(np.float32),
            "intrinsics_inv": np.linalg.inv(intrinsics).astype(np.float32),
        }

    def __len__(self):
        return len(self.samples)
