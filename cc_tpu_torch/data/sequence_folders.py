"""SequenceFolder dataset — scene folders of jpgs + cam.txt intrinsics.

Format parity with datasets/sequence_folders.py:30-64 (the output of the
prepare_train_data ETL): root/train.txt, root/val.txt list scene dirs, each
scene dir holds NNNNNNN.jpg frames + cam.txt (3x3, comma-separated).
Samples are center target + demi_length refs each side.

A copy of cc_tpu/data/sequence_folders.py (the port imports nothing of cc_tpu);
tests/test_torch_data.py holds the two to equal bits.
"""
from __future__ import annotations

import os
import glob
import random

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Decode an image to HWC float32 (0..255 range, like imread)."""
    import cv2
    im = cv2.imread(path, cv2.IMREAD_COLOR)
    if im is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(im, cv2.COLOR_BGR2RGB).astype(np.float32)


def crawl_folders(folders, sequence_length, shuffle_seed=None):
    sequence_set = []
    demi = (sequence_length - 1) // 2
    for folder in folders:
        intrinsics = np.genfromtxt(
            os.path.join(folder, "cam.txt"), delimiter=",",
        ).astype(np.float32).reshape(3, 3)
        imgs = sorted(glob.glob(os.path.join(folder, "*.jpg")))
        if len(imgs) < sequence_length:
            continue
        for i in range(demi, len(imgs) - demi):
            refs = [imgs[i + j] for j in range(-demi, demi + 1) if j != 0]
            sequence_set.append(
                {"intrinsics": intrinsics, "tgt": imgs[i], "ref_imgs": refs})
    rng = random.Random(shuffle_seed)
    rng.shuffle(sequence_set)
    return sequence_set


class SequenceFolder:
    """Yields dict samples {'tgt': [H,W,3], 'refs': [nref,H,W,3],
    'intrinsics': [3,3], 'intrinsics_inv': [3,3]} (NHWC float32)."""

    def __init__(self, root: str, seed=None, train: bool = True,
                 sequence_length: int = 3, transform=None):
        self.root = root
        list_file = os.path.join(root, "train.txt" if train else "val.txt")
        with open(list_file) as f:
            self.scenes = [os.path.join(root, line.strip())
                           for line in f if line.strip()]
        self.samples = crawl_folders(self.scenes, sequence_length,
                                     shuffle_seed=seed)
        self.transform = transform
        self.seed = seed
        self._epoch = 0
        self._dim_cache: dict = {}

    def set_epoch(self, epoch: int):
        """Vary per-sample augmentation across epochs (the reference's
        torch RNG draws fresh randomness each epoch) while staying
        deterministic per (seed, epoch, index)."""
        self._epoch = epoch

    def _rng(self, index):
        return np.random.default_rng(
            None if self.seed is None else [self.seed, self._epoch, index])

    def _dims(self, path: str):
        """Per-scene image dims (the ETL dumps uniform sizes per scene)."""
        key = os.path.dirname(path)
        if key not in self._dim_cache:
            self._dim_cache[key] = load_image(path).shape[:2]
        return self._dim_cache[key]

    def __getitem__(self, index):
        sample = self.samples[index]
        # native (C++) data plane: Python draws the aug parameters from the
        # same rng sequence, C++ does decode+augment (GIL-free); the
        # pipeline object owns the dispatch (and caches the lib handle)
        native_process = getattr(self.transform, "process", None)
        transform = self.transform
        if native_process is not None:
            in_h, in_w = self._dims(sample["tgt"])
            result = native_process(
                [sample["tgt"]] + list(sample["ref_imgs"]),
                self._rng(index), in_h, in_w, np.copy(sample["intrinsics"]))
            if result is not None:
                imgs, k = result
                return {
                    "tgt": imgs[0],
                    "refs": imgs[1:].copy(),
                    "intrinsics": k,
                    "intrinsics_inv": np.linalg.inv(k).astype(np.float32),
                }
            transform = self.transform.fallback

        tgt = load_image(sample["tgt"])
        refs = [load_image(p) for p in sample["ref_imgs"]]
        intrinsics = np.copy(sample["intrinsics"])
        if transform is not None:
            imgs, intrinsics = transform([tgt] + refs, intrinsics,
                                         self._rng(index))
            tgt, refs = imgs[0], imgs[1:]
        tgt = np.asarray(tgt)
        refs = np.stack(refs)
        if tgt.dtype != np.uint8:  # compact-H2D mode ships uint8 as-is
            tgt = tgt.astype(np.float32)
            refs = refs.astype(np.float32)
        return {
            "tgt": tgt,
            "refs": refs,
            "intrinsics": intrinsics.astype(np.float32),
            "intrinsics_inv": np.linalg.inv(intrinsics).astype(np.float32),
        }

    def __len__(self):
        return len(self.samples)
