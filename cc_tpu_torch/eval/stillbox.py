"""Stillbox synthetic-dataset depth-eval framework.

Parity: stillbox_eval/depth_evaluation_utils.py — metadata.json scenes,
speed*time_step displacements, 5%-border crop mask. (The reference's
general_sequence_folders.py loader for this format is dead code — its
__getitem__ reads a key that is never stored; this framework covers the
working stillbox path, test_disp --gt-type stillbox.)

A copy of cc_tpu/eval/stillbox.py (the port imports nothing of cc_tpu);
tests/test_torch_eval_depth.py holds the two to equal bits.
"""
from __future__ import annotations

import json
import os

import numpy as np


def generate_mask(gt_depth, min_depth, max_depth):
    mask = np.logical_and(gt_depth > min_depth, gt_depth < max_depth)
    h, w = gt_depth.shape
    crop = np.array([0.05 * h, 0.95 * h, 0.05 * w, 0.95 * w]
                    ).astype(np.int32)
    crop_mask = np.zeros_like(mask)
    crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
    return np.logical_and(mask, crop_mask)


class StillboxFramework:
    def __init__(self, root, test_files, seq_length=3, min_depth=1e-3,
                 max_depth=80, step=1):
        self.root = root
        self.min_depth, self.max_depth = min_depth, max_depth
        metadata = {}
        for folder in sorted(os.listdir(root)):
            meta = os.path.join(root, folder, "metadata.json")
            if os.path.isfile(meta):
                with open(meta) as f:
                    metadata[folder] = json.load(f)

        demi = (seq_length - 1) // 2
        shift_range = [step * i for i in
                       list(range(-demi, 0)) + list(range(1, demi + 1))]
        self.samples = []
        for sample in test_files:
            folder, fname = sample.split("/")
            _, scene_index, index = fname[:-4].split("_")
            index = int(index)
            scene = metadata[folder]["scenes"][int(scene_index)]
            tgt = os.path.join(root, sample)
            if not os.path.isfile(tgt):
                print(f"{tgt} missing")
                continue
            capped = [min(max(0, index + s), scene["length"] - 1)
                      for s in shift_range]
            speed = np.around(np.linalg.norm(scene["speed"]), decimals=3)
            self.samples.append({
                "tgt": tgt,
                "refs": [os.path.join(root, folder, scene["imgs"][r])
                         for r in capped],
                "gt": os.path.join(root, folder, scene["depth"][index]),
                "displacements": [speed * scene["time_step"]
                                  * abs(index - i) for i in capped],
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from cc_tpu_torch.data.sequence_folders import load_image
        s = self.samples[i]
        depth = np.load(s["gt"])
        return {
            "tgt": load_image(s["tgt"]),
            "ref": [load_image(p) for p in s["refs"]],
            "path": s["tgt"],
            "gt_depth": depth,
            "displacements": np.array(s["displacements"]),
            "mask": generate_mask(depth, self.min_depth, self.max_depth),
        }
