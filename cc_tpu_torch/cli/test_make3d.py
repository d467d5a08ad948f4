"""Make3D cross-dataset depth generalization on one CUDA GPU: the
counterpart of cc_tpu/cli/test_make3d.py, with the same flags and printed
results (parity: the reference's test_make3d.py; note its log_rms uses
log10).

python -m cc_tpu_torch.cli.test_make3d --pretrained-dispnet D.pth.tar \\
    --dataset-dir MAKE3D

It runs on the GPU; --device cpu runs it on the CPU.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from cc_tpu_torch.cli.test_disp import (
    DEVICE_HELP, eval_device, load_net_params, to_device,
)

parser = argparse.ArgumentParser(
    description="DispNet cross-dataset eval on Make3D",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--dispnet", default="DispResNet6")
parser.add_argument("--pretrained-dispnet", required=True)
parser.add_argument("--img-height", default=256, type=int)
parser.add_argument("--img-width", default=832, type=int)
parser.add_argument("--no-resize", action="store_true")
parser.add_argument("--min-depth", default=1e-3, type=float)
parser.add_argument("--max-depth", default=70, type=float)
parser.add_argument("--dataset-dir", default=".")
parser.add_argument("--output-dir", default=None)
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


class Make3DFramework:
    """Test134 jpgs + Gridlaserdata .mat GT, center crops
    (test_make3d.py:37-74; sample 61 is corrupted upstream and skipped)."""

    def __init__(self, root, min_depth=1e-3, max_depth=70):
        self.min_depth, self.max_depth = min_depth, max_depth
        self.img_files = sorted(glob.glob(os.path.join(root, "Test134",
                                                       "*.jpg")))
        self.depth_files = sorted(glob.glob(os.path.join(
            root, "Gridlaserdata", "*.mat")))
        self.img_files.pop(61)
        self.depth_files.pop(61)
        self.color_new_height = 1704 // 2

    def __len__(self):
        return len(self.img_files)

    def __getitem__(self, i):
        from scipy import io
        from cc_tpu_torch.data.sequence_folders import load_image
        tgt = load_image(self.img_files[i])
        tgt = tgt[(2272 - self.color_new_height) // 2:
                  (2272 + self.color_new_height) // 2]
        depth_gt = io.loadmat(self.depth_files[i])["Position3DGrid"][:, :, 3]
        depth_gt = depth_gt[(55 - 21) // 2:(55 + 21) // 2]
        mask = np.logical_and(depth_gt > self.min_depth,
                              depth_gt < self.max_depth)
        return {"tgt": tgt, "gt_depth": depth_gt, "mask": mask}


def compute_errors_make3d(gt, pred):
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log10(gt) - np.log10(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean((gt - pred) ** 2 / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def main(argv=None):
    args = parser.parse_args(argv)
    device = eval_device(args.device)
    import cv2

    disp_net = load_net_params(args.pretrained_dispnet, args.dispnet, device)
    framework = Make3DFramework(args.dataset_dir, args.min_depth,
                                args.max_depth)

    errors = np.zeros((7, len(framework)), np.float32)
    for j in range(len(framework)):
        s = framework[j]
        img = s["tgt"]
        if not args.no_resize:
            img = cv2.resize(img, (args.img_width, args.img_height))
        x = ((img / 255.0 - 0.5) / 0.5).astype(np.float32)[None]
        with torch.inference_mode():
            pred_disp = disp_net(to_device(x, device))[0, 0].cpu().numpy()
        pred_depth = 1.0 / pred_disp
        gt = s["gt_depth"]
        zoomed = cv2.resize(pred_depth, (gt.shape[1], gt.shape[0]))
        zoomed = np.clip(zoomed, args.min_depth, args.max_depth)
        zoomed = zoomed[s["mask"]]
        gt_m = gt[s["mask"]]
        scale = np.median(gt_m) / np.median(zoomed)
        zoomed = np.minimum(zoomed * scale, args.max_depth)
        errors[:, j] = compute_errors_make3d(gt_m, zoomed)

    names = ["abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2", "a3"]
    print("Results with scale factor determined by GT/prediction ratio "
          "(like the original paper):")
    print(", ".join(f"{n:>10}" for n in names))
    print(", ".join(f"{v:10.4f}" for v in errors.mean(1)))
    return errors.mean(1)


if __name__ == "__main__":
    main()
