"""Folder -> disparity/depth images on one CUDA GPU: the counterpart of
cc_tpu/cli/run_inference.py, with the same flags and files (parity: the
reference's run_inference.py).

python -m cc_tpu_torch.cli.run_inference --pretrained D.pth.tar \\
    --dataset-dir IMAGES --output-dir OUT --output-disp --output-depth

Kept quirk: normalization is (x/255 - 0.5)/0.2, unlike training's /0.5
(run_inference.py:62 — documented deviation in the reference itself).
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
    description="DispNet inference on a folder of images",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--output-disp", action="store_true")
parser.add_argument("--output-depth", action="store_true")
parser.add_argument("--pretrained", required=True)
parser.add_argument("--dispnet", default="DispNetS")
parser.add_argument("--img-height", default=128, type=int)
parser.add_argument("--img-width", default=416, type=int)
parser.add_argument("--no-resize", action="store_true")
parser.add_argument("--dataset-list", default=None)
parser.add_argument("--dataset-dir", default=".")
parser.add_argument("--output-dir", default="output")
parser.add_argument("--img-exts", default=["png", "jpg", "bmp"], nargs="*")
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


def main(argv=None):
    args = parser.parse_args(argv)
    if not (args.output_disp or args.output_depth):
        print("You must at least output one value !")
        return
    device = eval_device(args.device)

    import cv2
    from cc_tpu_torch.utils.viz import scalar_to_rgb

    disp_net = load_net_params(args.pretrained, args.dispnet, device)
    os.makedirs(args.output_dir, exist_ok=True)

    if args.dataset_list:
        with open(args.dataset_list) as f:
            test_files = [os.path.join(args.dataset_dir, p)
                          for p in f.read().splitlines()]
    else:
        test_files = sum(
            (sorted(glob.glob(os.path.join(args.dataset_dir, f"*.{e}")))
             for e in args.img_exts), [])
    print(f"{len(test_files)} files to test")

    for path in test_files:
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        if not args.no_resize and img.shape[:2] != (args.img_height,
                                                    args.img_width):
            img = cv2.resize(img, (args.img_width, args.img_height))
        x = ((img.astype(np.float32) / 255 - 0.5) / 0.2)[None]
        with torch.inference_mode():
            disp = disp_net(to_device(x, device))[0, 0].cpu().numpy()

        base = os.path.splitext(os.path.basename(path))
        if args.output_disp:
            viz = (255 * scalar_to_rgb(disp, colormap="bone")).astype(np.uint8)
            cv2.imwrite(os.path.join(
                args.output_dir, f"{base[0]}_disp{base[1]}"),
                cv2.cvtColor(viz, cv2.COLOR_RGB2BGR))
        if args.output_depth:
            depth = 1.0 / disp
            viz = (255 * scalar_to_rgb(depth, max_value=10,
                                       colormap="rainbow")).astype(np.uint8)
            cv2.imwrite(os.path.join(
                args.output_dir, f"{base[0]}_depth{base[1]}"),
                cv2.cvtColor(viz, cv2.COLOR_RGB2BGR))


if __name__ == "__main__":
    main()
