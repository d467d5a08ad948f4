"""Pure-numpy EPE/Fl between dumped KITTI flow png dirs: the counterpart of
cc_tpu/cli/evaluate_flow.py, with the same flags and printed results
(parity: the reference's evaluate_flow.py).

python -m cc_tpu_torch.cli.evaluate_flow --output-dir PRED --gt-dir GT -N 200

Host only: it runs no net and has no --device.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

EPSILON = 1e-8

parser = argparse.ArgumentParser(
    description="Benchmark optical flow predictions",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--output-dir", required=True)
parser.add_argument("--gt-dir", required=True)
parser.add_argument("-N", type=int, default=200)


def compute_err(u_gt, v_gt, valid_gt, u_pred, v_pred, tau=(3, 0.05)):
    epe = np.sqrt((u_gt - u_pred) ** 2 + (v_gt - v_pred) ** 2) * valid_gt
    aepe = epe.sum() / valid_gt.sum()
    f_mag = np.sqrt(u_gt ** 2 + v_gt ** 2)
    n_err = (epe > tau[0]) * ((epe / (f_mag + EPSILON)) > tau[1]) * valid_gt
    return [aepe, n_err.sum() / valid_gt.sum()]


def main(argv=None):
    args = parser.parse_args(argv)
    from cc_tpu_torch.utils.flow_io import flow_read_png
    from cc_tpu_torch.utils.logging import AverageMeter

    errors = AverageMeter(i=2)
    for i in range(args.N):
        name = str(i).zfill(6) + "_10.png"
        u_gt, v_gt, valid_gt = flow_read_png(os.path.join(args.gt_dir, name))
        u_pred, v_pred, _ = flow_read_png(os.path.join(args.output_dir, name))
        errors.update(compute_err(u_gt, v_gt, valid_gt, u_pred, v_pred))

    print("Results")
    print("\t {:>10}, {:>10}".format("epe_total", "outliers"))
    print("Errors \t {:10.4f}, {:10.4f}".format(*errors.avg))
    return errors.avg


if __name__ == "__main__":
    main()
