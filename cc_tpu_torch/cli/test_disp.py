"""Depth benchmark CLI (Eigen split) on one CUDA GPU: the counterpart of
cc_tpu/cli/test_disp.py, with the same flags and printed results, and
parity with the reference's test_disp.py.

python -m cc_tpu_torch.cli.test_disp --pretrained-dispnet D.pth.tar \\
    [--pretrained-posenet P.pth.tar] --dataset-dir KITTI_raw \\
    --dataset-list eigen

Reads reference torch checkpoints (.pth.tar). It runs on the GPU;
--device cpu runs it on the CPU. The nets run in fp32 with TF32 off; the
metrics run on the host, as cc_tpu's do.

Every eval CLI of the port loads its nets with load_net_params and takes
its device from eval_device.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch
from torch import nn

from cc_tpu_torch import models
from cc_tpu_torch.device import resolve_device
from cc_tpu_torch.weights import (
    load_reference_weights, read_reference_checkpoint,
    without_unused_mask_decoder,
)

LISTS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                     "lists")
# the benchmark protocol lists the reference ships as
# kitti_eval/test_files_eigen.txt and stillbox_eval/test_files_90.txt
PROTOCOL_LISTS = {"eigen": "test_files_eigen.txt",
                  "stillbox": "test_files_90.txt"}
DEVICE_HELP = ("torch device to run on; cuda raises when there is no GPU "
               "(the CPU runs only when asked for)")

parser = argparse.ArgumentParser(
    description="DispNet testing with corresponding ground truth",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--dispnet", default="DispResNet6")
parser.add_argument("--posenet", default="PoseExpNet")
parser.add_argument("--pretrained-dispnet", required=True)
parser.add_argument("--pretrained-posenet", default=None)
parser.add_argument("--img-height", default=256, type=int)
parser.add_argument("--img-width", default=832, type=int)
parser.add_argument("--no-resize", action="store_true")
parser.add_argument("--spatial-normalize", action="store_true")
parser.add_argument("--min-depth", default=1e-3, type=float)
parser.add_argument("--max-depth", default=80, type=float)
parser.add_argument("--dataset-dir", default=".")
parser.add_argument("--dataset-list", default=None)
parser.add_argument("--output-dir", default=None)
parser.add_argument("--gt-type", default="KITTI", choices=["KITTI"])
parser.add_argument("--seq-length", default=3, type=int,
                    help="snippet length when using a posenet")
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


def eval_device(name: str) -> torch.device:
    """The device of an eval CLI, resolved before any file is read (cuda
    raises without a GPU); fp32 with TF32 off for matmuls and cuDNN
    convolutions, as the reference evaluates."""
    device = resolve_device(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def compute_errors_eigen(gt, pred):
    """abs_rel, sq_rel, rms, log_rms, a1, a2, a3 (test_disp.py:171-187)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean((gt - pred) ** 2 / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def load_net_params(path: str, arch: str, device: torch.device,
                    **kw) -> nn.Module:
    """A reference .pth.tar -> the port's `arch` net built with `kw`, on
    `device`, in eval mode; the counterpart of cc_tpu's load_net_params
    (which returns a flax module and its variables). The weights load
    strictly (weights.load_reference_weights), but for a mask decoder that
    PoseExpNet is built without (weights.without_unused_mask_decoder)."""
    net = models.build(arch, **kw)
    sd = without_unused_mask_decoder(net, read_reference_checkpoint(path))
    load_reference_weights(net, sd, f"{arch} {path}")
    return net.to(device).eval()


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """An NHWC (or [B,N,H,W,C]) float array -> an NCHW tensor on device
    (the frames' axis, if any, stays second)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    return t.movedim(-1, -3).contiguous()


def pose_forward(pose_net: nn.Module, tgt: torch.Tensor,
                 refs: torch.Tensor) -> torch.Tensor:
    """C on a target [B,3,H,W] and its references [B,N,3,H,W]: the poses
    [B,N,6]; PoseExpNet's (masks, pose) gives its pose."""
    out = pose_net(tgt, [refs[:, i] for i in range(refs.shape[1])])
    return out[1] if isinstance(out, tuple) else out


def main(argv=None):
    args = parser.parse_args(argv)
    device = eval_device(args.device)
    import cv2
    from cc_tpu_torch.eval.kitti_depth import KittiEigenFramework
    from cc_tpu_torch.losses.charbonnier import spatial_normalize

    disp_net = load_net_params(args.pretrained_dispnet, args.dispnet, device)

    seq_length = 0
    if args.pretrained_posenet:
        seq_length = args.seq_length
        pose_net = load_net_params(
            args.pretrained_posenet, args.posenet, device,
            nb_ref_imgs=seq_length - 1, output_exp=False)

    if args.dataset_list:
        list_path = args.dataset_list
        if list_path in PROTOCOL_LISTS:
            list_path = os.path.join(LISTS, PROTOCOL_LISTS[list_path])
        with open(list_path) as f:
            test_files = f.read().splitlines()
    else:
        test_files = [os.path.relpath(p, args.dataset_dir) for ext in
                      ("png", "jpg", "bmp") for p in
                      glob.glob(os.path.join(args.dataset_dir, f"*.{ext}"))]

    framework = KittiEigenFramework(args.dataset_dir, test_files, seq_length,
                                    args.min_depth, args.max_depth)
    print(f"{len(framework)} files to test")

    def prep(im):
        if not args.no_resize and im.shape[:2] != (args.img_height,
                                                   args.img_width):
            im = cv2.resize(im, (args.img_width, args.img_height))
        return ((im / 255.0 - 0.5) / 0.5).astype(np.float32)[None]

    errors = np.zeros((2, 7, len(framework)), np.float32)
    predictions = None
    for j in range(len(framework)):
        sample = framework[j]
        tgt = prep(sample["tgt"])
        with torch.inference_mode():
            tgt_t = to_device(tgt, device)
            disp = disp_net(tgt_t).permute(0, 2, 3, 1)  # NHWC
            if args.spatial_normalize:
                disp = spatial_normalize(disp)
            # cv2's resize below runs on the host, as in cc_tpu
            pred_disp = disp[0, ..., 0].cpu().numpy()
        gt_depth = sample["gt_depth"]

        pred_depth = 1.0 / pred_disp
        pred_zoomed = cv2.resize(pred_depth,
                                 (gt_depth.shape[1], gt_depth.shape[0]),
                                 interpolation=cv2.INTER_LINEAR)
        pred_zoomed = np.clip(pred_zoomed, args.min_depth, args.max_depth)
        if args.output_dir is not None:
            if predictions is None:
                predictions = np.zeros((len(framework), *pred_disp.shape))
                os.makedirs(args.output_dir, exist_ok=True)
            predictions[j] = 1.0 / pred_disp
        if sample["mask"] is not None:
            pred_masked = pred_zoomed[sample["mask"]]
            gt_masked = gt_depth[sample["mask"]]
        else:
            pred_masked, gt_masked = pred_zoomed, gt_depth

        if seq_length > 0:
            refs = np.stack([prep(r)[0] for r in sample["ref"]])[None]
            with torch.inference_mode():
                poses = pose_forward(pose_net, tgt_t, to_device(refs, device)
                                     ).cpu().numpy()
            displacements = np.linalg.norm(poses[0, :, :3], axis=1)
            scale_factors = [s1 / s2 for s1, s2 in
                             zip(sample["displacements"], displacements)
                             if s1 > 0]
            scale = np.mean(scale_factors) if scale_factors else 0
            errors[0, :, j] = compute_errors_eigen(gt_masked,
                                                   pred_masked * scale)

        scale = np.median(gt_masked) / np.median(pred_masked)
        errors[1, :, j] = compute_errors_eigen(gt_masked,
                                               pred_masked * scale)

    mean_errors = errors.mean(2)
    names = ["abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2", "a3"]
    fmt_h = ", ".join(f"{n:>10}" for n in names)
    if args.pretrained_posenet:
        print("Results with scale factor determined by PoseNet:")
        print(fmt_h)
        print(", ".join(f"{v:10.4f}" for v in mean_errors[0]))
    print("Results with scale factor determined by GT/prediction ratio "
          "(like the original paper):")
    print(fmt_h)
    print(", ".join(f"{v:10.4f}" for v in mean_errors[1]))
    if args.output_dir is not None:
        np.save(os.path.join(args.output_dir, "predictions.npy"),
                predictions)
    return mean_errors


if __name__ == "__main__":
    main()
