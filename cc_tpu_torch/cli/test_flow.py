"""Composite flow evaluation on KITTI2015 on one CUDA GPU: the counterpart
of cc_tpu/cli/test_flow.py, with the same flags and printed results
(parity: the reference's test_flow.py).

python -m cc_tpu_torch.cli.test_flow --pretrained-disp D.pth.tar \\
    --pretrained-pose P.pth.tar --pretrained-mask M.pth.tar \\
    --pretrained-flow F.pth.tar --kitti-dir KITTI2015

It runs on the GPU, where F's correlation is the CUDA kernel (10 launches
an item for Back2Future, 1 for FlowNetC6); --device cpu runs it on the CPU
with the correlation's plain version. The EPEs run on the host.

test_mask and submit_flow load and run the four nets as this CLI does
(load_four_nets, four_net_forward).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cc_tpu_torch.cli.test_back2future import flow_forward
from cc_tpu_torch.cli.test_disp import (
    DEVICE_HELP, eval_device, load_net_params, pose_forward, to_device,
)

parser = argparse.ArgumentParser(
    description="Composite rigid+non-rigid flow eval on KITTI2015",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--kitti-dir", required=True)
parser.add_argument("--dispnet", default="DispResNet6")
parser.add_argument("--posenet", default="PoseNetB6")
parser.add_argument("--masknet", default="MaskNet6")
parser.add_argument("--flownet", default="Back2Future")
parser.add_argument("--THRESH", type=float, default=0.01)
parser.add_argument("--pretrained-disp", required=True)
parser.add_argument("--pretrained-pose", required=True)
parser.add_argument("--pretrained-mask", required=True)
parser.add_argument("--pretrained-flow", required=True)
parser.add_argument("--nlevels", type=int, default=6)
parser.add_argument("--dataset", default="kitti2015")
parser.add_argument("--output-dir", default=None)
# extensions over the reference (which hardcodes 256x832 / N=200 at
# test_flow.py:77,80): defaults preserve reference behavior
parser.add_argument("--img-height", type=int, default=256)
parser.add_argument("--img-width", type=int, default=832)
parser.add_argument("-N", "--n-samples", type=int, default=200,
                    dest="n_samples")
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


def load_four_nets(args, device, paths: dict) -> dict:
    """D, C, M and F from the reference checkpoints `paths` ({disp, pose,
    mask, flow}), as the flags name them: C and M with 4 references."""
    return {
        "disp": load_net_params(paths["disp"], args.dispnet, device),
        "pose": load_net_params(paths["pose"], args.posenet, device,
                                nb_ref_imgs=4),
        "mask": load_net_params(paths["mask"], args.masknet, device,
                                nb_ref_imgs=4),
        "flow": load_net_params(paths["flow"], args.flownet, device,
                                nlevels=args.nlevels)}


def four_net_forward(nets: dict, sample: dict, device) -> dict:
    """The four nets on one item of a KITTI 2015 set (5 frames, the
    target in the middle), under inference mode: D's disparity, C's poses,
    M's masks and F's forward flow, NHWC, and the rigid flow of D and C's
    pose to the next frame (pose2flow)."""
    from cc_tpu_torch.geometry.warp import pose2flow
    with torch.inference_mode():
        tgt = to_device(sample["tgt"][None], device)
        refs = to_device(sample["refs"][None], device)
        refs_l = [refs[:, i] for i in range(refs.shape[1])]
        k = torch.from_numpy(sample["intrinsics"][None]).to(device)
        k_inv = torch.from_numpy(sample["intrinsics_inv"][None]).to(device)
        disp = nets["disp"](tgt).permute(0, 2, 3, 1)
        pose = pose_forward(nets["pose"], tgt, refs)
        exp_mask = nets["mask"](tgt, refs_l).permute(0, 2, 3, 1)
        flow_fwd = flow_forward(nets["flow"], tgt, refs_l[1:3])
        flow_cam = pose2flow(1.0 / disp[..., 0], pose[:, 2], k, k_inv)
    return {"disp": disp, "pose": pose, "exp_mask": exp_mask,
            "flow_fwd": flow_fwd, "flow_cam": flow_cam}


def main(argv=None):
    args = parser.parse_args(argv)
    device = eval_device(args.device)
    from cc_tpu_torch.data import transforms
    from cc_tpu_torch.data.validation import ValidationFlow
    from cc_tpu_torch.eval.composite import composite_flow
    from cc_tpu_torch.losses.metrics import compute_all_epes
    from cc_tpu_torch.utils.logging import AverageMeter

    nets = load_four_nets(args, device, {
        "disp": args.pretrained_disp, "pose": args.pretrained_pose,
        "mask": args.pretrained_mask, "flow": args.pretrained_flow})

    tf = transforms.valid_flow_transform(args.img_height, args.img_width)
    val_set = ValidationFlow(root=args.kitti_dir, sequence_length=5,
                             transform=tf, N=args.n_samples)

    names = ["epe_total", "epe_sp", "epe_mv", "Fl", "epe_total_gt_mask",
             "epe_sp_gt_mask", "epe_mv_gt_mask", "Fl_gt_mask"]
    errors = AverageMeter(i=len(names))
    for i in range(len(val_set)):
        s = val_set[i]
        out = four_net_forward(nets, s, device)
        flow_cam, flow_fwd = out["flow_cam"], out["flow_fwd"]
        with torch.inference_mode():
            _, combined = composite_flow(flow_cam, flow_fwd, out["exp_mask"],
                                         args.THRESH)
        flow_gt = s["flow_gt"][None]
        obj_map = s["obj_map"][None][..., None]
        # partition threshold stays at compute_all_epes' default 0.5
        # (test_flow.py:145); args.THRESH feeds only the census mask.
        e = compute_all_epes(flow_gt, flow_cam, flow_fwd, combined)
        e += compute_all_epes(flow_gt, flow_cam, flow_fwd, 1.0 - obj_map)
        errors.update(e)

        if args.output_dir is not None:
            for sub in ("images", "gt", "mask"):
                os.makedirs(os.path.join(args.output_dir, sub),
                            exist_ok=True)
            i3 = str(i).zfill(3)
            np.save(os.path.join(args.output_dir, "images", i3),
                    np.asarray(s["tgt"]))
            np.save(os.path.join(args.output_dir, "gt", i3),
                    np.asarray(s["obj_map"]))
            np.save(os.path.join(args.output_dir, "mask", i3),
                    combined[0, ..., 0].cpu().numpy())

    print("Results")
    print("\t" + ", ".join(f"{n:>10}" for n in names))
    print("Errors\t" + ", ".join(f"{v:10.4f}" for v in errors.avg))
    return errors.avg, names


if __name__ == "__main__":
    main()
