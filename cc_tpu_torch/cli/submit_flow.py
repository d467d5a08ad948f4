"""KITTI2015 benchmark flow submission on one CUDA GPU: the counterpart of
cc_tpu/cli/submit_flow.py, with the same flags and files (parity: the
reference's submit_flow.py).

python -m cc_tpu_torch.cli.submit_flow PRETRAINED_DIR --kitti-dir KITTI2015

PRETRAINED_DIR holds {dispnet,posenet,masknet,flownet}_model_best.pth.tar.
Writes full-resolution composite flow as 16-bit KITTI pngs + .flo files.
It runs on the GPU (the composite flow and its resize to the original
frame size too); --device cpu runs it on the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cc_tpu_torch.cli.test_disp import DEVICE_HELP, eval_device
from cc_tpu_torch.cli.test_flow import four_net_forward, load_four_nets

parser = argparse.ArgumentParser(
    description="KITTI2015 flow benchmark submission",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("pretrained_path",
                    help="dir with {dispnet,posenet,masknet,flownet}"
                         "_model_best.pth.tar")
parser.add_argument("--kitti-dir", required=True)
parser.add_argument("--dispnet", default="DispResNet6")
parser.add_argument("--posenet", default="PoseNetB6")
parser.add_argument("--masknet", default="MaskNet6")
parser.add_argument("--flownet", default="Back2Future")
parser.add_argument("--THRESH", type=float, default=0.01)
parser.add_argument("--nlevels", type=int, default=6)
parser.add_argument("--output-dir", default="kitti_submission")
parser.add_argument("--DEBUG", action="store_true")
# extensions over the reference (hardcoded 256x832 / N=200)
parser.add_argument("--img-height", type=int, default=256)
parser.add_argument("--img-width", type=int, default=832)
parser.add_argument("-N", "--n-samples", type=int, default=200,
                    dest="n_samples")
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


def main(argv=None):
    args = parser.parse_args(argv)
    device = eval_device(args.device)
    from cc_tpu_torch.data import transforms
    from cc_tpu_torch.data.validation import KITTI2015Test
    from cc_tpu_torch.eval.composite import composite_flow
    from cc_tpu_torch.ops.image import resize_bilinear
    from cc_tpu_torch.utils.flow_io import flow_write_flo, flow_write_png

    def best(net):
        return os.path.join(args.pretrained_path,
                            f"{net}_model_best.pth.tar")

    nets = load_four_nets(args, device, {
        "disp": best("dispnet"), "pose": best("posenet"),
        "mask": best("masknet"), "flow": best("flownet")})

    tf = transforms.valid_flow_transform(args.img_height, args.img_width)
    val_set = KITTI2015Test(root=args.kitti_dir, sequence_length=5,
                            transform=tf, N=args.n_samples,
                            phase="training" if args.DEBUG else "testing")

    testing_dir = os.path.join(args.output_dir, "testing")
    testing_dir_flo = os.path.join(args.output_dir, "testing_flo")
    os.makedirs(testing_dir, exist_ok=True)
    os.makedirs(testing_dir_flo, exist_ok=True)

    for i in range(len(val_set)):
        s = val_set[i]
        out = four_net_forward(nets, s, device)
        h_gt, w_gt = s["tgt_original"].shape[:2]
        with torch.inference_mode():
            total, _ = composite_flow(out["flow_cam"], out["flow_fwd"],
                                      out["exp_mask"], args.THRESH)
            h_pred, w_pred = total.shape[1:3]
            full = resize_bilinear(total.permute(0, 3, 1, 2), (h_gt, w_gt))
            full = np.array(full.permute(0, 2, 3, 1)[0].cpu())
        full[..., 0] *= w_gt / w_pred
        full[..., 1] *= h_gt / h_pred
        name = str(i).zfill(6) + "_10"
        flow_write_png(os.path.join(testing_dir, name + ".png"),
                       u=full[..., 0], v=full[..., 1])
        flow_write_flo(os.path.join(testing_dir_flo, name + ".flo"), full)
    print("Done!")


if __name__ == "__main__":
    main()
