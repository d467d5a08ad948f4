"""Motion-segmentation IoU benchmark on one CUDA GPU: the counterpart of
cc_tpu/cli/test_mask.py, with the same flags and printed results (parity:
the reference's test_mask.py).

python -m cc_tpu_torch.cli.test_mask --pretrained-disp D.pth.tar \\
    --pretrained-pose P.pth.tar --pretrained-mask M.pth.tar \\
    --pretrained-flow F.pth.tar --kitti-dir KITTI2015

Evaluates M's rigidity mask (full model / census-only / bare M) against
KITTI2015 moving-car GT (obj_map AND semantic class 26). THRESH default 0.94
applies to the NORMALIZED census (test_mask.py:38, 130-132). It runs on the
GPU, the masks on the card and the IoU counts on the host; --device cpu
runs it on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from cc_tpu_torch.cli.test_disp import DEVICE_HELP, eval_device
from cc_tpu_torch.cli.test_flow import four_net_forward, load_four_nets

parser = argparse.ArgumentParser(
    description="Motion segmentation IoU on KITTI2015",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--kitti-dir", required=True)
parser.add_argument("--dispnet", default="DispResNet6")
parser.add_argument("--posenet", default="PoseNetB6")
parser.add_argument("--masknet", default="MaskNet6")
parser.add_argument("--flownet", default="Back2Future")
parser.add_argument("--THRESH", type=float, default=0.94)
parser.add_argument("--pretrained-disp", required=True)
parser.add_argument("--pretrained-pose", required=True)
parser.add_argument("--pretrained-mask", required=True)
parser.add_argument("--pretrained-flow", required=True)
parser.add_argument("--nlevels", type=int, default=6)
parser.add_argument("--output-dir", default=None)
# extensions over the reference (hardcoded 256x832 / N=200)
parser.add_argument("--img-height", type=int, default=256)
parser.add_argument("--img-width", type=int, default=832)
parser.add_argument("-N", "--n-samples", type=int, default=200,
                    dest="n_samples")
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


def mask_error(mot_gt, seg_gt, pred):
    """[tp0, fp0, fn0, tp1, fp1, fn1] for bg/fg classes; moving-car GT =
    obj_map AND semantic==26, others ignored (test_mask.py:224-262)."""
    import cv2
    max_label = 2
    tp, fp, fn = np.zeros(max_label), np.zeros(max_label), np.zeros(max_label)

    mot_gt = np.array(mot_gt)
    mot_gt[mot_gt != 0] = 1
    mov_car_gt = mot_gt.copy()
    mov_car_gt[seg_gt != 26] = 255
    mot_gt = mov_car_gt

    pred = cv2.resize(np.asarray(pred, np.float32),
                      (mot_gt.shape[1], mot_gt.shape[0]),
                      interpolation=cv2.INTER_NEAREST)
    if pred.ndim == 2:
        pred = np.stack([pred, 1.0 - pred])
    pred = pred.argmax(axis=0)

    for class_id in range(max_label):
        class_gt = np.equal(mot_gt, class_id)
        class_result = np.equal(pred, class_id)
        class_result[np.equal(mot_gt, 255)] = 0
        tp[class_id] += np.count_nonzero(class_gt & class_result)
        fp[class_id] += np.count_nonzero(class_result & ~class_gt)
        fn[class_id] += np.count_nonzero(~class_result & class_gt)
    return [tp[0], fp[0], fn[0], tp[1], fp[1], fn[1]]


def _iou(sums):
    bg = sums[0] / (sums[0] + sums[1] + sums[2])
    fg = sums[3] / (sums[3] + sums[4] + sums[5])
    return (bg + fg) / 2, bg, fg


def census_masks(flow_cam: torch.Tensor, flow_fwd: torch.Tensor,
                 exp_mask: torch.Tensor, THRESH: float):
    """(combined, census, rigidity) [B,H,W,1] (test_mask.py:119-138): M's
    soft-OR of its two middle-frame masks over 0.5; the census, where the
    rigid and the flow net's flows differ by less than a share of their
    largest difference; and the soft-OR of the two."""
    rigidity = (1.0 - (1.0 - exp_mask[..., 1:2])
                * (1.0 - exp_mask[..., 2:3]) > 0.5).float()
    census_soft = ((flow_cam - flow_fwd) ** 2).sum(-1, keepdim=True).sqrt()
    census_soft = 1.0 - census_soft / census_soft.max()
    census = (census_soft > THRESH).float()
    combined = 1.0 - (1.0 - rigidity) * (1.0 - census)
    return combined, census, rigidity


def main(argv=None):
    args = parser.parse_args(argv)
    device = eval_device(args.device)
    from cc_tpu_torch.data import transforms
    from cc_tpu_torch.data.validation import ValidationMask
    from cc_tpu_torch.utils.logging import AverageMeter

    nets = load_four_nets(args, device, {
        "disp": args.pretrained_disp, "pose": args.pretrained_pose,
        "mask": args.pretrained_mask, "flow": args.pretrained_flow})

    tf = transforms.valid_flow_transform(args.img_height, args.img_width)
    val_set = ValidationMask(root=args.kitti_dir, sequence_length=5,
                             transform=tf, N=args.n_samples)

    errors = AverageMeter(i=6)
    errors_census = AverageMeter(i=6)
    errors_bare = AverageMeter(i=6)
    for i in range(len(val_set)):
        s = val_set[i]
        out = four_net_forward(nets, s, device)
        with torch.inference_mode():
            masks = census_masks(out["flow_cam"], out["flow_fwd"],
                                 out["exp_mask"], args.THRESH)
        combined, census, bare = (m[0, ..., 0].cpu().numpy() for m in masks)
        gt_mask = np.asarray(s["obj_map"])
        semantic = np.asarray(s["semantic_map"])
        errors.update(mask_error(gt_mask, semantic, combined))
        errors_census.update(mask_error(gt_mask, semantic, census))
        errors_bare.update(mask_error(gt_mask, semantic, bare))

    results = {}
    for title, e in (("Full Model", errors), ("Census only", errors_census),
                     ("Bare", errors_bare)):
        avg, bg, fg = _iou(e.sum)
        results[title] = (avg, bg, fg)
        print(f"Results {title}")
        print("\t {:>10}, {:>10}, {:>10}".format("iou", "bg_iou", "fg_iou"))
        print(f"Errors \t {avg:10.4f}, {bg:10.4f} {fg:10.4f}")
    return results


if __name__ == "__main__":
    main()
