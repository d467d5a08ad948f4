"""KITTI odometry pose benchmark on one CUDA GPU: the counterpart of
cc_tpu/cli/test_pose.py, with the same flags and printed results (parity:
the reference's test_pose.py).

python -m cc_tpu_torch.cli.test_pose P.pth.tar --dataset-dir /kitti/odometry \\
    --sequences 09 --posenet PoseNetB6

It runs on the GPU; --device cpu runs it on the CPU. The snippets' pose
algebra and errors run on the host in float64, as cc_tpu's do.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cc_tpu_torch.cli.test_disp import (
    DEVICE_HELP, eval_device, load_net_params, pose_forward, to_device,
)

parser = argparse.ArgumentParser(
    description="PoseNet testing on KITTI Odometry (5-frame ATE/RE)",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("pretrained_posenet")
parser.add_argument("--posenet", default="PoseNetB6")
parser.add_argument("--img-height", default=256, type=int)
parser.add_argument("--img-width", default=832, type=int)
parser.add_argument("--no-resize", action="store_true")
parser.add_argument("--dataset-dir", default=".")
parser.add_argument("--sequences", default=["09"], nargs="*")
parser.add_argument("--output-dir", default=None)
parser.add_argument("--rotation-mode", default="euler",
                    choices=["euler", "quat"])
parser.add_argument("--seq-length", default=5, type=int)
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


def snippet_prep(args):
    """The frames' preprocessing of the pose CLIs: resized to the flags'
    size (cv2), then (x/255 - 0.5)/0.5."""
    import cv2

    def prep(im):
        if not args.no_resize and im.shape[:2] != (args.img_height,
                                                   args.img_width):
            im = cv2.resize(im, (args.img_width, args.img_height))
        return ((im / 255.0 - 0.5) / 0.5).astype(np.float32)
    return prep


def snippet_poses(pose_net, imgs, device) -> np.ndarray:
    """C on a snippet's preprocessed frames, the middle one the target:
    its [seq_len - 1, 6] poses on the host."""
    mid = len(imgs) // 2
    tgt = to_device(imgs[mid][None], device)
    refs = to_device(np.stack(imgs[:mid] + imgs[mid + 1:])[None], device)
    with torch.inference_mode():
        return pose_forward(pose_net, tgt, refs)[0].cpu().numpy()


def main(argv=None):
    args = parser.parse_args(argv)
    device = eval_device(args.device)
    from cc_tpu_torch.eval.kitti_pose import (
        KittiOdomFramework, compute_pose_error, snippet_poses_from_prediction,
    )

    seq_length = args.seq_length
    kw = {"nb_ref_imgs": seq_length - 1}
    if args.posenet == "PoseExpNet":
        kw["output_exp"] = False
    pose_net = load_net_params(args.pretrained_posenet, args.posenet, device,
                               **kw)

    framework = KittiOdomFramework(args.dataset_dir, args.sequences,
                                   seq_length)
    print(f"{len(framework)} snippets to test")
    prep = snippet_prep(args)

    # error/prediction arrays sized len(framework) == total IMAGE count and
    # zero-filled, exactly like the reference (test_pose.py:43,49,96): only
    # the leading snippet rows get written, and mean/std run over the
    # zero-padded full array — the published numbers inherit that quirk.
    errors = np.zeros((len(framework), 2), np.float32)
    predictions = (np.zeros((len(framework), args.seq_length, 3, 4))
                   if args.output_dir else None)
    for j, sample in enumerate(framework):
        poses = snippet_poses(pose_net, [prep(im) for im in sample["imgs"]],
                              device)
        final = snippet_poses_from_prediction(poses, args.rotation_mode)
        if predictions is not None:
            predictions[j] = final
        errors[j] = compute_pose_error(sample["poses"], final)
    print("\nResults")
    print("\t {:>10}, {:>10}".format("ATE", "RE"))
    print("mean \t {:10.4f}, {:10.4f}".format(*errors.mean(0)))
    print("std \t {:10.4f}, {:10.4f}".format(*errors.std(0)))
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        np.save(os.path.join(args.output_dir, "predictions.npy"),
                predictions)
    return errors.mean(0)


if __name__ == "__main__":
    main()
