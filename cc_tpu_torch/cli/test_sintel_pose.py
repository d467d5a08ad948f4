"""MPI-Sintel pose benchmark on one CUDA GPU: the counterpart of
cc_tpu/cli/test_sintel_pose.py, with the same flags and printed results
(parity: the reference's test_sintel_pose.py).

python -m cc_tpu_torch.cli.test_sintel_pose P.pth.tar --dataset-dir SINTEL \\
    --sequences alley_1 --posenet PoseNetB6

It runs on the GPU; --device cpu runs it on the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from cc_tpu_torch.cli.test_disp import (
    DEVICE_HELP, eval_device, load_net_params,
)
from cc_tpu_torch.cli.test_pose import snippet_poses, snippet_prep

parser = argparse.ArgumentParser(
    description="PoseNet rotation error on MPI-Sintel",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("pretrained_posenet")
parser.add_argument("--posenet", default="PoseNetB6")
parser.add_argument("--img-height", default=256, type=int)
parser.add_argument("--img-width", default=832, type=int)
parser.add_argument("--no-resize", action="store_true")
parser.add_argument("--dataset-dir", default=".")
parser.add_argument("--sequences", default=["alley_1"], nargs="*")
parser.add_argument("--output-dir", default=None)
parser.add_argument("--rotation-mode", default="euler",
                    choices=["euler", "quat"])
parser.add_argument("--seq-length", default=5, type=int)
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


def main(argv=None):
    args = parser.parse_args(argv)
    device = eval_device(args.device)
    from cc_tpu_torch.eval.kitti_pose import snippet_poses_from_prediction
    from cc_tpu_torch.eval.sintel import (
        SintelPoseFramework, compute_rotation_error,
    )

    pose_net = load_net_params(args.pretrained_posenet, args.posenet, device,
                               nb_ref_imgs=args.seq_length - 1)
    framework = SintelPoseFramework(args.dataset_dir, args.sequences,
                                    args.seq_length)
    print(f"{len(framework)} snippets to test")
    prep = snippet_prep(args)

    # zero-padded to len(framework) == total IMAGE count, like the
    # reference (test_sintel_pose.py:49,96 + the framework's __len__ quirk,
    # see eval/sintel.py): mean/std run over the padded array.
    res = np.zeros(len(framework), np.float32)
    preds = (np.zeros((len(framework), args.seq_length, 3, 4))
             if args.output_dir else None)
    for j, sample in enumerate(framework):
        poses = snippet_poses(pose_net, [prep(im) for im in sample["imgs"]],
                              device)
        final = snippet_poses_from_prediction(poses, args.rotation_mode)
        if preds is not None:
            preds[j] = final
        res[j] = compute_rotation_error(sample["poses"], final)
    print("\nResults\n\t {:>10}".format("RE"))
    print(f"mean \t {res.mean():10.4f}")
    print(f"std \t {res.std():10.4f}")
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        np.save(os.path.join(args.output_dir, "predictions.npy"),
                preds)
    return res.mean()


if __name__ == "__main__":
    main()
