"""Flow-only EPE of the flow net on KITTI2015/2012, on one CUDA GPU: the
counterpart of cc_tpu/cli/test_back2future.py, with the same flags and
printed results (parity: the reference's test_back2future.py).

python -m cc_tpu_torch.cli.test_back2future --kitti-dir KITTI2015 \\
    --pretrained-flow F.pth.tar [--flownet FlowNetC6]

It runs on the GPU, where F's correlation is the CUDA kernel (10 launches
an item for Back2Future, 1 for FlowNetC6); --device cpu runs it on the CPU
with the correlation's plain version. The EPEs run on the host.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from cc_tpu_torch.cli.test_disp import (
    DEVICE_HELP, eval_device, load_net_params, to_device,
)

parser = argparse.ArgumentParser(
    description="Flow-net-only EPE evaluation",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--kitti-dir", required=True)
parser.add_argument("--flownet", default="Back2Future")
parser.add_argument("--nlevels", type=int, default=6)
parser.add_argument("--pretrained-flow", required=True)
parser.add_argument("--dataset", default="kitti2015",
                    choices=["kitti2015", "kitti2012"])
parser.add_argument("-N", type=int, default=200,
                    help="number of KITTI2015 samples (reference hardcodes "
                         "200; smaller values allow partial trees)")
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


def flow_forward(flow_net, tgt: torch.Tensor, refs: list) -> torch.Tensor:
    """F's forward flow, NHWC, from the target and its references [I_-,
    I_+] (NCHW): Back2Future on both, a two-frame net on I_+."""
    if flow_net.arch == "Back2Future":
        flow = flow_net(tgt, refs)[0]
    else:
        flow = flow_net(tgt, refs[-1])
    return flow.permute(0, 2, 3, 1)


def main(argv=None):
    args = parser.parse_args(argv)
    device = eval_device(args.device)
    from cc_tpu_torch.data import transforms
    from cc_tpu_torch.data.validation import (
        ValidationFlow, ValidationFlowKitti2012,
    )
    from cc_tpu_torch.losses.metrics import compute_all_epes
    from cc_tpu_torch.utils.logging import AverageMeter

    flow_net = load_net_params(args.pretrained_flow, args.flownet, device,
                               nlevels=args.nlevels)
    tf = transforms.valid_flow_transform(256, 832)
    if args.dataset == "kitti2015":
        val_set = ValidationFlow(root=args.kitti_dir, sequence_length=5,
                                 transform=tf, N=args.N)
    else:
        val_set = ValidationFlowKitti2012(root=args.kitti_dir, transform=tf)

    errors = AverageMeter(i=4)
    for i in range(len(val_set)):
        s = val_set[i]
        if args.dataset == "kitti2015":
            refs = s["refs"][1:3]
        else:
            refs = np.stack([s["ref"], s["ref"]])
        with torch.inference_mode():
            refs_t = to_device(refs[None], device)
            flow_fwd = flow_forward(flow_net, to_device(s["tgt"][None],
                                                        device),
                                    [refs_t[:, 0], refs_t[:, 1]])
        flow_gt = s["flow_gt"][None]
        obj = s.get("obj_map", np.ones(flow_gt.shape[1:3], np.float32))
        obj = obj[None][..., None]
        errors.update(compute_all_epes(flow_gt, flow_fwd, flow_fwd,
                                       1.0 - obj))

    print("Average EPE [epe_total, epe_rigid, epe_non_rigid, outliers]:",
          errors.avg)
    return errors.avg


if __name__ == "__main__":
    main()
