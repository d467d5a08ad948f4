"""MNIST+SVHN CC evaluation on one CUDA GPU: the counterpart of
cc_tpu/cli/mnist_eval.py, with the same flags and prints. It scores
Alice, Bob and the moderator-gated ensemble on the mixed test set.

python -m cc_tpu_torch.cli.mnist_eval DATA \\
    --checkpoint checkpoints/EXP/mnist_best.pt

It runs on the GPU; --device cpu runs it on the CPU.
"""
from __future__ import annotations

import argparse

from cc_tpu_torch.cli.mnist import load_dataset
from cc_tpu_torch.cli.test_disp import DEVICE_HELP, eval_device
from cc_tpu_torch.mnist.data import iterate_batches
from cc_tpu_torch.mnist.train import evaluate, load_nets, models

parser = argparse.ArgumentParser(
    description="Evaluate CC Alice/Bob/Moderator",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("data", metavar="DIR")
parser.add_argument("--checkpoint", required=True,
                    help="mnist_best.pt or mnist_checkpoint.pt saved by "
                         "cc_tpu_torch.cli.mnist")
parser.add_argument("--dataset", default="both",
                    choices=["mnist", "svhn", "both"])
parser.add_argument("-b", "--batch-size", type=int, default=64)
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


def main(argv=None) -> list[float]:
    """Print and return the (total, alice, bob) error rates."""
    args = parser.parse_args(argv)
    device = eval_device(args.device)  # fp32, TF32 off
    nets = load_nets(args.checkpoint, models(device))

    val_x, val_y = load_dataset(args, train=False)
    errors, _ = evaluate(
        nets, iterate_batches(val_x, val_y, args.batch_size, shuffle=False,
                              drop_last=False))
    for n, e in zip(["total", "alice", "bob"], errors):
        print(f"accuracy_{n}: {1 - e:.4f} (error {e:.4f})")
    return errors


if __name__ == "__main__":
    main()
