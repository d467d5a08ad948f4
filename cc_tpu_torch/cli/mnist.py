"""MNIST+SVHN Competitive-Collaboration training on one CUDA GPU: the
counterpart of cc_tpu/cli/mnist.py, with the same flags, prints and
summary. Even epochs compete and odd ones collaborate (every epoch
competes with --fix-mod).

python -m cc_tpu_torch.cli.mnist DATA --name mnist_cc --epochs 10

It runs on the GPU; --device cpu runs it on the CPU. Checkpoints are torch
files, checkpoints/NAME/mnist_checkpoint.pt and mnist_best.pt (cc_tpu
writes orbax directories, which the port does not read).
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np
import torch

from cc_tpu_torch.cli.test_disp import DEVICE_HELP, eval_device
from cc_tpu_torch.mnist.data import iterate_batches, load_mnist, load_svhn
from cc_tpu_torch.mnist.train import (
    MnistConfig, evaluate, init_mnist_state, make_collaborate_step,
    make_compete_step, save_checkpoint,
)
from cc_tpu_torch.utils.logging import AverageMeter, CsvLogger, SummaryLogger

CHECKPOINT = "mnist_checkpoint.pt"
BEST = "mnist_best.pt"

parser = argparse.ArgumentParser(
    description="CC on MNIST+SVHN (Alice/Bob/Moderator)",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("data", metavar="DIR")
parser.add_argument("--name", required=True)
parser.add_argument("--dataset", default="both",
                    choices=["mnist", "svhn", "both"])
parser.add_argument("--epochs", type=int, default=200)
parser.add_argument("--epoch-size", type=int, default=0)
parser.add_argument("-b", "--batch-size", type=int, default=64)
parser.add_argument("--lr", type=float, default=2e-4)
parser.add_argument("--momentum", type=float, default=0.9)
parser.add_argument("--beta", type=float, default=0.999)
parser.add_argument("--weight-decay", type=float, default=0.0)
parser.add_argument("--wr", type=float, default=1.0)
parser.add_argument("--fix-alice", action="store_true")
parser.add_argument("--fix-bob", action="store_true")
parser.add_argument("--fix-mod", action="store_true")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--print-freq", type=int, default=10)
parser.add_argument("--device", default="cuda", help=DEVICE_HELP)


def load_dataset(args, train: bool):
    """The chosen sets' images and labels, concatenated (MNIST first)."""
    sets = []
    if args.dataset in ("mnist", "both"):
        sets.append(load_mnist(os.path.join(args.data, "mnist"), train))
    if args.dataset in ("svhn", "both"):
        sets.append(load_svhn(os.path.join(args.data, "svhn"), train))
    images = np.concatenate([s[0] for s in sets])
    labels = np.concatenate([s[1] for s in sets])
    return images, labels


def main(argv=None) -> list[dict]:
    """Train as the flags say. Returns one record per epoch: its mode, the
    steps taken and their seconds (the last step synchronized), the train
    loss as printed and logged, and the three error rates on the test
    sets."""
    args = parser.parse_args(argv)
    device = eval_device(args.device)  # fp32, TF32 off, as the reference
    with open("experiment_recorder.md", "a") as f:
        f.write("\npython3 " + " ".join(sys.argv))

    save_path = os.path.join("checkpoints", args.name)
    os.makedirs(save_path, exist_ok=True)
    cfg = MnistConfig(lr=args.lr, momentum=args.momentum, beta=args.beta,
                      weight_decay=args.weight_decay, wr=args.wr,
                      fix_alice=args.fix_alice, fix_bob=args.fix_bob,
                      fix_mod=args.fix_mod)

    train_x, train_y = load_dataset(args, True)
    val_x, val_y = load_dataset(args, False)
    print(f"{len(train_x)} train / {len(val_x)} val samples")

    state = init_mnist_state(cfg, device,
                             torch.Generator().manual_seed(args.seed))
    compete = make_compete_step(cfg)
    collaborate = make_collaborate_step(cfg)
    writer = SummaryLogger(save_path)
    summary_csv = CsvLogger(os.path.join(save_path,
                                         "progress_log_summary.csv"),
                            ["train_loss", "decisive_error"])

    records = []
    best_error = -1.0
    n_iter = 0
    for epoch in range(args.epochs):
        mode = "compete" if epoch % 2 == 0 or args.fix_mod else "collaborate"
        step = compete if mode == "compete" else collaborate
        losses = AverageMeter(precision=4)
        steps = 0
        t0 = time.perf_counter()
        for i, (img, tgt) in enumerate(iterate_batches(
                train_x, train_y, args.batch_size, seed=args.seed + epoch)):
            if args.epoch_size and i >= args.epoch_size:
                break
            m = step(state, img, tgt)
            if i > 0 and n_iter % args.print_freq == 0:
                losses.update(float(m["loss"]), args.batch_size)
                writer.add_scalar(f"{mode}_loss", float(m["loss"]), n_iter)
                writer.add_scalar("mod_mean", float(m["mod_mean"]), n_iter)
            n_iter += 1
            steps += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0

        errors, names = evaluate(
            state.nets,
            iterate_batches(val_x, val_y, args.batch_size, shuffle=False,
                            drop_last=False))
        print(f"epoch {epoch} [{mode}] " + ", ".join(
            f"{n}: {e:.4f}" for n, e in zip(names, errors)))
        for e, n in zip(errors, names):
            writer.add_scalar(n, e, epoch)

        decisive = errors[2] if args.fix_alice else (
            errors[1] if args.fix_bob else errors[0])
        if best_error < 0:
            best_error = decisive
        is_best = decisive <= best_error
        best_error = min(best_error, decisive)

        path = os.path.join(save_path, CHECKPOINT)
        save_checkpoint(path, state)
        if is_best:
            shutil.copyfile(path, os.path.join(save_path, BEST))
        summary_csv.append([losses.avg[0], decisive])
        records.append({"epoch": epoch, "mode": mode, "steps": steps,
                        "seconds": seconds, "loss": losses.avg[0],
                        "errors": errors, "decisive": decisive,
                        "is_best": is_best})
    writer.close()
    return records


if __name__ == "__main__":
    main()
