"""Joint Competitive-Collaboration training CLI on one CUDA GPU: the
counterpart of cc_tpu/cli/train.py, with the same flags, the same
alternation semantics (--fix-*) and the same per-epoch flow and depth
validation and decisive-error checkpoints, through the port's data path,
train step, eval forward and checkpoints.

Usage (one command per phase of the protocol, --resume between them):
  python -m cc_tpu_torch.cli.train DATA --name EXP --dispnet DispResNet6 \\
      --posenet PoseNetB6 --masknet MaskNet6 --flownet Back2Future \\
      -b4 -pc 1.0 -pf 0.5 -m 0.1 -s 0.1 -c 0.3 --nlevels 6 --lr 1e-4 \\
      -wssim 0.997 --smoothness-type edgeaware --fix-masknet --fix-flownet

It runs on the GPU; --device cpu runs it on the CPU, with the correlation's
plain PyTorch version in place of its CUDA kernels. Checkpoints are
checkpoints/EXP/checkpoint.pt and best.pt (train/checkpoint.py).

Data parallel over N processes, one device each (parallel/distributed.py):
  python -m torch.distributed.run --nproc-per-node N \\
      -m cc_tpu_torch.cli.train DATA --name EXP ...
Each process loads its rows of every global batch of -b rows, which N must
divide; the steps are cc_tpu's on the global batch. Only process 0 writes
the recorder line, the logs, training images and checkpoints, and
validates; --resume loads on every process from a shared directory.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

import numpy as np
import torch

from cc_tpu_torch.data import (
    DataLoader, SequenceFolder, ValidationSet, device_prefetch, transforms,
)
from cc_tpu_torch.data.native_pipeline import train_pipeline
from cc_tpu_torch.data.validation import ValidationFlow
from cc_tpu_torch.device import resolve_device
from cc_tpu_torch.eval.composite import composite_flow, rigidity_masks
from cc_tpu_torch.geometry.warp import pose2flow
from cc_tpu_torch.losses.metrics import compute_all_epes, compute_depth_errors
from cc_tpu_torch.parallel import distributed, mesh
from cc_tpu_torch.train import (
    TrainConfig, build_train_step, forward_eval, load_checkpoint, make_models,
    make_optimizer, save_checkpoint,
)
from cc_tpu_torch.train.step import check_ported
from cc_tpu_torch.utils.logging import AverageMeter, CsvLogger, SummaryLogger
from cc_tpu_torch.utils.term import TermLogger
from cc_tpu_torch.utils.viz import (
    flow_to_image, image_to_display, scalar_to_rgb,
)
from cc_tpu_torch.weights import load_pretrained


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Competitive Collaboration training (PyTorch/CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("data", metavar="DIR", help="path to formatted dataset")
    p.add_argument("--name", required=True,
                   help="experiment name; checkpoints under checkpoints/NAME")
    p.add_argument("--kitti-dir", default="kitti/kitti2015",
                   help="KITTI2015 dir for flow validation")
    p.add_argument("--DEBUG", action="store_true")
    p.add_argument("--sequence-length", type=int, default=5)
    p.add_argument("--rotation-mode", choices=["euler", "quat"],
                   default="euler")
    p.add_argument("--padding-mode", choices=["zeros", "border"],
                   default="zeros")
    p.add_argument("--with-depth-gt", action="store_true")
    p.add_argument("--with-flow-gt", action="store_true")
    p.add_argument("-j", "--workers", type=int, default=4)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--epoch-size", type=int, default=0)
    p.add_argument("-b", "--batch-size", type=int, default=4)
    p.add_argument("--lr", "--learning-rate", type=float, default=2e-4,
                   dest="lr")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--beta", type=float, default=0.999)
    p.add_argument("--weight-decay", "--wd", type=float, default=0.0,
                   dest="weight_decay")
    p.add_argument("--clip-grad-norm", type=float, default=0.0,
                   dest="clip_grad_norm",
                   help="global-norm gradient clip; 0 = off (reference "
                        "parity)")
    p.add_argument("--skip-nonfinite-updates", action="store_true",
                   dest="skip_nonfinite_updates",
                   help="drop optimizer updates with non-finite gradients")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default="float32", dest="compute_dtype",
                   help="net forward/backward dtype; bfloat16 is not "
                        "ported yet and raises")
    p.add_argument("--loss-dtype", choices=["float32", "bfloat16"],
                   default="float32", dest="loss_dtype",
                   help="loss-stack dtype; bfloat16 is not ported yet and "
                        "raises")
    p.add_argument("--matmul-precision",
                   choices=["default", "high", "highest"],
                   default="default", dest="matmul_precision",
                   help="kept for cc_tpu's flag surface: every value runs "
                        "full fp32, with TF32 off for matmuls and cuDNN "
                        "convolutions, as the reference trains")
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--smoothness-type", choices=["edgeaware", "regular"],
                   default="regular")
    p.add_argument("--data-normalization", choices=["local", "global"],
                   default="global")
    p.add_argument("--nlevels", type=int, default=6)
    p.add_argument("--dispnet", default="DispResNet6",
                   choices=["DispNetS", "DispNetS6", "DispResNetS6",
                            "DispResNet6"])
    p.add_argument("--posenet", default="PoseNetB6",
                   choices=["PoseNet6", "PoseNetB6", "PoseExpNet"])
    p.add_argument("--masknet", default="MaskNet6",
                   choices=["MaskResNet6", "MaskNet6"])
    p.add_argument("--flownet", default="Back2Future",
                   choices=["Back2Future", "FlowNetC6"])
    p.add_argument("--pretrained-disp", default=None)
    p.add_argument("--pretrained-mask", default=None)
    p.add_argument("--pretrained-pose", default=None)
    p.add_argument("--pretrained-flow", default=None)
    p.add_argument("--spatial-normalize", action="store_true")
    p.add_argument("--no-non-rigid-mask", action="store_true")
    p.add_argument("--joint-mask-for-depth", action="store_true")
    p.add_argument("--fix-masknet", action="store_true")
    p.add_argument("--fix-posenet", action="store_true")
    p.add_argument("--fix-flownet", action="store_true")
    p.add_argument("--fix-dispnet", action="store_true")
    p.add_argument("--fix-posemasknet", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-summary", default="progress_log_summary.csv")
    p.add_argument("--log-full", default="progress_log_full.csv")
    p.add_argument("-qch", "--qch", type=float, default=0.5)
    p.add_argument("-wrig", "--wrig", type=float, default=1.0)
    p.add_argument("-wbce", "--wbce", type=float, default=0.5)
    p.add_argument("-wssim", "--wssim", type=float, default=0.0)
    p.add_argument("-pc", "--cam-photo-loss-weight", type=float, default=1.0)
    p.add_argument("-pf", "--flow-photo-loss-weight", type=float, default=1.0)
    p.add_argument("-m", "--mask-loss-weight", type=float, default=0.0)
    p.add_argument("-s", "--smooth-loss-weight", type=float, default=0.1)
    p.add_argument("-c", "--consensus-loss-weight", type=float, default=0.1)
    p.add_argument("--THRESH", type=float, default=0.01)
    p.add_argument("--lambda-oob", type=float, default=0.0)
    p.add_argument("--log-output", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("-f", "--training-output-freq", type=int, default=0)
    # cc_tpu's extensions over the reference (whose flow-validation loader
    # is fixed at 256x832, N=200, train.py:163); the defaults keep it
    p.add_argument("--val-flow-height", type=int, default=256)
    p.add_argument("--val-flow-width", type=int, default=832)
    p.add_argument("--val-flow-N", type=int, default=200, dest="val_flow_n")
    p.add_argument("--loader", choices=["auto", "python", "native"],
                   default="auto",
                   help="data plane: native = C++ decode+augment "
                        "(cc_tpu_torch/native, numerically matching "
                        "python); auto = native when it builds, else python")
    p.add_argument("--h2d", choices=["float32", "uint8"], default="float32",
                   help="train-batch host->device format: uint8 ships "
                        "un-normalized pixels (4x less H2D traffic; "
                        "normalization runs in the device step). "
                        "Pixel numerics change by <=0.5/255 vs float32. "
                        "Requires --data-normalization global")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on; cuda raises when there "
                        "is no GPU (the CPU runs only when asked for)")
    return p


def config_from_args(args) -> TrainConfig:
    fix_pose = args.fix_posenet or args.fix_posemasknet
    fix_mask = args.fix_masknet or args.fix_posemasknet
    return TrainConfig(
        dispnet=args.dispnet, posenet=args.posenet, masknet=args.masknet,
        flownet=args.flownet, nlevels=args.nlevels,
        sequence_length=args.sequence_length, height=args.height,
        width=args.width, batch_size=args.batch_size, lr=args.lr,
        momentum=args.momentum, beta=args.beta,
        weight_decay=args.weight_decay,
        clip_grad_norm=args.clip_grad_norm,
        skip_nonfinite_updates=args.skip_nonfinite_updates,
        cam_photo_loss_weight=args.cam_photo_loss_weight,
        mask_loss_weight=args.mask_loss_weight,
        smooth_loss_weight=args.smooth_loss_weight,
        flow_photo_loss_weight=args.flow_photo_loss_weight,
        consensus_loss_weight=args.consensus_loss_weight,
        qch=args.qch, wrig=args.wrig, wbce=args.wbce, wssim=args.wssim,
        THRESH=args.THRESH, lambda_oob=args.lambda_oob,
        rotation_mode=args.rotation_mode, padding_mode=args.padding_mode,
        smoothness_type=args.smoothness_type,
        spatial_normalize=args.spatial_normalize,
        no_non_rigid_mask=args.no_non_rigid_mask,
        joint_mask_for_depth=args.joint_mask_for_depth,
        fix_dispnet=args.fix_dispnet, fix_posenet=fix_pose,
        fix_masknet=fix_mask, fix_flownet=args.fix_flownet,
        compute_dtype=args.compute_dtype, loss_dtype=args.loss_dtype,
    )


DEPTH_NAMES = ["abs_diff", "abs_rel", "sq_rel", "a1", "a2", "a3"]
FLOW_NAMES = ["epe_total", "epe_rigid", "epe_non_rigid", "outliers",
              "epe_total_with_gt_mask", "epe_rigid_with_gt_mask",
              "epe_non_rigid_with_gt_mask", "outliers_gt_mask"]


def validate_depth(cfg, nets, val_loader, term_logger=None):
    """Depth validation (train.py:588-636): the disp net alone, in eval
    mode, on the device of its parameters; [abs_diff, abs_rel, sq_rel, a1,
    a2, a3] averaged over the batches."""
    disp_net = nets["disp"].eval()
    device = next(disp_net.parameters()).device
    errors = AverageMeter(i=len(DEPTH_NAMES))
    with torch.inference_mode():
        for i, batch in enumerate(val_loader):
            tgt = torch.as_tensor(batch["tgt"]).to(device)
            disp = disp_net(tgt.permute(0, 3, 1, 2).contiguous())
            depth = 1.0 / disp[:, 0].cpu().numpy()
            errors.update(compute_depth_errors(batch["depth"], depth,
                                               crop=True))
            if term_logger is not None:
                term_logger.valid_bar.update(i)
    if term_logger is not None:
        term_logger.valid_bar.finish()
    return errors.avg, list(DEPTH_NAMES)


def validate_flow(cfg, nets, val_loader, output_writers=None, epoch=0,
                  term_logger=None):
    """Flow validation (train.py:638-777): the four nets' eval forward on
    the device of their parameters; 8 EPE/outlier metrics with predicted
    and GT rigidity masks; optional image logging to the --log-output
    writers, one item in ten (train.py:703-744)."""
    device = next(nets.parameters()).device
    errors = AverageMeter(i=len(FLOW_NAMES))
    for i, batch in enumerate(val_loader):
        inputs = {k: torch.as_tensor(batch[k]).to(device) for k in
                  ("tgt", "refs", "intrinsics", "intrinsics_inv")}
        out = forward_eval(cfg, nets, inputs)
        with torch.inference_mode():
            flow_cam = pose2flow(out["depth"][..., 0], out["pose"][:, 2],
                                 inputs["intrinsics"],
                                 inputs["intrinsics_inv"], cfg.rotation_mode)
            _, _, combined = rigidity_masks(flow_cam, out["flow_fwd"],
                                            out["exp_mask"], cfg.THRESH)
        flow_gt = batch["flow_gt"]
        obj_map = np.asarray(batch["obj_map"])[..., None]
        # the epe partition threshold is compute_all_epes' default 0.5
        # (train.py:749, test_flow.py:145), not cfg.THRESH, which only
        # feeds the census and composite masks above
        e = compute_all_epes(flow_gt, flow_cam, out["flow_fwd"], combined)
        e += compute_all_epes(flow_gt, flow_cam, out["flow_fwd"],
                              1.0 - obj_map)
        errors.update(e)

        if output_writers and i % 10 == 0 and i // 10 < len(output_writers):
            w = output_writers[i // 10]
            with torch.inference_mode():
                total, _ = composite_flow(flow_cam, out["flow_fwd"],
                                          out["exp_mask"], cfg.THRESH)
            w.add_image("val flow Input",
                        image_to_display(np.asarray(batch["tgt"])[0]), epoch)
            w.add_image("val Total Flow Output",
                        flow_to_image(total[0].cpu().numpy()) / 255.0, epoch)
            w.add_image("val Rigidity Mask Combined",
                        scalar_to_rgb(combined[0, ..., 0].cpu().numpy(),
                                      max_value=1, colormap="bone"), epoch)
        if term_logger is not None:
            term_logger.valid_bar.update(i)
    if term_logger is not None:
        term_logger.valid_bar.finish()
    return errors.avg, list(FLOW_NAMES)


def decisive_error(cfg, train_loss, flow_errors, depth_errors):
    """The error that picks the best checkpoint (train.py:382-389), the
    first of these that applies: C trains and flow was validated:
    epe_non_rigid_with_gt_mask; D trains and depth was validated:
    abs_diff; F trains and flow was validated: outliers_gt_mask; M trains
    and flow was validated: outliers; else the epoch's train loss."""
    if not cfg.fix_posenet and flow_errors:
        return flow_errors[-2]
    if not cfg.fix_dispnet and depth_errors:
        return depth_errors[0]
    if not cfg.fix_flownet and flow_errors:
        return flow_errors[-1]
    if not cfg.fix_masknet and flow_errors:
        return flow_errors[3]
    return train_loss


def _log_training_output(writer, cfg, nets, batch, n_iter):
    """The training images of -f (train.py:521-560), from the eval forward
    of the current nets on the step's batch."""
    out = forward_eval(cfg, nets, batch)
    tgt0 = batch["tgt"][0].cpu().numpy()
    if tgt0.dtype == np.uint8:  # --h2d uint8
        tgt0 = transforms.dequantize_u8(tgt0)
    writer.add_image("train Input", image_to_display(tgt0), n_iter)
    writer.add_image("train Dispnet Output Normalized",
                     scalar_to_rgb(out["disp"][0, ..., 0].cpu().numpy(),
                                   colormap="bone"), n_iter)
    writer.add_image("train Depth Output",
                     scalar_to_rgb(out["depth"][0, ..., 0].cpu().numpy(),
                                   max_value=10), n_iter)
    writer.add_image("train Non Rigid Flow Output",
                     flow_to_image(out["flow_fwd"][0].cpu().numpy()) / 255.0,
                     n_iter)


class _NullLogger:
    """The summary and CSV writers of a process other than the primary."""

    def add_scalar(self, *a, **k):
        pass

    add_image = append = close = add_scalar


def _check_flags(args, cfg) -> slice | None:
    """Flag and launch errors, raised before any side effect (a batch that
    the process count does not divide among them); returns the rows of
    each global batch this process loads (None: all of them)."""
    if args.h2d == "uint8" and args.data_normalization == "local":
        raise ValueError("--h2d uint8 requires --data-normalization global "
                         "(local stats are a host-side joint reduction)")
    check_ported(cfg)  # bf16, PoseExpNet as C
    resolve_device(args.device)
    return mesh.batch_slice(args.batch_size)


def main(argv=None) -> list[dict]:
    """Train as the flags say. Returns one record per epoch: the train
    loss, the validation errors, the decisive error and whether it was the
    best, the last im/s printed, and the host seconds of the epoch's
    training, validations and checkpoint."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    rows = _check_flags(args, cfg)
    # a torchrun launch: join it before any CUDA use or file, and create the
    # communicators while the processes are aligned
    launched = distributed.initialize(args.device)
    device = distributed.local_device(args.device)
    if launched:
        distributed.warmup_collectives(device)
    primary = distributed.is_primary()
    if primary:
        with open("experiment_recorder.md", "a") as f:
            f.write("\npython3 " + " ".join(sys.argv))

    # the reference trains in full fp32: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"=> {device}: fp32 with TF32 off for matmuls and convolutions "
          f"(--matmul-precision {args.matmul_precision} changes nothing)")

    save_path = os.path.join("checkpoints", args.name)
    if primary:
        os.makedirs(save_path, exist_ok=True)
    print(f"=> will save everything to {save_path}")
    if launched:
        print(f"=> {distributed.process_count()} process(es) on "
              f"{torch.distributed.get_backend()}")

    norm = args.data_normalization
    train_tf, plane = train_pipeline(norm, with_rotation=not args.fix_flownet,
                                     emit=args.h2d, loader=args.loader)
    if plane == "native":
        print("=> native (C++) data plane active")
    valid_tf = transforms.valid_transform(norm)
    valid_flow_tf = transforms.valid_flow_transform(
        args.val_flow_height, args.val_flow_width, norm)

    print(f"=> fetching scenes in '{args.data}'")
    train_set = SequenceFolder(args.data, seed=args.seed, train=True,
                               sequence_length=args.sequence_length,
                               transform=train_tf)
    if args.DEBUG:
        train_set.samples = train_set.samples[:32]
    print(f"{len(train_set)} samples in {len(train_set.scenes)} train scenes")

    # validation runs on the primary alone (it is not a collective)
    val_depth_loader = None
    if args.with_depth_gt and primary:
        val_set = ValidationSet(args.data.replace("cityscapes", "kitti"),
                                transform=valid_tf)
        val_depth_loader = DataLoader(val_set, args.batch_size,
                                      num_workers=args.workers)
    val_flow_loader = None
    if args.with_flow_gt and primary:
        val_flow_set = ValidationFlow(root=args.kitti_dir,
                                      sequence_length=args.sequence_length,
                                      transform=valid_flow_tf,
                                      N=args.val_flow_n)
        val_flow_loader = DataLoader(val_flow_set, 1,
                                     num_workers=args.workers)

    train_loader = DataLoader(train_set, args.batch_size, shuffle=True,
                              num_workers=args.workers, seed=args.seed,
                              batch_slice=rows)
    epoch_size = args.epoch_size or len(train_loader)

    print("=> creating models")
    nets = make_models(cfg, device=device,
                       generator=torch.Generator().manual_seed(args.seed))
    load_pretrained(nets, {"disp": args.pretrained_disp,
                           "pose": args.pretrained_pose,
                           "mask": args.pretrained_mask,
                           "flow": args.pretrained_flow})
    opt_state = make_optimizer(cfg).init(nets)
    if args.resume:
        print("=> resuming from checkpoint")
        load_checkpoint(save_path, nets, opt_state)
    # the replicas start from process 0's weights and BatchNorm stats
    distributed.broadcast_([*nets.parameters(), *nets.buffers()])
    step = build_train_step(cfg, nets, opt_state)

    output_writers = []
    if primary:
        writer = SummaryLogger(save_path)
        if args.log_output:  # 3 extra valid/N writers (train.py:157-160)
            output_writers = [SummaryLogger(os.path.join(save_path, "valid",
                                                         str(i)))
                              for i in range(3)]
        summary_csv = CsvLogger(os.path.join(save_path, args.log_summary),
                                ["train_loss", "validation_loss"])
        full_csv = CsvLogger(
            os.path.join(save_path, args.log_full),
            ["train_loss", "photo_cam_loss", "photo_flow_loss",
             "explainability_loss", "smooth_loss"])
    else:
        writer = summary_csv = full_csv = _NullLogger()

    # 3-bar fixed-position terminal UI (reference logger.py:6-59,
    # train.py:325-327); plain prints when stdout is not a TTY
    valid_size = len(val_flow_loader) if val_flow_loader is not None else (
        len(val_depth_loader) if val_depth_loader is not None else 0)
    logger = TermLogger(n_epochs=args.epochs, train_size=epoch_size,
                        valid_size=valid_size)
    logger.epoch_bar.start()

    records = []
    best_error = -1.0
    n_iter = 0
    for epoch in range(args.epochs):
        logger.epoch_bar.update(epoch)
        logger.reset_train_bar()
        losses = AverageMeter(precision=4)
        epoch_losses = []
        rate = None
        t0 = time.time()
        feed = device_prefetch(iter(train_loader), device)
        for i, batch in enumerate(itertools.islice(feed, epoch_size)):
            metrics = step(batch)
            if (primary and args.training_output_freq > 0
                    and n_iter % args.training_output_freq == 0):
                _log_training_output(writer, cfg, nets, batch, n_iter)
            # the train loss averages every step (train.py:563-576); the
            # per-step losses (global in a launch) stay on the device until
            # the epoch ends
            epoch_losses.append(metrics["loss"])
            if i > 0 and n_iter % args.print_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}
                losses.update(m["loss"], args.batch_size)
                for tag in ("loss", "photo_cam_loss", "photo_flow_loss",
                            "explainability_loss", "smooth_loss",
                            "consensus_loss"):
                    writer.add_scalar(tag, m[tag], n_iter)
                full_csv.append([m["loss"], m["photo_cam_loss"],
                                 m["photo_flow_loss"],
                                 m["explainability_loss"], m["smooth_loss"]])
                rate = args.batch_size * (i + 1) / (time.time() - t0)
                logger.train_writer.write(
                    f"Train [{epoch}] it {i}/{epoch_size} "
                    f"Loss {losses} ({rate:.1f} im/s)")
            logger.train_bar.update(i + 1)
            n_iter += 1
        feed.close()
        # one host fetch for the whole epoch
        train_loss = (float(np.mean(torch.stack(epoch_losses).cpu().numpy()))
                      if epoch_losses else losses.avg[0])
        t_train = time.time() - t0
        logger.train_writer.write(f" * Avg Loss : {train_loss:.3f}")
        logger.reset_valid_bar()

        flow_errors = depth_errors = None
        t1 = time.time()
        if val_flow_loader is not None:
            flow_errors, flow_names = validate_flow(
                cfg, nets, iter(val_flow_loader),
                output_writers=output_writers, epoch=epoch,
                term_logger=logger)
            for e, n in zip(flow_errors, flow_names):
                writer.add_scalar(n, e, epoch)
            logger.valid_writer.write(" * Avg " + ", ".join(
                f"{n} : {e:.3f}" for n, e in zip(flow_names, flow_errors)))
        t2 = time.time()
        if val_depth_loader is not None:
            # depth validation iterates a different loader than flow's
            logger.reset_valid_bar(len(val_depth_loader))
            depth_errors, depth_names = validate_depth(
                cfg, nets, iter(val_depth_loader), term_logger=logger)
            for e, n in zip(depth_errors, depth_names):
                writer.add_scalar(n, e, epoch)
            logger.valid_writer.write("Epoch {} depth: {}".format(
                epoch, ", ".join(f"{n} {e:.3f}"
                                 for n, e in zip(depth_names, depth_errors))))
        t3 = time.time()

        decisive = decisive_error(cfg, train_loss, flow_errors, depth_errors)
        if best_error < 0:
            best_error = decisive
        is_best = decisive <= best_error
        best_error = min(best_error, decisive)
        save_checkpoint(save_path, nets, opt_state, is_best=is_best)
        summary_csv.append([train_loss, decisive])
        records.append({
            "epoch": epoch, "steps": len(epoch_losses),
            "train_loss": train_loss, "flow_errors": flow_errors,
            "depth_errors": depth_errors, "decisive": decisive,
            "is_best": is_best, "im_per_s_printed": rate,
            "seconds": {"train": t_train, "flow_validation": t2 - t1,
                        "depth_validation": t3 - t2,
                        "checkpoint": time.time() - t3}})
    logger.epoch_bar.finish()
    for w in [writer, *output_writers]:
        w.close()
    distributed.shutdown()
    print("=> done")
    return records


if __name__ == "__main__":
    main()
