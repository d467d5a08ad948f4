"""The batch split over processes: the counterpart of cc_tpu/parallel/mesh.py
in torch's terms of one process, one device.

cc_tpu shards the batch axis of each global batch over a 1-D mesh of
devices, in one process on a host (8 devices on a TPU host) and across
hosts with jax.distributed. Here that mesh of 8 devices becomes 8
processes of one device each (torchrun, parallel/distributed.py): each
loads the contiguous rows of the global batch that cc_tpu would place on
its device, onto its own device (the loader's batch_slice and
device_prefetch(device=...) in the train CLI, shard_batch for a batch
already on the host). Parameters are replicated by keeping every
process's copy equal: they start equal (broadcast_ from process 0) and
take the same averaged update.
"""
from __future__ import annotations

import torch

from cc_tpu_torch.parallel.distributed import (
    Launch, launch_from_env, process_batch_slice,
)


def batch_slice(batch_size: int, launch: Launch | None = None) -> slice | None:
    """The rows of every global batch of `batch_size` that this process
    loads: None (all of them) outside a launch (`launch`, by default the
    one in the environment). In a launch the process count must divide the
    batch, or it raises ValueError, as cc_tpu/cli/train.py:400-405 does
    rather than train on a part of the devices."""
    launch = launch_from_env() if launch is None else launch
    if launch is None:
        return None
    if batch_size % launch.world_size:
        raise ValueError(
            f"multi-process launch: batch size {batch_size} must be a "
            f"multiple of the {launch.world_size} processes")
    return process_batch_slice(batch_size, launch.rank, launch.world_size)


def shard_batch(batch: dict, device: str | torch.device) -> dict:
    """This process's rows of a global batch (arrays or tensors, batch axis
    first) as tensors on `device`: the whole batch outside a launch."""
    rows = batch_slice(len(batch["tgt"]))
    rows = slice(None) if rows is None else rows
    return {k: torch.as_tensor(v[rows]).to(device) for k, v in batch.items()}
