"""Multi-process data parallelism under torchrun: the counterpart of
cc_tpu/parallel/distributed.py, in torch's idiom of one process a device.

Launch one process per device:

    python -m torch.distributed.run --nproc-per-node N \\
        -m cc_tpu_torch.cli.train DATA --name EXP ...

cc_tpu runs one process a host with its 1-D data mesh over the host's
devices, and jax.distributed joins the hosts. Here every process trains
one replica on one device (cuda:LOCAL_RANK), loads its rows of each global
batch (process_batch_slice), and the train step makes every replica take
cc_tpu's global-batch step: the gradients and the metrics are averaged
over the processes (all_reduce_mean_), and BatchNorm and the
out-of-bounds barrier read global sums (all_reduce_sum). Only process 0
writes checkpoints and logs and validates.

The process group uses NCCL when every local process has a CUDA device of
its own, and gloo when processes share a device or run on the CPU (gloo
all-reduces CUDA tensors through host memory, so two processes can share
one card). A failure to set it up raises; there is no fallback to the
other backend.

cc_tpu's host_local_tree has no counterpart: a torch tensor always lives
on this process's device, so the primary's own work (validation,
checkpoints) reads its replica's tensors as they are.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from cc_tpu_torch.device import resolve_device

# The primary validates and writes checkpoints while the others wait in the
# next collective (cc_tpu/parallel/distributed.py:66 waits as long)
TIMEOUT = datetime.timedelta(minutes=30)
# Gradients are all-reduced in flat buffers of at most this many bytes
BUCKET_BYTES = 25 * 2 ** 20
_LAUNCH_VARS = ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Launch:
    """A multi-process launch, as torchrun describes it in the environment."""
    world_size: int
    rank: int
    local_rank: int
    local_world_size: int


def launch_from_env() -> Launch | None:
    """The launch in torchrun's environment (WORLD_SIZE, RANK, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT); None when WORLD_SIZE is
    unset or 1. Raises ValueError when WORLD_SIZE asks for several
    processes and the rest of the launch is missing."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    missing = [k for k in _LAUNCH_VARS if k not in os.environ]
    if missing:
        raise ValueError(f"WORLD_SIZE={world} without {', '.join(missing)}: "
                         "launch with python -m torch.distributed.run")
    return Launch(world, int(os.environ["RANK"]),
                  int(os.environ["LOCAL_RANK"]),
                  int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def local_device(device: str | torch.device | None = None) -> torch.device:
    """The device this process trains on: resolve_device(device), and in a
    launch on CUDA the LOCAL_RANK-th card (modulo the cards there are, so
    that processes may share one)."""
    dev = resolve_device(device)
    launch = launch_from_env()
    if launch is None or dev.type != "cuda":
        return dev
    return torch.device("cuda", launch.local_rank % torch.cuda.device_count())


def _backend(dev: torch.device, launch: Launch) -> tuple[str, str]:
    if dev.type != "cuda":
        return "gloo", "on the CPU"
    cards = torch.cuda.device_count()
    if launch.local_world_size <= cards:
        return "nccl", (f"a CUDA device for each of "
                         f"{launch.local_world_size} local processes")
    return "gloo", (f"{launch.local_world_size} local processes share "
                    f"{cards} CUDA device(s)")


def initialize(device: str | torch.device | None = None) -> bool:
    """Join the process group of a torchrun launch, on this process's device
    (local_device), which becomes the current CUDA device first. A no-op
    returning False outside a launch (WORLD_SIZE unset or 1); True once
    joined. Prints the backend and why it was chosen."""
    launch = launch_from_env()
    if launch is None:
        return False
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend, why = _backend(dev, launch)
    print(f"=> process {launch.rank} of {launch.world_size} on {dev}: "
          f"{backend}, {why}", flush=True)
    dist.init_process_group(backend, init_method="env://",
                            world_size=launch.world_size, rank=launch.rank,
                            timeout=TIMEOUT,
                            device_id=dev if backend == "nccl" else None)
    return True


def warmup_collectives(device: str | torch.device) -> None:
    """Align the processes, then run one tiny all-reduce on `device`, so
    that the communicators exist before the first step; raises if its sum
    is not the process count."""
    dist.barrier()
    x = torch.ones(1, device=device)
    dist.all_reduce(x)
    if int(x.item()) != process_count():
        raise RuntimeError(f"warm-up all-reduce gave {x.item()}, not "
                           f"{process_count()}")


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """Number of launch processes (1 outside a launch)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's index in the launch (0 outside a launch)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return process_index() == 0


_count, _index = process_count, process_index


def process_batch_slice(global_batch_size: int,
                        process_index: int | None = None,
                        process_count: int | None = None) -> slice:
    """The rows of the global batch this process loads: process p owns the
    contiguous rows [p*B/P, (p+1)*B/P). B must divide evenly by the process
    count."""
    p = _index() if process_index is None else process_index
    n = _count() if process_count is None else process_count
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{n} processes")
    per = global_batch_size // n
    return slice(p * per, (p + 1) * per)


def _buckets(tensors, bucket_bytes: int):
    """Consecutive runs of `tensors` of one dtype and device, each of at
    most bucket_bytes (or one tensor, where it alone is larger)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > bucket_bytes
                       or (t.dtype, t.device) != (bucket[0].dtype,
                                                  bucket[0].device)):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def _coalesced(tensors, collective, bucket_bytes: int) -> None:
    for bucket in _buckets(tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(v.view_as(t))


def all_reduce_mean_(tensors: list[torch.Tensor],
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor by its mean over the processes, in place, through
    flat buffers of at most bucket_bytes. Every process must pass tensors
    of the same shapes and dtypes in the same order; all end with the same
    bits. Outside a launch it returns at once."""
    n = process_count()
    if n == 1:
        return

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(n)
    _coalesced(tensors, mean, bucket_bytes)


def broadcast_(tensors: list[torch.Tensor]) -> None:
    """Overwrite each tensor with process 0's, in place (parameters and
    buffers after init, pretrained weights and resume, as
    DistributedDataParallel's constructor does). Outside a launch it
    returns at once."""
    if process_count() == 1:
        return
    _coalesced(tensors, lambda flat: dist.broadcast(flat, 0), BUCKET_BYTES)


class _SumOverProcesses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        # every process's loss reads the sum: each input's gradient is the
        # sum of theirs
        return _SumOverProcesses.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the processes, as a new tensor; autograd flows back
    through it (each process's x receives the sum of the processes'
    gradients of the result). Outside a launch, x itself."""
    if process_count() == 1:
        return x
    return _SumOverProcesses.apply(x)
