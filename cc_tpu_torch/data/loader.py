"""Threaded batch loader, and the prefetch of its batches to the GPU.

The replacement for torch DataLoader worker processes (train.py:228-233):
a thread pool decodes and augments samples (cv2 and numpy release the
GIL) and batches are collated to numpy. `collate` and `DataLoader` are
copies of cc_tpu/data/loader.py's (the port imports nothing of cc_tpu);
tests/test_torch_data.py holds the two to equal batches. `device_prefetch`
is the port's own: pinned host buffers and copies on a side CUDA stream.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import random
from typing import Iterator

import numpy as np
import torch

from cc_tpu_torch.device import resolve_device


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = True,
                 seed: int | None = None, batch_slice: slice | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        # Multi-process: every process iterates the SAME shuffled index
        # sequence (seeded) batched at the GLOBAL batch size, but loads
        # only its own rows of each batch. None = load the full batch.
        self.batch_slice = batch_slice
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            rng = random.Random(
                None if self.seed is None else self.seed + self._epoch)
            rng.shuffle(indices)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1

        n_batches = len(self)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            # pipeline 2 batches ahead
            pending = collections.deque()

            def submit(b):
                idxs = indices[b * self.batch_size:(b + 1) * self.batch_size]
                if self.batch_slice is not None:
                    idxs = idxs[self.batch_slice]
                pending.append(pool.map(self.dataset.__getitem__, idxs))

            ahead = min(2, n_batches)
            for b in range(ahead):
                submit(b)
            for b in range(n_batches):
                if b + ahead < n_batches:
                    submit(b + ahead)
                yield collate(list(pending.popleft()))


class _PinnedSlot:
    """One batch's pinned host buffers, reused while their shapes and
    dtypes stay, and the event that marks its host-to-device copies."""

    def __init__(self):
        self.host: dict[str, torch.Tensor] = {}
        self.copied: torch.cuda.Event | None = None

    def stage(self, batch: dict) -> dict[str, torch.Tensor]:
        if self.copied is not None:
            # the copies that read these buffers last time must be done
            # before the host writes them again
            self.copied.synchronize()
        for k, v in batch.items():
            src = torch.from_numpy(np.ascontiguousarray(v))
            buf = self.host.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = self.host[k] = torch.empty(src.shape, dtype=src.dtype,
                                                 pin_memory=True)
            buf.copy_(src)
        return self.host


def device_prefetch(iterator, device: str | torch.device | None = None,
                    size: int = 2) -> Iterator[dict]:
    """Yield the host batches of `iterator` as tensors on `device` (CUDA
    unless the caller asks for the CPU; raises here when CUDA is asked for
    and absent), `size` batches ahead of the consumer: the counterpart of
    cc_tpu's device_prefetch (cc_tpu/data/loader.py:76-95). The batches
    keep their keys, dtypes and NHWC layout, so that train steps take them
    as they are.

    On CUDA, each batch is first copied into one of a ring of size + 1
    pinned host buffers, allocated once per shape and dtype; a buffer is
    refilled only after its last host-to-device copy has completed. The
    copies run non_blocking on a side stream. Before a batch is yielded,
    the consumer's current stream waits for its copies, and its tensors
    are marked as used by that stream, so that the caching allocator does
    not hand their memory to a later copy while the consumer's kernels
    still read it. On the CPU the batches become tensors with no copy
    beyond torch.from_numpy's.
    """
    dev = resolve_device(device)
    if size < 1:
        raise ValueError(f"size must be at least 1, not {size}")
    if dev.type == "cuda":
        return _prefetch_cuda(iterator, dev, size)
    return ({k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()} for batch in iterator)


def _prefetch_cuda(iterator, dev: torch.device, size: int) -> Iterator[dict]:
    side = torch.cuda.Stream(device=dev)
    ring = [_PinnedSlot() for _ in range(size + 1)]
    inflight = collections.deque()  # (device tensors, copies-done event)

    def put(slot: _PinnedSlot, batch: dict):
        with torch.cuda.stream(side):
            host = slot.stage(batch)
            out = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
            slot.copied = torch.cuda.Event()
            slot.copied.record(side)
        return out, slot.copied

    def take():
        out, copied = inflight.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(copied)
        for t in out.values():
            t.record_stream(consumer)
        return out

    for i, batch in enumerate(iterator):
        inflight.append(put(ring[i % len(ring)], batch))
        if len(inflight) >= size:
            yield take()
    while inflight:
        yield take()
