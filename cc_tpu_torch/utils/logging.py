"""Metric accumulators, the two CSV logs, optional TensorBoard, step timing
and a profiler window: a copy of cc_tpu/utils/logging.py (the port imports
nothing of cc_tpu), whose trace hook is torch.profiler's here.
"""
from __future__ import annotations

import csv
import os
import time
from contextlib import contextmanager


class AverageMeter:
    """Vector running means (logger.py:62-89)."""

    def __init__(self, i: int = 1, precision: int = 3):
        self.meters = i
        self.precision = precision
        self.reset()

    def reset(self):
        self.val = [0.0] * self.meters
        self.avg = [0.0] * self.meters
        self.sum = [0.0] * self.meters
        self.count = 0

    def update(self, val, n: int = 1):
        if not isinstance(val, (list, tuple)):
            val = [val]
        if len(val) != self.meters:
            raise ValueError(f"{len(val)} values for {self.meters} meters")
        self.count += n
        self.val = [float(v) for v in val]
        self.sum = [s + v * n for s, v in zip(self.sum, self.val)]
        self.avg = [s / self.count for s in self.sum]

    def __repr__(self):
        val = " ".join(f"{v:.{self.precision}f}" for v in self.val)
        avg = " ".join(f"{a:.{self.precision}f}" for a in self.avg)
        return f"{val} ({avg})"


class CsvLogger:
    """A tab-separated file: the header on creation, then a row per append."""

    def __init__(self, path: str, header: list[str]):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", newline="") as f:
            csv.writer(f, delimiter="\t").writerow(header)

    def append(self, row):
        with open(self.path, "a", newline="") as f:
            csv.writer(f, delimiter="\t").writerow(row)


class SummaryLogger:
    """Scalar/image logger: tensorboardX when available, else the scalars
    go to <log_dir>/scalars.tsv and the images nowhere."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except ImportError:
            self._scalars = CsvLogger(
                os.path.join(log_dir, "scalars.tsv"),
                ["tag", "value", "step"])

    def add_scalar(self, tag, value, step):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        else:
            self._scalars.append([tag, float(value), step])

    def add_image(self, tag, img_hwc, step):
        if self._tb is not None:
            import numpy as np
            self._tb.add_image(tag, np.transpose(img_hwc, (2, 0, 1)), step)

    def add_histogram(self, tag, values, step):
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()


@contextmanager
def profile_trace(log_dir: str | None):
    """A torch.profiler window over a region, CPU and (when there is one)
    CUDA activity, written as a Chrome trace to <log_dir>/trace.json; no
    profiling when log_dir is empty."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Batch/data wall-clock meters (train.py:424-425 pattern)."""

    def __init__(self):
        self.data_time = AverageMeter()
        self.batch_time = AverageMeter()
        self._t = time.time()

    def mark_data(self):
        now = time.time()
        self.data_time.update(now - self._t)
        self._t = now

    def mark_step(self):
        now = time.time()
        self.batch_time.update(now - self._t)
        self._t = now
