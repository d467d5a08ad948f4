"""Fixed-position 3-bar terminal UI: a copy of cc_tpu/utils/term.py (the
port imports nothing of cc_tpu).

Parity with the reference's blessings+progressbar TermLogger
(logger.py:6-59): a 10-row region is reserved at the bottom of the screen
holding an epoch progress bar (row offset 1), a train status line + train
bar (offsets 3-4), and a valid status line + valid bar (offsets 6-7). The
cursor addressing and the bars are raw ANSI, so neither `blessings` nor
`progressbar` is needed.

When stdout is not a TTY (pytest, piped logs), every bar update is dropped
and writer.write() degrades to a plain print: the UI is observability, not
behavior.
"""
from __future__ import annotations

import shutil
import sys


class Writer:
    """Write a string at a fixed (col, row) screen position (logger.py:39-57).

    Saves/restores the cursor around the write so the scrolling region
    (normal prints) is unaffected.
    """

    def __init__(self, location, stream=None):
        self.location = location  # (x, y) 0-based, like the reference
        self.stream = stream or sys.stdout

    def write(self, string: str):
        if not self.stream.isatty():
            print(string, file=self.stream)
            return
        x, y = self.location
        # \0337 save cursor, CUP is 1-based, \033[K clear to EOL, \0338 restore
        self.stream.write(f"\0337\033[{y + 1};{x + 1}H\033[K{string}\0338")
        self.stream.flush()

    def flush(self):
        return


class ProgressBar:
    """Minimal progressbar.ProgressBar: start()/update(i)/finish() rendering
    `NN% |####    | i/maxval` through a Writer."""

    def __init__(self, maxval: int, fd: Writer, width: int = 50):
        self.maxval = max(1, maxval)
        self.fd = fd
        self.width = width
        self.currval = 0

    def start(self):
        self._render(0)
        return self

    def update(self, value: int):
        value = min(value, self.maxval)
        if value != self.currval:
            self.currval = value
            self._render(value)

    def finish(self):
        self.update(self.maxval)

    def _render(self, value: int):
        if not self.fd.stream.isatty():
            return  # bars are TTY-only; status lines still print
        frac = value / self.maxval
        filled = int(frac * self.width)
        bar = "#" * filled + " " * (self.width - filled)
        self.fd.write(f"{int(frac * 100):3d}% |{bar}| {value}/{self.maxval}")


class TermLogger:
    """3-bar fixed-position training UI (logger.py:6-36 layout)."""

    def __init__(self, n_epochs: int, train_size: int, valid_size: int,
                 stream=None):
        self.n_epochs = n_epochs
        self.train_size = train_size
        self.valid_size = valid_size
        self.stream = stream or sys.stdout
        s, e, tr, ts = 10, 1, 3, 6  # region height + row offsets (ref: s/e/tr/ts)
        h = shutil.get_terminal_size().lines
        if self.stream.isatty():
            for _ in range(s):  # reserve the region by scrolling it in
                print("", file=self.stream)
        self.epoch_bar = ProgressBar(n_epochs,
                                     Writer((0, h - s + e), self.stream))
        self.train_writer = Writer((0, h - s + tr), self.stream)
        self.train_bar_writer = Writer((0, h - s + tr + 1), self.stream)
        self.valid_writer = Writer((0, h - s + ts), self.stream)
        self.valid_bar_writer = Writer((0, h - s + ts + 1), self.stream)
        self.reset_train_bar()
        self.reset_valid_bar()

    def reset_train_bar(self):
        self.train_bar = ProgressBar(self.train_size,
                                     self.train_bar_writer).start()

    def reset_valid_bar(self, size: int | None = None):
        """Fresh validation bar; pass `size` as a ONE-SHOT override when
        the next validation pass iterates a different loader (e.g. depth
        after flow) — the default valid_size is left untouched so the
        next epoch's flow bar keeps its own total."""
        self.valid_bar = ProgressBar(
            self.valid_size if size is None else size,
            self.valid_bar_writer).start()
