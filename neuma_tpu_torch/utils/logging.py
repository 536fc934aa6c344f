"""Running averages, stdout tee and elapsed-time formatting.

Counterpart of ``neuma_tpu/utils/logging.py`` (``AverageMeter``,
``Logger.tee``, ``Timer``), the same code, and ``Logger.close``, which
ends the tee so that one process can run an app more than once.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Logger:
    """Tee stdout to a log file (reference tune/utils.py:50-61)."""

    def __init__(self, filename):
        Path(filename).parent.mkdir(parents=True, exist_ok=True)
        self.terminal = sys.stdout
        self.log = open(filename, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()

    @classmethod
    def tee(cls, filename) -> "Logger":
        logger = cls(filename)
        sys.stdout = logger
        return logger

    def close(self) -> None:
        """Stop the tee: restore the stream it replaced and close the file."""
        if sys.stdout is self:
            sys.stdout = self.terminal
        self.log.close()


class Timer:
    """Elapsed/ETA formatting (reference tune/utils.py:64-77)."""

    def __init__(self):
        self.o = time.time()

    def measure(self, p=1):
        x = int((time.time() - self.o) / p)
        if x >= 3600:
            return f"{x / 3600:.1f}h"
        if x >= 60:
            return f"{round(x / 60)}m"
        return f"{x}s"
