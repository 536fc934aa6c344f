"""Phase timers that wait for the card, and an optional profiler trace.

Counterpart of ``neuma_tpu/utils/profiling.py``: ``device_sync``,
``PhaseTimer`` (the same accumulation and ``report()`` format) and
``profiler_trace``, the counterpart of ``xla_trace``. Where the JAX
package syncs by fetching a scalar, ``device_sync`` calls
``torch.cuda.synchronize`` on the device that holds the work.

    timer = PhaseTimer()
    with timer.phase("sim", out=state): ...
    print(timer.report())
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch


def _first_tensor(x):
    """The first tensor leaf of a tensor, dict, list, tuple or dataclass."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (list, tuple)):
        for item in x:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def device_sync(x=None) -> None:
    """Wait for pending card work: on the device of ``x``'s first tensor
    leaf, or on the current CUDA device when ``x`` holds none. Nothing
    for CPU tensors, nor without a CUDA device."""
    leaf = _first_tensor(x) if x is not None else None
    if leaf is not None:
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulating named phase timer with device synchronization.

    with timer.phase("sim", out=state): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, out=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            device_sync(out)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            c = self.counts[name]
            lines.append(
                f"{name:24s} {t:8.3f}s total  {t / max(c, 1) * 1e3:8.2f} "
                f"ms/call  x{c}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Optional ``torch.profiler`` trace of the CPU and (where present)
    CUDA activity, written as a Chrome trace (``trace.json``) into
    ``log_dir``; the counterpart of the JAX package's ``xla_trace``.
    Nothing happens when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
