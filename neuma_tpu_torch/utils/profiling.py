"""Phase timers that wait for the card, an optional profiler trace, and
the port's spans and counters.

Counterpart of ``neuma_tpu/utils/profiling.py``: ``device_sync``,
``PhaseTimer`` (the same accumulation and ``report()`` format) and
``profiler_trace``, the counterpart of ``xla_trace``. Where the JAX
package syncs by fetching a scalar, ``device_sync`` calls
``torch.cuda.synchronize`` on the device that holds the work.

    timer = PhaseTimer()
    with timer.phase("sim", out=state): ...
    print(timer.report())

``span(name)`` marks a layer of the port (``<layer>.<what>``: ``train.*``,
``loss.frame``, ``material.*``, ``mpm.*``, ``binding.*``, ``raster.*``) in
a profiler trace without waiting for the card; ``counters`` holds the
port's always-on counts (``layouts.*``, ``grid_sum.*``,
``halo_exchange.*``, ``tile_gather.*``: ``calls``, ``bytes`` and host
``seconds`` of the collectives).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

counters: Counter = Counter()


def reset_counters() -> None:
    counters.clear()


class span:
    """A named span of the port, as a context manager or a decorator.

    With no profiler running it reads one flag and does nothing else. With
    one running it records the span as an operation of the host thread
    (``torch._C._profiler._RecordFunctionFast``), in the same trace and on
    the same clock as the device operations it launches. It is not
    ``torch.profiler.record_function``: that one is a user annotation,
    which the trace copies onto the device's timeline, where a reader of
    the device's operations would count it as device time."""

    __slots__ = ("name", "_record")

    def __init__(self, name: str):
        self.name = name
        self._record = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._record = torch._C._profiler._RecordFunctionFast(self.name)
            self._record.__enter__()

    def __exit__(self, *exc):
        if self._record is not None:
            record, self._record = self._record, None
            record.__exit__(*exc)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch._C._profiler._RecordFunctionFast(name):
                return fn(*args, **kwargs)

        return spanned


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
