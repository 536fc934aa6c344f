"""The host a run ran on, recorded beside the card in every result line
(``device.host``), so that lines of different runs and calls can be told
apart by the host's speed and load:

* ``cpu``: the CPU model; ``cpus``: the CPUs online; ``pinned``: the
  CPUs the run's main thread may run on;
* ``load``: the one-minute load average at the window's start and after
  it closed;
* ``launch_us``: a probe of the host's speed, microseconds per empty
  kernel launch (``torch.cuda._sleep(0)``), before the window and after it;
* ``main_cpu_pct``: the main thread's CPU time over the window's wall
  time (the rest it waited: for the autograd engine's device thread, the
  card or the host);
* ``cuda_mallocs``: the segments the caching allocator newly reserved on
  the card while the window ran (each a ``cudaMalloc``): 0 where set-up
  warmed up every size the window uses.
"""
from __future__ import annotations

import os
import statistics
import time

import torch

PROBE_LAUNCHES = 1000  # under the depth of the launch queue: the host's time, not the card's
PROBE_BATCHES = 5


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "not read"


def _segments(device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get("segment.all.allocated", 0))


def launch_us(device):
    """Host microseconds per empty kernel launch, the median of a few
    batches, or None off the card."""
    if device.type != "cuda":
        return None
    times = []
    for _ in range(PROBE_BATCHES):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(PROBE_LAUNCHES):
            torch.cuda._sleep(0)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize(device)
    return 1e6 * statistics.median(times) / PROBE_LAUNCHES


class Record:
    """``start()`` as the window opens, ``stop()`` once it has closed,
    then ``line()``."""

    def __init__(self, device):
        self.device = device

    def start(self) -> None:
        self.probe0 = launch_us(self.device)
        self.load0 = os.getloadavg()[0]
        self.segments0 = _segments(self.device)
        self.cpu0, self.wall0 = time.thread_time(), time.perf_counter()

    def stop(self) -> None:
        self.cpu1, self.wall1 = time.thread_time(), time.perf_counter()
        self.segments1 = _segments(self.device)
        self.load1 = os.getloadavg()[0]
        self.probe1 = launch_us(self.device)

    def line(self) -> dict:
        return {
            "cpu": cpu_model(), "cpus": os.cpu_count(), "pinned": sorted(os.sched_getaffinity(0)),
            "load": [self.load0, self.load1], "launch_us": [self.probe0, self.probe1],
            "main_cpu_pct": 100.0 * (self.cpu1 - self.cpu0) / max(self.wall1 - self.wall0, 1e-9),
            "cuda_mallocs": self.segments1 - self.segments0,
        }
