"""The device trace of a short stretch after the window.

``Tracer`` runs ``torch.profiler`` with CPU and CUDA activities over the
stretch and reads its events in memory (nothing is written to disk):
the device's busy time (the union of its kernel and copy intervals),
the stretch's wall time, the kernel launches, the device time of each
kernel by name, and the longest idle gaps of the device named by the
innermost host operation that was running in the middle of each gap.
"""
from __future__ import annotations

import bisect
import collections
import time

import torch

# The port's hand-written kernels (``neuma_tpu_torch/csrc``) by their
# ``__global__`` names.
KERNELS = {
    "p2g": ("p2g_chunk_kernel", "p2g_block_sum_kernel"),  # K1
    "g2p": ("g2p_gather_kernel",),  # K2
    "g2p_derivs": ("g2p_gather_derivs_kernel",),  # K3
    "composite": ("k4_",),  # K4
    "composite_bwd": ("k5_",),  # K5
}


def short_name(name: str) -> str:
    """A device operation's name without its namespace, template and
    argument lists: ``void at::native::f<4, ...>(int, ...)`` -> ``at::native::f``."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].strip()
    return base[5:] if base.startswith("void ") else base


def kernel_of(name: str):
    """The port's kernel a device operation belongs to, or None."""
    base = short_name(name).rsplit("::", 1)[-1]
    for key, names in KERNELS.items():
        for n in names:
            if (base.startswith(n) if n.endswith("_") else base == n):
                return key
    return None


def merge(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(device_ops, host_ops, wall_s: float, top: int = 10) -> dict:
    """``device_ops``: (name, start_ns, dur_ns, is_kernel); ``host_ops``:
    (name, start_ns, end_ns) of the main thread."""
    busy = merge((s, s + d) for _, s, d, _ in device_ops)
    busy_s = sum(e - s for s, e in busy) / 1e9
    by_name = collections.Counter()
    by_kernel = collections.Counter()
    launches = 0
    for name, _, d, is_kernel in device_ops:
        by_name[short_name(name)] += d / 1e9
        launches += int(is_kernel)
        k = kernel_of(name)
        if k is not None:
            by_kernel[k] += d / 1e9
    host_ops = sorted(host_ops, key=lambda o: o[1])
    starts = [o[1] for o in host_ops]
    gaps = collections.Counter()
    for (_, e0), (s1, _) in zip(busy[:-1], busy[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host_outside_any_op"
        for j in range(i, max(i - 64, -1), -1):
            if host_ops[j][2] >= mid:
                name = host_ops[j][0]
                break
        gaps[name] += (s1 - e0) / 1e9
    return {
        "busy_s": busy_s, "window_s": wall_s, "launches": launches,
        "kernel_s": dict(by_kernel),
        "device_ops": [[n, s] for n, s in by_name.most_common(top)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(top)],
    }


class Tracer:
    """Profile one stretch: ``start()``, the work, ``stop()`` (which
    synchronizes the device first) returns the summary and the port's
    kernel launch counters over the stretch."""

    def __init__(self, device, launch_counter=None):
        self.device = device
        self.counter = launch_counter
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            acts.append(ProfilerActivity.CUDA)
        self.before = collections.Counter(self.counter) if self.counter is not None else None
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        device_ops, host_ops = [], []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                name = e.name()
                device_ops.append((name, e.start_ns(), e.duration_ns(),
                                   not name.startswith(("Memcpy", "Memset"))))
            else:
                host_ops.append((e.start_thread_id(), e.name(), e.start_ns(),
                                 e.start_ns() + e.duration_ns()))
        self.prof = None
        tids = collections.Counter(o[0] for o in host_ops)
        main = tids.most_common(1)[0][0] if tids else None
        host_ops = [o[1:] for o in host_ops if o[0] == main]
        out = summarize(device_ops, host_ops, wall)
        if self.counter is not None:
            out["counters"] = dict(collections.Counter(self.counter) - self.before)
        return out
