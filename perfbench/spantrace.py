"""The traced stretch charged to the port's spans.

The port opens named spans at its layer boundaries
(``neuma_tpu_torch.utils.profiling.span``: ``train.*``, ``loss.frame``,
``material.*``, ``mpm.*``, ``binding.*``, ``raster.*``), recorded as host
operations in the profiler's trace. ``charge`` puts every device
operation (kernel, copy, fill) and every idle gap of the device down to
the nest of spans that launched it:

- a device operation is linked by its correlation id to the runtime call
  that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...); its
  path is the nest of spans open on that call's thread at that time, on
  any host thread;
- a launch inside an autograd node (``autograd::engine::evaluate_function``)
  that has no span of its own inside the node takes the path of the
  node's forward operation (found by thread and sequence number) with
  ``.bwd`` added; a node that opens a span (the port's own backward
  functions) keeps the thread's path;
- each operation is charged the device time it adds to the busy union,
  and the idle gap before it: the host was busy preparing that launch;
- operations with no link, or launched outside every span, are charged to
  ``untraced``; so are their gaps;
- the blocking runtime calls (``BLOCKING``) are counted on their path;
  those outside every span (the harness's own) are not.

The charges plus the idle time before the first operation and after the
last add up to the stretch's wall time.

``SpanTracer`` is ``devtrace.Tracer`` that also charges the stretch and
diffs the port's counters (``utils.profiling.counters``) beside its
kernel launches. The metric readers (``metrics/*_ms_per_*``,
``host_syncs_per_frame.*``, ``untraced_share.*``) take each path's charge
by its innermost span that a metric owns (``OWNERS``).
"""
from __future__ import annotations

import bisect
import collections
import re

import torch

from . import devtrace

LAYERS = ("train.", "loss.", "material.", "mpm.", "binding.", "raster.")
OWNERS = {
    "material": ("material.",),
    "mpm": ("mpm.",),
    "render": ("binding.", "raster."),
    "trainer": ("train.optim", "train.read"),
}
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                      "cudaMemcpy"})
UNTRACED = "untraced"
NODE = "autograd::engine::evaluate_function: "
RUNTIME = re.compile(r"cu(da)?[A-Z]")
MARK = "perfbench.stretch"  # the stretch's start on the trace's clock


class _Nest:
    """Properly nested intervals of one thread: the innermost one that
    holds a time, by the latest start at or before it and its parents."""

    def __init__(self, intervals):
        intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
        self.starts = [iv[0] for iv in intervals]
        self.ends = [iv[1] for iv in intervals]
        self.items = [iv[2] for iv in intervals]
        self.parent = []
        stack = []
        for i, start in enumerate(self.starts):
            while stack and self.ends[stack[-1]] <= start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self._paths = {}

    def at(self, t) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] <= t:
            i = self.parent[i]
        return i

    def path(self, i) -> str:
        p = self._paths.get(i)
        if p is None:
            up = self.parent[i]
            p = self.items[i] if up < 0 else self.path(up) + "/" + self.items[i]
            self._paths[i] = p
        return p


def charge(device_ops, host_ops, t0_ns: int, wall_s: float) -> dict:
    """``device_ops``: (start_ns, dur_ns, correlation_id); ``host_ops``:
    (thread, name, start_ns, end_ns, correlation_id, sequence_nr,
    forward_thread) of every thread; ``t0_ns`` the stretch's start on the
    trace's clock and ``wall_s`` its length. Returns ``by_path`` (path ->
    [idle_s, busy_s, blocking calls]), ``lead_s`` and ``trail_s``, the
    idle time before the first device operation and after the last."""
    spans, nodes = collections.defaultdict(list), collections.defaultdict(list)
    launched, forward, blocking = {}, {}, []
    for tid, name, start, end, corr, seq, fwd_tid in host_ops:
        if name.startswith(LAYERS):
            spans[tid].append((start, end, name))
        elif name.startswith(NODE):
            nodes[tid].append((start, end, (fwd_tid, seq)))
        elif RUNTIME.match(name):
            launched[corr] = (tid, start)
            if name in BLOCKING:
                blocking.append((tid, start))
        elif seq >= 0 and fwd_tid == 0:  # an operation that recorded an autograd node
            key = (tid, seq)
            if start < forward.get(key, start + 1):
                forward[key] = start
    spans = {tid: _Nest(iv) for tid, iv in spans.items()}
    nodes = {tid: _Nest(iv) for tid, iv in nodes.items()}

    def span_path(tid, t):
        nest = spans.get(tid)
        i = nest.at(t) if nest is not None else -1
        return (nest, i) if i >= 0 else (None, -1)

    def path_at(tid, t) -> str:
        nest, i = span_path(tid, t)
        node_nest = nodes.get(tid)
        j = node_nest.at(t) if node_nest is not None else -1
        if j >= 0 and (i < 0 or node_nest.starts[j] > nest.starts[i]):
            fwd_tid, seq = node_nest.items[j]
            start = forward.get((fwd_tid, seq))
            if start is not None:
                f_nest, k = span_path(fwd_tid, start)
                if k >= 0:
                    return f_nest.path(k) + ".bwd"
        return nest.path(i) if i >= 0 else UNTRACED

    by_path = collections.defaultdict(lambda: [0.0, 0.0, 0])
    covered = lead = None
    for start, dur, corr in sorted(device_ops):
        where = launched.get(corr)
        rec = by_path[path_at(*where) if where is not None else UNTRACED]
        if covered is None:
            lead, covered = start - t0_ns, start
        if start > covered:
            rec[0] += (start - covered) / 1e9
        rec[1] += max(0, start + dur - max(start, covered)) / 1e9
        covered = max(covered, start + dur)
    for tid, start in blocking:
        path = path_at(tid, start)
        if path != UNTRACED:
            by_path[path][2] += 1
    if covered is None:
        return {"by_path": {}, "lead_s": wall_s, "trail_s": 0.0}
    return {"by_path": dict(by_path), "lead_s": lead / 1e9,
            "trail_s": wall_s - (covered - t0_ns) / 1e9}


def owner(path: str):
    """The metric that owns the innermost owned span of ``path``, or None."""
    for name in reversed(path.split("/")):
        for key, prefixes in OWNERS.items():
            if name.startswith(prefixes):
                return key
    return None


def owned_s(trace: dict, key: str):
    """Seconds (idle and busy) charged to the metric ``key``, or None
    when the trace holds no charges."""
    by_path = trace.get("by_path")
    if not by_path:
        return None
    return sum(idle + busy for path, (idle, busy, _) in by_path.items() if owner(path) == key)


def host_syncs(trace: dict):
    """The blocking runtime calls on every program path, or None."""
    by_path = trace.get("by_path")
    if not by_path:
        return None
    return sum(n for _, _, n in by_path.values())


def idle_by_span(by_path: dict, top: int = 10) -> list:
    """The ``top`` paths with the most idle time: [path, idle_s, busy_s]."""
    rows = sorted(by_path.items(), key=lambda kv: -kv[1][0])[:top]
    return [[path, idle, busy] for path, (idle, busy, _) in rows]


def _registry():
    """The port's counters, or None where the port has none."""
    try:
        from neuma_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters


class SpanTracer(devtrace.Tracer):
    """``devtrace.Tracer`` whose summary (also kept as ``summary``) holds
    the stretch's charges (``by_path``, ``lead_s``, ``trail_s``,
    ``idle_by_span``) and the port's counters over the stretch beside its
    kernel launches."""

    def start(self) -> None:
        self.registry = _registry()
        self.registry_before = collections.Counter(self.registry or {})
        super().start()
        with torch._C._profiler._RecordFunctionFast(MARK):
            pass

    def stop(self) -> dict:
        prof = self.prof
        out = super().stop()
        device_ops, host_ops, t0 = [], [], None
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    device_ops.append((e.start_ns(), e.duration_ns(), e.correlation_id()))
                continue
            name = e.name()
            if name == MARK:
                t0 = e.start_ns()
                continue
            seq = e.sequence_nr()
            runtime = RUNTIME.match(name) is not None
            if not (runtime or seq >= 0 or name.startswith(LAYERS)):
                continue
            start = e.start_ns()
            host_ops.append((e.start_thread_id(), name, start, start + e.duration_ns(),
                             e.correlation_id() if runtime else 0, seq, e.fwd_thread_id()))
        charged = charge(device_ops, host_ops, t0, out["window_s"])
        out.update(charged, idle_by_span=idle_by_span(charged["by_path"]))
        if self.registry is not None:
            out.setdefault("counters", {}).update(
                collections.Counter(self.registry) - self.registry_before)
        self.summary = out
        return out
