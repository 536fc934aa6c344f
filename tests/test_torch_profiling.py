"""The port's ``utils/profiling.py`` against the JAX package's
``neuma_tpu/utils/profiling.py`` on the CPU: ``PhaseTimer``'s totals,
counts and ``report()`` for the same recorded phases, ``reset``,
``device_sync`` on CPU trees, and ``profiler_trace`` (nothing for None,
a Chrome trace file for a directory)."""
import json
import time

import numpy as np
import pytest
import torch

from neuma_tpu.utils import profiling as jprofiling
from neuma_tpu_torch.core.types import ParticleState
from neuma_tpu_torch.utils import profiling
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_report_is_the_jax_format():
    """The same totals and counts give the same report, character for
    character (sorted by total, longest first)."""
    recorded = {"sim": (1.23456, 40), "render": (0.5, 3), "a-very-long-phase-name-x": (2.0, 1),
                "never": (0.0, 0)}
    got, want = profiling.PhaseTimer(), jprofiling.PhaseTimer()
    for timer in (got, want):
        for name, (total, count) in recorded.items():
            timer.totals[name] += total
            timer.counts[name] += count
    assert got.report() == want.report()
    assert got.report().splitlines()[0] == ("a-very-long-phase-name-x    2.000s total   2000.00 "
                                            "ms/call  x1")
    got.reset()
    assert got.report() == "" and not got.totals and not got.counts


def test_phase_accumulates_like_jax(monkeypatch):
    """A fake clock makes both timers see the same durations; each phase
    adds its time and one call, exceptions included."""
    for mod in (profiling, jprofiling):
        ticks = iter(np.arange(0.0, 100.0, 0.25))
        monkeypatch.setattr(mod.time, "perf_counter", lambda ticks=ticks: float(next(ticks)))
        timer = mod.PhaseTimer()
        with timer.phase("a", out=np.zeros(3)):
            pass
        with timer.phase("a"):
            pass
        with pytest.raises(ValueError):
            with timer.phase("b"):
                raise ValueError
        assert dict(timer.totals) == {"a": 0.5, "b": 0.25}
        assert dict(timer.counts) == {"a": 2, "b": 1}
        monkeypatch.setattr(mod.time, "perf_counter", time.perf_counter)


def test_device_sync_on_cpu_trees():
    x = torch.ones(3)
    state = ParticleState.initial(torch.zeros((4, 3)), torch.zeros((4, 3)))
    for tree in (None, x, [x, 2.0], {"a": (x,)}, state, {"none": None}, []):
        assert profiling.device_sync(tree) is None
    assert profiling._first_tensor({"a": [1.0, (None, x)]}) is x
    assert profiling._first_tensor(state) is state.x
    timer = profiling.PhaseTimer()
    with timer.phase("cpu", out=state):
        torch.ones(8).sum()
    assert timer.counts["cpu"] == 1 and timer.totals["cpu"] >= 0.0


def test_profiler_trace(tmp_path):
    with profiling.profiler_trace(None):
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())
    out = tmp_path / "trace"
    with profiling.profiler_trace(str(out)):
        torch.ones((64, 64)) @ torch.ones((64, 64))
    trace = out / "trace.json"
    assert trace.is_file() and trace.stat().st_size > 0
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
