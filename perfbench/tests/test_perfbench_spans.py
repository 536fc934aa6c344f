"""The charging of the traced stretch to the port's spans
(``spantrace.py``), the span metrics' readers (``metrics/_spans.py``)
and their entries in ``BENCHMARK.json``, and a traced tiny cell through
the harness on the CPU."""
import json
import time
import types

import pytest
import torch

from perfbench import harness, spantrace
from perfbench.tests.test_perfbench_cells import SEED, TINY_LIMITS, manifest, tiny

NODE = spantrace.NODE


def synthetic():
    """Two host threads, spans, autograd nodes, launches and gaps (ns).
    Thread 1 runs the forward: a kernel under ``material.elasticity``, an
    overlapping one under ``mpm.substep``, one under ``train.loss`` alone
    and one outside every span; then a blocking call outside every span
    and one inside ``train.read``. Thread 2 runs the backward: a generic
    node whose forward operation (sequence number 5 of thread 1) ran under
    ``material.elasticity``, the port's own backward node that opens
    ``mpm.substep.bwd``, and a node with no forward operation. A kernel
    with no runtime call is not linked."""
    host = [
        (1, "train.loss", 0, 100, 1, -1, 0),
        (1, "mpm.substep", 10, 60, 2, -1, 0),
        (1, "material.elasticity", 10, 30, 3, -1, 0),
        (1, "aten::mul", 12, 20, 4, 5, 0),
        (1, "cudaLaunchKernel", 15, 16, 101, -1, 0),
        (1, "cudaLaunchKernel", 40, 41, 102, -1, 0),
        (1, "cudaLaunchKernel", 70, 71, 103, -1, 0),
        (1, "cudaLaunchKernel", 110, 111, 104, -1, 0),
        (1, "cudaStreamSynchronize", 120, 125, 120, -1, 0),
        (1, "train.read", 130, 150, 5, -1, 0),
        (1, "cudaStreamSynchronize", 140, 145, 121, -1, 0),
        (2, NODE + "MulBackward0", 200, 260, 6, 5, 1),
        (2, "MulBackward0", 201, 259, 7, 5, 1),
        (2, "cuLaunchKernel", 210, 211, 105, -1, 0),
        (2, NODE + "_PackedSubstepBackward", 270, 350, 8, 9, 1),
        (2, "mpm.substep.bwd", 275, 345, 9, -1, 0),
        (2, "cudaLaunchKernel", 280, 281, 106, -1, 0),
        (2, NODE + "AddBackward0", 360, 380, 10, 77, 1),
        (2, "cudaLaunchKernel", 365, 366, 108, -1, 0),
    ]
    device = [(1000, 100, 101), (1050, 150, 102), (1300, 50, 103), (1400, 50, 104),
              (1500, 100, 105), (1600, 100, 106), (1800, 50, 107), (1900, 50, 108)]
    return device, host


def test_charge_rule():
    device, host = synthetic()
    out = spantrace.charge(device, host, 900, 1200e-9)
    ns = {p: [round(i * 1e9), round(b * 1e9), n] for p, (i, b, n) in out["by_path"].items()}
    assert ns == {
        "train.loss/mpm.substep/material.elasticity": [0, 100, 0],
        "train.loss/mpm.substep": [0, 100, 0],
        "train.loss": [100, 50, 0],
        "untraced": [200, 150, 0],
        "train.loss/mpm.substep/material.elasticity.bwd": [50, 100, 0],
        "mpm.substep.bwd": [0, 100, 0],
        "train.read": [0, 0, 1],
    }
    assert out["lead_s"] == pytest.approx(100e-9)
    assert out["trail_s"] == pytest.approx(150e-9)
    charged = sum(i + b for i, b, _ in out["by_path"].values())
    assert charged + out["lead_s"] + out["trail_s"] == pytest.approx(1200e-9)
    assert spantrace.idle_by_span(out["by_path"], top=2) == [
        ["untraced", pytest.approx(200e-9), pytest.approx(150e-9)],
        ["train.loss", pytest.approx(100e-9), pytest.approx(50e-9)]]


def test_charge_without_device_operations():
    out = spantrace.charge([], [(1, "train.loss", 0, 10, 1, -1, 0)], 0, 0.5)
    assert out == {"by_path": {}, "lead_s": 0.5, "trail_s": 0.0}


@pytest.mark.parametrize("path,key", [
    ("train.loss/loss.frame/mpm.substep/mpm.step", "mpm"),
    ("train.loss/loss.frame/mpm.substep/material.elasticity", "material"),
    ("loss.frame/mpm.substep/material.plasticity.bwd", "material"),
    ("mpm.substep.bwd/mpm.step.bwd", "mpm"),
    ("train.loss/loss.frame/raster.view/raster.pairs.bwd", "render"),
    ("binding.xyz", "render"),
    ("train.optim/train.read", "trainer"),
    ("train.loss/loss.frame.bwd", None),
    ("untraced", None),
])
def test_innermost_owned_span(path, key):
    assert spantrace.owner(path) == key


def test_span_metric_readers():
    by_path = {
        "train.loss/mpm.substep/material.elasticity": [0.01, 0.02, 0],
        "train.loss/mpm.substep": [0.03, 0.0, 2],
        "train.loss/loss.frame/raster.view/raster.pairs": [0.006, 0.0, 0],
        "binding.xyz": [0.0, 0.006, 0],
        "train.optim": [0.001, 0.001, 0],
        "train.optim/train.read": [0.002, 0.0, 3],
        "untraced": [0.05, 0.05, 0],
    }
    trace = {"by_path": by_path, "window_s": 0.4, "frames": 2,
             "counters": {"layouts.refreshed": 40, "layouts.rebuilt": 3}}
    cfg = {"views": [{}, {}, {}]}
    read = lambda n, kind: harness.reader(n)(types.SimpleNamespace(kind=kind, cfg=cfg, trace=trace))
    assert read("material_ms_per_frame.train", "train") == pytest.approx(15.0)
    assert read("mpm_ms_per_frame.serve", "serve") == pytest.approx(15.0)
    assert read("render_ms_per_frame.train", "train") == pytest.approx(6.0)
    assert read("raster_ms_per_view.serve", "serve") == pytest.approx(2.0)
    assert read("trainer_ms_per_epoch.train", "train") == pytest.approx(4.0)
    assert read("host_syncs_per_frame.train", "train") == pytest.approx(2.5)
    assert read("layout_rebuild_share.serve", "serve") == pytest.approx(7.5)
    assert read("untraced_share.train", "train") == pytest.approx(25.0)
    assert read("material_ms_per_frame.serve", "train") is None
    trace.update(by_path={}, counters={})
    for entry in span_entries(harness.load_json(harness.HERE.parent / "BENCHMARK.json")):
        if entry["name"] in ("sim_ms_per_frame.serve", "render_ms_per_view.serve"):
            continue  # the harness's own spans, read from the window's clock
        kind = entry["name"].rsplit(".", 1)[1]
        assert read(entry["name"], kind) is None, entry["name"]


def span_entries(m):
    """The per-layer metrics read from the port's spans and counters."""
    return [e for e in m["per_layer"] if e["source"] in ("program_span", "program_counter")]


def test_span_metric_entries():
    """The span metrics' entries in ``BENCHMARK.json``: their keys, one
    cell each that reports what the metric moves, and a reader for each."""
    m = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    entries = [e for e in span_entries(m) if e["name"] not in ("sim_ms_per_frame.serve",
                                                                "render_ms_per_view.serve")]
    assert len(entries) == 13
    e2e = {e["name"]: e.get("workloads") for e in m["end_to_end"]}
    layers = {e["layer"] for e in m["per_layer"]}
    assert {"material", "trainer"} <= layers
    for e in entries:
        assert set(e) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert e["layer"] in layers
        assert len(e["workloads"]) == 1 and e["workloads"][0] in e2e[e["moves"]]
        assert (harness.HERE / "metrics" / f"{e['name']}.py").is_file()


@pytest.mark.parametrize("cell", ["bun.train", "bun.serve"])
def test_traced_cell_with_spans(cell):
    """A tiny cell traced on the CPU: no device operations to charge, so
    the span metrics are silent but for the layouts' counters, and the
    result line's breakdown carries ``idle_by_span``."""
    res = harness.run(cell, SEED, 0.3, True, torch.device("cpu"), time.perf_counter(),
                      manifest=manifest(), overrides=tiny, limits=TINY_LIMITS[cell.split(".")[1]])
    assert res["correct"], res["checks"]
    kind = cell.split(".")[1]
    share = res["metrics"][f"layout_rebuild_share.{kind}"]["value"]
    assert 0.0 <= share <= 100.0
    assert not any(n.startswith(("material_ms", "mpm_ms", "untraced")) for n in res["metrics"])
    if kind == "train":
        assert res["metrics"]["frame_ms.train"]["value"] > 0.0
    assert res["breakdown"]["idle_by_span"] == []
    json.dumps(res)
