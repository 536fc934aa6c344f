"""Each cell's path at a tiny size on the CPU, through the port's plain
paths, against the plain reference; the planted faults must come out
not correct; the control (TF32) needs a card."""
import copy
import time

import pytest
import torch

from perfbench import control, harness

CELLS = ("bun.train", "bouncyball.train", "bun.serve")
SEED = 2 ** 31 + 77


def tiny(cfg, traffic):
    cfg = copy.deepcopy(cfg)
    cfg["scene"].update(particles=300, gaussians=200)
    cfg["sim"]["num_grids"] = 32
    cfg["sim"]["substeps"] = min(cfg["sim"]["substeps"], 2)
    cfg["train"]["num_frames"] = 2
    cfg["raster"]["max_pairs"] = 4096
    for v in cfg["views"]:
        v["width"], v["height"] = (48, 32) if v["width"] > v["height"] else (40, 40)
    traffic = dict(traffic, rollout_steps=8, warmup_frames=2, checked_range=3, checked_frames=2,
                   traced_frames=2)
    return cfg, traffic


def manifest():
    """BENCHMARK.json with the `bouncyball.train` cell, which its spread
    kept out of the benchmark (PERF.md), so that its path stays tested."""
    m = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    m["workloads"].append({"name": "bouncyball.train", "config": "bouncyball", "traffic": "train",
                           "chips": 1, "why": "tests only"})
    for e in m["end_to_end"]:
        if "bun.train" in e.get("workloads", []):
            e["workloads"].append("bouncyball.train")
    return m


# The tiny scenes' own limits: a few hundred particles on the CPU's plain
# kernels average less than the cells' tens of thousands (the cells' limits
# and their readings are in perfbench/limits/); every fault reads 1e-2 or
# more here.
TINY_LIMITS = {"train": {"loss_gap": {"limit": 1e-5}, "grad_gap": {"limit": 1e-3},
                         "change_gap": {"limit": 1e-3}},
               "serve": {"state_gap": {"limit": 1e-3}, "image_rmse": {"limit": 1e-4}}}


def run(cell, trace=False, seconds=0.3):
    kind = "train" if cell.endswith("train") else "serve"
    return harness.run(cell, SEED, seconds, trace, torch.device("cpu"), time.perf_counter(),
                       manifest=manifest(), overrides=tiny, limits=TINY_LIMITS[kind])


def result_shape(res):
    assert list(res)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(res)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_matches_reference(cell):
    res = run(cell)
    result_shape(res)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = set(res["metrics"])
    assert "setup_s" in names
    assert names == ({"train_peak_gib", "setup_s"} if cell.endswith("train")
                     else {"serve_frame_ms", "serve_frame_p95_ms", "setup_s"})
    assert all(m["value"] >= 0 for m in res["metrics"].values())


def test_traced_serve_reads_its_layers():
    res = run("bun.serve", trace=True)
    result_shape(res)
    assert res["correct"]
    assert {"sim_ms_per_frame.serve", "render_ms_per_view.serve", "idle_share.serve"} <= set(
        res["metrics"])
    assert not set(res["metrics"]) & {"serve_frame_ms", "idle_share.train"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps", "idle_by_span"}


@pytest.mark.parametrize("cell,what", [
    ("bun.train", "unchanged"), ("bun.train", "half"), ("bun.train", "altered"),
    ("bouncyball.train", "half"), ("bun.serve", "half"), ("bun.serve", "altered"),
])
def test_fault_is_not_correct(cell, what):
    kind = "train" if cell.endswith("train") else "serve"
    with control.planted(kind, what):
        res = run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bun.train", "bun.serve"])
def test_control_fails_on_a_card(cell):
    """The control (the reference in TF32 in the port's place) at the
    cell's own size, one seed: it fails one of the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 exists only on a CUDA device")
    import io
    import json
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        control.main(["--workload", cell, "--what", "control", "--seconds", "2", "--seeds",
                      str(SEED)])
    numbers = json.loads(buf.getvalue().strip().splitlines()[-1])["numbers"]
    ok, _ = harness.check.judge(numbers, harness.load_json(harness.HERE / "limits" / f"{cell}.json"))
    assert not ok, numbers
