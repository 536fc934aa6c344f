"""One run of one cell: set-up, the timed window, the check and the
result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix;
both are found by name, ``configs/<config>.json`` and
``traffic/<traffic>.json``, and the traffic's ``kind`` picks the runner in
``program.py``. With ``--trace 0`` the line carries the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, each read by
``metrics/<metric>.py`` (a module with ``read(ctx)`` that returns a number
or None when it finds nothing to read) from the stretch that
``spantrace.SpanTracer`` traced after the window and charged to the
port's spans. The limits of the check are ``limits/<cell>.json``. Every
line records the host beside the card (``host.py``).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from . import check, host, inputs, program, reference, roofline, spantrace

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "neuma_tpu"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, name: str):
    for w in manifest["workloads"]:
        if w["name"] == name:
            return (w, load_json(HERE / "configs" / f"{w['config']}.json"),
                    load_json(HERE / "traffic" / f"{w['traffic']}.json"))
    raise SystemExit(f"unknown workload {name!r}")


def forbidden_modules() -> set:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole."""
    return {m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def frame_latencies(win) -> list:
    t = [win.t_start] + list(win.ends)
    return [b - a for a, b in zip(t[:-1], t[1:])]


def end_to_end(kind: str, win, setup_s: float) -> dict:
    span = win.ends[-1] - win.t_start
    frames = len(win.ends) * win.frames_per_unit
    out = {}
    if kind == "train":
        out["train_frame_ms"] = (1e3 * span / frames, "ms")
        out["train_peak_gib"] = (win.peak_bytes / 2 ** 30, "GiB")
    else:
        out["serve_frame_ms"] = (1e3 * span / frames, "ms")
        out["serve_frame_p95_ms"] = (1e3 * float(np.percentile(frame_latencies(win), 95)), "ms")
    out["setup_s"] = (setup_s, "s")
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(cell: str, seed: int, seconds: float, trace: bool, device, t0: float,
        manifest: dict = None, overrides=None, limits: dict = None) -> dict:
    """One run; tests may pass ``overrides`` (edits of the configuration and
    traffic) and the ``limits`` of their smaller sizes."""
    manifest = manifest or load_json(HERE.parent / "BENCHMARK.json")
    work, cfg, traffic = find_cell(manifest, cell)
    if overrides is not None:
        cfg, traffic = overrides(cfg, traffic)
    kind = traffic["kind"]
    torch.set_num_threads(int(traffic["torch_threads"]))
    from neuma_tpu_torch import kernels

    marks = {"import": time.perf_counter()}
    raw = inputs.make(cfg, seed, device, with_gt=kind == "train",
                      lora_b_std=float(traffic["lora_b_std"]))
    marks["inputs"] = time.perf_counter()
    scene = program.build_scene(cfg, raw, device)
    marks["scene"] = time.perf_counter()
    tracer = spantrace.SpanTracer(device, kernels.launches) if trace else None
    record = host.Record(device)

    def on_window():
        record.start()
        gc.collect()
        gc.freeze()
        gc.disable()
        marks["window"] = time.perf_counter()

    if kind == "train":
        win = program.train(cfg, traffic, raw, scene, seconds, tracer, device, on_window,
                            record.stop)
    else:
        # the rollout's first frame (the start), and frames drawn from the seed
        rng = random.Random(seed)
        sample = [0] + sorted(rng.sample(range(1, int(traffic["checked_range"])),
                                         int(traffic["checked_frames"]) - 1))
        win = program.serve(cfg, traffic, raw, scene, seconds, tracer, device, on_window, sample,
                            record.stop)
    setup_s = marks["window"] - t0
    print("setup_s {:.3f}: imports {:.3f}, inputs {:.3f}, scene {:.3f}, warm-up {:.3f}".format(
        setup_s, marks["import"] - t0, marks["inputs"] - marks["import"],
        marks["scene"] - marks["inputs"], marks["window"] - marks["scene"]), file=sys.stderr)
    lat = frame_latencies(win)
    q = np.percentile(lat, [10, 50, 90, 100]) * 1e3
    print("window: {} units in {:.3f} s; unit ms p10 {:.2f} p50 {:.2f} p90 {:.2f} max {:.2f}; "
          "first {}; last {}; load {}".format(
              len(lat), win.ends[-1] - win.t_start, *q,
              [round(1e3 * x, 1) for x in lat[:5]], [round(1e3 * x, 1) for x in lat[-5:]],
              [round(x, 2) for x in os.getloadavg()]), file=sys.stderr)
    loaded = forbidden_modules()
    del scene
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if kind == "train":
        ref = reference.train(raw, cfg, steps=int(traffic["checked_steps"]))
        numbers = check.train_numbers(win.checked, ref)
    else:
        numbers = check.serve_numbers(win.checked["frames"], win.checked["host"], raw, cfg)
    limits = limits or load_json(HERE / "limits" / f"{cell}.json")
    correct, rows = check.judge(numbers, limits)

    metrics = {}
    result = {"correct": bool(correct) and win.failed == 0 and not loaded,
              "attempted": len(win.ends), "failed": win.failed, "metrics": metrics}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(work["chips"]), "memory_peak_bytes": int(win.peak_bytes)}
    if not trace:
        # the cell's end-to-end metrics as BENCHMARK.json lists them; what it
        # lists per layer only (a window's frame time on a drifting host) is
        # left to the traced run's readers
        listed = {m["name"] for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])}
        for name, (value, unit) in end_to_end(kind, win, setup_s).items():
            if name in listed:
                metrics[name] = {"value": value, "unit": unit}
    else:
        tr = win.traced
        ctx = types.SimpleNamespace(
            cell=cell, kind=kind, cfg=cfg, traffic=traffic, trace=tr, roofline=roofline,
            frame_s=(win.ends[-1] - win.t_start) / (len(win.ends) * win.frames_per_unit),
            pairs=(reference.train_pairs(raw, cfg, tr["leaves"]) if kind == "train"
                   else reference.serve_pairs(raw, cfg, tr["start"], tr["frames"])))
        for entry in manifest["per_layer"]:
            if cell not in entry.get("workloads", [cell]):
                continue
            value = reader(entry["name"])(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"],
                               "idle_by_span": tr["idle_by_span"]}
    dev["power"] = power_limit() if device.type == "cuda" else "cpu"
    dev["host"] = record.line()
    result["device"] = dev
    result["checks"] = {name: {"value": value, "limit": lim} for name, value, lim in rows}
    return result


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    manifest = load_json(HERE.parent / "BENCHMARK.json")
    work, _, _ = find_cell(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(work["chips"]):
        print(f"needs {work['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), device, t0, manifest)
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded modules of JAX or of the JAX package: {sorted(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
