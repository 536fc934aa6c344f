"""Run one cell traced, with its stretch charged to the port's spans.

    python3 perfbench/trace_spans.py --workload <cell> --seed <n> --seconds <s> [--spans 0|1]

Run from the root of a checkout. The run is ``run.py``'s ``--trace 1`` run
of the cell, with ``spantrace.SpanTracer`` in place of ``devtrace.Tracer``
and the per-layer metrics of ``span_metrics.json`` read beside those of
``BENCHMARK.json``. The result line adds ``breakdown.idle_by_span`` (the
10 paths with the most idle time: path, idle s, busy s), ``charge`` (the
charged seconds, the idle time before the first device operation and
after the last, and the traced wall) and ``traced_frames``. With
``--spans 0`` the port's spans stay off while the profiler runs, so that
the traced wall with and without them can be compared.
"""
import os
import sys
import time


def traced_run(cell: str, seed: int, seconds: float, device, t0: float, spans: bool = True,
               **kwargs) -> dict:
    """``harness.run`` of ``cell`` with ``--trace 1`` and the span
    metrics; ``kwargs`` go to ``harness.run`` (tests pass their sizes)."""
    import types

    from perfbench import devtrace, harness, spantrace

    manifest = kwargs.pop("manifest", None) or harness.load_json(
        harness.HERE.parent / "BENCHMARK.json")
    manifest = dict(manifest, per_layer=manifest["per_layer"] + harness.load_json(
        harness.HERE / "span_metrics.json"))
    _, cfg, traffic = harness.find_cell(manifest, cell)
    if "overrides" in kwargs:
        cfg, traffic = kwargs["overrides"](cfg, traffic)
    from neuma_tpu_torch.utils import profiling

    tracers, flag, real = [], profiling._autograd_profiler, devtrace.Tracer

    def tracer(*args):
        tracers.append(spantrace.SpanTracer(*args))
        return tracers[-1]

    devtrace.Tracer = tracer
    if not spans:
        profiling._autograd_profiler = types.SimpleNamespace(_is_profiler_enabled=False)
    try:
        result = harness.run(cell, seed, seconds, True, device, t0, manifest, **kwargs)
    finally:
        devtrace.Tracer, profiling._autograd_profiler = real, flag
    tr = tracers[-1].summary
    result["breakdown"]["idle_by_span"] = tr["idle_by_span"]
    charged = sum(idle + busy for idle, busy, _ in tr["by_path"].values())
    result["charge"] = {"charged_s": charged, "lead_s": tr["lead_s"], "trail_s": tr["trail_s"],
                        "window_s": tr["window_s"]}
    result["traced_frames"] = (int(traffic["traced_frames"]) if traffic["kind"] == "serve"
                               else int(cfg["train"]["num_frames"]))
    return result


def main(argv, t0: float) -> int:
    import argparse
    import json

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    result = traced_run(args.workload, args.seed, args.seconds, torch.device("cuda", 0), t0,
                        spans=bool(args.spans))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    T0 = time.perf_counter()
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import perfbench.run  # noqa: E402,F401  (the environment that run.py sets)

    sys.exit(main(sys.argv[1:], T0))
