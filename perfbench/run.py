"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cells, metrics and bounds are in
``BENCHMARK.json``; ``perfbench/harness.py`` says how a run goes.
"""
import os
import sys
import time

T0 = time.perf_counter()
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkout's root, not this folder, heads the import path: the port
# imports from it, and this folder's module names must not shadow others.
sys.path[0] = CHECKOUT
BUILD = os.path.join(CHECKOUT, "build")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = os.path.join(BUILD, sub)
os.environ["USE_FLAX"] = "0"
os.environ["OMP_NUM_THREADS"] = "1"

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
