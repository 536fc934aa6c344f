"""The benchmark's own tests: run from the checkout's root with
``python -m pytest perfbench/tests``. They import no JAX; a test marked
``cuda`` needs a card and skips without one."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips with a reason without one")
