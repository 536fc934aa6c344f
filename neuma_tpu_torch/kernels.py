"""Build, load and count the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain ``extern "C"`` interface. On
first use each is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, the objects are linked into
``build/kernels/<hash>/libneuma_kernels.so`` at the repository root, and
the library is loaded with ``ctypes``. The hash covers the sources and
the flags, so an edited source rebuilds. Nothing here runs at import
time: the CPU tests import every module and never build.

``launches`` counts kernel launches by name (``p2g`` K1, ``g2p`` K2,
``g2p_derivs`` K3, ``composite`` K4, ``composite_bwd`` K5); each wrapper
adds one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

launches: collections.Counter = collections.Counter()
build_seconds: Optional[float] = None
build_log: str = ""
_lib: Optional[ctypes.CDLL] = None

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (every pointer and the stream are c_void_p).
_SIGNATURES = {
    # payload, c2b, M, NB, scratch, out, stream
    "neuma_p2g_fwd": [P, P, I, I, P, P, P],
    # payload, slabs, c2b, rows, chunk, dx, out, stream
    "neuma_g2p_gather": [P, P, P, I, I, F, P, P],
    # payload, slabs, c2b, rows, chunk, dx, inv_dx, out, stream
    "neuma_g2p_gather_derivs": [P, P, P, I, I, F, F, P, P],
    # pair_feats, tile_start, counts, num_tiles, tiles_x, T, C, last, stream
    "neuma_composite_fwd": [P, P, P, I, I, P, P, P, P],
    # pair_feats, tile_start, counts, num_tiles, tiles_x, T, last, dT, dC, out,
    # scratch, P, stream
    "neuma_composite_bwd": [P, P, P, I, I, P, P, P, P, P, P, I, P],
    # 4-byte words of the scratch each kernel needs: (M, NB) and (P, num_tiles)
    "neuma_p2g_scratch_words": [I, I],
    "neuma_composite_bwd_scratch_words": [I, I],
    # slots per (tile, segment) work item of K5
    "neuma_k5_seg": [],
}


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path("/usr/local/cuda/bin/nvcc")
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build() -> Path:
    global build_seconds, build_log
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for src in sources + sorted(_CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = _BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "libneuma_kernels.so"
    if lib_path.exists():
        build_seconds = 0.0
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *_ARCH, *_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs = []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            build_log = "\n".join(logs)
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
    tmp = out_dir / f"libneuma_kernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, *_ARCH, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return lib_path


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream (the kernels
    launch on it). The private getter returns the integer without building
    a ``torch.cuda.Stream``, which the small kernels' wrappers would pay
    for on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned after a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} after launch")


def require(t, name: str, shape, dtype) -> None:
    """Wrapper-side argument checks: CUDA, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
