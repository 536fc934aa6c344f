"""PLY I/O without plyfile: vertex elements of a PLY file as per-property
arrays, float32 binary writes, and bare xyz point clouds.

Counterpart of ``neuma_tpu/data/ply.py`` (``load_ply``, ``save_ply``,
``load_ply_points``, ``save_ply_points``), the same numpy code; the
Gaussian PLY layout on top of it is ``render/gaussians.py``'s.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

_PLY_DTYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def load_ply(path) -> Dict[str, np.ndarray]:
    """Read the first (vertex) element of a PLY file into a dict of
    per-property arrays."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        names: List[str] = []
        types: List[str] = []
        count = 0
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    count = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError("list properties unsupported for vertex")
                types.append(tokens[1])
                names.append(tokens[2])
            elif tokens[0] == "end_header":
                break

        if fmt == "binary_little_endian":
            dtype = np.dtype(
                [(n, "<" + _PLY_DTYPES[t]) for n, t in zip(names, types)]
            )
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
        elif fmt == "binary_big_endian":
            dtype = np.dtype(
                [(n, ">" + _PLY_DTYPES[t]) for n, t in zip(names, types)]
            )
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
        elif fmt == "ascii":
            rows = np.loadtxt(
                f, max_rows=count, dtype=np.float64, ndmin=2
            )
            return {
                n: rows[:, i].astype(_PLY_DTYPES[t])
                for i, (n, t) in enumerate(zip(names, types))
            }
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")
    return {n: np.ascontiguousarray(data[n]) for n in names}


def save_ply(path, props: Dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian PLY with float32 vertex properties in
    dict order."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    names = list(props.keys())
    n = len(next(iter(props.values())))
    dtype = np.dtype([(name, "<f4") for name in names])
    data = np.empty(n, dtype=dtype)
    for name in names:
        data[name] = np.asarray(props[name], np.float32).reshape(n)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(data.tobytes())


def load_ply_points(path) -> np.ndarray:
    d = load_ply(path)
    return np.stack(
        [d["x"], d["y"], d["z"]], axis=1
    ).astype(np.float32)


def save_ply_points(path, points: np.ndarray) -> None:
    points = np.asarray(points, np.float32)
    save_ply(
        path, {"x": points[:, 0], "y": points[:, 1], "z": points[:, 2]}
    )
