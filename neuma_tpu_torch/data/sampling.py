"""Particle sampling from meshes: uniform (grid + point-in-mesh),
surface (area-weighted + jittered copy) and volumetric (SPH-style
interior lattice), dispatched by ``sample_particles``.

Counterpart of ``neuma_tpu/data/sampling.py``, the same numpy code. The
volumetric mode runs the repository's native sampler
``native/volume_sampler/volume_sampler`` as a subprocess (built with
``make`` on first use when the binary is absent), with the Python HCP
lattice as the fallback when it cannot run.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from .mesh import TriMesh, load_mesh

NATIVE_SAMPLER = (
    Path(__file__).resolve().parent.parent.parent
    / "native"
    / "volume_sampler"
    / "volume_sampler"
)
# Which route the last volumetric_sampling call took: "native" (the
# binary) or "hcp" (the Python fallback); None before the first call.
last_volumetric_route: Optional[str] = None


def uniform_sampling(mesh: TriMesh, resolution: int) -> np.ndarray:
    """Grid + point-in-mesh (reference tune/utils.py:157-168)."""
    bounds = mesh.bounds.copy()
    verts = mesh.vertices - bounds[0]
    shifted = TriMesh(vertices=verts, faces=mesh.faces)
    upper = verts.max(0)
    dims = np.linspace(np.zeros(3), upper, resolution).T
    grid = np.stack(
        np.meshgrid(*dims, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    p = grid[shifted.contains(grid)]
    return p + bounds[0]


def surface_sampling(
    mesh: TriMesh, resolution: int, rng=None
) -> np.ndarray:
    """Surface points + jittered copy (reference tune/utils.py:194-201)."""
    rng = rng or np.random.default_rng(0)
    points = mesh.sample_surface(resolution // 2, rng)
    noise = rng.normal(0, 0.001, points.shape)
    return np.concatenate([points, points + noise], axis=0)


def volumetric_sampling(
    mesh: TriMesh,
    resolution: int,
    work_dir: Optional[Path] = None,
) -> np.ndarray:
    """SPH-style interior sampling at radius 0.5/resolution inside the
    normalized unit box (reference tune/utils.py:171-191 + sph.py:6-28).

    Uses the native C++ sampler when built; falls back to a hexagonal
    close-packed lattice + point-in-mesh filter in Python (the same
    behavioral contract: near-uniform interior points at given radius).
    Sets ``last_volumetric_route``."""
    global last_volumetric_route
    bounds = mesh.bounds.copy()
    center = bounds.mean(0)
    extent = (bounds[1] - bounds[0]).max()
    verts_norm = (mesh.vertices - center) / extent + 0.5
    norm_mesh = TriMesh(vertices=verts_norm, faces=mesh.faces)
    radius = 1.0 / resolution * 0.5

    p = None
    _ensure_native_sampler()
    if NATIVE_SAMPLER.is_file() and os.access(NATIVE_SAMPLER, os.X_OK):
        with tempfile.TemporaryDirectory(dir=work_dir) as td:
            obj = Path(td) / "temp.obj"
            out = Path(td) / "temp.vtk"
            norm_mesh.export_obj(obj)
            subprocess.run(
                [
                    str(NATIVE_SAMPLER),
                    "-i", str(obj),
                    "-o", str(out),
                    "-r", str(radius),
                    "--res", f"{resolution},{resolution},{resolution}",
                ],
                check=True,
                capture_output=True,
            )
            p = read_vtk_points(out)
        last_volumetric_route = "native"
    if p is None:
        p = _hcp_interior_points(norm_mesh, radius)
        last_volumetric_route = "hcp"

    # undo normalization
    return (p - 0.5) * extent + center


_native_build_attempted = False


def _ensure_native_sampler() -> None:
    """Build the C++ sampler on first use (the binary is not committed;
    `make -C native/volume_sampler` produces it from source). Failures
    are non-fatal — the Python HCP fallback covers the contract."""
    global _native_build_attempted
    if NATIVE_SAMPLER.is_file() or _native_build_attempted:
        return
    _native_build_attempted = True
    makefile = NATIVE_SAMPLER.parent / "Makefile"
    if not makefile.is_file():
        return
    try:
        subprocess.run(
            ["make", "-C", str(NATIVE_SAMPLER.parent)],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (subprocess.SubprocessError, OSError) as e:
        print(f"note: native volume sampler build failed ({e}); "
              f"using the Python fallback")


def _hcp_interior_points(mesh: TriMesh, radius: float) -> np.ndarray:
    """Hexagonal close-packed lattice clipped to the mesh interior (the
    particle arrangement SPlisHSPlasH's VolumeSampling produces)."""
    diam = 2.0 * radius
    bounds = mesh.bounds
    xs = np.arange(bounds[0][0], bounds[1][0] + diam, diam * 1.0)
    ys = np.arange(bounds[0][1], bounds[1][1] + diam, diam * np.sqrt(3) / 2)
    zs = np.arange(bounds[0][2], bounds[1][2] + diam, diam * np.sqrt(6) / 3)
    pts = []
    for j, y in enumerate(ys):
        for k, z in enumerate(zs):
            offset_x = (j % 2) * radius + (k % 2) * radius
            row = np.stack(
                [
                    xs + offset_x,
                    np.full_like(xs, y),
                    np.full_like(xs, z),
                ],
                axis=1,
            )
            pts.append(row)
    pts = np.concatenate(pts)
    return pts[mesh.contains(pts)]


def read_vtk_points(path) -> np.ndarray:
    """Read POINTS from a legacy ASCII/binary VTK polydata file."""
    with open(path, "rb") as f:
        header = f.readline()  # version
        f.readline()  # title
        fmt = f.readline().strip().decode()
        f.readline()  # DATASET
        points_line = f.readline().split()
        n = int(points_line[1])
        dtype = points_line[2].decode().lower()
        np_dtype = np.float32 if dtype == "float" else np.float64
        if fmt == "ASCII":
            vals = []
            while len(vals) < 3 * n:
                vals.extend(float(x) for x in f.readline().split())
            return np.array(vals[: 3 * n]).reshape(n, 3)
        data = np.frombuffer(
            f.read(3 * n * np_dtype().itemsize), dtype=np.dtype(np_dtype).newbyteorder(">")
        )
        return data.astype(np.float64).reshape(n, 3)


def sample_particles(
    mesh_path,
    mode: str,
    resolution: int,
    rng=None,
) -> np.ndarray:
    """Dispatch matching prepare_simulation_data's mesh_sample_mode
    (reference tune/utils.py:258-265)."""
    mesh = load_mesh(mesh_path)
    if mode == "uniform":
        return uniform_sampling(mesh, resolution)
    if mode == "volumetric":
        return volumetric_sampling(mesh, resolution)
    if mode == "surface":
        return surface_sampling(mesh, resolution, rng)
    raise ValueError(f"Unsupported mesh sample mode: {mode}")
