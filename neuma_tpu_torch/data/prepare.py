"""Simulation data preparation: prune Gaussians, sample particles,
compute the two-pass binding, persist the artifacts.

Counterpart of ``neuma_tpu/data/prepare.py`` (``prepare_simulation_data``,
``load_prepared``), the reference's ``prepare_simulation_data``
(``modules/tune/utils.py:212-320``): idempotent (skips when kernels.ply,
particles.ply and bindings.npz exist); prunes opacity <= threshold;
samples particles from a point cloud or a mesh; shuffles and downsamples
them with ``default_rng(seed)``; a first binding pass finds the Gaussians
with no bound particle and injects their centres as extra particles; a
second pass computes the final weighted binding. The binding runs on
``device`` through ``render/binding.py::compute_binding_table``; the
files are the JAX package's.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..render.binding import BindingTable, compute_binding_table
from ..render.gaussians import GaussianPack
from .ply import load_ply_points, save_ply_points
from .sampling import sample_particles

PREPARED_FILES = ("kernels.ply", "particles.ply", "bindings.npz")


def prepare_simulation_data(
    save_dir: Path,
    kernels_path: Path,
    particles_path: Optional[Path] = None,
    mesh_path: Optional[Path] = None,
    mesh_sample_mode: str = "volumetric",
    mesh_sample_resolution: int = 30,
    sh_degree: int = 3,
    opacity_thres: float = 0.02,
    particles_downsample_factor: int = 3,
    confidence: float = 0.95,
    max_particles: int = 10,
    seed: int = 0,
    device=None,
) -> None:
    """The binding runs on ``cuda`` unless ``device="cpu"``."""
    device = resolve_device(device)
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    if all((save_dir / f).is_file() for f in PREPARED_FILES):
        print("Data already prepared. Skipping data preparation.")
        return

    print("Start preparing data for simulation.")
    gaussians = GaussianPack.from_ply(kernels_path, sh_degree, device=device)
    retain = (gaussians.get_opacity.squeeze(-1) > opacity_thres).cpu().numpy()
    print(f"Gaussians after pruning low opacity kernels: {retain.sum()}")
    gaussians = gaussians.masked(retain)
    gaussians.to_ply(save_dir / "kernels.ply")

    rng = np.random.default_rng(seed)
    if particles_path is not None:
        particles = load_ply_points(particles_path).astype(np.float32)
    elif mesh_path is not None:
        particles = sample_particles(
            mesh_path, mesh_sample_mode, mesh_sample_resolution, rng
        ).astype(np.float32)
    else:
        raise ValueError("Either 'particles_path' or 'mesh_path' must be provided.")

    # random downsample (reference tune/utils.py:270-273)
    perm = rng.permutation(particles.shape[0])
    particles = particles[perm][::particles_downsample_factor]

    def bind(points: np.ndarray) -> BindingTable:
        with torch.no_grad():
            return compute_binding_table(
                gaussians,
                torch.as_tensor(points, device=device),
                confidence=confidence,
                max_particles=max_particles,
            )

    # pass 1: kernels with no bound particle get their centre as a particle
    unbound = (bind(particles).counts() == 0).cpu().numpy()
    to_clone = gaussians.xyz.cpu().numpy()[unbound]
    print(f"Particles to be added: {to_clone.shape}")
    particles = np.concatenate([particles, to_clone], axis=0)

    # pass 2: the final weighted binding
    table = bind(particles)
    counts = table.counts().cpu().numpy().astype(np.int32)  # the JAX package's dtype
    if not np.all(counts > 0):
        raise RuntimeError(f"{(counts == 0).sum()} kernels still unbound after injection")

    save_ply_points(save_dir / "particles.ply", particles)
    table.save(save_dir / "bindings.npz")
    np.save(save_dir / "n_particles.npy", counts)
    print(
        f"Data preparation done: {particles.shape[0]} particles, "
        f"avg binding {counts.mean():.1f}, max {counts.max()}"
    )


def load_prepared(save_dir: Path, sh_degree: int = 3, device=None):
    """(gaussians, particles (P, 3) numpy, binding table) from a prepared
    folder; the tensors on ``cuda`` unless ``device="cpu"``."""
    device = resolve_device(device)
    save_dir = Path(save_dir)
    gaussians = GaussianPack.from_ply(save_dir / "kernels.ply", sh_degree, device=device)
    particles = load_ply_points(save_dir / "particles.ply")
    table = BindingTable.load(save_dir / "bindings.npz", device=device)
    return gaussians, particles, table
