"""Particle sharding of the simulation over a ``torch.distributed`` world.

Counterpart of ``neuma_tpu/parallel/sharding.py`` (``make_mesh``,
``pad_to_multiple``, ``pad_scene_particles``, ``shard_particles``,
``replicate``, ``make_sharded_sim_step``, ``tile_sharding``). Each rank
holds a contiguous slice of the particles and a replicated grid: K1
scatters the rank's particles into per-block sums, the sums are added
over the axis in rank order (the all-reduce that XLA inserts in the JAX
package), and every
rank runs the slab chain's halo add, ``grid_op_slabs`` and K2 on its own
particles (on a grid of at most 24 cells, the dense grid is summed
instead). The step is differentiable: its adjoint adds the ranks' shares
of the grid cotangent once and runs the rest on the shard. The grounding
rollout's ``grid_mode="replicated"`` over a mesh runs it
(``train/grounding.py``). ``tile_sharding`` names the rasterizer's
third parallel axis beside particles and views: given as
``RasterConfig.tile_sharding`` it splits each view's image tiles over a
mesh axis, each rank running K4 and K5 over its own range of tiles
(``render/raster_kernel.py::composite_pairs_sharded``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..core.types import MPMConstants, ParticleState, Statics
from ..sim.mpm import mpm_step_diff
from ..utils.profiling import counters
from .distributed import Mesh, global_mesh


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """A one-axis mesh over the world (``n_devices``, when given, must be
    the world size: a rank is a device here)."""
    mesh = global_mesh((axis,))
    if n_devices is not None and n_devices != mesh.world:
        raise ValueError(f"a mesh of {n_devices} needs a world of {n_devices} ranks, "
                         f"not {mesh.world}")
    return mesh


def pad_to_multiple(arr: torch.Tensor, multiple: int, axis: int = 0):
    """Pad ``axis`` with zeros up to a multiple; returns (padded, n)."""
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr, n
    shape = list(arr.shape)
    shape[axis] = target - n
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis), n


def pad_scene_particles(state: ParticleState, statics: Statics, multiple: int):
    """Pad state and statics to a multiple of the mesh size: padded
    particles are disabled (they add nothing and stay frozen) and their F
    is the identity. Returns (state, statics, n)."""
    x, n = pad_to_multiple(state.x, multiple)
    pad = lambda t: pad_to_multiple(t, multiple)[0]
    F = pad(state.F)
    if F.shape[0] != n:
        F = torch.where((torch.arange(F.shape[0], device=F.device) < n)[:, None, None], F,
                        torch.eye(3, dtype=F.dtype, device=F.device))
    return (
        ParticleState(x=x, v=pad(state.v), C=pad(state.C), F=F),
        Statics(vol=pad(statics.vol), rho=pad(statics.rho), clip_bound=pad(statics.clip_bound),
                enabled=pad(statics.enabled)),
        n,
    )


def shard_particles(tree, mesh: Mesh, axis: str = "dp"):
    """This rank's contiguous slice of each per-particle tensor (a
    dataclass of tensors or one tensor), whose leading size divides by the
    axis size."""
    k, i = mesh.shape[axis], mesh.coord(axis)

    def cut(t):
        m = t.shape[0] // k
        return t[i * m:(i + 1) * m]

    if isinstance(tree, torch.Tensor):
        return cut(tree)
    return type(tree)(**{f: cut(getattr(tree, f)) for f in tree.__dataclass_fields__})


def replicate(tree, mesh: Mesh):
    """Rank 0's values on every rank (a dataclass of tensors or one
    tensor), so that replicated state is equal bit for bit."""
    def bcast(t):
        return mesh.all_gather(t.contiguous())[0]

    if isinstance(tree, torch.Tensor):
        return bcast(tree)
    return type(tree)(**{f: bcast(getattr(tree, f)) if isinstance(getattr(tree, f), torch.Tensor)
                         else getattr(tree, f) for f in tree.__dataclass_fields__})


def particle_grid_sum(mesh: Mesh, axis: str = "dp"):
    """The grid reduction of a particle shard, ``t -> mesh.all_sum(t,
    axis)`` (rank order): the step applies it to K1's per-block sums (or
    the dense grid) in the forward and to the grid cotangent in the
    backward. Each call adds its tensor's bytes and its host seconds
    (staging and waiting on the peers included) to ``grid_sum.*`` in
    ``utils.profiling.counters``."""

    def grid_sum(t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        out = mesh.all_sum(t, axis)
        counters["grid_sum.calls"] += 1
        counters["grid_sum.bytes"] += t.numel() * t.element_size()
        counters["grid_sum.seconds"] += time.perf_counter() - t0
        return out

    return grid_sum


@dataclasses.dataclass(frozen=True)
class TileSharding:
    """The rasterizer's image tiles split over ``axis`` of ``mesh``."""

    mesh: Mesh
    axis: str


def tile_sharding(mesh: Mesh, axis: str = "dp") -> TileSharding:
    """The split of the rasterizer's image-tile dimension over ``axis``:
    tiles composite independently, so passing it as
    ``RasterConfig.tile_sharding`` makes each rank of the axis composite
    its contiguous range of every view's tiles (K4 forward, K5 backward)
    and gather the ranges, while the per-Gaussian tables stay replicated.
    The third rasterizer parallel axis next to particles (dp) and views
    (vp)."""
    if axis not in mesh.shape:
        raise ValueError(f"tile axis {axis!r} is not an axis of the mesh {mesh.axis_names}")
    return TileSharding(mesh, axis)


def make_sharded_sim_step(constants: MPMConstants, mesh: Mesh, axis: str = "dp"):
    """Returns ``step(statics, state, stress) -> new_state`` on this rank's
    particle shard: ``mpm_step_diff`` with ``particle_grid_sum``, so K1's
    per-block sums are added over the axis in rank order before the halo
    add, ``grid_op_slabs`` and K2 run on the shard (at 24 cells or fewer
    the dense grid is summed). Differentiable: the backward adds the
    ranks' grid cotangents once and runs K3 in both roles on the shard."""
    grid_sum = particle_grid_sum(mesh, axis)

    def step(statics: Statics, state: ParticleState, stress: torch.Tensor) -> ParticleState:
        return mpm_step_diff(constants, statics, state, stress, grid_sum=grid_sum)

    return step
