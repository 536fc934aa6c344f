"""Particle sharding of the simulation over a ``torch.distributed`` world.

Counterpart of ``neuma_tpu/parallel/sharding.py`` (``make_mesh``,
``pad_to_multiple``, ``pad_scene_particles``, ``shard_particles``,
``replicate``, ``make_sharded_sim_step``). Each rank holds a contiguous
slice of the particles and a replicated grid: K1 scatters the rank's
particles into per-block sums, the sums are added over the axis in rank
order (the all-reduce that XLA inserts in the JAX package), and every
rank runs the slab chain's halo add, ``grid_op_slabs`` and K2 on its own
particles (on a grid of at most 24 cells, the dense grid is summed
instead). The step here is the forward only: the training path scales
out through the halo-exchange grid (``parallel/halo.py``). The JAX
package's ``tile_sharding`` (its jnp rasterizer's tiles over a mesh
axis) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.types import MPMConstants, ParticleState, Statics
from ..sim.blocked import _dense_forward, _slab_grid
from ..sim.mpm import _g2p_tail, _p2g_terms, g2p_core, grid_op, grid_op_slabs
from ..sim.p2g_kernel import (
    CHUNK,
    _num_blocks,
    _resolve_layout,
    build_step_layouts,
    gather_from_slabs,
    halo_add_slabs,
    pack_payload,
    run_p2g_fwd,
)
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


def make_sharded_sim_step(constants: MPMConstants, mesh: Mesh, axis: str = "dp"):
    """Returns ``step(statics, state, stress) -> new_state`` on this rank's
    particle shard: K1 on the shard, the per-block sums added over the
    axis in rank order, then the halo add, ``grid_op_slabs`` and K2 on the
    shard. Forward only (no autograd graph)."""
    nbs, NB = _num_blocks(constants)

    @torch.no_grad()
    def step(statics: Statics, state: ParticleState, stress: torch.Tensor) -> ParticleState:
        mass, b, affine = _p2g_terms(constants, statics, state, stress)
        if not _slab_grid(constants):  # the dense grid, summed over the axis
            grid_m, grid_mv = _dense_forward(constants, state.x, mass, b, affine)
            grid = mesh.all_sum(torch.cat([grid_mv, grid_m[:, None]], 1), axis)
            new_v, new_C = g2p_core(constants, state.x, grid_op(constants, grid[:, 3], grid[:, :3]))
            return _g2p_tail(constants, statics, state, new_v, new_C)
        sort = build_step_layouts(constants, state.x)
        layout, bsort = _resolve_layout(constants, state.x, CHUNK, sort)
        payload = pack_payload(constants, layout, bsort.fx, bsort.loc, mass, b, affine)
        pb = mesh.all_sum(run_p2g_fwd(payload, layout.c2b, NB), axis)
        slabs_v = grid_op_slabs(constants, halo_add_slabs(pb, nbs), nbs)
        zeros3 = torch.zeros_like(state.x)
        zeros33 = torch.zeros(state.x.shape + (3,), dtype=state.x.dtype, device=state.x.device)
        _, _, new_v, dA = gather_from_slabs(constants, state.x, slabs_v, None, zeros3, zeros33,
                                            derivs=False, sort=sort)
        return _g2p_tail(constants, statics, state, new_v,
                         4.0 * constants.inv_dx * constants.inv_dx * dA)

    return step
