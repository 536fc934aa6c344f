"""Halo-exchange grid sharding for the MPM step over ``torch.distributed``.

Counterpart of ``neuma_tpu/parallel/halo.py``. The grid's x axis is cut
into slabs of width ``w``, one per rank along the mesh axis; a particle
belongs to the slab its (clamped) stencil base line falls in. Per step
each rank runs what the JAX package's ``shard_map`` body runs:

0. the margin flag: an enabled particle whose stencil base left
   ``[s w - tol, s w + w - 1 + tol]`` (its mass would leave the view);
1. one block sort of its particles in its view ``(w + lo + hi, G, G)``
   at x origin ``s w - lo`` (``lo = hi = 2 + tol``), then the APIC
   scatter into that view (``blocked.apic_scatter`` with the view's
   ``GridGeom``: K1 and the fold above 24 cells per axis);
2. the face exchange: rows ``[0, lo)`` go to the left neighbour and rows
   ``[lo + w, size)`` to the right one, and each rank adds what it gets
   onto its own rows (cyclic: the wrapped rows are zero);
3. ``grid_op`` on the owned slab, in global coordinates;
4. the velocity exchange: the right neighbour's leading ``hi`` rows,
   and with ``tol > 0`` the left neighbour's trailing ``lo`` rows;
5. G2P from the view (``g2p_core``: K2, and K1 and K3 in its backward)
   and advection.

A JAX ``ppermute`` is a ring exchange here (``Mesh.exchange``: isend /
irecv to both neighbours in one batch) inside an autograd Function whose
backward sends the cotangents the other way: the transpose of a permute
is the inverse permute. The per-step cotangent scrub sits at the step
boundary, as in the JAX package.

``partition_particles`` / ``unpartition`` bin the (replicated) global
particle arrays by owner in the JAX package's stable order (by owner,
ties by index), with disabled clones of particle 0 in the padding slots.
A rank steps its own bin; ``gather_bins`` puts the bins back on every
rank by an all-gather whose backward is a reduce-scatter, so that each
rank's cotangent of every bin reaches the bin's owner once.

``halo_exchange.*`` in ``utils.profiling.counters`` counts the exchanges,
their bytes sent per rank and host seconds (staging included).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.nn.functional as tnf

from ..core.types import GridGeom, MPMConstants, ParticleState, Statics
from ..sim.blocked import _blocked, apic_scatter
from ..sim.mpm import _g2p_tail, _p2g_terms, g2p_core, grid_op, scrub_cotangents
from ..sim.p2g_kernel import build_step_layouts
from ..utils.profiling import counters
from .distributed import Mesh

HALO = 2  # cells of halo on each side of a slab


def slab_width(num_grids: int, n_shards: int) -> int:
    """Smallest slab width covering the grid across n shards."""
    return -(-num_grids // n_shards)


def owner_of(constants: MPMConstants, x: torch.Tensor, w: int, n: int) -> torch.Tensor:
    """Owning shard per particle: by (clamped) stencil base x-line."""
    g = constants.num_grids
    base_x = torch.floor(x[:, 0] * constants.inv_dx - 0.5).to(torch.int64)
    return torch.clamp(base_x, 0, g - 1) // w


@dataclasses.dataclass
class Partition:
    """Fixed-capacity per-shard particle bins (leading axis = shard)."""

    state: ParticleState  # (n_shards, cap, ...)
    statics: Statics  # (n_shards, cap, ...)
    perm: torch.Tensor  # (n_shards, cap) source index
    valid: torch.Tensor  # (n_shards, cap) bool
    overflow: torch.Tensor  # () bool: a bin exceeded capacity


def partition_particles(
    constants: MPMConstants,
    state: ParticleState,
    statics: Statics,
    n_shards: int,
    capacity: int,
) -> Partition:
    """Sort particles into per-shard slab bins of ``capacity`` slots, by
    owner, ties by index. Particles past a bin's capacity are dropped and
    flagged in ``overflow``; padding slots are disabled clones of
    particle 0 with F = I. Differentiable in ``state``."""
    n = state.x.shape[0]
    dev = state.x.device
    w = slab_width(constants.num_grids, n_shards)
    owner = owner_of(constants, state.x.detach(), w, n_shards)
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n_shards)
    start = torch.cumsum(counts, 0) - counts
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    rank = inv - start[owner]
    overflow = (counts > capacity).any()
    dest = torch.where(rank < capacity, owner * capacity + rank, n_shards * capacity)
    src = torch.zeros(n_shards * capacity + 1, dtype=torch.int64, device=dev)
    src[dest] = torch.arange(n, device=dev)  # the spare last slot takes the dropped
    src = src[:-1].reshape(n_shards, capacity)
    valid = torch.arange(capacity, device=dev)[None, :] < counts[:, None]
    src = torch.where(valid, src, 0)
    eye = torch.eye(3, dtype=state.F.dtype, device=dev)
    return Partition(
        state=ParticleState(
            x=state.x[src], v=state.v[src], C=state.C[src],
            F=torch.where(valid[..., None, None], state.F[src], eye),
        ),
        statics=Statics(
            vol=statics.vol[src], rho=statics.rho[src], clip_bound=statics.clip_bound[src],
            enabled=torch.where(valid, statics.enabled[src], 0),
        ),
        perm=src,
        valid=valid,
        overflow=overflow,
    )


def unpartition(part: Partition, n: int, template: ParticleState) -> ParticleState:
    """Scatter bins back to the original particle order. Particles absent
    from the bins (dropped on overflow) keep their ``template`` state."""
    flat_src = torch.where(part.valid.reshape(-1), part.perm.reshape(-1), n)

    def put(binned, orig):
        flat = binned.reshape((-1,) + binned.shape[2:])
        out = torch.cat([orig, orig.new_zeros((1,) + orig.shape[1:])])
        return out.index_put((flat_src,), flat)[:n]

    return ParticleState(
        x=put(part.state.x, template.x),
        v=put(part.state.v, template.v),
        C=put(part.state.C, template.C),
        F=put(part.state.F, template.F),
    )


def shard_of(part: Partition, shard: int):
    """One shard's bin: (state, statics, valid), each (cap, ...)."""
    pick = lambda t: t[shard]
    state = ParticleState(*(pick(t) for t in (part.state.x, part.state.v, part.state.C,
                                                part.state.F)))
    statics = Statics(*(pick(t) for t in (part.statics.vol, part.statics.rho,
                                           part.statics.clip_bound, part.statics.enabled)))
    return state, statics, pick(part.valid)


class _Exchange(torch.autograd.Function):
    """``Mesh.exchange`` (the counterpart of two ``ppermute`` calls):
    forward sends ``to_left`` left and ``to_right`` (or nothing, when
    None) right and returns ``(from_right, from_left)`` (``from_right``
    alone without ``to_right``); backward sends the cotangents the other
    way, the inverse permutation."""

    @staticmethod
    def forward(ctx, mesh, axis, to_left, to_right):
        ctx.mesh, ctx.axis, ctx.one_way = mesh, axis, to_right is None
        from_right, from_left = _timed_exchange(mesh, axis, to_left, to_right)
        return from_right if ctx.one_way else (from_right, from_left)

    @staticmethod
    def backward(ctx, g_from_right, g_from_left=None):
        if ctx.one_way:  # what went left comes back from the left
            _, from_left = _timed_exchange(ctx.mesh, ctx.axis, None, g_from_right.contiguous())
            return None, None, from_left, None
        from_right, from_left = _timed_exchange(ctx.mesh, ctx.axis, g_from_left.contiguous(),
                                                g_from_right.contiguous())
        return None, None, from_left, from_right


def _timed_exchange(mesh: Mesh, axis: str, to_left, to_right):
    t0 = time.perf_counter()
    out = mesh.exchange(axis, to_left, to_right)
    counters["halo_exchange.calls"] += 1
    counters["halo_exchange.bytes"] += sum(t.numel() * t.element_size() for t in (to_left, to_right)
                                           if t is not None)
    counters["halo_exchange.seconds"] += time.perf_counter() - t0
    return out


def exchange(mesh: Mesh, axis: str, to_left: torch.Tensor, to_right: Optional[torch.Tensor]):
    """Differentiable ring exchange along ``axis``: returns
    ``(from_right, from_left)``; ``to_right=None`` sends nothing right and
    gives ``from_left=None``."""
    if to_right is None:
        return _Exchange.apply(mesh, axis, to_left, None), None
    return _Exchange.apply(mesh, axis, to_left, to_right)


class _AllGather(torch.autograd.Function):
    """Every rank's ``t`` along ``axis`` stacked (R, ...); the backward is
    the reduce-scatter: this rank's slot of every rank's cotangent,
    added in rank order."""

    @staticmethod
    def forward(ctx, mesh, axis, t):
        ctx.mesh, ctx.axis = mesh, axis
        return torch.stack(mesh.all_gather(t.contiguous(), axis))

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.mesh, ctx.axis
        i = mesh.ranks(axis).index(mesh.rank)
        parts = mesh.all_gather(g.contiguous(), axis)
        out = parts[0][i]
        for p in parts[1:]:
            out = out + p[i]
        return None, None, out


def gather_bins(mesh: Mesh, axis: str, state: ParticleState) -> ParticleState:
    """This rank's bin (cap, ...) -> every rank's bins (n_shards, cap, ...)
    along ``axis``, in one all-gather of the packed (cap, 24) state."""
    cap = state.x.shape[0]
    packed = torch.cat([state.x, state.v, state.C.reshape(cap, 9), state.F.reshape(cap, 9)], 1)
    allb = _AllGather.apply(mesh, axis, packed)
    r = allb.shape[0]
    return ParticleState(x=allb[..., 0:3], v=allb[..., 3:6], C=allb[..., 6:15].reshape(r, cap, 3, 3),
                         F=allb[..., 15:24].reshape(r, cap, 3, 3))


def make_halo_sim_step(constants: MPMConstants, mesh: Mesh, axis: str = "dp", tol: int = 0):
    """Returns ``step(statics, state, stress) -> (new_state, margin_bad)``,
    what one rank runs on its bin (cap, ...) of the partitioned particles:
    the grid exists only as each rank's slab view. ``margin_bad`` is a ()
    bool on this rank: an enabled particle's stencil left its view, so
    the step (and its gradient) dropped mass.

    ``tol`` is the drift tolerance in cells: the view widens by ``tol``
    on each side, so a particle may wander ``tol`` cells outside its
    bin's slab between repartitions (one repartition per frame with
    ``tol = 2``)."""
    n_shards = mesh.shape[axis]
    g = constants.num_grids
    w = slab_width(g, n_shards)
    lo = hi = HALO + tol
    if w < max(lo, hi):
        raise ValueError(f"slab width {w} must cover the halo ({max(lo, hi)}): fewer shards "
                         f"or a bigger grid")
    size_x = w + lo + hi
    dims = (size_x, g, g)
    shard = mesh.coord(axis)

    def step(statics: Statics, state: ParticleState, stress: torch.Tensor):
        x, v, C, F, stress = scrub_cotangents(state.x, state.v, state.C, state.F, stress)
        state = ParticleState(x, v, C, F)
        dev = x.device
        geom = GridGeom(dims=dims, origin=torch.tensor([shard * w - lo, 0, 0], device=dev))

        # 0. the ownership margin flag
        base_x = torch.floor(x.detach()[:, 0] * constants.inv_dx - 0.5).to(torch.int64)
        base_c = torch.clamp(base_x, 0, g - 1)
        in_window = (base_c >= shard * w - tol) & (base_c <= shard * w + w - 1 + tol)
        margin_bad = ((statics.enabled > 0) & ~in_window).any()

        sort = build_step_layouts(constants, x, geom) if _blocked(constants, geom) else None

        # 1. local P2G into the slab view
        mass, b, affine = _p2g_terms(constants, statics, state, stress)
        grid_m, grid_f = apic_scatter(constants, x, mass, b, affine, sort, geom)
        grid = torch.cat([grid_f, grid_m[:, None]], 1).reshape(size_x, g * g, 4)

        # 2. face exchange: view rows [0, lo) are the left neighbour's,
        # [lo + w, size_x) the right one's
        from_right, from_left = exchange(mesh, axis, grid[:lo], grid[lo + w:])
        own = grid[lo:lo + w]
        own = own + tnf.pad(from_left, (0, 0, 0, 0, 0, w - hi))
        own = own + tnf.pad(from_right, (0, 0, 0, 0, w - lo, 0))

        # 3. grid_op on the owned slab, global coordinates
        geom_own = GridGeom(dims=(w, g, g), origin=torch.tensor([shard * w, 0, 0], device=dev))
        vel = grid_op(constants, own[..., 3].reshape(-1), own[..., :3].reshape(-1, 3),
                      geom_own).reshape(w, g * g, 3)

        # 4. velocity rows: the right neighbour's leading hi rows extend
        # the top; with drift (tol > 0) the left one's trailing lo rows
        # fill view rows [0, lo), which exact ownership never taps
        lead, trail = exchange(mesh, axis, vel[:hi], vel[w - lo:] if tol > 0 else None)
        if trail is None:
            trail = vel.new_zeros((lo,) + vel.shape[1:])
        v_full = torch.cat([trail, vel, lead], 0)

        # 5. local G2P and advection
        new_v, new_C = g2p_core(constants, x, v_full.reshape(-1, 3), sort, geom)
        return _g2p_tail(constants, statics, state, new_v, new_C), margin_bad

    return step


def make_halo_mpm_step(
    constants: MPMConstants,
    statics: Statics,
    mesh: Mesh,
    axis: str = "dp",
    capacity: Optional[int] = None,
    tol: int = 0,
):
    """The trainer-facing halo step: ``step(state, stress) -> (new_state,
    overflow)`` on GLOBAL (N, ...) particle arrays, the same on every rank
    of the axis. Each call repartitions (exact ownership), steps this
    rank's bin, and gathers the bins back. ``overflow`` ORs the bin
    overflow with every rank's margin flag. ``capacity`` defaults to N."""
    n_shards = mesh.shape[axis]
    inner = make_halo_sim_step(constants, mesh, axis, tol=tol)
    shard = mesh.coord(axis)

    def step(state: ParticleState, stress: torch.Tensor):
        n = state.x.shape[0]
        part = partition_particles(constants, state, statics, n_shards,
                                   capacity if capacity is not None else n)
        bin_state, bin_statics, valid = shard_of(part, shard)
        stress_b = torch.where(valid[:, None, None], stress[part.perm[shard]], 0.0)
        new_bin, margin_bad = inner(bin_statics, bin_state, stress_b)
        new_state = unpartition(dataclasses.replace(part, state=gather_bins(mesh, axis, new_bin)),
                                n, state)
        return new_state, part.overflow | mesh.any(margin_bad, axis)

    return step


def make_halo_bins_step(constants: MPMConstants, mesh: Mesh, axis: str = "dp", tol: int = 2):
    """``make_halo_sim_step`` under the JAX package's name for its use in
    bins space, with one repartition per frame: a substep loop carries
    this rank's bin, and ``tol`` cells of drift are covered by the wider
    view (``margin_bad`` fires past it)."""
    return make_halo_sim_step(constants, mesh, axis, tol=tol)
