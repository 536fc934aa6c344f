"""APIC scatter with its closed-form tap-space adjoint: the dense grid,
and the public ``apic_scatter`` / ``apic_scatter_f`` on every grid.

Counterpart of ``neuma_tpu/sim/blocked.py``: ``_spline``, ``_tap_geometry``,
``_dense_forward``, ``_apic_bwd_jnp``, ``_apic_bwd_dual_impl`` and the
custom-VJP primitives ``apic_scatter`` (mass and momentum) and
``apic_scatter_f`` (momentum only), each on the full cube or on a
``GridGeom`` view (the halo step's per-rank slab). On a grid or view of
at most 24 cells per axis the JAX package's dispatchers
(``_forward_dispatch``, ``_apic_bwd_impl``) take ``_dense_forward`` and
``_apic_bwd_jnp`` on every backend, and so does the port. Above 24
cells the port runs the kernels on every device: the primitives'
forward is K1 (the blocked scatter; on the cube its halo-complete slabs
cut back to the dense grid, in a view its per-block sums folded onto
the view) and their backward K3 (the tap gather with spline
derivatives, on the cotangent unfolded into slabs), so the blocked jnp
scatter ``_blocked_forward`` has no counterpart.

The dense path launches no TPU kernel, and plain PyTorch is its
implementation on the CPU and on the card. The scatter (``.at[idx].add``
in JAX) is an ordered sum, ``_ordered_scatter``: a stable sort of the
27 N flat tap cells, then a pairwise tree within each cell's run of
elementwise adds. ``index_add_`` and ``scatter_add_`` sum with float
atomics on the card; the tree adds in one fixed order, the same on the
CPU and the card, so the scatter repeats bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import GridGeom, MPMConstants, geom_dims
from .p2g_kernel import BLOCK  # noqa: F401  (the grid block side, 14)

# The JAX package's chunk of its jnp blocked scatter. The port has no jnp
# blocked scatter: K1 carves its blocks into ``p2g_kernel.CHUNK`` rows.
CHUNK = 512

# Static 3x3x3 tap offsets, (27, 3), x-major.
_OFFSETS = np.stack(
    np.meshgrid(np.arange(3), np.arange(3), np.arange(3), indexing="ij"), axis=-1
).reshape(27, 3)


def _spline(fx: torch.Tensor):
    """Quadratic B-spline weights and d/dfx derivatives, (N, 3 axes, 3 taps)."""
    wa = 1.5 - fx
    wb = fx - 1.0
    wc = fx - 0.5
    w = torch.stack([0.5 * wa * wa, 0.75 - wb * wb, 0.5 * wc * wc], dim=-1)
    wd = torch.stack([-wa, -2.0 * wb, wc], dim=-1)
    return w, wd


def _tap_geometry(constants: MPMConstants, x: torch.Tensor, geom: Optional[GridGeom] = None):
    """27-tap stencil geometry: flat cell index (N, 27) of each tap
    (clamped into the grid), weight W (N, 27), its derivative dW/dfx_a
    (N, 27, 3) and the unclamped offset dpos (N, 27, 3). With a ``geom``
    view the indices are local to the view and a tap outside it gets
    zero weight (it belongs to a neighbouring rank's view)."""
    g = constants.num_grids
    p_x = x * constants.inv_dx
    base = torch.floor(p_x - 0.5).to(torch.int64)
    fx = p_x - base.to(x.dtype)
    w, wd = _spline(fx)
    offsets = torch.as_tensor(_OFFSETS, device=x.device)
    cells = torch.clamp(base[:, None, :] + offsets[None], 0, g - 1)
    o0, o1, o2 = offsets[:, 0], offsets[:, 1], offsets[:, 2]
    wx, wy, wz = w[:, 0, o0], w[:, 1, o1], w[:, 2, o2]
    W = wx * wy * wz
    gW = torch.stack([wd[:, 0, o0] * wy * wz, wx * wd[:, 1, o1] * wz, wx * wy * wd[:, 2, o2]], dim=-1)
    dpos = (offsets.to(x.dtype)[None] - fx[:, None, :]) * constants.dx
    if geom is None:
        flat = (cells[..., 0] * g + cells[..., 1]) * g + cells[..., 2]
        return flat, W, gW, dpos
    _, gy, gz = geom.dims
    dims = torch.as_tensor(geom.dims, device=x.device)
    loc = cells - geom.origin.to(device=x.device, dtype=torch.int64)[None, None, :]
    in_view = ((loc >= 0) & (loc < dims)).all(dim=-1)
    loc = torch.minimum(torch.clamp(loc, min=0), dims - 1)
    flat = (loc[..., 0] * gy + loc[..., 1]) * gz + loc[..., 2]
    m = in_view.to(x.dtype)
    return flat, W * m, gW * m[..., None], dpos


def _ordered_scatter(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """``zeros((size, ch)).at[idx].add(vals)`` in a fixed order: rows
    sorted stably by ``idx``, then each index's run summed as a pairwise
    tree (level k adds the partial sum 2^k rows on into every row at a
    multiple of 2^(k+1) from its run's start). Elementwise adds only, so
    the CPU and the card give the same bits, run after run."""
    order = torch.argsort(idx, stable=True)
    cells, counts = torch.unique_consecutive(idx[order], return_counts=True)
    v = vals[order]
    first = torch.cumsum(counts, 0) - counts
    run = torch.repeat_interleave(counts)
    rank = torch.arange(idx.numel(), device=idx.device) - first[run]
    left = counts[run] - rank  # rows from this one to its run's end
    longest = int(counts.max()) if counts.numel() else 0
    step = 1
    while step < longest:
        take = ((rank % (2 * step) == 0) & (left > step))[:, None]
        v = torch.where(take, v + torch.cat([v[step:], v.new_zeros((step,) + v.shape[1:])]), v)
        step *= 2
    out = vals.new_zeros((size,) + vals.shape[1:])
    out[cells] = v[first]
    return out


def _dense_forward(
    constants: MPMConstants,
    x: torch.Tensor,
    gm: Optional[torch.Tensor],
    b: torch.Tensor,
    A: torch.Tensor,
    geom: Optional[GridGeom] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Single-region APIC scatter: grid_f[c] += W_c (b + A dpos_c) and, with
    ``gm``, grid_m[c] += W_c gm. Returns (grid_m (cells,) or None,
    grid_f (cells, 3)) on the cube or the ``geom`` view; one ordered
    scatter carries all channels."""
    flat, W, _, dpos = _tap_geometry(constants, x, geom)
    dims = geom_dims(constants, geom)
    f_tap = W[..., None] * (b[:, None, :] + torch.einsum("nij,noj->noi", A, dpos))
    vals = f_tap if gm is None else torch.cat([f_tap, (W * gm[:, None])[..., None]], dim=-1)
    grid = _ordered_scatter(flat.reshape(-1), vals.reshape(-1, vals.shape[-1]),
                            dims[0] * dims[1] * dims[2])
    return (grid[:, 3] if gm is not None else None), grid[:, :3]


def _apic_bwd_jnp(
    constants: MPMConstants,
    x: torch.Tensor,
    gm: Optional[torch.Tensor],
    b: torch.Tensor,
    A: torch.Tensor,
    du: Optional[torch.Tensor],
    df: torch.Tensor,
    geom: Optional[GridGeom] = None,
):
    """Tap-space cotangents of the APIC scatter by 27-tap gathers. Per
    particle, with u_o / r_o the grid cotangents at tap o:

        d gm  = sum_o W_o u_o
        d b   = sum_o W_o r_o
        d A   = sum_o W_o r_o (x) dpos_o
        d x_a = inv_dx sum_o (dW_o/dfx_a) s_o - sum_o W_o (A^T r_o)_a

    with s_o = u_o gm + r_o . (b + A dpos_o); cell indices are piecewise
    constant in x. Returns (dx, dgm or None, db, dA). With a ``geom``
    view, taps outside it have zero weight."""
    flat, W, gW, dpos = _tap_geometry(constants, x, geom)
    r = df[flat]  # (N, 27, 3)
    db = torch.einsum("no,noi->ni", W, r)
    dA = torch.einsum("no,noi,noj->nij", W, r, dpos)
    s = torch.einsum("noi,noi->no", r, b[:, None, :] + torch.einsum("nij,noj->noi", A, dpos))
    if du is not None and gm is not None:
        u = du[flat]  # (N, 27)
        dgm = torch.einsum("no,no->n", W, u)
        s = s + u * gm[:, None]
    else:
        dgm = None
    dx_w = constants.inv_dx * torch.einsum("noa,no->na", gW, s)
    dx_d = -torch.einsum("no,nij,noi->nj", W, A, r)
    return dx_w + dx_d, dgm, db, dA


def _apic_bwd_dual_impl(constants, x, gm, b, A, du, df, b2, A2, gv, geom=None):
    """The step backward's two tap-gather adjoints: the P2G scatter adjoint
    (``gm``, ``b``, ``A`` against the grid cotangents ``du``, ``df``) and
    the G2P position adjoint (``b2``, ``A2`` against the grid velocity
    ``gv``). Returns (dx1, dgm, db, dA, dx2)."""
    dx1, dgm, db, dA = _apic_bwd_jnp(constants, x, gm, b, A, du, df, geom)
    dx2, _, _, _ = _apic_bwd_jnp(constants, x, None, b2, A2, None, gv, geom)
    return dx1, dgm, db, dA, dx2


def _slab_grid(constants: MPMConstants) -> bool:
    return constants.num_grids > 24


def _blocked(constants: MPMConstants, geom: Optional[GridGeom]) -> bool:
    """The kernels' branch: a cube of more than 24 cells, or a view
    more than 24 cells wide on some axis (``_forward_dispatch``)."""
    return _slab_grid(constants) if geom is None else max(geom.dims) > 24


def _scatter_forward(constants, x, gm, b, A, sort, geom=None):
    """(grid_m or None, grid_f) of the APIC scatter on the cube or the
    ``geom`` view: K1 on the kernels' branch, the ordered dense scatter
    otherwise."""
    if not _blocked(constants, geom):
        return _dense_forward(constants, x, gm, b, A, geom)
    from .p2g_kernel import p2g_blocked, p2g_slab_scatter, slabs_to_dense

    if geom is not None:
        return p2g_blocked(constants, x, gm, b, A, sort, geom)
    grid = slabs_to_dense(p2g_slab_scatter(constants, x, gm, b, A, sort), constants.num_grids)
    return (grid[:, 3] if gm is not None else None), grid[:, :3]


def _scatter_backward(constants, x, gm, b, A, du, df, sort, geom=None):
    """(dx, dgm or None, db, dA) for the grid cotangents ``du`` (mass, or
    None) and ``df`` (momentum): K3 against the cotangent's slabs on the
    kernels' branch, the tap-space gathers of ``_apic_bwd_jnp`` otherwise."""
    if not _blocked(constants, geom):
        return _apic_bwd_jnp(constants, x, gm, b, A, du, df, geom)
    from .p2g_kernel import apic_gather

    dx, dgm, db, dA = apic_gather(constants, x, gm, b, A, df, du, derivs=True, sort=sort,
                                  geom=geom)
    return dx, (dgm if du is not None and gm is not None else None), db, dA


def _layouts(constants, x, sort, geom=None):
    """The step layouts the kernels share between forward and backward
    (None on the dense branch), built in the ``geom`` view."""
    if sort is None and _blocked(constants, geom):
        from .p2g_kernel import build_step_layouts

        return build_step_layouts(constants, x, geom)
    return sort


class _ApicScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, constants, sort, geom, x, gm, b, A):
        ctx.save_for_backward(x, gm, b, A)
        ctx.constants, ctx.sort, ctx.geom = constants, sort, geom
        return _scatter_forward(constants, x, gm, b, A, sort, geom)

    @staticmethod
    def backward(ctx, du, df):
        x, gm, b, A = ctx.saved_tensors
        dx, dgm, db, dA = _scatter_backward(ctx.constants, x, gm, b, A, du, df, ctx.sort,
                                            ctx.geom)
        return None, None, None, dx, dgm, db, dA


class _ApicScatterF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, constants, sort, geom, x, b, A):
        ctx.save_for_backward(x, b, A)
        ctx.constants, ctx.sort, ctx.geom = constants, sort, geom
        return _scatter_forward(constants, x, None, b, A, sort, geom)[1]

    @staticmethod
    def backward(ctx, df):
        x, b, A = ctx.saved_tensors
        dx, _, db, dA = _scatter_backward(ctx.constants, x, None, b, A, None, df, ctx.sort,
                                          ctx.geom)
        return None, None, None, dx, db, dA


def apic_scatter(
    constants: MPMConstants,
    x: torch.Tensor,
    gm: torch.Tensor,
    b: torch.Tensor,
    A: torch.Tensor,
    sort=None,
    geom: Optional[GridGeom] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mass and momentum APIC scatter,

        grid_m[c] += W_c(x) gm,   grid_f[c] += W_c(x) (b + A dpos_c),

    returning (grid_m (cells,), grid_f (cells, 3)) on the full cube or
    the ``geom`` view (the halo step's per-rank slab). The backward is the
    closed-form 27-tap gather (cell indices are piecewise constant in x).
    ``sort`` may carry the step's ``StepLayouts`` (or a ``BlockSort``),
    built with the same ``geom``."""
    return _ApicScatter.apply(constants, _layouts(constants, x, sort, geom), geom, x, gm, b, A)


def apic_scatter_f(
    constants: MPMConstants, x: torch.Tensor, b: torch.Tensor, A: torch.Tensor, sort=None,
    geom: Optional[GridGeom] = None,
) -> torch.Tensor:
    """Momentum-only APIC scatter, grid_f[c] += W_c(x) (b + A dpos_c):
    the G2P grid cotangent's transpose."""
    return _ApicScatterF.apply(constants, _layouts(constants, x, sort, geom), geom, x, b, A)
