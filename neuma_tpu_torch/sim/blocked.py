"""APIC scatter with its closed-form tap-space adjoint: the dense grid,
and the public ``apic_scatter`` / ``apic_scatter_f`` on every grid.

Counterpart of ``neuma_tpu/sim/blocked.py``: ``_spline``,
``_tap_geometry`` (the full cube; halo ``GridGeom`` views are scale-out
work), ``_dense_forward``, ``_apic_bwd_jnp``, ``_apic_bwd_dual_impl``
and the custom-VJP primitives ``apic_scatter`` (mass and momentum) and
``apic_scatter_f`` (momentum only). On grids of at most 24 cells the JAX
package's dispatchers (``_forward_dispatch``, ``_apic_bwd_impl``) take
``_dense_forward`` and ``_apic_bwd_jnp`` on every backend, and so does
the port. Above 24 cells the port runs the slab chain of
``sim/p2g_kernel.py`` on every device: the primitives' forward is K1
(the blocked scatter, its halo-complete slabs cut back to the dense
grid) and their backward K3 (the tap gather with spline derivatives, on
the dense cotangent unfolded into slabs), so the blocked jnp scatter
``_blocked_forward`` has no counterpart.

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

from ..core.types import MPMConstants

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


def _tap_geometry(constants: MPMConstants, x: torch.Tensor):
    """27-tap stencil geometry on the full cube: flat cell index (N, 27)
    of each tap (clamped into the grid), weight W (N, 27), its derivative
    dW/dfx_a (N, 27, 3) and the unclamped offset dpos (N, 27, 3)."""
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
    flat = (cells[..., 0] * g + cells[..., 1]) * g + cells[..., 2]
    return flat, W, gW, dpos


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
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Single-region APIC scatter: grid_f[c] += W_c (b + A dpos_c) and, with
    ``gm``, grid_m[c] += W_c gm. Returns (grid_m (G^3,) or None,
    grid_f (G^3, 3)); one ordered scatter carries all channels."""
    flat, W, _, dpos = _tap_geometry(constants, x)
    f_tap = W[..., None] * (b[:, None, :] + torch.einsum("nij,noj->noi", A, dpos))
    vals = f_tap if gm is None else torch.cat([f_tap, (W * gm[:, None])[..., None]], dim=-1)
    grid = _ordered_scatter(flat.reshape(-1), vals.reshape(-1, vals.shape[-1]),
                            constants.num_grids ** 3)
    return (grid[:, 3] if gm is not None else None), grid[:, :3]


def _apic_bwd_jnp(
    constants: MPMConstants,
    x: torch.Tensor,
    gm: Optional[torch.Tensor],
    b: torch.Tensor,
    A: torch.Tensor,
    du: Optional[torch.Tensor],
    df: torch.Tensor,
):
    """Tap-space cotangents of the APIC scatter by 27-tap gathers. Per
    particle, with u_o / r_o the grid cotangents at tap o:

        d gm  = sum_o W_o u_o
        d b   = sum_o W_o r_o
        d A   = sum_o W_o r_o (x) dpos_o
        d x_a = inv_dx sum_o (dW_o/dfx_a) s_o - sum_o W_o (A^T r_o)_a

    with s_o = u_o gm + r_o . (b + A dpos_o); cell indices are piecewise
    constant in x. Returns (dx, dgm or None, db, dA)."""
    flat, W, gW, dpos = _tap_geometry(constants, x)
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


def _apic_bwd_dual_impl(constants, x, gm, b, A, du, df, b2, A2, gv):
    """The step backward's two tap-gather adjoints: the P2G scatter adjoint
    (``gm``, ``b``, ``A`` against the grid cotangents ``du``, ``df``) and
    the G2P position adjoint (``b2``, ``A2`` against the grid velocity
    ``gv``). Returns (dx1, dgm, db, dA, dx2)."""
    dx1, dgm, db, dA = _apic_bwd_jnp(constants, x, gm, b, A, du, df)
    dx2, _, _, _ = _apic_bwd_jnp(constants, x, None, b2, A2, None, gv)
    return dx1, dgm, db, dA, dx2


def _slab_grid(constants: MPMConstants) -> bool:
    return constants.num_grids > 24


def _scatter_forward(constants, x, gm, b, A, sort):
    """(grid_m or None, grid_f) of the APIC scatter: K1 on slab grids,
    the ordered dense scatter otherwise."""
    if not _slab_grid(constants):
        return _dense_forward(constants, x, gm, b, A)
    from .p2g_kernel import p2g_slab_scatter, slabs_to_dense

    grid = slabs_to_dense(p2g_slab_scatter(constants, x, gm, b, A, sort), constants.num_grids)
    return (grid[:, 3] if gm is not None else None), grid[:, :3]


def _scatter_backward(constants, x, gm, b, A, du, df, sort):
    """(dx, dgm or None, db, dA) for the grid cotangents ``du`` (mass, or
    None) and ``df`` (momentum): K3 against the cotangent's slabs on slab
    grids, the tap-space gathers of ``_apic_bwd_jnp`` otherwise."""
    if not _slab_grid(constants):
        return _apic_bwd_jnp(constants, x, gm, b, A, du, df)
    from .p2g_kernel import dense_to_slabs, gather_from_slabs

    ch = df if du is None else torch.cat([df, du[:, None]], dim=1)
    slabs = dense_to_slabs(ch, constants.num_grids)
    dx, dgm, db, dA = gather_from_slabs(constants, x, slabs, gm, b, A, derivs=True, sort=sort)
    return dx, (dgm if du is not None else None), db, dA


def _layouts(constants, x, sort):
    """The step layouts the slab chain shares between forward and
    backward (None on the dense grid)."""
    if sort is None and _slab_grid(constants):
        from .p2g_kernel import build_step_layouts

        return build_step_layouts(constants, x)
    return sort


class _ApicScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, constants, sort, x, gm, b, A):
        ctx.save_for_backward(x, gm, b, A)
        ctx.constants, ctx.sort = constants, sort
        return _scatter_forward(constants, x, gm, b, A, sort)

    @staticmethod
    def backward(ctx, du, df):
        x, gm, b, A = ctx.saved_tensors
        dx, dgm, db, dA = _scatter_backward(ctx.constants, x, gm, b, A, du, df, ctx.sort)
        return None, None, dx, dgm, db, dA


class _ApicScatterF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, constants, sort, x, b, A):
        ctx.save_for_backward(x, b, A)
        ctx.constants, ctx.sort = constants, sort
        return _scatter_forward(constants, x, None, b, A, sort)[1]

    @staticmethod
    def backward(ctx, df):
        x, b, A = ctx.saved_tensors
        dx, _, db, dA = _scatter_backward(ctx.constants, x, None, b, A, None, df, ctx.sort)
        return None, None, dx, db, dA


def apic_scatter(
    constants: MPMConstants,
    x: torch.Tensor,
    gm: torch.Tensor,
    b: torch.Tensor,
    A: torch.Tensor,
    sort=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mass and momentum APIC scatter,

        grid_m[c] += W_c(x) gm,   grid_f[c] += W_c(x) (b + A dpos_c),

    returning (grid_m (G^3,), grid_f (G^3, 3)). The backward is the
    closed-form 27-tap gather (cell indices are piecewise constant in x).
    ``sort`` may carry the step's ``StepLayouts`` (or a ``BlockSort``)."""
    return _ApicScatter.apply(constants, _layouts(constants, x, sort), x, gm, b, A)


def apic_scatter_f(
    constants: MPMConstants, x: torch.Tensor, b: torch.Tensor, A: torch.Tensor, sort=None
) -> torch.Tensor:
    """Momentum-only APIC scatter, grid_f[c] += W_c(x) (b + A dpos_c):
    the G2P grid cotangent's transpose."""
    return _ApicScatterF.apply(constants, _layouts(constants, x, sort), x, b, A)
