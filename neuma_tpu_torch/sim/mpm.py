"""MLS-MPM step, slab and dense branches, with its direct adjoint.

Counterpart of ``neuma_tpu/sim/mpm.py``: ``_p2g_terms``, ``grid_op``
(on the cube or a ``GridGeom`` view, the boundary in global coordinates)
and ``grid_op_slabs`` (``noslip`` and ``freeslip``), ``g2p_core`` (on the
cube or a view: K2, and K1 and K3 in its backward, above 24 cells),
``_g2p_tail``, the public ``p2g`` (every ``method``: ``"auto"`` /
``"blocked"``, ``"matmul"`` and ``"scatter"``) with ``p2g_scatter``,
``_axis_weights`` and ``p2g_matmul``, ``g2p`` and ``advect_extra`` on
the dense grid's tensors, ``_step_sort``, the step on either branch
(``_step_fwd``, the direct adjoint ``_step_bwd``), ``mpm_step``,
``mpm_step_diff``, ``make_packed_substep`` and ``scrub_cotangents``.

``p2g_scatter`` and ``p2g_matmul`` are the JAX package's code outside
any Pallas kernel, in their plain PyTorch form, differentiated by
autograd as the JAX versions are by AD: the scatter is the ordered sum
of ``sim/blocked.py`` (no ``index_add_``, so it repeats bit for bit on
the card), the separable products are ``torch.matmul`` in full FP32
(TF32 off around each product and its backward, where the JAX code asks
for ``Precision.HIGHEST``). Neither runs on the default path.

Grids of more than 24 cells take the slab branch on any device: the grid
lives as halo-complete per-block slabs from the P2G kernel (K1) through
the grid op to the G2P kernel (K2) and never exists densely. Grids of at
most 24 cells take the dense branch, as the JAX package does on every
backend: the ordered dense scatter of ``sim/blocked.py``, ``grid_op`` on
the (G^3,) grid and the 27-tap gather of ``g2p_core`` (its full-cube
``_stencil`` is ``blocked._tap_geometry``). The dense branch launches no
kernel and needs no block layouts (``_step_sort`` gives None).

The backward composes the piece adjoints explicitly, as the JAX
package's custom VJPs do, and never runs autograd through a kernel: the
tail vjp, the transpose of the gather (K1 on slabs, the dense scatter
on the dense grid), the grid-op vjp, the two tap-gather adjoints (K3
twice, or ``blocked._apic_bwd_dual_impl``), the ``_p2g_terms`` vjp, then
the NaN/Inf scrub of every outgoing cotangent. The elementwise pieces'
vjps are autograd on a recompute, as ``jax.vjp`` is in the JAX package.
``make_packed_substep`` is one ``torch.autograd.Function`` that saves the
state, stress, grid residual (the merged slabs, or grid_m and grid_mv),
``new_v``/``new_C`` and the pre-plasticity F, and recomputes each
material's forward in its backward (no MLP or SVD activations are kept
across the rollout).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.types import GridGeom, MPMConstants, ParticleState, Statics
from ..utils.profiling import span
from .blocked import (
    _apic_bwd_dual_impl,
    _blocked,
    _dense_forward,
    _layouts,
    _ordered_scatter,
    _scatter_backward,
    _scatter_forward,
    _slab_grid,
    _spline,
    _tap_geometry,
    apic_scatter,
)
from .p2g_kernel import (
    BLOCK,
    S,
    _cdiv,
    apic_gather,
    build_step_layouts,
    gather_from_slabs,
    p2g_slab_scatter,
)


def _p2g_terms(constants: MPMConstants, statics: Statics, state: ParticleState, stress):
    """Per-particle APIC scatter channels (mass, momentum, affine)."""
    dtype = state.x.dtype
    en = statics.enabled.to(dtype)
    mass = statics.vol * statics.rho * en
    stress_term = (
        -constants.dt * statics.vol * 4.0 * constants.inv_dx * constants.inv_dx
    )[:, None, None] * stress
    affine = stress_term * en[:, None, None] + mass[:, None, None] * state.C
    b = mass[:, None] * state.v
    return mass, b, affine


def grid_op_slabs(constants: MPMConstants, slabs: torch.Tensor, nbs) -> torch.Tensor:
    """Momentum -> velocity, gravity and the box boundary per slab:
    (NB, 4, S, S*S) with channels (mv, mass) -> (velocity, 0). The
    boundary test runs in global cell coordinates from the block origin."""
    g = constants.num_grids
    bound = constants.bound
    dtype = slabs.dtype
    dev = slabs.device
    NB = slabs.shape[0]
    _, nby, nbz = nbs

    grid_m = slabs[:, 3]
    gv = constants.gravity.to(dtype) * constants.dt
    has_mass = grid_m > 0.0
    denom = torch.where(has_mass, grid_m + constants.eps, 1.0)
    v = [torch.where(has_mass, slabs[:, c] / denom + gv[c], gv[c]) for c in range(3)]

    bidx = torch.arange(NB, device=dev)
    obx = (bidx // (nby * nbz)) * BLOCK
    oby = ((bidx // nbz) % nby) * BLOCK
    obz = (bidx % nbz) * BLOCK
    sx = torch.arange(S, device=dev)[None, :, None]
    lane = torch.arange(S * S, device=dev)[None, None, :]
    coords = (
        obx[:, None, None] + sx,
        oby[:, None, None] + lane // S,
        obz[:, None, None] + lane % S,
    )
    viol = [
        ((coords[c] < bound) & (v[c] < 0.0)) | ((coords[c] >= g - bound) & (v[c] > 0.0))
        for c in range(3)
    ]
    if constants.bc == "freeslip":
        v = [torch.where(viol[c], 0.0, v[c]) for c in range(3)]
    elif constants.bc == "noslip":
        any_v = viol[0] | viol[1] | viol[2]
        v = [torch.where(any_v, 0.0, v[c]) for c in range(3)]
    else:
        raise ValueError(f"invalid boundary condition: {constants.bc}")
    return torch.stack(v + [torch.zeros_like(v[0])], dim=1)


def grid_op(constants: MPMConstants, grid_m: torch.Tensor, grid_mv: torch.Tensor,
            geom: Optional[GridGeom] = None) -> torch.Tensor:
    """Momentum -> velocity, gravity and the box boundary on the dense
    grid or a ``geom`` view: grid_m (cells,), grid_mv (cells, 3) ->
    velocity (cells, 3). In a view the boundary test runs in global
    coordinates (local index + the view's origin)."""
    g = constants.num_grids
    bound = constants.bound
    gv = constants.gravity.to(grid_mv.dtype) * constants.dt
    has_mass = grid_m > 0.0
    # where m == 0 divide by 1 (the value is replaced): no NaN either way
    denom = torch.where(has_mass, grid_m + constants.eps, 1.0)[:, None]
    v = torch.where(has_mass[:, None], grid_mv / denom + gv, gv)
    gx, gy, gz = (g, g, g) if geom is None else geom.dims
    idx = torch.arange(gx * gy * gz, device=grid_mv.device)
    coords = torch.stack([idx // (gy * gz), (idx // gz) % gy, idx % gz], dim=-1)
    if geom is not None:
        coords = coords + geom.origin.to(device=grid_mv.device, dtype=torch.int64)[None, :]
    violating = ((coords < bound) & (v < 0.0)) | ((coords >= g - bound) & (v > 0.0))
    if constants.bc == "freeslip":
        return torch.where(violating, 0.0, v)
    if constants.bc == "noslip":
        return torch.where(violating.any(dim=-1, keepdim=True), 0.0, v)
    raise ValueError(f"invalid boundary condition: {constants.bc}")


def _g2p_dense(constants: MPMConstants, x: torch.Tensor, grid_v: torch.Tensor, geom=None):
    """new_v = sum_o W_o grid_v[cell_o], new_C = kappa sum_o W_o grid_v[cell_o] (x) dpos_o."""
    kappa = 4.0 * constants.inv_dx * constants.inv_dx
    flat, weight, _, dpos = _tap_geometry(constants, x, geom)
    v_taps = grid_v[flat]  # (N, 27, 3)
    new_v = torch.einsum("no,noi->ni", weight, v_taps)
    new_C = kappa * torch.einsum("no,noi,noj->nij", weight, v_taps, dpos)
    return new_v, new_C


def _g2p_slab(constants: MPMConstants, x: torch.Tensor, grid_v: torch.Tensor, sort, geom=None):
    """The same contractions by K2 on the grid velocity's slabs."""
    zeros3 = torch.zeros_like(x)
    zeros33 = torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device)
    _, _, new_v, dA = apic_gather(constants, x, None, zeros3, zeros33, grid_v, None,
                                  derivs=False, sort=sort, geom=geom)
    return new_v, 4.0 * constants.inv_dx * constants.inv_dx * dA


class _G2PCore(torch.autograd.Function):
    """The G2P tap contractions (K2 on the kernels' branch, plain gathers
    on the dense one); the backward routes the grid cotangent through the
    scatter with b = d new_v, A = kappa d new_C (the exact transpose: K1
    or the dense scatter) and the position cotangent through the same
    tap-space gather as the step backward (K3 or ``_apic_bwd_jnp``)."""

    @staticmethod
    def forward(ctx, constants, sort, geom, x, grid_v):
        ctx.save_for_backward(x, grid_v)
        ctx.constants, ctx.sort, ctx.geom = constants, sort, geom
        if _blocked(constants, geom):
            return _g2p_slab(constants, x, grid_v, sort, geom)
        return _g2p_dense(constants, x, grid_v, geom)

    @staticmethod
    def backward(ctx, dv, dC):
        x, grid_v = ctx.saved_tensors
        constants, sort, geom = ctx.constants, ctx.sort, ctx.geom
        A = 4.0 * constants.inv_dx * constants.inv_dx * dC
        _, d_grid = _scatter_forward(constants, x, None, dv, A, sort, geom)
        d_x, _, _, _ = _scatter_backward(constants, x, None, dv, A, None, grid_v, sort, geom)
        return None, None, None, d_x, d_grid


def g2p_core(constants: MPMConstants, x: torch.Tensor, grid_v: torch.Tensor, sort=None,
             geom: Optional[GridGeom] = None):
    """The two tap contractions of G2P, (new_v, new_C), against the grid
    velocity (cells, 3) of the full cube or the ``geom`` view, with the
    JAX package's custom backward. ``sort`` may carry the step's layouts
    (the kernels' branch only), built with the same ``geom``."""
    sort = _layouts(constants, x, sort, geom)
    return _G2PCore.apply(constants, sort, geom, x, grid_v)


def _g2p_tail(
    constants: MPMConstants,
    statics: Statics,
    state: ParticleState,
    new_v: torch.Tensor,
    new_C: torch.Tensor,
) -> ParticleState:
    """F update, advection, clamp and the enabled freeze."""
    dt = constants.dt
    enabled = (statics.enabled > 0)[:, None]
    eye = torch.eye(3, dtype=state.x.dtype, device=state.x.device)
    new_F = (eye + dt * new_C) @ state.F
    clip = (statics.clip_bound * constants.dx)[:, None]
    # maximum then minimum, as jnp.clip: ties split the gradient alike.
    new_x = torch.minimum(torch.maximum(state.x + dt * new_v, clip), 1.0 - clip)
    return ParticleState(
        x=torch.where(enabled, new_x, state.x),
        v=torch.where(enabled, new_v, state.v),
        C=torch.where(enabled[..., None], new_C, state.C),
        F=torch.where(enabled[..., None], new_F, state.F),
    )


def g2p(
    constants: MPMConstants,
    statics: Statics,
    state: ParticleState,
    grid_v: torch.Tensor,
    sort=None,
) -> ParticleState:
    """Grid-to-particle transfer from the dense grid velocity (G^3, 3):
    the tap contractions (``g2p_core``), then the F update, advection,
    clamp and enabled freeze. Differentiable end to end."""
    new_v, new_C = g2p_core(constants, state.x, grid_v, sort)
    return _g2p_tail(constants, statics, state, new_v, new_C)


def p2g_scatter(constants: MPMConstants, statics: Statics, state: ParticleState,
                stress: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Particle-to-grid as a scatter of the 27 taps (reference
    mpm.py:321-371): (grid_m (G^3,), grid_mv (G^3, 3)). Each cell's taps
    are summed by ``_ordered_scatter`` in one fixed order."""
    g3 = constants.num_grids ** 3
    mass = statics.vol * statics.rho
    enabled = statics.enabled.to(state.x.dtype)
    flat, weight, _, dpos = _tap_geometry(constants, state.x)
    stress_term = (
        -constants.dt * statics.vol * 4.0 * constants.inv_dx * constants.inv_dx
    )[:, None, None] * stress
    affine = stress_term + mass[:, None, None] * state.C
    # mv contribution: weight * (mass * v + affine @ dpos), per tap.
    mv_tap = mass[:, None, None] * state.v[:, None, :] + torch.einsum("nij,noj->noi", affine, dpos)
    weight = weight * enabled[:, None]
    vals = torch.cat([weight[..., None] * mv_tap, (weight * mass[:, None])[..., None]], dim=-1)
    grid = _ordered_scatter(flat.reshape(-1), vals.reshape(-1, 4), g3)
    return grid[:, 3], grid[:, :3]


def _axis_weights(constants: MPMConstants, x: torch.Tensor,
                  region: Optional[Tuple[Tuple[int, int], ...]] = None):
    """Per-axis dense quadratic B-spline weight matrices.

    Returns (W, Wi, base, fx): W and Wi are lists of 3 tensors (N, S_a)
    each. W[a][p, c] is the axis-a spline weight of particle p at LOCAL
    grid line c, and Wi[a] the same weighted by the LOCAL tap offset i in
    {0, 1, 2} (the affine term's offset dependence).

    ``region``: optional per-axis (lo, size) restricting the dense
    coordinate range to global lines [lo, lo+size), the slab view of the
    halo-exchange step, where each shard holds only its slab and halo.
    Taps whose (clamped) cell falls outside the region are dropped; the
    caller sizes the region to cover the taps of the particles it passes.
    """
    g = constants.num_grids
    p_x = x * constants.inv_dx
    base = torch.floor(p_x - 0.5).to(torch.int64)
    fx = p_x - base.to(x.dtype)
    w, _ = _spline(fx)  # (N, 3 axes, 3 taps)
    if region is None:
        region = ((0, g),) * 3
    W, Wi = [], []
    for a in range(3):
        lo, size = region[a]
        coords = lo + torch.arange(size, device=x.device)
        # Taps off the grid fold onto the edge line, the index clamp of
        # the scatter path; dpos keeps the unclamped local offset.
        Wa = torch.zeros((x.shape[0], size), dtype=x.dtype, device=x.device)
        Wia = torch.zeros_like(Wa)
        for i in range(3):
            ci = torch.clamp(base[:, a : a + 1] + i, 0, g - 1)
            tap = (coords[None, :] == ci).to(x.dtype)
            Wa = Wa + w[:, a, i : i + 1] * tap
            if i:
                Wia = Wia + float(i) * w[:, a, i : i + 1] * tap
        W.append(Wa)
        Wi.append(Wia)
    return W, Wi, base, fx


@contextlib.contextmanager
def _fp32_matmul():
    """cuBLAS without TF32 (the JAX code's ``Precision.HIGHEST``); the
    global flag is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _ExactMatmul(torch.autograd.Function):
    """``a @ b`` whose forward and backward products both run in full
    FP32: autograd runs a backward after any ``with`` block around the
    forward has closed, so the backward sets the flag itself."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _fp32_matmul():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _fp32_matmul():
            da = torch.matmul(g, b.T) if ctx.needs_input_grad[0] else None
            db = torch.matmul(a.T, g) if ctx.needs_input_grad[1] else None
        return da, db


def p2g_matmul(constants: MPMConstants, statics: Statics, state: ParticleState,
               stress: torch.Tensor, chunk: int = 16384,
               region: Optional[Tuple[Tuple[int, int], ...]] = None):
    """Particle-to-grid as separable matmuls over the dense grid (or the
    ``region`` slab view): (grid_m (S^3,), grid_mv (S^3, 3)).

    The 27-tap APIC scatter factorizes: with local tap offsets (i, j, k),
        mv_tap = wx_i wy_j wz_k * (b + i*a0 + j*a1 + k*a2)
    where b = mass*v - (A @ fx) * dx and a_c = A[:, c] * dx. The grid is
    a sum of four tensor-product terms, each a (Sx, N) @ (N, Sy Sz)
    product against the per-particle (Wy x Wz) outer products, summed
    over particle chunks of ``chunk``: no scatter forward or backward.
    """
    g = constants.num_grids
    if region is None:
        region = ((0, g),) * 3
    (_, sx), (_, sy), (_, sz) = region
    dtype = state.x.dtype
    n = state.x.shape[0]
    en = statics.enabled.to(dtype)
    mass = statics.vol * statics.rho * en
    stress_term = (
        -constants.dt * statics.vol * 4.0 * constants.inv_dx * constants.inv_dx
    )[:, None, None] * stress
    affine = stress_term + mass[:, None, None] * state.C

    W, Wi, _, fx = _axis_weights(constants, state.x, region)
    Wx, Wy, Wz = W
    Wix, Wiy, Wiz = Wi
    # Zero disabled particles through the x-axis weights.
    Wx = Wx * en[:, None]
    Wix = Wix * en[:, None]
    dx = constants.dx
    b_vec = mass[:, None] * state.v - torch.einsum("nij,nj->ni", affine, fx) * dx
    a_cols = affine * dx  # a_c = affine[:, :, c] * dx
    mm = _ExactMatmul.apply

    def accumulate(lo, hi):
        wx, wy, wz = Wx[lo:hi], Wy[lo:hi], Wz[lo:hi]
        wix, wiy, wiz = Wix[lo:hi], Wiy[lo:hi], Wiz[lo:hi]
        m_ = hi - lo
        yz = (wy[:, :, None] * wz[:, None, :]).reshape(m_, sy * sz)
        yz_i = (wiy[:, :, None] * wz[:, None, :]).reshape(m_, sy * sz)
        yz_k = (wy[:, :, None] * wiz[:, None, :]).reshape(m_, sy * sz)
        b, a, m = b_vec[lo:hi], a_cols[lo:hi], mass[lo:hi]
        grid_m = mm(wx.T, yz * m[:, None])  # (Sx, Sy*Sz)
        mv = []
        for r in range(3):
            lhs = yz * b[:, r : r + 1] + yz_i * a[:, r, 1][:, None] + yz_k * a[:, r, 2][:, None]
            mv.append(mm(wx.T, lhs) + mm(wix.T, yz * a[:, r, 0][:, None]))
        return grid_m, torch.stack(mv, dim=-1)

    if n <= chunk:
        grid_m, grid_mv = accumulate(0, n)
    else:
        grid_m = torch.zeros((sx, sy * sz), dtype=dtype, device=state.x.device)
        grid_mv = torch.zeros((sx, sy * sz, 3), dtype=dtype, device=state.x.device)
        for start in range(0, n, chunk):
            dm, dmv = accumulate(start, min(start + chunk, n))
            grid_m = grid_m + dm
            grid_mv = grid_mv + dmv
    return grid_m.reshape(sx * sy * sz), grid_mv.reshape(sx * sy * sz, 3)


def p2g(
    constants: MPMConstants,
    statics: Statics,
    state: ParticleState,
    stress: torch.Tensor,
    method: str = "auto",
    sort=None,
):
    """Particle-to-grid scatter, (grid_m (G^3,), grid_mv (G^3, 3)).
    ``method``:

    * 'auto' / 'blocked': ``apic_scatter`` of the step's channels (K1 on
      slab grids, the ordered dense scatter otherwise), differentiable
      through its tap-space adjoint; ``sort`` may carry the step's
      layouts.
    * 'matmul': ``p2g_matmul`` over the full grid, chunked so each
      (chunk, G^2) intermediate stays near 2^25 elements.
    * 'scatter': ``p2g_scatter``.
    """
    if method in ("auto", "blocked"):
        mass, b, affine = _p2g_terms(constants, statics, state, stress)
        return apic_scatter(constants, state.x, mass, b, affine, sort)
    if method == "matmul":
        chunk = max(2048, (1 << 25) // constants.num_grids ** 2)
        return p2g_matmul(constants, statics, state, stress, chunk=chunk)
    if method == "scatter":
        return p2g_scatter(constants, statics, state, stress)
    raise ValueError(f"unknown p2g method: {method!r}")


def advect_extra(
    constants: MPMConstants,
    statics: Statics,
    state: ParticleState,
    stress: torch.Tensor,
    statics_extra: Statics,
    state_extra: ParticleState,
) -> ParticleState:
    """Advect a passive second particle set on the grid that the primary
    set scatters."""
    grid_m, grid_mv = p2g(constants, statics, state, stress)
    grid_v = grid_op(constants, grid_m, grid_mv)
    return g2p(constants, statics_extra, state_extra, grid_v)


def _step_fwd_slab(constants, statics, state, stress, sort, grid_sum=None):
    """P2G (K1) -> grid op -> G2P (K2) -> tail. Returns
    (out_state, slabs_mmv, new_v, new_C)."""
    nb = _cdiv(constants.num_grids, BLOCK)
    nbs = (nb, nb, nb)
    mass, b, affine = _p2g_terms(constants, statics, state, stress)
    slabs_mmv = p2g_slab_scatter(constants, state.x, mass, b, affine, sort, grid_sum)
    slabs_v = grid_op_slabs(constants, slabs_mmv, nbs)
    kappa = 4.0 * constants.inv_dx * constants.inv_dx
    zeros3 = torch.zeros_like(state.x)
    zeros33 = torch.zeros(state.x.shape + (3,), dtype=state.x.dtype, device=state.x.device)
    _, _, new_v, dA = gather_from_slabs(
        constants, state.x, slabs_v, None, zeros3, zeros33, derivs=False, sort=sort
    )
    new_C = kappa * dA
    out = _g2p_tail(constants, statics, state, new_v, new_C)
    return out, slabs_mmv, new_v, new_C


def _step_sort(constants: MPMConstants, x: torch.Tensor):
    """The step's shared block sort and chunk layouts: built on the slab
    branch, None on the dense one (which needs none)."""
    return build_step_layouts(constants, x) if _slab_grid(constants) else None


@span("mpm.step")
def _step_fwd(constants, statics, state, stress, sort, grid_sum=None):
    """The step on its branch. Returns (out_state, grid residuals, new_v,
    new_C): the residuals are (slabs_mmv,) on the slab branch and
    (grid_m, grid_mv) on the dense one (dense scatter -> grid op -> G2P
    -> tail). ``grid_sum`` (None in one process) adds this rank's grid
    partials over the particle axis: K1's per-block sums before the halo
    add, or the dense grid."""
    if _slab_grid(constants):
        out, slabs_mmv, new_v, new_C = _step_fwd_slab(constants, statics, state, stress, sort,
                                                      grid_sum)
        return out, (slabs_mmv,), new_v, new_C
    mass, b, affine = _p2g_terms(constants, statics, state, stress)
    grid_m, grid_mv = _dense_forward(constants, state.x, mass, b, affine)
    if grid_sum is not None:  # one (cells, 4) sum
        grid = grid_sum(torch.cat([grid_mv, grid_m[:, None]], 1))
        grid_m, grid_mv = grid[:, 3], grid[:, :3]
    new_v, new_C = g2p_core(constants, state.x, grid_op(constants, grid_m, grid_mv))
    out = _g2p_tail(constants, statics, state, new_v, new_C)
    return out, (grid_m, grid_mv), new_v, new_C


def _scrub(t: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)


def _vjp(fn: Callable, primals: Sequence[torch.Tensor], cotangents, params=()):
    """``jax.vjp`` by recompute: run ``fn`` on detached copies of
    ``primals`` under autograd and pull ``cotangents`` back to them (zeros
    where unused) and to ``params`` (None where unused). Returns
    ``(outputs, primal_grads, param_grads)``."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in primals]
        outs = fn(*leaves)
        outs = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)
        live = [(o, c) for o, c in zip(outs, cotangents)
                if c is not None and o.requires_grad]
        inputs = leaves + list(params)
        grads = (
            torch.autograd.grad([o for o, _ in live], inputs, [c for _, c in live],
                                allow_unused=True)
            if live else (None,) * len(inputs)
        )
    outs = tuple(o.detach() for o in outs)
    n = len(leaves)
    g_primals = [torch.zeros_like(x) if g is None else g for g, x in zip(grads[:n], leaves)]
    return outs, g_primals, list(grads[n:])


def _state_tuple(s: ParticleState):
    return (s.x, s.v, s.C, s.F)


def _grid_bwd_slab(constants, x, sort, slabs_mmv, mass, b, affine, d_new_v, A2, grid_sum=None):
    """The slab branch's grid stages of the step adjoint: K1 as the exact
    transpose of the slab gather (tap scatter per slab, ``grid_sum`` over
    the ranks, halo merge), the ``grid_op_slabs`` vjp, then K3 twice (the
    P2G scatter adjoint and the G2P position adjoint). Returns (d_x_s,
    dgm, db, dA, d_x_g2p)."""
    nb = _cdiv(constants.num_grids, BLOCK)
    nbs = (nb, nb, nb)
    d_slabs_v = p2g_slab_scatter(constants, x, None, d_new_v, A2, sort, grid_sum)
    (slabs_v,), (d_slabs_mmv,), _ = _vjp(
        lambda s_: grid_op_slabs(constants, s_, nbs), (slabs_mmv,), (d_slabs_v,)
    )
    d_x_s, dgm, db, dA = gather_from_slabs(
        constants, x, d_slabs_mmv, mass, b, affine, derivs=True, sort=sort
    )
    d_x_g2p, _, _, _ = gather_from_slabs(
        constants, x, slabs_v, None, d_new_v, A2, derivs=True, sort=sort
    )
    return d_x_s, dgm, db, dA, d_x_g2p


def _grid_bwd_dense(constants, x, grid_m, grid_mv, mass, b, affine, d_new_v, A2, grid_sum=None):
    """The dense branch's grid stages: the dense scatter as the exact
    transpose of the G2P gather (summed by ``grid_sum`` over the ranks),
    the ``grid_op`` vjp, then the two tap-space gathers. Returns (d_x_s,
    dgm, db, dA, d_x_g2p)."""
    _, d_grid_v = _dense_forward(constants, x, None, d_new_v, A2)
    if grid_sum is not None:
        d_grid_v = grid_sum(d_grid_v)
    (grid_v,), (d_m, d_mv), _ = _vjp(
        lambda m_, mv_: grid_op(constants, m_, mv_), (grid_m, grid_mv), (d_grid_v,)
    )
    return _apic_bwd_dual_impl(constants, x, mass, b, affine, d_m, d_mv, d_new_v, A2, grid_v)


@span("mpm.step.bwd")
def _step_bwd(constants, statics, state, stress, sort, grid_res, new_v, new_C, g, grid_sum=None):
    """Direct adjoint of ``_step_fwd`` for the output cotangent ``g`` (a
    ``ParticleState``), on the branch ``_step_fwd`` took. With
    ``grid_sum`` the ranks' shares of the grid cotangent are added (the
    one sum of the adjoint); the grid-op vjp then runs on the replicated
    sum and the tap gathers on this rank's particles. Returns the
    scrubbed ``(d_state, d_stress)``."""

    def tail(x, v, C, F, v_, C_):
        return _state_tuple(_g2p_tail(constants, statics, ParticleState(x, v, C, F), v_, C_))

    _, d_tail, _ = _vjp(tail, (*_state_tuple(state), new_v, new_C), _state_tuple(g))
    d_new_v, d_new_C = d_tail[4], d_tail[5]
    kappa = 4.0 * constants.inv_dx * constants.inv_dx
    A2 = kappa * d_new_C
    mass, b, affine = _p2g_terms(constants, statics, state, stress)
    if _slab_grid(constants):
        d_x_s, dgm, db, dA, d_x_g2p = _grid_bwd_slab(
            constants, state.x, sort, grid_res[0], mass, b, affine, d_new_v, A2, grid_sum)
    else:
        d_x_s, dgm, db, dA, d_x_g2p = _grid_bwd_dense(
            constants, state.x, *grid_res, mass, b, affine, d_new_v, A2, grid_sum)

    def prep(x, v, C, F, sr):
        return _p2g_terms(constants, statics, ParticleState(x, v, C, F), sr)

    _, d_prep, _ = _vjp(prep, (*_state_tuple(state), stress), (dgm, db, dA))
    d_state = ParticleState(
        x=_scrub(d_tail[0] + d_x_g2p + d_x_s + d_prep[0]),
        v=_scrub(d_tail[1] + d_prep[1]),
        C=_scrub(d_tail[2] + d_prep[2]),
        F=_scrub(d_tail[3] + d_prep[3]),
    )
    return d_state, _scrub(d_prep[4])


def mpm_step(
    constants: MPMConstants,
    statics: Statics,
    state: ParticleState,
    stress: torch.Tensor,
    sort=None,
) -> ParticleState:
    """One MPM step, p2g -> grid_op -> g2p, on the slab branch above 24
    cells and the dense one otherwise. ``sort`` may carry pre-built or
    refreshed ``StepLayouts`` (the dense branch ignores it)."""
    if sort is None:
        sort = _step_sort(constants, state.x)
    out, _, _, _ = _step_fwd(constants, statics, state, stress, sort)
    return out


class _MPMStepDiff(torch.autograd.Function):
    """``mpm_step`` whose backward is ``_step_bwd``."""

    @staticmethod
    def forward(ctx, constants, statics, sort, grid_sum, x, v, C, F, stress):
        state = ParticleState(x, v, C, F)
        out, grid_res, new_v, new_C = _step_fwd(constants, statics, state, stress, sort,
                                                grid_sum)
        ctx.save_for_backward(x, v, C, F, stress, new_v, new_C, *grid_res)
        ctx.step = (constants, statics, sort, grid_sum)
        return _state_tuple(out)

    @staticmethod
    def backward(ctx, gx, gv, gC, gF):
        x, v, C, F, stress, new_v, new_C, *grid_res = ctx.saved_tensors
        constants, statics, sort, grid_sum = ctx.step
        d_state, d_stress = _step_bwd(
            constants, statics, ParticleState(x, v, C, F), stress, sort, grid_res,
            new_v, new_C, ParticleState(gx, gv, gC, gF), grid_sum,
        )
        return (None, None, None, None, *_state_tuple(d_state), d_stress)


def mpm_step_diff(
    constants: MPMConstants,
    statics: Statics,
    state: ParticleState,
    stress: torch.Tensor,
    sort=None,
    grid_sum: Optional[Callable] = None,
) -> ParticleState:
    """``mpm_step`` with the reference's backward: the direct piece
    adjoint of ``_step_bwd`` with every outgoing cotangent
    NaN/Inf-scrubbed. ``sort`` is not differentiated. ``grid_sum`` (for
    a particle shard on a mesh: ``parallel.sharding.particle_grid_sum``)
    adds the ranks' grid partials in the forward and their grid
    cotangents in the backward."""
    if sort is None:
        sort = _step_sort(constants, state.x)
    return ParticleState(*_MPMStepDiff.apply(constants, statics, sort, grid_sum,
                                             *_state_tuple(state), stress))


def trainable_params(material) -> list:
    """The parameters of a material module that require grad (its LoRA
    leaves); none for a plain callable."""
    if isinstance(material, nn.Module):
        return [p for p in material.parameters() if p.requires_grad]
    return []


class _PackedSubstep(torch.autograd.Function):
    """elasticity -> MPM step -> plasticity; the material parameters
    are explicit inputs so their gradients flow."""

    @staticmethod
    def forward(ctx, step, sort, x, v, C, F, *params):
        constants, statics, elasticity, plasticity, grid_sum = step
        state = ParticleState(x, v, C, F)
        with span("material.elasticity"):
            stress = elasticity(F)
        out, grid_res, new_v, new_C = _step_fwd(constants, statics, state, stress, sort,
                                                grid_sum)
        f2 = out.F
        ctx.save_for_backward(x, v, C, F, stress, new_v, new_C, f2, *grid_res)
        ctx.step, ctx.sort = step, sort
        with span("material.plasticity"):
            f_out = plasticity(f2)
        return out.x, out.v, out.C, f_out

    @staticmethod
    @span("mpm.substep.bwd")
    def backward(ctx, gx, gv, gC, gF):
        x, v, C, F, stress, new_v, new_C, f2, *grid_res = ctx.saved_tensors
        constants, statics, elasticity, plasticity, grid_sum = ctx.step
        e_params, p_params = trainable_params(elasticity), trainable_params(plasticity)
        # Each material's vjp from a recompute of its forward.
        with span("material.plasticity"):
            _, (d_f2,), d_pp = _vjp(plasticity, (f2,), (gF,), p_params)
        state = ParticleState(x, v, C, F)
        d_s, d_stress = _step_bwd(
            constants, statics, state, stress, ctx.sort, grid_res, new_v, new_C,
            ParticleState(gx, gv, gC, d_f2), grid_sum,
        )
        with span("material.elasticity"):
            _, (d_f_e,), d_pe = _vjp(elasticity, (F,), (d_stress,), e_params)
        return (None, None, d_s.x, d_s.v, d_s.C, d_s.F + d_f_e, *d_pe, *d_pp)


def make_packed_substep(constants: MPMConstants, statics: Statics, elasticity, plasticity,
                        grid_sum: Optional[Callable] = None):
    """One grounding substep (elasticity net -> MPM step -> plasticity
    net) as a single ``torch.autograd.Function``. ``elasticity`` and
    ``plasticity`` are callables on F; where they are ``nn.Module``s,
    their parameters that require grad are the Function's inputs. The
    substep takes the state and its step layouts (None builds them where
    the branch needs them). On a particle shard, ``statics`` is the
    shard's and ``grid_sum`` adds the ranks' grid partials and grid
    cotangents (``mpm_step_diff``)."""

    @span("mpm.substep")
    def substep(s: ParticleState, layouts) -> ParticleState:
        if layouts is None:
            layouts = _step_sort(constants, s.x)
        e_params, p_params = trainable_params(elasticity), trainable_params(plasticity)
        step = (constants, statics, elasticity, plasticity, grid_sum)
        out = _PackedSubstep.apply(step, layouts, *_state_tuple(s), *e_params, *p_params)
        return ParticleState(*out)

    return substep


class _Scrub(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *tensors):
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *cts):
        return tuple(None if c is None else _scrub(c) for c in cts)


def scrub_cotangents(*tensors):
    """Identity whose backward NaN/Inf-scrubs the cotangents: the
    standalone form of the per-step scrub (composed steps wrap their
    differentiable inputs)."""
    out = _Scrub.apply(*tensors)
    return out[0] if len(tensors) == 1 else out
