"""Block layout, chunk payload and the P2G / G2P kernel wrappers.

Counterpart of ``neuma_tpu/sim/p2g_kernel.py``: particles are sorted by
14-cell grid block, carved into padded chunks of ``CHUNK`` = 128 rows,
and packed into the same 48-column payload. Two kernels run on it:

* K1, ``run_p2g_fwd`` (``csrc/p2g.cu``): the blocked APIC scatter, the
  port of ``_p2g_fwd_kernel`` plus the chunk -> block ``.at[c2b].add``
  of ``p2g_slab_scatter``; it returns per-block sums (NB, 4, S, S*S)
  with channels (momentum xyz, mass), lanes ``y * S + z``. Each chunk's
  taps are binned by lane, and clusters of chunks sum their blocks
  through distributed shared memory. The step backward also runs it, as
  the transpose of the G2P gather.
* K2, ``run_apic_gather(derivs=False)`` (``csrc/g2p.cu``): the 27-tap
  G2P gather, the port of ``_make_gather_kernel(derivs=False)``; it
  returns (rows, 16) = dgm | db (3) | dA (9) | 0 (3). A CTA takes half a
  chunk, three threads per row (one per x tap).
* K3, ``run_apic_gather(derivs=True)`` (``csrc/g2p_bwd.cu``): the same
  gather plus the spline-derivative position adjoint in columns 13-15,
  the port of ``_make_gather_kernel(derivs=True)``; the step backward
  runs it twice.

The layouts also take a ``GridGeom`` view (the halo step's per-rank
slab, ``parallel/halo.py``): block counts per axis (non-cubic, e.g.
``(2, 5, 5)``), view-local block ids and tap lines, and line -1 for a tap
outside the view, which every kernel skips. ``p2g_blocked`` (K1 and the
fold onto the view, the JAX package's ``p2g_blocked_pallas``) and
``apic_gather`` (the unfold into slabs, then K2 or K3; its
``apic_gather_tpu``) serve such views and the full cube alike.

Each wrapper takes its plain PyTorch version (``*_plain``) only for
tensors on the CPU; on CUDA tensors it launches the kernel or raises.
The layout glue (sorts, carving, payload, halo add, fold and unfold, the
slab <-> dense grid views of the public scatter and gather) is plain
torch.
Every ``argsort`` passes ``stable=True``, as ``jnp.argsort`` is stable.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..core.types import GridGeom, MPMConstants, geom_dims
from ..utils.profiling import counters, span

BLOCK = 14
S = BLOCK + 2  # 16: padded block side; S^2 = 256 lanes
CHUNK = 128  # scatter chunk (the JAX package's NEUMA_SCATTER_CHUNK default)
GATHER_CHUNK = 128  # gather chunk (NEUMA_GATHER_CHUNK default)

# payload column layout (44 used, padded to 48)
_W0 = 0  # 9: spline weights, 3 taps x 3 axes (x taps 0-2, y 3-5, z 6-8)
_L0 = 9  # 9: local tap grid lines (as f32 ints)
_BE0 = 18  # 3: b_eff = b - (A @ fx) * dx
_AC0 = 21  # 9: a_cols = A * dx, row-major
_GM = 30  # 1: mass channel value
_WD0 = 32  # 9: spline weight derivatives d w / d fx
_FX0 = 41  # 3: fx
_COLS = 48
_OUT_COLS = 16  # dgm | db (3) | dA (9) | dx (3)

# Static 3x3x3 tap offsets, (27, 3), x-major.
_OFFSETS = np.stack(
    np.meshgrid(np.arange(3), np.arange(3), np.arange(3), indexing="ij"), axis=-1
).reshape(27, 3)


class ChunkLayout(NamedTuple):
    src: torch.Tensor  # (M*C,) int64 source particle per padded slot
    valid: torch.Tensor  # (M*C,) float 1.0 for live slots
    c2b: torch.Tensor  # (M,) int32 block id per chunk, non-decreasing
    dest: torch.Tensor  # (N,) int64 padded slot of each particle


class BlockSort(NamedTuple):
    perm: torch.Tensor  # (N,) block-sorted order
    inv_perm: torch.Tensor  # (N,) rank of each particle in sorted order
    bstart: torch.Tensor  # (NB,) first sorted index of each block
    counts: torch.Tensor  # (NB,) particles per block
    bid: torch.Tensor  # (N,) flat block id per particle
    base: torch.Tensor  # (N, 3) stencil base cell
    fx: torch.Tensor  # (N, 3) fractional position
    loc: torch.Tensor  # (N, 3, 3) local tap grid lines in [0, S); -1 outside a view


class StepLayouts(NamedTuple):
    sort: BlockSort
    scatter: ChunkLayout  # chunk == CHUNK
    gather: ChunkLayout  # chunk == GATHER_CHUNK


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _num_blocks(constants: MPMConstants, geom: Optional[GridGeom] = None):
    """Blocks per axis of the grid view (the full cube without ``geom``)
    and their product: ``nbs = cdiv(dims, BLOCK)``, non-cubic in a view."""
    nbs = tuple(_cdiv(d, BLOCK) for d in geom_dims(constants, geom))
    return nbs, nbs[0] * nbs[1] * nbs[2]


def _sort_geometry(constants: MPMConstants, x: torch.Tensor, geom: Optional[GridGeom] = None):
    """Stencil base, fractional position, local tap lines and flat block
    id per particle. With a ``geom`` view the base is clamped into the
    grid, then into the view, block ids and lines are view-local, and a
    tap outside the view gets line -1 (the kernels give it nothing)."""
    g = constants.num_grids
    (nbx, nby, nbz), NB = _num_blocks(constants, geom)
    p_x = x * constants.inv_dx
    base = torch.floor(p_x - 0.5).to(torch.int64)
    fx = p_x - base.to(x.dtype)
    taps = torch.clamp(
        base[:, :, None] + torch.arange(3, device=x.device)[None, None, :], 0, g - 1
    )
    if geom is None:
        blk = torch.clamp(base, 0, g - 1) // BLOCK
        loc = taps - (blk * BLOCK)[:, :, None]
    else:
        origin = geom.origin.to(device=x.device, dtype=torch.int64)
        dims = torch.as_tensor(geom.dims, device=x.device)
        bloc = torch.minimum(torch.clamp(torch.clamp(base, 0, g - 1) - origin, min=0), dims - 1)
        blk = bloc // BLOCK
        tl = taps - origin[None, :, None]
        loc = tl - (blk * BLOCK)[:, :, None]
        in_view = (tl >= 0) & (tl < dims[None, :, None]) & (loc >= 0) & (loc < S)
        loc = torch.where(in_view, loc, -1)
    bid = (blk[:, 0] * nby + blk[:, 1]) * nbz + blk[:, 2]
    return base, fx, loc, bid, NB


def block_sort(constants: MPMConstants, x: torch.Tensor,
               geom: Optional[GridGeom] = None) -> BlockSort:
    """Stable order by (block id, index) plus per-block ranges, in the
    ``geom`` view's blocks (the full cube without it)."""
    n = x.shape[0]
    base, fx, loc, bid, NB = _sort_geometry(constants, x, geom)
    perm = torch.argsort(bid, stable=True)
    counts = torch.bincount(bid, minlength=NB)
    bstart = torch.cumsum(counts, 0) - counts
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(n, device=x.device)
    return BlockSort(perm, inv_perm, bstart, counts, bid, base, fx, loc)


def build_chunk_layout(
    constants: MPMConstants, x: torch.Tensor, chunk: int = CHUNK, sort: Optional[BlockSort] = None,
    geom: Optional[GridGeom] = None,
) -> Tuple[ChunkLayout, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Carve the block-sorted order into ``chunk``-row padded chunks:
    M = ceil(N / C) + NB chunks, each block's run padded to a multiple
    of C. Returns (layout, base, fx, loc). ``sort`` must come from the
    same ``geom``."""
    _, NB = _num_blocks(constants, geom)
    n = x.shape[0]
    C = chunk
    M = _cdiv(n, C) + NB
    dev = x.device
    if sort is None:
        sort = block_sort(constants, x, geom)
    perm, bstart, counts, bid = sort.perm, sort.bstart, sort.counts, sort.bid

    nchunk = (counts + C - 1) // C
    cum = torch.cumsum(nchunk, 0)
    cid = torch.arange(M, device=dev)
    c2b = torch.searchsorted(cum, cid, right=True)
    in_range = c2b < NB
    c2b = torch.clamp(c2b, max=NB - 1)
    prev_chunks = torch.where(c2b > 0, cum[torch.clamp(c2b - 1, min=0)], 0)
    rank = cid - prev_chunks
    start = bstart[c2b] + rank * C
    cnt = torch.clamp(counts[c2b] - rank * C, 0, C) * in_range

    lane = torch.arange(C, device=dev)
    slot = start[:, None] + lane[None, :]
    valid = (lane[None, :] < cnt[:, None]).reshape(-1).to(x.dtype)
    src = perm[torch.clamp(slot, 0, n - 1)].reshape(-1)
    dest = C * torch.where(bid > 0, cum[torch.clamp(bid - 1, min=0)], 0) + (
        sort.inv_perm - bstart[bid]
    )
    layout = ChunkLayout(src, valid, c2b.to(torch.int32), dest)
    return layout, sort.base, sort.fx, sort.loc


@span("mpm.layouts")
def build_step_layouts(constants: MPMConstants, x: torch.Tensor,
                       geom: Optional[GridGeom] = None) -> StepLayouts:
    """Block sort and chunk carving of ``x.detach()`` in the ``geom``
    view: the layouts carry no autograd graph, as the JAX package builds
    them from ``stop_gradient(x)``."""
    x = x.detach()
    sort = block_sort(constants, x, geom)
    scatter, _, _, _ = build_chunk_layout(constants, x, CHUNK, sort, geom)
    # GATHER_CHUNK == CHUNK: the scatter and gather carvings are one.
    return StepLayouts(sort, scatter, scatter)


def refresh_step_layouts(
    constants: MPMConstants, x: torch.Tensor, stale: StepLayouts
) -> Tuple[StepLayouts, bool]:
    """Reuse the stale sort when no particle changed block (recomputing
    only the elementwise geometry), else rebuild. A Python ``if`` on
    ``(bid == stale.sort.bid).all()`` takes the place of ``lax.cond``:
    one host sync per substep. Runs on ``x.detach()``. Returns
    ``(layouts, reused)``; counts ``layouts.refreshed`` and, for a
    rebuild, ``layouts.rebuilt`` in ``utils.profiling.counters``."""
    counters["layouts.refreshed"] += 1
    x = x.detach()
    with span("mpm.layouts"):
        base, fx, loc, bid, _ = _sort_geometry(constants, x)
        same = bool(torch.equal(bid, stale.sort.bid))
    if same:
        sort = stale.sort._replace(base=base, fx=fx, loc=loc)
        return StepLayouts(sort, stale.scatter, stale.gather), True
    counters["layouts.rebuilt"] += 1
    return build_step_layouts(constants, x), False


def _resolve_layout(
    constants: MPMConstants, x: torch.Tensor, chunk: int, shared, geom: Optional[GridGeom] = None
) -> Tuple[ChunkLayout, BlockSort]:
    """``shared`` may be None, a BlockSort or a StepLayouts, built with
    the same ``geom`` (the layouts are view-local)."""
    if isinstance(shared, StepLayouts):
        if chunk == CHUNK:
            return shared.scatter, shared.sort
        if chunk == GATHER_CHUNK:
            return shared.gather, shared.sort
        shared = shared.sort
    if shared is None:
        shared = block_sort(constants, x, geom)
    layout, _, _, _ = build_chunk_layout(constants, x, chunk, shared, geom)
    return layout, shared


def pack_payload(
    constants: MPMConstants,
    layout: ChunkLayout,
    fx: torch.Tensor,
    loc: torch.Tensor,
    gm: Optional[torch.Tensor],
    b: torch.Tensor,
    A: torch.Tensor,
) -> torch.Tensor:
    """The padded (M*C, 48) chunk payload."""
    n = fx.shape[0]
    dtype = fx.dtype
    wa = 1.5 - fx
    wb = fx - 1.0
    wc = fx - 0.5
    w = torch.stack([0.5 * wa * wa, 0.75 - wb * wb, 0.5 * wc * wc], dim=-1)
    wd = torch.stack([-wa, -2.0 * wb, wc], dim=-1)
    dxc = constants.dx
    b_eff = b - torch.einsum("nij,nj->ni", A, fx) * dxc
    a_cols = A * dxc
    zeros = lambda k: torch.zeros((n, k), dtype=dtype, device=fx.device)
    cols = [
        w.reshape(n, 9),
        loc.to(dtype).reshape(n, 9),
        b_eff,
        a_cols.reshape(n, 9),
        (gm if gm is not None else torch.zeros((n,), dtype=dtype, device=fx.device))[:, None],
        zeros(1),
        wd.reshape(n, 9),
        fx,
        zeros(_COLS - 44),
    ]
    payload = torch.cat(cols, dim=1)
    return (payload[layout.src] * layout.valid[:, None]).contiguous()


# --------------------------------------------------------------------------
# K1: blocked P2G scatter
# --------------------------------------------------------------------------


def _block_sums(partials: torch.Tensor, c2b: torch.Tensor, NB: int) -> torch.Tensor:
    """Chunk -> block sum over the non-decreasing ``c2b``: each block adds
    its contiguous run of chunks in chunk order (the order of the CPU's
    ``index_add_``), with no atomics, so it repeats bit for bit on the card."""
    c2b = c2b.to(torch.int64)
    M = partials.shape[0]
    counts = torch.bincount(c2b, minlength=NB)
    first = torch.cumsum(counts, 0) - counts
    out = torch.zeros((NB,) + partials.shape[1:], dtype=partials.dtype, device=partials.device)
    for r in range(int(counts.max()) if M else 0):
        live = (r < counts).reshape((NB,) + (1,) * (partials.dim() - 1))
        out = torch.where(live, out + partials[torch.clamp(first + r, max=M - 1)], out)
    return out


def run_p2g_fwd_plain(payload: torch.Tensor, c2b: torch.Tensor, NB: int) -> torch.Tensor:
    """Plain version of K1: one-hot spline rows contracted per chunk
    (as ``_p2g_fwd_kernel`` does), then the ordered chunk -> block sum."""
    M = c2b.shape[0]
    C = payload.shape[0] // M
    p = payload.reshape(M, C, _COLS)
    idx = torch.arange(S, device=payload.device)

    def axis_rows(a):
        W = torch.zeros((M, C, S), dtype=payload.dtype, device=payload.device)
        Wi = torch.zeros_like(W)
        for t in range(3):
            oh = (idx == p[..., _L0 + 3 * a + t].to(torch.int64)[..., None]).to(payload.dtype)
            wt = p[..., _W0 + 3 * a + t][..., None]
            W = W + wt * oh
            if t:
                Wi = Wi + float(t) * wt * oh
        return W, Wi

    Wx, Wix = axis_rows(0)
    Wy, Wiy = axis_rows(1)
    Wz, Wiz = axis_rows(2)
    yz = (Wy[..., :, None] * Wz[..., None, :]).reshape(M, C, S * S)
    yz_i = (Wiy[..., :, None] * Wz[..., None, :]).reshape(M, C, S * S)
    yz_k = (Wy[..., :, None] * Wiz[..., None, :]).reshape(M, C, S * S)

    def col(j):
        return p[..., j][..., None]

    def dott(lhs, rhs):
        return torch.einsum("mcs,mcq->msq", lhs, rhs)

    parts = []
    for r in range(3):
        lhs = yz * col(_BE0 + r) + yz_i * col(_AC0 + 3 * r + 1) + yz_k * col(_AC0 + 3 * r + 2)
        parts.append(dott(Wx, lhs) + dott(Wix, yz * col(_AC0 + 3 * r)))
    parts.append(dott(Wx * col(_GM), yz))
    partials = torch.stack(parts, dim=1)  # (M, 4, S, S*S)
    return _block_sums(partials, c2b, NB)


def run_p2g_fwd(payload: torch.Tensor, c2b: torch.Tensor, NB: int) -> torch.Tensor:
    """K1: payload (M*CHUNK, 48), c2b (M,) int32 non-decreasing ->
    per-block sums (NB, 4, S, S*S). Plain version on CPU tensors."""
    if not payload.is_cuda:
        return run_p2g_fwd_plain(payload, c2b, NB)
    M = c2b.shape[0]
    kernels.require(payload, "payload", (M * CHUNK, _COLS), torch.float32)
    kernels.require(c2b, "c2b", (M,), torch.int32)
    lib = kernels.library()
    out = torch.empty((NB, 4, S, S * S), dtype=torch.float32, device=payload.device)
    words = lib.neuma_p2g_scratch_words(M, NB)
    scratch = torch.empty((words,), dtype=torch.int32, device=payload.device)
    rc = lib.neuma_p2g_fwd(
        payload.data_ptr(), c2b.data_ptr(), M, NB, scratch.data_ptr(), out.data_ptr(),
        kernels.stream(payload.device),
    )
    kernels.check(rc, "neuma_p2g_fwd")
    kernels.launches["p2g"] += 1
    return out


# --------------------------------------------------------------------------
# K2 / K3: G2P tap gather, without and with the spline derivatives
# --------------------------------------------------------------------------


def run_apic_gather_plain(
    payload: torch.Tensor,
    slabs: torch.Tensor,
    c2b: torch.Tensor,
    inv_dx: float,
    derivs: bool = False,
) -> torch.Tensor:
    """Plain version of K2 (``derivs=False``) and K3 (``derivs=True``):
    per payload row, the 27 taps read from its block's slab (ch, x, y, z),
    with the (t - fx) factor applied per tap; a tap on a line outside
    0..S-1 reads zero (the TPU kernel's one-hot factors are zero there, and
    the CUDA kernels skip it). With ``derivs`` columns
    13-15 hold the position adjoint

        dx_a = inv_dx sum_o dW_a,o s_o - inv_dx sum_i a_col[i, a] db_i,
        s_o  = u_o gm + sum_r v_r,o (b_eff_r + sum_c a_col[r, c] o_c),

    with dW_a,o the tap weight whose axis-a factor is the derivative
    column ``_WD0`` (as ``_make_gather_kernel(derivs=True)``)."""
    rows = payload.shape[0]
    M = c2b.shape[0]
    C = rows // M
    NB = slabs.shape[0]
    dev = payload.device
    flat = slabs.reshape(NB * 4 * S ** 3)
    blk = torch.repeat_interleave(c2b.to(torch.int64), C)
    w = payload[:, _W0 : _W0 + 9].reshape(rows, 3, 3)
    lines = payload[:, _L0 : _L0 + 9].to(torch.int64).reshape(rows, 3, 3)
    fx = payload[:, _FX0 : _FX0 + 3]
    taps = torch.arange(3, dtype=payload.dtype, device=dev)
    wp = w * (taps[None, None, :] - fx[:, :, None])  # w * (t - fx)
    ox, oy, oz = (torch.as_tensor(_OFFSETS[:, a], device=dev) for a in range(3))
    wxo, wyo, wzo = w[:, 0, ox], w[:, 1, oy], w[:, 2, oz]
    W = wxo * wyo * wzo  # (rows, 27)
    Wp = (wp[:, 0, ox] * wyo * wzo, wxo * wp[:, 1, oy] * wzo, wxo * wyo * wp[:, 2, oz])
    inside = (lines >= 0) & (lines < S)
    inside = inside[:, 0, ox] & inside[:, 1, oy] & inside[:, 2, oz]  # (rows, 27)
    lines = lines.clamp(0, S - 1)
    cell = (lines[:, 0, ox] * S + lines[:, 1, oy]) * S + lines[:, 2, oz]
    vals = [torch.where(inside, flat[(blk[:, None] * 4 + ch) * S ** 3 + cell], 0.0)
            for ch in range(4)]
    out = torch.zeros((rows, _OUT_COLS), dtype=payload.dtype, device=dev)
    out[:, 0] = (W * vals[3]).sum(1)
    dxc = 1.0 / inv_dx
    for r in range(3):
        out[:, 1 + r] = (W * vals[r]).sum(1)
        for c in range(3):
            out[:, 4 + 3 * r + c] = dxc * (Wp[c] * vals[r]).sum(1)
    if not derivs:
        return out
    wd = payload[:, _WD0 : _WD0 + 9].reshape(rows, 3, 3)
    dW = (wd[:, 0, ox] * wyo * wzo, wxo * wd[:, 1, oy] * wzo, wxo * wyo * wd[:, 2, oz])
    gm = payload[:, _GM : _GM + 1]
    ac = payload[:, _AC0 : _AC0 + 9].reshape(rows, 3, 3)  # a_col[r, c] = A[r, c] dx
    off = torch.as_tensor(_OFFSETS, dtype=payload.dtype, device=dev)  # (27, 3)
    s_o = vals[3] * gm
    for r in range(3):
        coef = payload[:, _BE0 + r : _BE0 + r + 1] + ac[:, r, :] @ off.T  # (rows, 27)
        s_o = s_o + vals[r] * coef
    for a in range(3):
        minus = sum(ac[:, i, a] * out[:, 1 + i] for i in range(3))
        out[:, 13 + a] = inv_dx * (dW[a] * s_o).sum(1) - inv_dx * minus
    return out


def run_apic_gather(
    payload: torch.Tensor,
    slabs: torch.Tensor,
    c2b: torch.Tensor,
    inv_dx: float,
    derivs: bool = False,
) -> torch.Tensor:
    """K2 (``derivs=False``) or K3 (``derivs=True``): payload (M*C, 48),
    slabs (NB, 4, S, S, S), c2b (M,) int32 -> (M*C, 16). Plain version on
    CPU tensors."""
    if not payload.is_cuda:
        return run_apic_gather_plain(payload, slabs, c2b, inv_dx, derivs)
    M = c2b.shape[0]
    rows = payload.shape[0]
    if rows % M:
        raise ValueError(f"payload rows {rows} are not a multiple of {M} chunks")
    NB = slabs.shape[0]
    kernels.require(payload, "payload", (rows, _COLS), torch.float32)
    kernels.require(slabs, "slabs", (NB, 4, S, S, S), torch.float32)
    kernels.require(c2b, "c2b", (M,), torch.int32)
    lib = kernels.library()
    out = torch.empty((rows, _OUT_COLS), dtype=torch.float32, device=payload.device)
    stream = kernels.stream(payload.device)
    ptrs = (payload.data_ptr(), slabs.data_ptr(), c2b.data_ptr(), rows, rows // M)
    per_cta = lib.neuma_g2p_derivs_rows_per_cta() if derivs else lib.neuma_g2p_rows_per_cta()
    if (rows // M) % per_cta or payload.data_ptr() % 16:
        raise ValueError(f"{'K3' if derivs else 'K2'} takes 16-byte aligned chunks of a multiple "
                         f"of {per_cta} rows, got {rows // M}")
    if derivs:
        name, count = "neuma_g2p_gather_derivs", "g2p_derivs"
        rc = lib.neuma_g2p_gather_derivs(*ptrs, 1.0 / inv_dx, float(inv_dx), out.data_ptr(), stream)
    else:
        name, count = "neuma_g2p_gather", "g2p"
        rc = lib.neuma_g2p_gather(*ptrs, 1.0 / inv_dx, out.data_ptr(), stream)
    kernels.check(rc, name)
    kernels.launches[count] += 1
    return out


# --------------------------------------------------------------------------
# slab-space grid chain
# --------------------------------------------------------------------------


def _shift_blocks(t: torch.Tensor, ax: int, direction: int) -> torch.Tensor:
    """Shift along a block axis: -1 brings block b+1 to slot b (zero at
    the end), +1 brings b-1 (zero at the start)."""
    n = t.shape[ax]
    zshape = list(t.shape)
    zshape[ax] = 1
    z = torch.zeros(zshape, dtype=t.dtype, device=t.device)
    if direction == -1:
        return torch.cat([t.narrow(ax, 1, n - 1), z], dim=ax)
    return torch.cat([z, t.narrow(ax, 0, n - 1)], dim=ax)


def halo_add_slabs(pb: torch.Tensor, nbs) -> torch.Tensor:
    """Per-block sums (NB, CH, S, S*S) -> halo-complete slabs: slab line
    l of block b holds dense grid line 14*b + l. Same two-operand adds
    as the JAX package (z, then y, then x), so the result is equal."""
    nbx, nby, nbz = nbs
    NB, ch = pb.shape[0], pb.shape[1]
    B = BLOCK
    t = pb.reshape(nbx, nby, nbz, ch, S, S * S)

    zmod = torch.arange(S * S, device=pb.device) % S
    prev_tail = torch.roll(_shift_blocks(t, 2, +1), -B, dims=-1)
    next_core = torch.roll(_shift_blocks(t, 2, -1), B, dims=-1)
    t = torch.where(zmod < 2, t + prev_tail, torch.where(zmod >= B, next_core + t, t))

    prev = _shift_blocks(t, 1, +1)
    nxt = _shift_blocks(t, 1, -1)
    head = t[..., : 2 * S] + prev[..., B * S :]
    mid = t[..., 2 * S : B * S]
    tail = nxt[..., : 2 * S] + t[..., B * S :]
    t = torch.cat([head, mid, tail], dim=-1)

    prev = _shift_blocks(t, 0, +1)
    nxt = _shift_blocks(t, 0, -1)
    head = t[:, :, :, :, 0:2] + prev[:, :, :, :, B:S]
    mid = t[:, :, :, :, 2:B]
    tail = nxt[:, :, :, :, 0:2] + t[:, :, :, :, B:S]
    t = torch.cat([head, mid, tail], dim=4)
    return t.reshape(NB, ch, S, S * S)


def slabs_to_dense(slabs: torch.Tensor, num_grids: int) -> torch.Tensor:
    """Halo-complete slabs (NB, CH, S, S*S) or (NB, CH, S, S, S) -> the
    dense (G^3, CH) grid: block b's core lines 0..13 are dense lines
    14 b + l (a halo-complete slab repeats its neighbours' values in its
    last two lines, so the cores alone tile the grid)."""
    g = num_grids
    nb = _cdiv(g, BLOCK)
    ch = slabs.shape[1]
    t = slabs.reshape(nb, nb, nb, ch, S, S, S)[..., :BLOCK, :BLOCK, :BLOCK]
    t = t.permute(0, 4, 1, 5, 2, 6, 3).reshape(nb * BLOCK, nb * BLOCK, nb * BLOCK, ch)
    return t[:g, :g, :g].reshape(g ** 3, ch)


def unfold_blocks(grid_ch: torch.Tensor, dims, nbs, ch_out: int = 4) -> torch.Tensor:
    """A grid view (num_cells, CH <= ch_out) of ``dims`` cells -> per-block
    slabs (NB, ch_out, S, S, S): slab b covers the view's lines
    ``[b * BLOCK, b * BLOCK + S)`` per axis, zero past the view and in the
    missing channels; blocks in x-major flat order (``nbs`` per axis). The
    JAX package's ``unfold_blocks`` and ``_unfold_axis``, as one gather."""
    gx, gy, gz = dims
    ch = grid_ch.shape[1]
    gp = [n * BLOCK + 2 for n in nbs]
    arr = grid_ch.reshape(gx, gy, gz, ch)
    arr = torch.nn.functional.pad(
        arr, (0, ch_out - ch, 0, gp[2] - gz, 0, gp[1] - gy, 0, gp[0] - gx))
    lines = [(torch.arange(n, device=grid_ch.device)[:, None] * BLOCK
              + torch.arange(S, device=grid_ch.device)[None, :]) for n in nbs]  # (nb, S)
    t = arr[lines[0]][:, :, lines[1]][:, :, :, :, lines[2]]  # (nbx, S, nby, S, nbz, S, ch)
    return t.permute(0, 2, 4, 6, 1, 3, 5).reshape(
        nbs[0] * nbs[1] * nbs[2], ch_out, S, S, S).contiguous()


def _fold_axis(x: torch.Tensor, block: int) -> torch.Tensor:
    """(..., nb, S, rest) -> (..., nb * block, rest): block cores
    concatenate (stride == block) and each block's 2-line tail adds onto
    the next block's head; the last block's tail is dropped."""
    core = x[..., :block, :]
    tail = x[..., block:, :]
    zeros = lambda shape: x.new_zeros(shape)
    tailpad = torch.cat([tail, zeros(tail.shape[:-2] + (block - tail.shape[-2],) + tail.shape[-1:])],
                        dim=-2)
    shifted = torch.cat([zeros(tailpad.shape[:-3] + (1,) + tailpad.shape[-2:]), tailpad[..., :-1, :, :]],
                        dim=-3)
    out = core + shifted
    return out.reshape(x.shape[:-3] + (x.shape[-3] * block,) + x.shape[-1:])


def _fold_blocks(pb: torch.Tensor, dims, nbs, block: int) -> torch.Tensor:
    """Per-block (NB, S, S, S, CH) buffers -> the (gx, gy, gz, CH) grid
    view: fold z, then y, then x, with the JAX package's operand order."""
    S = block + 2
    gx, gy, gz = dims
    nbx, nby, nbz = nbs
    ch = pb.shape[-1]
    t = pb.reshape(nbx, nby, nbz, S, S, S, ch).permute(0, 1, 3, 4, 2, 5, 6)
    t = _fold_axis(t, block)  # (nbx, nby, S, S, Gz, ch)
    t = _fold_axis(t.permute(0, 2, 4, 1, 3, 5), block)  # (nbx, S, Gz, Gy, ch)
    t = _fold_axis(t.permute(2, 3, 0, 1, 4), block)  # (Gz, Gy, Gx, ch)
    return t.permute(2, 1, 0, 3)[:gx, :gy, :gz]


def _fold(pb: torch.Tensor, dims, nbs) -> torch.Tensor:
    """Per-block sums (NB, 4, S, S*S) -> the (num_cells, 4) grid view:
    block cores tile the view and each block's 2-line tails add onto the
    next block's head, per axis (``_fold_blocks``)."""
    NB = pb.shape[0]
    t = pb.reshape(NB, 4, S, S, S).permute(0, 2, 3, 4, 1)
    return _fold_blocks(t, dims, nbs, BLOCK).reshape(dims[0] * dims[1] * dims[2], 4)


def p2g_blocked(
    constants: MPMConstants,
    x: torch.Tensor,
    gm: Optional[torch.Tensor],
    b: torch.Tensor,
    A: torch.Tensor,
    sort=None,
    geom: Optional[GridGeom] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Blocked APIC scatter into the ``geom`` view (the full cube without
    it): K1's per-block sums folded onto the view, (grid_m (cells,) or
    None, grid_f (cells, 3)). The JAX package's ``p2g_blocked_pallas``.
    ``sort`` may carry the step's layouts, built with the same ``geom``."""
    dims = geom_dims(constants, geom)
    nbs, NB = _num_blocks(constants, geom)
    layout, bsort = _resolve_layout(constants, x, CHUNK, sort, geom)
    payload = pack_payload(constants, layout, bsort.fx, bsort.loc, gm, b, A)
    grid = _fold(run_p2g_fwd(payload, layout.c2b, NB), dims, nbs)
    return (grid[:, 3] if gm is not None else None), grid[:, :3]


def apic_gather(
    constants: MPMConstants,
    x: torch.Tensor,
    gm: Optional[torch.Tensor],
    b: torch.Tensor,
    A: torch.Tensor,
    df: torch.Tensor,
    du: Optional[torch.Tensor],
    derivs: bool = True,
    sort=None,
    geom: Optional[GridGeom] = None,
):
    """Blocked tap gather against the view grid's channels ``df`` (cells,
    3) and ``du`` (cells,) or None: the view unfolded into slabs, then K3
    (``derivs``) or K2. Returns per particle (dx (N, 3), dgm (N,) or
    None, db (N, 3), dA (N, 3, 3)). The JAX package's ``apic_gather_tpu``."""
    n = x.shape[0]
    dims = geom_dims(constants, geom)
    nbs, _ = _num_blocks(constants, geom)
    layout, bsort = _resolve_layout(constants, x, GATHER_CHUNK, sort, geom)
    payload = pack_payload(constants, layout, bsort.fx, bsort.loc, gm, b, A)
    grid_ch = df if du is None else torch.cat([df, du[:, None]], dim=1)
    slabs = unfold_blocks(grid_ch, dims, nbs)
    res = run_apic_gather(payload, slabs, layout.c2b, float(constants.inv_dx), derivs)[layout.dest]
    dgm = res[:, 0] if du is not None else None
    return res[:, 13:16], dgm, res[:, 1:4], res[:, 4:13].reshape(n, 3, 3)


def p2g_slab_scatter(
    constants: MPMConstants,
    x: torch.Tensor,
    gm: Optional[torch.Tensor],
    b: torch.Tensor,
    A: torch.Tensor,
    sort=None,
    grid_sum=None,
) -> torch.Tensor:
    """Blocked APIC scatter (K1) straight to halo-complete slabs
    (NB, 4, S, S*S); channel 3 carries mass (zero when ``gm`` is None).
    ``grid_sum`` (a particle shard on a mesh) adds K1's per-block sums
    over the ranks before the halo add."""
    nbs, NB = _num_blocks(constants)
    layout, bsort = _resolve_layout(constants, x, CHUNK, sort)
    payload = pack_payload(constants, layout, bsort.fx, bsort.loc, gm, b, A)
    pb = run_p2g_fwd(payload, layout.c2b, NB)
    if grid_sum is not None:
        pb = grid_sum(pb)
    return halo_add_slabs(pb, nbs)


def gather_from_slabs(
    constants: MPMConstants,
    x: torch.Tensor,
    slabs: torch.Tensor,
    gm: Optional[torch.Tensor],
    b: torch.Tensor,
    A: torch.Tensor,
    derivs: bool = True,
    sort=None,
):
    """Tap gather against merged slabs: K3 with the spline derivatives
    (``derivs=True``, the step backward) or K2 without (the forward,
    where dx is zero). Returns (dx, dgm, db, dA) per particle."""
    n = x.shape[0]
    NB = slabs.shape[0]
    layout, bsort = _resolve_layout(constants, x, GATHER_CHUNK, sort)
    payload = pack_payload(constants, layout, bsort.fx, bsort.loc, gm, b, A)
    out = run_apic_gather(
        payload, slabs.reshape(NB, 4, S, S, S), layout.c2b, float(constants.inv_dx), derivs
    )
    res = out[layout.dest]
    dgm = res[:, 0] if gm is not None else None
    return res[:, 13:16], dgm, res[:, 1:4], res[:, 4:13].reshape(n, 3, 3)
