"""Tile-composite kernels, forward (K4) and backward (K5), with their
plain versions and the differentiable ``composite_pairs``.

Counterpart of ``neuma_tpu/render/pallas_raster.py`` (``_fwd_kernel``
launched by ``_composite_fwd_impl``, ``_bwd_kernel`` launched by
``_composite_vjp_bwd``, both under the custom VJP
``composite_pairs_tpu``; and ``_padded_starts``). The CUDA kernels are
``csrc/composite.cu`` and ``csrc/composite_bwd.cu``, which share the
guard, the row culling and the segment plan (``csrc/composite_common.cuh``).
K4 composites each pixel front to back over its tile's depth-sorted pair
range up to the true count with the CUDA rasterizer's guard set (power
<= 0, alpha >= 1/255, alpha capped at 0.99, the pixel stops before a
contribution would take T below 1e-4). The kernel cuts each range into
fixed-length segments that run in parallel, then combines their
transmittance products and colour sums per pixel in order, walking
again the one segment where a pixel stops.

Contract (the TPU kernel's): ``pair_feats`` (P, 9) = mean2d (2) | conic
(3) | opacity | rgb (3); ``tile_start`` (T+1,) CHUNK-aligned range
starts; ``tile_counts`` (T,) true pair counts. Outputs T (T, 256),
C (T, 768) channel-blocked, ``last`` (T, 256) the last contributing
pair index as a float, -1 where none. Pixel lane ``l`` of tile ``t`` is
(x, y) = (16 (t % tiles_x) + l % 16, 16 (t // tiles_x) + l // 16).
The TPU's PAIR_W = 128 feature padding and GROUP = 8 tile grouping are
not part of the contract and are not kept.

K5 walks each tile back to front from every pixel's ``last``, rebuilds
the exclusive transmittance by dividing the forward T by ``1 - alpha``,
and writes one (9,) gradient row per pair slot (mean2d.xy, conic.abc,
opacity, rgb), summed over the tile's 256 pixels; the 0.99 alpha cap is
ignored in the chain, as in the CUDA rasterizer. The kernel cuts each
walk into fixed-length segments that run in parallel, each started
from per-segment transmittance and colour summaries (the algebra is in
the kernel's note and ``tests/test_torch_composite_segments.py``). Each
slot belongs to one tile, so the rows never collide. Rows of pad slots
and past ``tile_start[-1]`` are zero.
"""
from __future__ import annotations

import time

import torch

from .. import kernels
from ..utils.profiling import counters, span

TILE = 16
PIX = TILE * TILE
CHUNK = 32  # tile-range alignment (the JAX package's NEUMA_RASTER_CHUNK default)
GROUP = 8  # tile grouping of the TPU launch grid, for _padded_starts


def _padded_starts(tile_start, tile_counts, num_tiles, group: int = GROUP):
    """Pad offsets/counts to a multiple of ``group`` tiles; pad tiles get
    empty ranges (and composite to T = 1, C = 0, last = -1)."""
    num_pad = ((num_tiles + group - 1) // group) * group
    if num_pad == num_tiles:
        return tile_start, tile_counts, num_pad
    pad = tile_start[-1:].expand(num_pad - num_tiles)
    zpad = torch.zeros((num_pad - num_tiles,), dtype=tile_counts.dtype, device=tile_counts.device)
    return torch.cat([tile_start, pad]), torch.cat([tile_counts, zpad]), num_pad


def composite_fwd_plain(pair_feats, tile_start, tile_counts, tiles_x: int, tile_base: int = 0):
    """Plain version of K4: the renderCUDA loop, one pair slot at a time
    for all tiles and pixels at once. ``tile_base`` is the frame index of
    the first tile (``tile_start`` / ``tile_counts`` then describe a range
    of the frame's tiles)."""
    dev = pair_feats.device
    num_tiles = tile_counts.shape[0]
    P = pair_feats.shape[0]
    t_idx = torch.arange(num_tiles, device=dev) + tile_base
    lane = torch.arange(PIX, device=dev)
    px = ((t_idx % tiles_x) * TILE)[:, None] + (lane % TILE)[None, :]
    py = ((t_idx // tiles_x) * TILE)[:, None] + (lane // TILE)[None, :]
    px, py = px.to(torch.float32), py.to(torch.float32)
    T = torch.ones((num_tiles, PIX), dtype=torch.float32, device=dev)
    C = [torch.zeros_like(T) for _ in range(3)]
    last = torch.full_like(T, -1.0)
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=dev)
    starts = tile_start[:-1].to(torch.int64)
    counts = tile_counts.to(torch.int64)
    max_count = int(counts.max().item()) if num_tiles else 0
    inv255 = 1.0 / 255.0
    for s in range(max_count):
        idx = starts + s
        live = (s < counts)[:, None]
        f = pair_feats[torch.clamp(idx, max=P - 1)]
        col = lambda j: f[:, j : j + 1]
        dx = col(0) - px
        dy = col(1) - py
        power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
        alpha = torch.clamp(col(5) * torch.exp(power), max=0.99)
        valid = live & ~done & (power <= 0.0) & (alpha >= inv255)
        test_T = T * (1.0 - alpha)
        stop = valid & (test_T < 1e-4)
        contrib = valid & ~stop
        done = done | stop
        w = alpha * T
        for c in range(3):
            C[c] = torch.where(contrib, C[c] + w * col(6 + c), C[c])
        T = torch.where(contrib, test_T, T)
        last = torch.where(contrib, idx.to(torch.float32)[:, None], last)
    return T, torch.cat(C, dim=1), last


def composite_fwd(pair_feats, tile_start, tile_counts, tiles_x: int, tile_base: int = 0,
                  with_exact: bool = False):
    """K4: returns (T, C, last). Plain version on CPU tensors. A range of
    a frame's tiles is composited from the range's slices
    ``tile_start[t0 : t1 + 1]`` and ``tile_counts[t0 : t1]`` with
    ``tile_base = t0`` (the pair slots stay the frame's). With
    ``with_exact`` (CUDA tensors only) a fourth item: each tile's count
    (T,) int32 of pixels whose stop test fell within rounding of 1e-4 and
    that the kernel therefore walked as the plain version does."""
    if not pair_feats.is_cuda:
        if with_exact:
            raise ValueError("with_exact counts K4's own walks; CPU tensors run its plain version")
        return composite_fwd_plain(pair_feats, tile_start, tile_counts, tiles_x, tile_base)
    P = pair_feats.shape[0]
    num_tiles = tile_counts.shape[0]
    if P % CHUNK:
        raise ValueError(f"pair count {P} must be a multiple of {CHUNK}")
    kernels.require(pair_feats, "pair_feats", (P, 9), torch.float32)
    kernels.require(tile_start, "tile_start", (num_tiles + 1,), torch.int32)
    kernels.require(tile_counts, "tile_counts", (num_tiles,), torch.int32)
    dev = pair_feats.device
    if num_tiles == 0:  # an empty range of tiles: nothing to launch
        empty = torch.empty((0, PIX), dtype=torch.float32, device=dev)
        out = (empty, torch.empty((0, 3 * PIX), dtype=torch.float32, device=dev), empty.clone())
        return out + (torch.empty(0, dtype=torch.int32, device=dev),) if with_exact else out
    lib = kernels.library()
    T = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    C = torch.empty((num_tiles, 3 * PIX), dtype=torch.float32, device=dev)
    last = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    words = lib.neuma_composite_fwd_scratch_words(P, num_tiles)
    if words < 0:
        raise ValueError(f"{P} pairs over {num_tiles} tiles overflow K4's scratch")
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    rc = lib.neuma_composite_fwd(
        pair_feats.data_ptr(), tile_start.data_ptr(), tile_counts.data_ptr(),
        num_tiles, tiles_x, tile_base, T.data_ptr(), C.data_ptr(), last.data_ptr(),
        scratch.data_ptr(), P, kernels.stream(dev),
    )
    kernels.check(rc, "neuma_composite_fwd")
    kernels.launches["composite"] += 1
    if with_exact:  # the scratch's tail (the kernel's layout note)
        return T, C, last, scratch[words - num_tiles:].clone()
    return T, C, last


def composite_bwd_plain(pair_feats, tile_start, tile_counts, T, last, dT, dC, tiles_x: int,
                        tile_base: int = 0):
    """Plain version of K5: the reverse sweep, one pair slot at a time for
    all tiles and pixels at once, with the arithmetic of ``_bwd_kernel``:
    ``contribute = valid & live & (idx <= last)``, exclusive T by
    division, ``s_dot`` carried from the back, the cap ignored.
    ``tile_base`` as in ``composite_fwd_plain``."""
    dev = pair_feats.device
    num_tiles = tile_counts.shape[0]
    P = pair_feats.shape[0]
    t_idx = torch.arange(num_tiles, device=dev) + tile_base
    lane = torch.arange(PIX, device=dev)
    px = (((t_idx % tiles_x) * TILE)[:, None] + (lane % TILE)[None, :]).to(torch.float32)
    py = (((t_idx // tiles_x) * TILE)[:, None] + (lane // TILE)[None, :]).to(torch.float32)
    starts = tile_start[:-1].to(torch.int64)
    counts = tile_counts.to(torch.int64)
    dc = [dC[:, c * PIX : (c + 1) * PIX] for c in range(3)]
    T_after = T
    s_dot = torch.zeros_like(T)
    out = torch.zeros((P + 1, 9), dtype=torch.float32, device=dev)
    max_count = int(counts.max().item()) if num_tiles else 0
    inv255 = 1.0 / 255.0
    for s in reversed(range(max_count)):
        idx = starts + s
        live = s < counts
        f = pair_feats[torch.clamp(idx, max=P - 1)]
        col = lambda j: f[:, j : j + 1]
        dx = col(0) - px
        dy = col(1) - py
        power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
        G = torch.exp(power)
        alpha = torch.clamp(col(5) * G, max=0.99)
        contrib = (live[:, None] & (power <= 0.0) & (alpha >= inv255)
                   & (idx.to(torch.float32)[:, None] <= last))
        a = torch.where(contrib, alpha, 0.0)
        q = 1.0 - a
        T_excl = T_after / q
        col_dot = col(6) * dc[0] + col(7) * dc[1] + col(8) * dc[2]
        w = a * T_excl
        inv_1ma = 1.0 / q
        dL_dalpha = torch.where(
            contrib, T_excl * col_dot - s_dot * inv_1ma - T * inv_1ma * dT, 0.0
        )
        # CUDA quirk: the 0.99 cap is ignored in the chain.
        dL_dop = G * dL_dalpha
        dL_dpower = col(5) * G * dL_dalpha
        terms = [
            -(col(2) * dx + col(3) * dy) * dL_dpower,
            -(col(4) * dy + col(3) * dx) * dL_dpower,
            -0.5 * dx * dx * dL_dpower,
            -dx * dy * dL_dpower,
            -0.5 * dy * dy * dL_dpower,
            dL_dop,
            w * dc[0],
            w * dc[1],
            w * dc[2],
        ]
        rows = torch.stack([torch.where(contrib, t, 0.0).sum(1) for t in terms], dim=1)
        out[torch.where(live, idx, P)] = rows
        s_dot = s_dot + w * col_dot
        T_after = T_excl
    return out[:P]


def composite_bwd(pair_feats, tile_start, tile_counts, T, last, dT, dC, tiles_x: int,
                  tile_base: int = 0):
    """K5: per-pair gradient rows (P, 9) from the forward's T and
    ``last`` and the cotangents dT (T, 256), dC (T, 768). Plain version
    on CPU tensors. Over a range of the frame's tiles (``tile_base`` as in
    ``composite_fwd``) only the range's slots get rows; the rest are 0."""
    if not pair_feats.is_cuda:
        return composite_bwd_plain(pair_feats, tile_start, tile_counts, T, last, dT, dC, tiles_x,
                                   tile_base)
    P = pair_feats.shape[0]
    num_tiles = tile_counts.shape[0]
    kernels.require(pair_feats, "pair_feats", (P, 9), torch.float32)
    kernels.require(tile_start, "tile_start", (num_tiles + 1,), torch.int32)
    kernels.require(tile_counts, "tile_counts", (num_tiles,), torch.int32)
    for name, t, w in (("T", T, PIX), ("last", last, PIX), ("dT", dT, PIX), ("dC", dC, 3 * PIX)):
        kernels.require(t, name, (num_tiles, w), torch.float32)
    dev = pair_feats.device
    out = torch.zeros((P, 9), dtype=torch.float32, device=dev)
    if num_tiles == 0:  # an empty range of tiles: nothing to launch
        return out
    lib = kernels.library()
    words = lib.neuma_composite_bwd_scratch_words(P, num_tiles)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    rc = lib.neuma_composite_bwd(
        pair_feats.data_ptr(), tile_start.data_ptr(), tile_counts.data_ptr(),
        num_tiles, tiles_x, tile_base, T.data_ptr(), last.data_ptr(), dT.data_ptr(),
        dC.data_ptr(), out.data_ptr(), scratch.data_ptr(), P, kernels.stream(dev),
    )
    kernels.check(rc, "neuma_composite_bwd")
    kernels.launches["composite_bwd"] += 1
    return out


class _CompositePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair_feats, tile_start, tile_counts, tiles_x):
        T, C, last = composite_fwd(pair_feats, tile_start, tile_counts, tiles_x)
        ctx.save_for_backward(pair_feats, tile_start, tile_counts, T, last)
        ctx.tiles_x = tiles_x
        return T, C

    @staticmethod
    @span("raster.composite.bwd")
    def backward(ctx, dT, dC):
        pair_feats, tile_start, tile_counts, T, last = ctx.saved_tensors
        d_pf = composite_bwd(
            pair_feats, tile_start, tile_counts, T, last,
            dT.contiguous(), dC.contiguous(), ctx.tiles_x,
        )
        return d_pf, None, None, None


def composite_pairs(pair_feats, tile_start, tile_counts, tiles_x: int):
    """Differentiable tile composite: K4 forward, K5 backward. Returns
    (T (T, 256), C (T, 768))."""
    return _CompositePairs.apply(pair_feats, tile_start, tile_counts, tiles_x)


def tile_range(num_tiles: int, size: int, coord: int):
    """``(t0, t1, k)``: the contiguous tiles ``[t0, t1)`` that coordinate
    ``coord`` of an axis of ``size`` owns, ``k = ceil(num_tiles / size)``
    each, as ``P(axis)`` splits the tile dimension in the JAX package; a
    coordinate past the end owns none."""
    k = -(-num_tiles // size)
    t0 = min(coord * k, num_tiles)
    return t0, min(t0 + k, num_tiles), k


def _timed_gather(mesh, axis, t):
    """The tile-sharded composite's gather, counted as ``tile_gather.*``
    in ``utils.profiling.counters``: calls, bytes sent by this rank and
    host seconds (staging and waiting on the peers included)."""
    start = time.perf_counter()
    parts = mesh.all_gather(t.contiguous(), axis)
    counters["tile_gather.calls"] += 1
    counters["tile_gather.bytes"] += t.numel() * t.element_size()
    counters["tile_gather.seconds"] += time.perf_counter() - start
    return parts


class _TileShardedComposite(torch.autograd.Function):
    """The composite with the tiles split over a mesh axis (see
    ``composite_pairs_sharded``)."""

    @staticmethod
    def forward(ctx, pair_feats, tile_start, tile_counts, tiles_x, mesh, axis):
        num_tiles = tile_counts.shape[0]
        size = mesh.shape[axis]
        t0, t1, k = tile_range(num_tiles, size, mesh.coord(axis))
        ts, cn = tile_start[t0:t1 + 1], tile_counts[t0:t1]
        T, C, last = composite_fwd(pair_feats, ts, cn, tiles_x, t0)
        TC = torch.cat([T, C], 1)
        if t1 - t0 < k:  # the gather takes equal shapes
            TC = torch.cat([TC, TC.new_zeros((k - (t1 - t0), 4 * PIX))])
        full = torch.cat(_timed_gather(mesh, axis, TC))[:num_tiles]
        if ctx.needs_input_grad[0]:
            # every coordinate's pair slots [tile_start[t0], tile_start[t1]),
            # contiguous and disjoint: the backward gathers its rows
            edges = [tile_range(num_tiles, size, r)[0] for r in range(size)] + [num_tiles]
            ctx.bounds = tile_start[edges].tolist()
            ctx.save_for_backward(pair_feats, ts, cn, T, last)
            ctx.meta = (tiles_x, mesh, axis, t0, t1)
        return full[:, :PIX].contiguous(), full[:, PIX:].contiguous()

    @staticmethod
    @span("raster.composite.bwd")
    def backward(ctx, dT, dC):
        pair_feats, ts, cn, T, last = ctx.saved_tensors
        tiles_x, mesh, axis, t0, t1 = ctx.meta
        rows = composite_bwd(pair_feats, ts, cn, T, last, dT[t0:t1].contiguous(),
                             dC[t0:t1].contiguous(), tiles_x, t0)
        b, c = ctx.bounds, mesh.coord(axis)
        lens = [hi - lo for lo, hi in zip(b[:-1], b[1:])]
        width = max(1, max(lens))
        mine = rows[b[c]:b[c + 1]]
        if lens[c] < width:
            mine = torch.cat([mine, mine.new_zeros((width - lens[c], mine.shape[1]))])
        parts = _timed_gather(mesh, axis, mine)
        # the pad slots past the last tile's range get no rows
        tail = rows.new_zeros((rows.shape[0] - b[-1], rows.shape[1]))
        d_pf = torch.cat([p[:n] for p, n in zip(parts, lens)] + [tail])
        return d_pf, None, None, None, None, None


def composite_pairs_sharded(pair_feats, tile_start, tile_counts, tiles_x: int, mesh, axis: str):
    """``composite_pairs`` with the frame's tiles split over ``axis`` of
    ``mesh`` (a ``parallel.distributed.Mesh``): this rank runs K4 over its
    range ``tile_range(T, size, coord)``, and T and C of every range are
    gathered over the axis in axis order, so every rank returns the whole
    frame's (T, C), bit for bit those of ``composite_pairs``.

    The backward follows GSPMD's semantics (the JAX package's
    ``tile_sharding``): every rank of the axis holds the whole image and
    the cotangent of the whole image. K5 runs on this rank's range with
    its own rows of dT and dC, and the ranges' pair-gradient rows, which
    are disjoint, are gathered over the axis into the (P, 9) rows. The
    gather's backward does not add the ranks' cotangents (it is not the
    reduce-scatter of ``parallel.halo.gather_bins``): each tile's rows
    depend on that tile's cotangent alone, so when every rank of the axis
    computes the same function of the image, the rows, and every gradient
    after them, are one process's on every rank. A caller whose ranks'
    losses differ must make them equal (the rollout weights each rank's
    share of a view's loss by 1 / size). Every rank of the axis must
    call it, also one that owns no tile."""
    return _TileShardedComposite.apply(pair_feats, tile_start, tile_counts, tiles_x, mesh, axis)
