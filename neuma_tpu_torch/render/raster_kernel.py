"""Tile-composite kernels, forward (K4) and backward (K5), with their
plain versions and the differentiable ``composite_pairs``.

Counterpart of ``neuma_tpu/render/pallas_raster.py`` (``_fwd_kernel``
launched by ``_composite_fwd_impl``, ``_bwd_kernel`` launched by
``_composite_vjp_bwd``, both under the custom VJP
``composite_pairs_tpu``; and ``_padded_starts``). The CUDA kernels are
``csrc/composite.cu`` and ``csrc/composite_bwd.cu``. K4: one CTA
per 16x16 tile, one thread per pixel, walking the tile's depth-sorted
pair range up to its true count with the CUDA rasterizer's guard set
(power <= 0, alpha >= 1/255, alpha capped at 0.99, the pixel stops
before a contribution would take T below 1e-4).

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

import torch

from .. import kernels

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


def composite_fwd_plain(pair_feats, tile_start, tile_counts, tiles_x: int):
    """Plain version of K4: the renderCUDA loop, one pair slot at a time
    for all tiles and pixels at once."""
    dev = pair_feats.device
    num_tiles = tile_counts.shape[0]
    P = pair_feats.shape[0]
    t_idx = torch.arange(num_tiles, device=dev)
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


def composite_fwd(pair_feats, tile_start, tile_counts, tiles_x: int):
    """K4: returns (T, C, last). Plain version on CPU tensors."""
    if not pair_feats.is_cuda:
        return composite_fwd_plain(pair_feats, tile_start, tile_counts, tiles_x)
    P = pair_feats.shape[0]
    num_tiles = tile_counts.shape[0]
    if P % CHUNK:
        raise ValueError(f"pair count {P} must be a multiple of {CHUNK}")
    kernels.require(pair_feats, "pair_feats", (P, 9), torch.float32)
    kernels.require(tile_start, "tile_start", (num_tiles + 1,), torch.int32)
    kernels.require(tile_counts, "tile_counts", (num_tiles,), torch.int32)
    lib = kernels.library()
    dev = pair_feats.device
    T = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    C = torch.empty((num_tiles, 3 * PIX), dtype=torch.float32, device=dev)
    last = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    rc = lib.neuma_composite_fwd(
        pair_feats.data_ptr(), tile_start.data_ptr(), tile_counts.data_ptr(),
        num_tiles, tiles_x, T.data_ptr(), C.data_ptr(), last.data_ptr(),
        kernels.stream(dev),
    )
    kernels.check(rc, "neuma_composite_fwd")
    kernels.launches["composite"] += 1
    return T, C, last


def composite_bwd_plain(pair_feats, tile_start, tile_counts, T, last, dT, dC, tiles_x: int):
    """Plain version of K5: the reverse sweep, one pair slot at a time for
    all tiles and pixels at once, with the arithmetic of ``_bwd_kernel``:
    ``contribute = valid & live & (idx <= last)``, exclusive T by
    division, ``s_dot`` carried from the back, the cap ignored."""
    dev = pair_feats.device
    num_tiles = tile_counts.shape[0]
    P = pair_feats.shape[0]
    t_idx = torch.arange(num_tiles, device=dev)
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


def composite_bwd(pair_feats, tile_start, tile_counts, T, last, dT, dC, tiles_x: int):
    """K5: per-pair gradient rows (P, 9) from the forward's T and
    ``last`` and the cotangents dT (T, 256), dC (T, 768). Plain version
    on CPU tensors."""
    if not pair_feats.is_cuda:
        return composite_bwd_plain(pair_feats, tile_start, tile_counts, T, last, dT, dC, tiles_x)
    P = pair_feats.shape[0]
    num_tiles = tile_counts.shape[0]
    kernels.require(pair_feats, "pair_feats", (P, 9), torch.float32)
    kernels.require(tile_start, "tile_start", (num_tiles + 1,), torch.int32)
    kernels.require(tile_counts, "tile_counts", (num_tiles,), torch.int32)
    for name, t, w in (("T", T, PIX), ("last", last, PIX), ("dT", dT, PIX), ("dC", dC, 3 * PIX)):
        kernels.require(t, name, (num_tiles, w), torch.float32)
    lib = kernels.library()
    dev = pair_feats.device
    out = torch.zeros((P, 9), dtype=torch.float32, device=dev)
    words = lib.neuma_composite_bwd_scratch_words(P, num_tiles)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    rc = lib.neuma_composite_bwd(
        pair_feats.data_ptr(), tile_start.data_ptr(), tile_counts.data_ptr(),
        num_tiles, tiles_x, T.data_ptr(), last.data_ptr(), dT.data_ptr(), dC.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), P, kernels.stream(dev),
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
