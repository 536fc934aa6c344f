"""The segment algebra of the K4 and K5 kernels (``neuma_tpu_torch/csrc/composite.cu``,
``csrc/composite_bwd.cu``) against the port's plain versions
(``raster_kernel.composite_fwd_plain``, ``composite_bwd_plain``), on the CPU.

K4 cuts each tile's range into segments of ``seg`` slots. Launch A gives,
per (segment, pixel), the product ``P`` of ``1 - alpha`` over the
segment's contributing slots, the colour sums ``S_c = sum alpha T_local
rgb_c`` and the last contributing slot; a pixel leaves a segment once
``P < 1e-4``. Launch B takes each pixel's segments in order, carrying
``T``: a segment with ``T P >= 1e-4 (1 + 1e-4)`` is taken whole (``C +=
T S``, ``T *= P``), any other is walked again from ``T`` with the
sequential stop test. ``_segmented_fwd`` below is that algorithm written
in torch. Bound: K4's abs 2e-5 on T and C, ``last`` equal.

K5 cuts each tile's back-to-front walk into segments of ``seg``
slots that run in parallel. Phase A gives, per (segment, pixel), the
product ``P`` of ``1 - alpha`` over the segment's contributing slots and
the local colour sum ``S = sum alpha T_local (rgb . dC)``. Phase B starts
each segment's walk from ``T_after = T_front * P`` and
``s_dot = sum_{later segments} T_front' S'``, with ``T_front`` the
product of the earlier segments' ``P``, and walks it back to front with
one reciprocal of ``1 - alpha`` per visit. ``_segmented_bwd`` below is
that algorithm written in torch (every (tile, segment) at once), so an
algebra error shows here without the card. Bound: the K5 check's scaled
1e-5 per column (the kernel's check tolerance on the card).
"""
import numpy as np
import pytest
import torch

from neuma_tpu_torch.render import raster_kernel as rk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

K4_TOL = 2e-5
K5_TOL = 1e-5
T_MIN = torch.tensor(1e-4, dtype=torch.float32)
T_ACCEPT = T_MIN * torch.tensor(1.0 + 1e-4, dtype=torch.float32)


def _pixels(nt, tiles_x):
    t_idx, lane = torch.arange(nt), torch.arange(rk.PIX)
    px = (((t_idx % tiles_x) * rk.TILE)[:, None] + (lane % rk.TILE)[None, :]).float()
    py = (((t_idx // tiles_x) * rk.TILE)[:, None] + (lane // rk.TILE)[None, :]).float()
    return px, py


def _guard(pf, idx, px, py):
    """K4's guard at pair slots ``idx`` (broadcast against the pixels):
    (contributes before the stop test, alpha, the pair rows)."""
    f = pf[idx.clamp(max=pf.shape[0] - 1)]
    col = lambda k: f[..., k : k + 1]
    dx, dy = col(0) - px, col(1) - py
    power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
    alpha = torch.clamp(col(5) * torch.exp(power), max=0.99)
    return (power <= 0.0) & (alpha >= 1.0 / 255.0), alpha, f


def _segmented_fwd(pf, tile_start, counts, tiles_x, seg):
    """K4's launches A and B for every (tile, segment) at once."""
    nt = counts.shape[0]
    px, py = _pixels(nt, tiles_x)
    starts, cnt = tile_start[:-1].long(), counts.long()
    nseg = (cnt + seg - 1) // seg
    n_seg = max(int(nseg.max()), 1)

    # Launch A: per (tile, segment, pixel) summaries.
    P = torch.ones((nt, n_seg, rk.PIX))
    S = torch.zeros((nt, n_seg, 3, rk.PIX))
    sl = torch.full((nt, n_seg, rk.PIX), -1, dtype=torch.int64)
    left = torch.zeros((nt, n_seg, rk.PIX), dtype=torch.bool)
    for j in range(seg):
        loc = torch.arange(n_seg) * seg + j
        ok, alpha, f = _guard(pf, starts[:, None] + loc[None, :], px[:, None, :], py[:, None, :])
        c = ok & (loc[None, :] < cnt[:, None])[..., None] & ~left
        w = alpha * P
        S = torch.where(c[:, :, None], S + w[:, :, None] * f[..., 6:9, None], S)
        P = torch.where(c, P * (1.0 - alpha), P)
        sl = torch.where(c, j, sl)
        left = left | (c & (P < T_MIN))

    # Launch B: each pixel's segments in order.
    T = torch.ones((nt, rk.PIX))
    C = torch.zeros((nt, 3, rk.PIX))
    last = torch.full((nt, rk.PIX), -1.0)
    done = torch.zeros((nt, rk.PIX), dtype=torch.bool)
    for s in range(n_seg):
        live = ~done & (s < nseg)[:, None]
        Tn = T * P[:, s]
        whole = live & (Tn >= T_ACCEPT)
        C = torch.where(whole[:, None], C + T[:, None] * S[:, s], C)
        T = torch.where(whole, Tn, T)
        last = torch.where(whole & (sl[:, s] >= 0),
                           (starts[:, None] + s * seg + sl[:, s]).float(), last)
        again = live & ~whole
        if not bool(again.any()):
            continue
        for j in range(s * seg, (s + 1) * seg):
            idx = starts + j
            ok, alpha, f = _guard(pf, idx, px, py)
            visit = again & ~done & (j < cnt)[:, None] & ok
            test_T = T * (1.0 - alpha)
            stop = visit & (test_T < T_MIN)
            c = visit & ~stop
            C = torch.where(c[:, None], C + (alpha * T)[:, None] * f[:, 6:9, None], C)
            T = torch.where(c, test_T, T)
            last = torch.where(c, idx.float()[:, None], last)
            done = done | stop
    return T, C.reshape(nt, 3 * rk.PIX), last


def _stop_slots(pf, tile_start, counts, last, tiles_x):
    """The slot (local to its tile) where each pixel stops on the 1e-4
    test, -1 where it does not: the first slot past its ``last`` that
    passes the guard, since that slot would have contributed."""
    px, py = _pixels(counts.shape[0], tiles_x)
    starts, cnt = tile_start[:-1].long(), counts.long()
    stop = torch.full(last.shape, -1, dtype=torch.int64)
    for s in range(int(cnt.max())):
        idx = starts + s
        ok, _, _ = _guard(pf, idx, px, py)
        hit = ok & (s < cnt)[:, None] & (idx.float()[:, None] > last) & (stop < 0)
        stop = torch.where(hit, s, stop)
    return stop


def _segmented_bwd(pf, tile_start, counts, T, last, dT, dC, tiles_x, seg):
    nt, P = counts.shape[0], pf.shape[0]
    t_idx, lane = torch.arange(nt), torch.arange(rk.PIX)
    px = (((t_idx % tiles_x) * rk.TILE)[:, None] + (lane % rk.TILE)[None, :]).float()[:, None, :]
    py = (((t_idx // tiles_x) * rk.TILE)[:, None] + (lane // rk.TILE)[None, :]).float()[:, None, :]
    starts = tile_start[:-1].long()
    end = torch.minimum(counts.long(), last.max(1).values.long() - starts + 1).clamp(min=0)
    n_seg = int(((end + seg - 1) // seg).max())
    dc = [dC[:, None, c * rk.PIX : (c + 1) * rk.PIX] for c in range(3)]
    T_fin, dT, last = T[:, None, :], dT[:, None, :], last[:, None, :]

    def visit(j):
        loc = torch.arange(n_seg) * seg + j
        valid = loc[None, :] < end[:, None]  # (nt, n_seg)
        idx = starts[:, None] + loc[None, :]
        f = pf[idx.clamp(max=P - 1)]
        col = lambda k: f[..., k : k + 1]
        dx, dy = col(0) - px, col(1) - py
        power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
        G = torch.exp(power)
        alpha = torch.clamp(col(5) * G, max=0.99)
        contrib = (valid[..., None] & (power <= 0.0) & (alpha >= 1.0 / 255.0)
                   & (idx.float()[..., None] <= last))
        col_dot = col(6) * dc[0] + col(7) * dc[1] + col(8) * dc[2]
        return valid, idx, col, dx, dy, G, torch.where(contrib, alpha, 0.0), contrib, col_dot

    # Phase A: per (segment, pixel) summaries, front to back.
    Pseg = torch.ones((nt, n_seg, rk.PIX))
    Sseg = torch.zeros((nt, n_seg, rk.PIX))
    for j in range(seg):
        _, _, _, _, _, _, a, c, col_dot = visit(j)
        Sseg = torch.where(c, Sseg + a * Pseg * col_dot, Sseg)
        Pseg = torch.where(c, Pseg * (1.0 - a), Pseg)

    # Combine: each segment's state at its back end, in a fixed order.
    T_front, acc = [], torch.ones((nt, rk.PIX))
    for s in range(n_seg):
        T_front.append(acc)
        acc = acc * Pseg[:, s]
    T_after = torch.stack([T_front[s] * Pseg[:, s] for s in range(n_seg)], 1)
    s_dot = torch.zeros((nt, n_seg, rk.PIX))
    for s in range(n_seg):
        for s2 in range(s + 1, n_seg):
            s_dot[:, s] = s_dot[:, s] + T_front[s2] * Sseg[:, s2]

    # Phase B: each segment walked back to front.
    out = torch.zeros((P + 1, 9))
    for j in reversed(range(seg)):
        valid, idx, col, dx, dy, G, a, c, col_dot = visit(j)
        inv = 1.0 / (1.0 - a)
        T_excl = T_after * inv
        w = a * T_excl
        dLda = torch.where(c, T_excl * col_dot - s_dot * inv - T_fin * inv * dT, 0.0)
        dpow = col(5) * G * dLda
        terms = [
            -(col(2) * dx + col(3) * dy) * dpow,
            -(col(4) * dy + col(3) * dx) * dpow,
            -0.5 * dx * dx * dpow,
            -dx * dy * dpow,
            -0.5 * dy * dy * dpow,
            G * dLda,
            w * dc[0],
            w * dc[1],
            w * dc[2],
        ]
        rows = torch.stack([torch.where(c, t, 0.0).sum(-1) for t in terms], -1)
        out[torch.where(valid, idx, P)] = rows
        s_dot = torch.where(c, s_dot + w * col_dot, s_dot)
        T_after = torch.where(c, T_excl, T_after)
    return out[:P]


def _frame(seed=0):
    """A 3x3-tile frame: a long walk with many weak contributions per
    pixel (T falls towards 1e-4), tiles with count 0, a tile whose pairs
    are all below 1/255 (every pixel's last is -1), a tile whose pairs
    cover only one corner (some pixels never contribute), a tile whose
    pixel rows stop on the 1e-4 test at slots 64, 96 and 127 (the first,
    a middle and the last slot of a 64-slot segment, and of 16-slot ones)
    and a 300-pair tile whose pixels all stop at slot 3."""
    rng = np.random.default_rng(seed)
    tiles_x, tiles_y = 3, 3
    counts = np.array([1100, 0, 37, 150, 0, 90, 160, 300, 0])
    aligned = (counts + rk.CHUNK - 1) // rk.CHUNK * rk.CHUNK
    start = np.concatenate([[0], np.cumsum(aligned)])
    P = int(start[-1]) + rk.CHUNK
    pf = np.zeros((P, 9), np.float32)
    for t, n in enumerate(counts[:6]):
        s = slice(start[t], start[t] + n)
        ox, oy = 16 * (t % tiles_x), 16 * (t // tiles_x)
        pf[s, 0] = ox - 4 + 24 * rng.random(n)
        pf[s, 1] = oy - 4 + 24 * rng.random(n)
        pf[s, 2:5] = np.array([0.05, 0.01, 0.05]) * (0.5 + rng.random((n, 3)))
        pf[s, 5] = 0.02 + 0.5 * rng.random(n)
        pf[s, 6:9] = rng.random((n, 3))
    t0 = slice(start[0], start[0] + counts[0])
    pf[t0, 0], pf[t0, 1] = 16 * rng.random(counts[0]), 16 * rng.random(counts[0])
    pf[t0, 5] = 0.005 + 0.03 * rng.random(counts[0])  # weak: long walks per pixel
    pf[start[2] : start[2] + counts[2], 5] = 1e-3  # below 1/255 everywhere
    t5 = slice(start[5], start[5] + counts[5])
    pf[t5, 0], pf[t5, 1] = 32 + 3 * rng.random(counts[5]), 16 + 3 * rng.random(counts[5])
    pf[t5, 2:5] = [1.0, 0.0, 1.0]  # tight: only the corner's pixels see them
    # Tile 6: conic (0, 0, 0) pairs have alpha = opacity at every pixel,
    # (0, 0, 12) pairs at one pixel row only. Rows 0-3 are darkened to T ~
    # 3e-4, rows 4-7 to ~3e-3, rows 8-11 to ~3e-2 before three opacity-0.9
    # walls at slots 64, 96 and 127, so each group stops at one wall; rows
    # 12-15 never stop. The other slots hold pairs below 1/255.
    t6 = start[6]
    pf[t6 : t6 + counts[6]] = [0, 0, 0, 0, 0, 1e-3, 0.5, 0.5, 0.5]
    pf[t6 : t6 + counts[6], 0] = 16 * rng.random(counts[6])
    darken = {0: [0.9, 0.9, 0.97], 4: [0.9, 0.97], 8: [0.97]}
    slot = t6
    for row0, ops in darken.items():
        for row in range(row0, row0 + 4):
            for op in ops:
                pf[slot] = [8.0, 32 + row, 0, 0, 12.0, op, *rng.random(3)]
                slot += 1
    for w in (64, 96, 127):
        pf[t6 + w] = [8.0, 40.0, 0, 0, 0, 0.9, *rng.random(3)]
    # Tile 7: three uniform opacity-0.95 pairs take T to 1.25e-4 and a
    # uniform opacity-0.5 one stops every pixel at slot 3; the random pairs
    # behind never count.
    t7 = slice(start[7], start[7] + counts[7])
    pf[t7, 0], pf[t7, 1] = 16 + 16 * rng.random(counts[7]), 32 + 16 * rng.random(counts[7])
    pf[t7, 2:5] = [0.05, 0.01, 0.05]
    pf[t7, 5] = 0.02 + 0.5 * rng.random(counts[7])
    pf[t7, 6:9] = rng.random((counts[7], 3))
    pf[start[7] : start[7] + 4, 2:5] = 0.0
    pf[start[7] : start[7] + 4, 5] = [0.95, 0.95, 0.95, 0.5]
    as_i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)
    args = (torch.as_tensor(pf), as_i32(start), as_i32(counts), tiles_x)
    T, _, last = rk.composite_fwd_plain(*args)
    dT = torch.as_tensor(rng.standard_normal(T.shape), dtype=torch.float32)
    dC = torch.as_tensor(rng.standard_normal((T.shape[0], 768)), dtype=torch.float32)
    return (*args[:3], T, last, dT, dC, tiles_x)


@pytest.fixture(scope="module")
def frame():
    args = _frame()
    return args, rk.composite_bwd_plain(*args)


def test_frame_covers_the_edge_cases(frame):
    (pf, start, counts, T, last, *_), _ = frame
    walk = last.max(1).values - start[:-1].float() + 1
    assert walk[0] > 256  # crosses several segment boundaries at every length tested
    assert (counts == 0).sum() == 3 and bool((last[2] == -1).all())
    assert bool((last[5] == -1).any()) and bool((last[5] >= 0).any())
    assert float(T[0].min()) < 1e-2  # many contributions per pixel


def test_frame_stops_at_segment_edges(frame):
    """The 1e-4 test fires where the frame puts it: in tile 6 on 64 pixels
    at each of slots 64, 96 and 127, in tile 7 on every pixel at slot 3."""
    (pf, start, counts, T, last, *_), _ = frame
    stop = _stop_slots(pf, start, counts, last, 3)
    for k, slot in enumerate((64, 96, 127)):
        assert bool((stop[6, 64 * k : 64 * (k + 1)] == slot).all()), slot
    assert bool((stop[6, 192:] == -1).all()) and float(T[6, 192:].min()) >= 1e-4
    assert bool((stop[7] == 3).all()) and int(counts[7]) > 4 * 64


@pytest.mark.parametrize("seg", [16, 64, 100, 1024])
def test_forward_segment_algebra_matches_plain(frame, seg):
    (pf, start, counts, *_), _ = frame
    T, C, last = _segmented_fwd(pf, start, counts, 3, seg)
    Tp, Cp, lp = rk.composite_fwd_plain(pf, start, counts, 3)
    assert float((T - Tp).abs().max()) <= K4_TOL and float((C - Cp).abs().max()) <= K4_TOL
    assert torch.equal(last, lp)


@pytest.mark.parametrize("seg", [16, 64, 100, 1024])
def test_segment_algebra_matches_plain(frame, seg):
    args, ref = frame
    out = _segmented_bwd(*args, seg)
    end = int(args[1][-1])
    assert torch.equal(out[end:], ref[end:])  # rows past the ranges stay zero
    assert bool((out[:end] == 0).eq(ref[:end] == 0).all())  # the same slots are live
    for j in range(9):
        a, b = out[:end, j], ref[:end, j]
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert (err / scale if scale > 0 else err) <= K5_TOL, (seg, j, err, scale)


def _row_bounds(pf):
    """The kernel's per-pair row bounds (``row_bounds`` in composite_bwd.cu)
    in float32: pixel rows outside [y0, y1] cannot reach alpha >= 1/255."""
    a, b, c, op, my = pf[:, 2], pf[:, 3], pf[:, 4], pf[:, 5], pf[:, 1]
    det = a * c - b * b
    tau = torch.log(op * 255.0)
    ext = torch.sqrt(2.0 * (tau * 1.001 + 1e-3) * a / det) * 1.001 + 0.01
    inf = torch.full_like(my, float("inf"))
    cull = (a > 0) & (c > 0) & (det > 0.1 * a * c) & torch.isfinite(tau) & torch.isfinite(my)
    y0 = torch.where(cull, my - ext, -inf)
    y1 = torch.where(cull, my + ext, inf)
    none = ~(op >= 1.0 / 255.0)
    return torch.where(none, inf, y0), torch.where(none, -inf, y1)


def test_row_bounds_keep_every_contributing_pixel():
    """Every pixel the guard accepts lies inside its pair's row bounds:
    random conics from round to nearly degenerate (det just above 0.1 a c),
    opacities from below 1/255 to 1, on a 64x64 pixel window."""
    rng = np.random.default_rng(3)
    n = 4000
    a = 10.0 ** rng.uniform(-3, 0.5, n)
    c = 10.0 ** rng.uniform(-3, 0.5, n)
    rho = rng.uniform(-0.9487, 0.9487, n)  # |b| / sqrt(ac) < sqrt(0.9): det > 0.1 a c
    pf = np.zeros((n, 9), np.float32)
    pf[:, 0], pf[:, 1] = 32 + rng.random(n), 32 + rng.random(n)
    pf[:, 2], pf[:, 3], pf[:, 4] = a, rho * np.sqrt(a * c), c
    pf[:, 5] = np.concatenate([rng.uniform(0.001, 0.01, n // 4), rng.uniform(0.01, 1.0, n - n // 4)])
    pf = torch.as_tensor(pf)
    y0, y1 = _row_bounds(pf)
    ys, xs = torch.meshgrid(torch.arange(64.0), torch.arange(64.0), indexing="ij")
    col = lambda k: pf[:, k, None, None]
    dx, dy = col(0) - xs, col(1) - ys
    power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
    alpha = torch.clamp(col(5) * torch.exp(power), max=0.99)
    hit = (power <= 0) & (alpha >= 1.0 / 255.0)
    inside = (ys >= y0[:, None, None]) & (ys <= y1[:, None, None])
    assert int(hit.sum()) > 10000
    assert not bool((hit & ~inside).any())
    assert float((~inside).float().mean()) > 0.3  # the bounds do cull
