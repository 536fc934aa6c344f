#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``neuma_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

1. Build the CUDA kernels from ``neuma_tpu_torch/csrc`` with ``nvcc``
   and print the build seconds and the card's name and power limit.
2. Kernel checks: P2G (K1), G2P (K2), G2P with spline derivatives (K3),
   tile composite (K4) and its backward (K5), each against its plain
   PyTorch version on the card, on inputs taken from the headline and the
   realworld scenes; each kernel, its plain version and (K1 only)
   ``index_add_`` are timed with CUDA events, and the device time of each
   CUDA kernel a wrapper launches is read with torch.profiler. For K1 and
   K5 it also prints the work they get (K1: occupied blocks and chunks
   per block; K5: the tiles' walk lengths and the (tile, segment) work
   items).
3. Headline forward (10k particles, 32^3 grid, one 800x800 view, 4
   frames x 1 substep) under ``torch.no_grad()``: loss, overflow,
   ms/frame (median of 3 after a warm-up) and the forward's launch counts
   (K1, K2, K4 must be > 0).
4. Determinism: two headline rollouts give a bitwise-equal loss and
   final particle positions.
5. Realworld forward (30k particles, 70^3 grid, three 1920x1080 mask
   views, 2 frames x 20 substeps): loss, overflow, ms/frame.
   Phases 3 and 5 also profile one forward (device idle share, time by
   kernel) and each layer of one substep and one view.
6. A small scene's loss on the card (kernels) and on the CPU (plain
   versions) within rtol 1e-4.
7. Headline value-and-grad (the training path, the work ``bench.py``
   times): loss and its gradient with respect to both materials' LoRA
   leaves and ``init_v`` through every frame and substep. ms/frame for
   forward + backward (median of 3 after a warm-up), the launch counts
   of one run (all five kernels must be > 0), finite values, nonzero
   gradient norms, and a profile of one step (device idle share).
8. Determinism of the training path: two headline value-and-grad runs
   give a bitwise-equal loss and every gradient leaf bitwise equal.
9. Realworld value-and-grad: finite and timed. Its loss is exactly 3 per
   frame (white background, all-ones mask colours, zero ground truth)
   whatever the sim does, so its gradient is ~0 up to rounding and only
   finiteness and speed are checked.
10. The small scene's gradients on the card vs the CPU, scaled max error
    per leaf <= 1e-3 (the card sums in other orders: cuBLAS, the K1 block
    sums, K5's 256-pixel reduction; BPTT carries the differences).
11. Trainers at the headline shape with ``max_pairs = 1 << 17`` (at rest
    the view needs 67,768 pairs, and the trainers raise on overflow):
    ``finetune_constitutive`` for 3 epochs (finite losses; only
    ``lora_a``/``lora_b`` change, every other leaf stays bitwise equal)
    and ``optimize_init_velocity`` for 2 epochs.

The scenes follow ``bench.py``'s recipe with random weights from seed 0.
Output: one JSON line ``{"kernels": [...]}`` (launches counted on the
headline training path), the card's ``nvidia-smi`` name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Details go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM FP32 outside the tensor cores, NVIDIA data sheet
K12_TOL = 1e-5  # scaled max abs error: both sides full FP32
K3_TOL = 1e-5  # scaled per output group: dx sums 27 signed spline-derivative terms
K4_TOL = 2e-5  # abs error on T and C
K5_TOL = 1e-5  # scaled per column: segment starts, approximate reciprocal, pixel-sum order
GRAD_TOL = 1e-3  # small scene gradients, card vs CPU, scaled per leaf
KERNELS = ("p2g", "g2p", "g2p_derivs", "composite", "composite_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scaled_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max error over the reference's largest value; the absolute max
    error where the reference is all zero."""
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return err / scale if scale > 0 else err


def scaled_err_cols(a: torch.Tensor, b: torch.Tensor, groups) -> float:
    """The largest scaled error over column groups, each scaled by its own
    largest reference value (a small column is not hidden by a large one)."""
    return max(scaled_err(a[:, g], b[:, g]) for g in groups)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@torch.no_grad()
def kernel_inputs(scene, gen):
    """Kernel inputs at the scene's shapes: the scene's positions and
    masses with random APIC C and stress (so every payload column is
    live); for K3 the two gathers of the step backward (the forward
    (mass, b, affine) against the slab cotangent that random (d new_v,
    d new_C) give through K1's transpose and the grid-op vjp, and (d new_v,
    kappa d new_C) against the grid velocities); the pair features of the
    first view at rest, and random dT/dC for K5."""
    from neuma_tpu_torch.core.types import ParticleState
    from neuma_tpu_torch.render.rasterize import (
        _build_aligned_pairs, _project, _sh_colors, _tile_ranges)
    from neuma_tpu_torch.sim import p2g_kernel as pk
    from neuma_tpu_torch.sim.mpm import _p2g_terms, _vjp, grid_op_slabs

    c = scene.constants
    dev = scene.init_x.device
    n = scene.init_x.shape[0]
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    state = ParticleState.initial(scene.init_x, 0.3 * rnd(n, 3))
    state = ParticleState(x=state.x, v=state.v, C=0.5 * rnd(n, 3, 3), F=state.F)
    stress = 1e-3 * rnd(n, 3, 3)
    layouts = pk.build_step_layouts(c, state.x)
    nbs, NB = pk._num_blocks(c)
    mass, b, affine = _p2g_terms(c, scene.statics, state, stress)
    lay, srt = layouts.scatter, layouts.sort
    payload = pk.pack_payload(c, lay, srt.fx, srt.loc, mass, b, affine)
    pb = pk.run_p2g_fwd_plain(payload, lay.c2b, NB)
    slabs_mmv = pk.halo_add_slabs(pb, nbs)
    slab_shape = (NB, 4, pk.S, pk.S, pk.S)
    slabs = grid_op_slabs(c, slabs_mmv, nbs).reshape(slab_shape)
    zeros3 = torch.zeros_like(state.x)
    zeros33 = torch.zeros((n, 3, 3), device=dev)
    glay = layouts.gather
    payload_g = pk.pack_payload(c, glay, srt.fx, srt.loc, None, zeros3, zeros33)
    kappa = 4.0 * float(c.inv_dx) ** 2
    d_new_v, A2 = rnd(n, 3), kappa * 1e-2 * rnd(n, 3, 3)
    d_slabs_v = pk.halo_add_slabs(
        pk.run_p2g_fwd_plain(pk.pack_payload(c, lay, srt.fx, srt.loc, None, d_new_v, A2),
                             lay.c2b, NB), nbs)
    _, (d_slabs_mmv,), _ = _vjp(lambda s_: grid_op_slabs(c, s_, nbs), (slabs_mmv,), (d_slabs_v,))
    k3 = [
        (pk.pack_payload(c, glay, srt.fx, srt.loc, mass, b, affine),
         d_slabs_mmv.reshape(slab_shape).contiguous()),
        (pk.pack_payload(c, glay, srt.fx, srt.loc, None, d_new_v, A2), slabs),
    ]

    g = scene.gaussians
    cam = scene.cameras[0]
    cov = g.get_covariance(scene.scaling_modifier)
    opacity = g.get_opacity.reshape(-1)
    depth, visible, mean2d, conic, radius = _project(g.xyz, cov, cam)
    if scene.force_mask_data:
        colors = torch.ones((g.xyz.shape[0], 3), device=dev)
    else:
        colors = _sh_colors(g.get_features, g.xyz, cam.camera_center, g.sh_degree)
    pair_gid, counts, tile_start, tiles_x, _, overflow = _build_aligned_pairs(
        depth, visible, mean2d, radius, cam.width, cam.height, scene.raster_cfg
    )
    feats = torch.cat([mean2d, conic, opacity[:, None], colors], 1)
    x0, y0, x1, y1, _, _ = _tile_ranges(mean2d, radius, cam.width, cam.height)
    shown = visible & (radius > 0)
    pairs_needed = int(torch.where(shown, (x1 - x0) * (y1 - y0), 0).sum())
    nt = counts.shape[0]
    return dict(
        payload=payload, c2b=lay.c2b, NB=NB, live=int(lay.valid.sum()),
        payload_g=payload_g, slabs=slabs, c2b_g=glay.c2b, inv_dx=float(c.inv_dx), k3=k3,
        pf=feats[pair_gid].contiguous(), tile_start=tile_start.to(torch.int32),
        counts=counts.to(torch.int32), tiles_x=tiles_x, raster_overflow=bool(overflow),
        pairs_needed=pairs_needed, max_pairs=scene.raster_cfg.max_pairs,
        dT=0.1 * rnd(nt, 256), dC=0.1 * rnd(nt, 768),
    )


def p2g_library_call(inp):
    """``index_add_`` of the precomputed 27-tap contributions into the
    block grid: the one PyTorch call that sums the same scatter."""
    from neuma_tpu_torch.sim import p2g_kernel as pk

    p = inp["payload"]
    rows = p.shape[0]
    C = rows // inp["c2b"].shape[0]
    blk = torch.repeat_interleave(inp["c2b"].to(torch.int64), C)
    w = p[:, pk._W0 : pk._W0 + 9].reshape(rows, 3, 3)
    lines = p[:, pk._L0 : pk._L0 + 9].to(torch.int64).reshape(rows, 3, 3)
    o = [torch.as_tensor(pk._OFFSETS[:, a], device=p.device) for a in range(3)]
    W = w[:, 0, o[0]] * w[:, 1, o[1]] * w[:, 2, o[2]]
    taps = torch.stack(o, 1).to(p.dtype)  # (27, 3)
    be, ac, gm = p[:, pk._BE0 : pk._BE0 + 3], p[:, pk._AC0 : pk._AC0 + 9].reshape(rows, 3, 3), p[:, pk._GM]
    mom = W[:, :, None] * (be[:, None, :] + torch.einsum("nrd,od->nor", ac, taps))
    vals = torch.cat([mom, (W * gm[:, None])[:, :, None]], 2).reshape(-1, 4)
    yzx = (lines[:, 0, o[0]] * pk.S + lines[:, 1, o[1]]) * pk.S + lines[:, 2, o[2]]
    index = (blk[:, None] * pk.S ** 3 + yzx).reshape(-1)
    out = torch.zeros((inp["NB"] * pk.S ** 3, 4), device=p.device)
    return lambda: out.zero_().index_add_(0, index, vals)


def device_rows(fn, reps: int = 10):
    """Mean device ms per call of each kernel that ``fn`` launches
    (torch.profiler over ``reps`` calls after a warm-up, kernel rows)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows[ev.key[:60]] = dev_us / 1e3 / reps
    return rows


def p2g_block_stats(inp):
    """K1's occupancy: blocks that hold particles, chunks per such block."""
    c2b = inp["c2b"].to(torch.int64)
    # the carving's spare chunks (no live row) sit on the last block; skip them
    live = inp["payload"].reshape(c2b.shape[0], -1).abs().sum(1) > 0
    occ = torch.bincount(c2b[live], minlength=inp["NB"])
    occ = occ[occ > 0].to(torch.float64)
    return dict(blocks=inp["NB"], occupied_blocks=int(occ.numel()),
                chunks_per_occupied_block_mean=float(occ.mean()),
                chunks_per_occupied_block_max=int(occ.max()))


def composite_walk_stats(inp, lk):
    """K5's work: slots each tile walks (up to its largest ``last``), and
    the (tile, segment) work items the kernel cuts them into."""
    from neuma_tpu_torch import kernels

    seg = kernels.library().neuma_k5_seg()
    starts = inp["tile_start"][:-1].to(torch.float32)
    walked = (lk.max(1).values - starts + 1).clamp(min=0)
    walked = torch.minimum(walked, inp["counts"].to(torch.float32))
    w = walked[walked > 0].to(torch.float64)
    return dict(tiles=int(walked.numel()), tiles_with_pairs=int((inp["counts"] > 0).sum()),
                tiles_walking=int(w.numel()), walk_mean=float(w.mean()),
                walk_p99=float(torch.quantile(w, 0.99)), walk_max=int(w.max()),
                walk_total=int(w.sum()), segment=seg,
                segments=int(torch.ceil(w / seg).sum()))


@torch.no_grad()
def check_and_time(tag, inp, rec):
    from neuma_tpu_torch.render import raster_kernel as rk
    from neuma_tpu_torch.sim import p2g_kernel as pk

    ok = True
    # K1
    k = pk.run_p2g_fwd(inp["payload"], inp["c2b"], inp["NB"])
    p = pk.run_p2g_fwd_plain(inp["payload"], inp["c2b"], inp["NB"])
    torch.cuda.synchronize()
    e1 = scaled_err(k, p)
    ok &= e1 <= K12_TOL
    rows, M, NB = inp["payload"].shape[0], inp["c2b"].shape[0], inp["NB"]
    b1 = bound_ms(rows * 48 * 4 + M * 4 + NB * 16384 * 4, inp["live"] * 27 * 28)
    lib1 = p2g_library_call(inp)
    rec["p2g"][tag] = dict(
        max_abs_err=e1, tol=K12_TOL,
        ms=cuda_ms(lambda: pk.run_p2g_fwd(inp["payload"], inp["c2b"], NB), 20),
        plain_ms=cuda_ms(lambda: pk.run_p2g_fwd_plain(inp["payload"], inp["c2b"], NB), 3),
        library_ms=cuda_ms(lib1, 5), bound_ms=b1[0], bound_by=b1[1], M=M, NB=NB,
        device_rows=device_rows(lambda: pk.run_p2g_fwd(inp["payload"], inp["c2b"], NB)),
        work=p2g_block_stats(inp),
    )
    # K2
    args = (inp["payload_g"], inp["slabs"], inp["c2b_g"], inp["inv_dx"])
    k = pk.run_apic_gather(*args)
    p = pk.run_apic_gather_plain(*args)
    torch.cuda.synchronize()
    e2 = scaled_err(k, p)
    ok &= e2 <= K12_TOL
    rows = inp["payload_g"].shape[0]
    b2 = bound_ms(
        rows * 48 * 4 + inp["slabs"].numel() * 4 + M * 4 + rows * 16 * 4, inp["live"] * 27 * 34
    )
    rec["g2p"][tag] = dict(
        max_abs_err=e2, tol=K12_TOL,
        ms=cuda_ms(lambda: pk.run_apic_gather(*args), 20),
        plain_ms=cuda_ms(lambda: pk.run_apic_gather_plain(*args), 3),
        library_ms=None, bound_ms=b2[0], bound_by=b2[1], rows=rows,
        device_rows=device_rows(lambda: pk.run_apic_gather(*args)),
    )
    # K3: both gathers of the step backward; each output group (dgm, db,
    # dA, dx) is scaled by its own largest value (absolute where all zero,
    # as dgm is in the second gather).
    groups = (slice(0, 1), slice(1, 4), slice(4, 13), slice(13, 16))
    e3, ms3, plain3, rows3 = 0.0, 0.0, 0.0, {}
    for payload, slabs in inp["k3"]:
        a3 = (payload, slabs, inp["c2b_g"], inp["inv_dx"], True)
        k = pk.run_apic_gather(*a3)
        p = pk.run_apic_gather_plain(*a3)
        torch.cuda.synchronize()
        e3 = max(e3, scaled_err_cols(k, p, groups))
        ms3 += cuda_ms(lambda: pk.run_apic_gather(*a3), 20) / 2
        plain3 += cuda_ms(lambda: pk.run_apic_gather_plain(*a3), 3) / 2
        for key, ms in device_rows(lambda: pk.run_apic_gather(*a3)).items():
            rows3[key] = rows3.get(key, 0.0) + ms / 2
    ok &= e3 <= K3_TOL
    b3 = bound_ms(
        rows * 48 * 4 + inp["slabs"].numel() * 4 + M * 4 + rows * 16 * 4, inp["live"] * 27 * 71
    )
    rec["g2p_derivs"][tag] = dict(
        max_abs_err=e3, tol=K3_TOL, ms=ms3, plain_ms=plain3, library_ms=None,
        bound_ms=b3[0], bound_by=b3[1], rows=rows, device_rows=rows3,
    )
    # K4
    args = (inp["pf"], inp["tile_start"], inp["counts"], inp["tiles_x"])
    Tk, Ck, lk = rk.composite_fwd(*args)
    Tp, Cp, lp = rk.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    e4 = max(float((Tk - Tp).abs().max()), float((Ck - Cp).abs().max()))
    last_mismatch = int((lk != lp).sum())
    ok &= e4 <= K4_TOL and last_mismatch == 0
    nt = inp["counts"].shape[0]
    starts = inp["tile_start"][:-1].to(torch.float32)[:, None]
    visited = torch.where(lk >= 0, lk - starts + 1, torch.zeros_like(lk)).sum()
    b4 = bound_ms(
        int(inp["counts"].sum()) * 36 + (2 * nt + 1) * 4 + nt * 5 * 256 * 4, float(visited) * 22
    )
    rec["composite"][tag] = dict(
        max_abs_err=e4, tol=K4_TOL, last_mismatch=last_mismatch,
        ms=cuda_ms(lambda: rk.composite_fwd(*args), 20),
        plain_ms=cuda_ms(lambda: rk.composite_fwd_plain(*args), 2),
        library_ms=None, bound_ms=b4[0], bound_by=b4[1], tiles=nt,
        pairs=inp["pf"].shape[0], live_pairs=int(inp["counts"].sum()),
        raster_overflow=inp["raster_overflow"], pairs_needed=inp["pairs_needed"],
        device_rows=device_rows(lambda: rk.composite_fwd(*args)),
    )
    # K5 on K4's T and last, compared on the rows below tile_start[-1]
    a5 = (*args[:3], Tk, lk, inp["dT"], inp["dC"], inp["tiles_x"])
    k = rk.composite_bwd(*a5)
    p = rk.composite_bwd_plain(*a5)
    torch.cuda.synchronize()
    end = int(inp["tile_start"][-1])
    e5 = scaled_err_cols(k[:end], p[:end], [slice(j, j + 1) for j in range(9)])
    ok &= e5 <= K5_TOL
    # slots each tile walks: up to its largest `last`
    walked = (lk.max(1).values - starts[:, 0] + 1).clamp(min=0)
    walked = torch.minimum(walked, inp["counts"].to(torch.float32)).sum()
    b5 = bound_ms(2 * float(walked) * 36 + (2 * nt + 1) * 4 + nt * 6 * 256 * 4, float(visited) * 60)
    rec["composite_bwd"][tag] = dict(
        max_abs_err=e5, tol=K5_TOL,
        ms=cuda_ms(lambda: rk.composite_bwd(*a5), 20),
        plain_ms=cuda_ms(lambda: rk.composite_bwd_plain(*a5), 1),
        library_ms=None, bound_ms=b5[0], bound_by=b5[1], tiles=nt,
        device_rows=device_rows(lambda: rk.composite_bwd(*a5)),
        work=composite_walk_stats(inp, lk),
    )
    log(f"[check:{tag}] first view at rest needs {inp['pairs_needed']} (gaussian, tile) "
        f"pairs, max_pairs {inp['max_pairs']}: overflow {inp['raster_overflow']}")
    for name in KERNELS:
        r = rec[name][tag]
        log(
            f"[check:{tag}] {name}: max err {r['max_abs_err']:.3e} (bound {r['tol']:.0e})"
            + (f", last mismatches {r['last_mismatch']}" if name == "composite" else "")
            + f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
            + (f", index_add_ {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
        )
    for name in KERNELS:
        r = rec[name][tag]
        if "work" in r:
            log(f"[work:{tag}] {name}: {json.dumps(r['work'])}")
        for key, ms in r["device_rows"].items():
            log(f"[work:{tag}] {name} device {ms:.4f} ms  {key}")
    return ok


def timed(fn, args, reps=3):
    """Median host seconds of ``reps`` synchronized calls after a warm-up,
    and the kernel launches of the warm-up call (every count set to 0
    just before it and read just after). Returns the warm-up's output."""
    from neuma_tpu_torch import kernels

    kernels.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times), launches


def profile_step(fn, args, top=8):
    """Device time by kernel over one call (torch.profiler), and the
    device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # Device-side kernel rows only (the aten:: rows repeat their time).
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log("[profile] no device time recorded: not measured")
        return None
    log(f"[profile] wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}, {sum(r[1] for r in rows)} device ops")
    for ms, count, key in rows[:top]:
        log(f"[profile]   {ms:8.3f} ms  x{count:<5d} {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                top=[dict(ms=m, count=c, name=k) for m, c, k in rows[:20]])


@torch.no_grad()
def layer_breakdown(tag, scene):
    """Wall ms, device kernels and device ms of each layer of one substep
    and one view, at the state after one substep (profiler, kernel rows)."""
    from torch.profiler import ProfilerActivity, profile

    from neuma_tpu_torch.core.types import ParticleState
    from neuma_tpu_torch.render.binding import apply_binding_F, apply_binding_xyz, deform_cov_by_F
    from neuma_tpu_torch.render.rasterize import rasterize_with_aux
    from neuma_tpu_torch.sim.mpm import make_packed_substep, mpm_step
    from neuma_tpu_torch.sim.p2g_kernel import build_step_layouts, refresh_step_layouts

    c, g = scene.constants, scene.gaussians
    n = scene.init_x.shape[0]
    s = ParticleState.initial(scene.init_x, torch.tensor([[0.3, 0.0, 0.0]], device="cuda").expand(n, 3))
    lay = build_step_layouts(c, s.x)
    s = make_packed_substep(c, scene.statics, scene.elasticity, scene.plasticity)(s, lay)
    stress = scene.elasticity(s.F)
    cov0 = g.get_covariance(scene.scaling_modifier)
    kw = (dict(colors_precomp=torch.ones((g.xyz.shape[0], 3), device="cuda"))
          if scene.force_mask_data else dict(shs=g.get_features, sh_degree=g.sh_degree))

    def binding():
        apply_binding_xyz(scene.binding, s.x, scene.init_x, g.xyz)
        return deform_cov_by_F(cov0, apply_binding_F(scene.binding, s.F))

    layers = {
        "elasticity MLP + SVD": lambda: scene.elasticity(s.F),
        "layout refresh": lambda: refresh_step_layouts(c, s.x, lay),
        "MPM step (K1, grid op, K2)": lambda: mpm_step(c, scene.statics, s, stress, lay),
        "plasticity MLP + SVD": lambda: scene.plasticity(s.F),
        "binding": binding,
        "render one view (K4)": lambda: rasterize_with_aux(
            g.xyz, cov0, g.get_opacity, scene.cameras[0], scene.background,
            cfg=scene.raster_cfg, **kw),
    }
    out = {}
    for name, fn in layers.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                  for e in kern) / 1e3
        out[name] = dict(wall_ms=wall, kernels=len(kern), device_ms=dev)
        log(f"[layers:{tag}] {name:28s} wall {wall:8.3f} ms  {len(kern):5d} kernels  "
            f"device {dev:7.3f} ms")
    return out


def train_layer_breakdown(tag, scene, init_v):
    """Wall ms, device kernels and device ms of the training path's
    pieces: one substep forward + backward (materials recomputed in the
    backward; K1 twice, K2, K3 twice) and one view forward + backward
    (K4, K5), at the rest state (profiler, kernel rows)."""
    from torch.profiler import ProfilerActivity, profile

    from neuma_tpu_torch.core.types import ParticleState
    from neuma_tpu_torch.render.rasterize import rasterize_with_aux
    from neuma_tpu_torch.sim.mpm import make_packed_substep
    from neuma_tpu_torch.sim.p2g_kernel import build_step_layouts

    c, g = scene.constants, scene.gaussians
    n = scene.init_x.shape[0]
    sub = make_packed_substep(c, scene.statics, scene.elasticity, scene.plasticity)
    params, _ = lora_params(scene)
    s0 = ParticleState.initial(scene.init_x, init_v.reshape(1, 3).expand(n, 3).contiguous())
    lay = build_step_layouts(c, s0.x)
    with torch.no_grad():
        cov0 = g.get_covariance(scene.scaling_modifier)
        kw = (dict(colors_precomp=torch.ones((g.xyz.shape[0], 3), device="cuda"))
              if scene.force_mask_data else dict(shs=g.get_features, sh_degree=g.sh_degree))

    def substep():
        leaves = [t.clone().requires_grad_(True) for t in (s0.x, s0.v, s0.C, s0.F)]
        out = sub(ParticleState(*leaves), lay)
        outs = [out.x, out.v, out.C, out.F]
        return torch.autograd.grad(outs, leaves + params, [torch.ones_like(o) for o in outs])

    def render():
        means = g.xyz.detach().clone().requires_grad_(True)
        img, _ = rasterize_with_aux(means, cov0, g.get_opacity, scene.cameras[0], scene.background,
                                    cfg=scene.raster_cfg, **kw)
        return torch.autograd.grad(img.sum(), means)

    out = {}
    for name, fn in (("substep fwd+bwd", substep), ("render one view fwd+bwd", render)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                  for e in kern) / 1e3
        out[name] = dict(wall_ms=wall, kernels=len(kern), device_ms=dev)
        log(f"[train-layers:{tag}] {name:24s} wall {wall:8.3f} ms  {len(kern):5d} kernels  "
            f"device {dev:7.3f} ms")
    return out


@torch.no_grad()
def sim_final_x(scene, init_v, frames):
    """Final positions of the rollout's simulation (the substep chain alone)."""
    from neuma_tpu_torch.core.types import ParticleState
    from neuma_tpu_torch.sim.mpm import make_packed_substep
    from neuma_tpu_torch.sim.p2g_kernel import build_step_layouts, refresh_step_layouts

    n = scene.init_x.shape[0]
    sub = make_packed_substep(scene.constants, scene.statics, scene.elasticity, scene.plasticity)
    s = ParticleState.initial(scene.init_x, init_v.reshape(1, 3).expand(n, 3).contiguous())
    lay = build_step_layouts(scene.constants, s.x)
    for _ in range(frames * scene.substeps):
        lay, _ = refresh_step_layouts(scene.constants, s.x, lay)
        s = sub(s, lay)
    return s.x.clone()


def lora_params(scene):
    """The trainable (LoRA) leaves of both materials, and how many are
    the elasticity's."""
    from neuma_tpu_torch.sim.mpm import trainable_params

    pe, pp = trainable_params(scene.elasticity), trainable_params(scene.plasticity)
    return pe + pp, len(pe)


def value_and_grad_fn(scene, device):
    """``(init_v, weights, gt) -> (loss, aux, grads)`` with ``grads`` =
    [d init_v] + the LoRA leaves' gradients (elasticity, then plasticity)."""
    from neuma_tpu_torch.train.grounding import make_rollout_loss

    loss_fn = make_rollout_loss(scene, device=device)
    params, _ = lora_params(scene)

    def vg(init_v, weights, gt):
        iv = init_v.detach().clone().requires_grad_(True)
        loss, aux = loss_fn(iv, weights, gt)
        grads = torch.autograd.grad(loss, [iv] + params)
        return loss.detach(), aux, grads

    return vg


def grad_norms(grads, n_e):
    norm = lambda gs: float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs)))
    return dict(init_v=norm(grads[:1]), elasticity=norm(grads[1 : 1 + n_e]),
                plasticity=norm(grads[1 + n_e :]))


def training_phases(scenes, report, init_v):
    """Phases 7-11. Returns (ok, launches on the headline training path)."""
    from neuma_tpu_torch.train.grounding import (
        BENCH_SHAPES, build_scene, finetune_constitutive, optimize_init_velocity)
    from neuma_tpu_torch.train.schedulers import cosine_decay_schedule

    # 7. headline value-and-grad
    hp = BENCH_SHAPES["headline"]
    h_scene = scenes["headline"]
    vg = value_and_grad_fn(h_scene, "cuda")
    _, n_e = lora_params(h_scene)
    h_args = (init_v, torch.ones(hp["frames"], device="cuda"),
              torch.zeros((hp["frames"], 1, 3, hp["height"], hp["width"]), device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    (loss_h, aux_h, grads_h), sec, launches = timed(vg, h_args)
    peak_h = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_h = sec / hp["frames"] * 1e3
    norms = grad_norms(grads_h, n_e)
    finite = bool(torch.isfinite(loss_h)) and all(bool(torch.isfinite(g).all()) for g in grads_h)
    log(f"[train:headline] loss {float(loss_h):.6f} overflow {bool(aux_h['overflow'])} "
        f"{ms_h:.2f} ms/frame (forward+backward) peak {peak_h:.2f} GiB "
        f"launches {launches} grad norms {norms}")
    if not finite or not all(launches.get(k, 0) > 0 for k in KERNELS):
        log("[train:headline] FAILED: non-finite values or a kernel never launched")
        return False, launches
    if not all(v > 0 for v in norms.values()):
        log("[train:headline] FAILED: a zero gradient norm")
        return False, launches
    report["train_headline"] = dict(
        loss=float(loss_h), ms_per_frame=ms_h, launches=launches, grad_norms=norms,
        peak_gib=peak_h, profile=profile_step(vg, h_args),
        layers=train_layer_breakdown("headline", h_scene, init_v))

    # 8. determinism of the training path
    loss_b, _, grads_b = vg(*h_args)
    same = bool(torch.equal(loss_h, loss_b)) and all(
        torch.equal(a, b) for a, b in zip(grads_h, grads_b))
    n_diff = sum(not torch.equal(a, b) for a, b in zip(grads_h, grads_b))
    log(f"[train:determinism] loss bitwise equal {bool(torch.equal(loss_h, loss_b))}, "
        f"{len(grads_h) - n_diff} of {len(grads_h)} gradient leaves bitwise equal")
    report["train_determinism"] = same
    if not same:
        return False, launches

    # 9. realworld value-and-grad
    rp = BENCH_SHAPES["realworld"]
    r_scene = scenes["realworld"]
    vg_r = value_and_grad_fn(r_scene, "cuda")
    _, n_er = lora_params(r_scene)
    r_args = (init_v, torch.ones(rp["frames"], device="cuda"),
              torch.zeros((rp["frames"], rp["n_views"], 3, rp["height"], rp["width"]), device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    (loss_r, aux_r, grads_r), sec, launches_r = timed(vg_r, r_args)
    peak_r = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_r = sec / rp["frames"] * 1e3
    finite = bool(torch.isfinite(loss_r)) and all(bool(torch.isfinite(g).all()) for g in grads_r)
    log(f"[train:realworld] loss {float(loss_r):.6f} (3 per frame by construction, so the "
        f"gradient is ~0: finiteness and speed only) overflow {bool(aux_r['overflow'])} "
        f"{ms_r:.2f} ms/frame (forward+backward) peak {peak_r:.2f} GiB "
        f"launches {launches_r} grad norms {grad_norms(grads_r, n_er)}")
    report["train_realworld"] = dict(loss=float(loss_r), ms_per_frame=ms_r, peak_gib=peak_r,
                                     launches=launches_r, grad_norms=grad_norms(grads_r, n_er),
                                     layers=train_layer_breakdown("realworld", r_scene, init_v))
    if not finite:
        log("[train:realworld] FAILED: non-finite values")
        return False, launches

    # 10. small scene gradients, card vs CPU
    small = dict(n_particles=800, grid=32, substeps=2, width=64, height=64, n_views=1,
                 force_mask=False, max_pairs=1 << 12, max_per_tile=64,
                 layer_widths=(16, 16), lora_r=4)
    gt = torch.rand((2, 1, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    l_gpu, _, g_gpu = value_and_grad_fn(build_scene(**small, device="cuda"), "cuda")(
        init_v, torch.ones(2, device="cuda"), gt.cuda())
    l_cpu, _, g_cpu = value_and_grad_fn(build_scene(**small, device="cpu"), "cpu")(
        init_v.cpu(), torch.ones(2), gt)
    rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    errs = [scaled_err(a.cpu(), b) for a, b in zip(g_gpu, g_cpu)]
    log(f"[train:small] loss rel gap {rel:.2e} (bound 1e-4); gradient scaled max error "
        f"{max(errs):.2e} over {len(errs)} leaves (bound {GRAD_TOL:.0e})")
    report["train_small"] = dict(loss_rel_gap=rel, grad_errs=errs)
    if not (rel <= 1e-4 and max(errs) <= GRAD_TOL):
        return False, launches

    # 11. trainers
    t_scene = build_scene(**{**{k: v for k, v in hp.items() if k != "frames"},
                             "max_pairs": 1 << 17}, seed=0, device="cuda")
    frozen = {f"{m}.{k}": v.detach().clone() for m, mod in
              (("e", t_scene.elasticity), ("p", t_scene.plasticity))
              for k, v in list(mod.named_parameters()) + list(mod.named_buffers())}
    cfg = dict(num_epochs=3, elasticity_lr=1e-3, plasticity_lr=1e-3, warmup_step=1,
               elasticity_scheduler={"type": "cos", "max_steps": 3},
               plasticity_scheduler={"type": "exp", "max_steps": 3, "lr_final": 1e-4},
               decay_init=0.5, decay_final=1.0, decay_steps=2, lambda_max_decay=0.33)
    t0 = time.perf_counter()
    res = finetune_constitutive(t_scene, h_args[2], init_v, cfg, device="cuda")
    torch.cuda.synchronize()
    s_epoch = (time.perf_counter() - t0) / cfg["num_epochs"]
    after = {f"{m}.{k}": v.detach() for m, mod in
             (("e", t_scene.elasticity), ("p", t_scene.plasticity))
             for k, v in list(mod.named_parameters()) + list(mod.named_buffers())}
    lora = lambda k: k.endswith("lora_a") or k.endswith("lora_b")
    moved = [k for k in frozen if not torch.equal(frozen[k], after[k])]
    base_ok = all(lora(k) for k in moved) and any(lora(k) for k in moved)
    losses_ok = all(np.isfinite(res.losses))
    log(f"[trainer] finetune_constitutive losses {res.losses} grad norms e {res.grad_norms_e} "
        f"p {res.grad_norms_p}; {s_epoch:.3f} s/epoch; {len(moved)} leaves changed, all LoRA: "
        f"{all(lora(k) for k in moved)}")
    t0 = time.perf_counter()
    vres = optimize_init_velocity(t_scene, h_args[2], num_epochs=2, lr=0.01,
                                  schedule=cosine_decay_schedule(0.01, 2), device="cuda")
    v_epoch = (time.perf_counter() - t0) / 2
    v_ok = all(np.isfinite(vres.losses)) and bool(np.isfinite(vres.init_v).all())
    log(f"[trainer] optimize_init_velocity losses {vres.losses} init_v {vres.init_v.tolist()}; "
        f"{v_epoch:.3f} s/epoch")
    report["trainers"] = dict(constitutive_losses=res.losses, s_per_epoch=s_epoch,
                              changed=moved, velocity_losses=vres.losses, velocity_s_per_epoch=v_epoch)
    report.update(train_headline_ms=ms_h, train_realworld_ms=ms_r)
    return base_ok and losses_ok and v_ok, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "neuma_tpu_torch").is_dir():
        print("chip_smoke: neuma_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.train.grounding import BENCH_SHAPES, build_scene, make_rollout_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    report = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # 1. build
    kernels.library()
    smi = nvidia_smi()
    report["nvidia_smi"] = smi
    report["build_seconds"] = kernels.build_seconds
    log(f"[build] kernels built in {kernels.build_seconds:.1f} s")
    log(smi)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[ptxas] {line.strip()}")

    # 2. kernel checks at both shapes
    rec = {name: {} for name in KERNELS}
    scenes = {}
    ok = True
    gen = torch.Generator().manual_seed(0)
    for tag in ("headline", "realworld"):
        p = BENCH_SHAPES[tag]
        scenes[tag] = build_scene(**{k: v for k, v in p.items() if k != "frames"},
                                  seed=0, device="cuda")
        ok &= check_and_time(tag, kernel_inputs(scenes[tag], gen), rec)
    if not ok:
        log("[check] FAILED")
        return 1

    # 3. headline forward, launches counted on one rollout
    init_v = torch.tensor([0.3, 0.0, 0.0], device="cuda")
    hp = BENCH_SHAPES["headline"]
    h_scene = scenes["headline"]
    h_loss = torch.no_grad()(make_rollout_loss(h_scene, device="cuda"))
    h_args = (init_v, torch.ones(hp["frames"], device="cuda"),
              torch.zeros((hp["frames"], 1, 3, hp["height"], hp["width"]), device="cuda"))
    (loss_h, aux_h), sec, launches_fwd = timed(h_loss, h_args)
    ms_h = sec / hp["frames"] * 1e3
    log(f"[headline] loss {float(loss_h):.6f} overflow {bool(aux_h['overflow'])} "
        f"{ms_h:.2f} ms/frame (forward) launches {launches_fwd}")
    if not all(launches_fwd.get(k, 0) > 0 for k in ("p2g", "g2p", "composite")):
        log("[headline] FAILED: a kernel of the path was never launched")
        return 1
    if not torch.isfinite(loss_h):
        log("[headline] FAILED: non-finite loss")
        return 1
    report["profile_headline"] = profile_step(h_loss, h_args)
    report["layers_headline"] = layer_breakdown("headline", h_scene)

    # 4. determinism
    loss2, _ = h_loss(*h_args)
    x_a = sim_final_x(h_scene, init_v, hp["frames"])
    x_b = sim_final_x(h_scene, init_v, hp["frames"])
    det = bool(torch.equal(loss_h, loss2)) and bool(torch.equal(x_a, x_b))
    log(f"[determinism] loss bitwise equal {bool(torch.equal(loss_h, loss2))}, "
        f"final x bitwise equal {bool(torch.equal(x_a, x_b))}")
    if not det:
        return 1

    # 5. realworld forward
    rp = BENCH_SHAPES["realworld"]
    r_loss = torch.no_grad()(make_rollout_loss(scenes["realworld"], device="cuda"))
    r_args = (init_v, torch.ones(rp["frames"], device="cuda"),
              torch.zeros((rp["frames"], rp["n_views"], 3, rp["height"], rp["width"]), device="cuda"))
    (loss_r, aux_r), sec, launches_fwd_r = timed(r_loss, r_args)
    ms_r = sec / rp["frames"] * 1e3
    log(f"[realworld] loss {float(loss_r):.6f} overflow {bool(aux_r['overflow'])} "
        f"{ms_r:.2f} ms/frame (forward) launches {launches_fwd_r}")
    if not torch.isfinite(loss_r):
        log("[realworld] FAILED: non-finite loss")
        return 1
    report["profile_realworld"] = profile_step(r_loss, r_args)
    report["layers_realworld"] = layer_breakdown("realworld", scenes["realworld"])

    # 6. small scene: kernels on the card vs plain versions on the CPU
    small = dict(n_particles=800, grid=32, substeps=2, width=64, height=64, n_views=1,
                 force_mask=False, max_pairs=1 << 12, max_per_tile=64,
                 layer_widths=(16, 16), lora_r=4)
    gt = torch.rand((2, 1, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    l_gpu, _ = torch.no_grad()(make_rollout_loss(build_scene(**small, device="cuda"), device="cuda"))(
        init_v, torch.ones(2, device="cuda"), gt.cuda())
    l_cpu, _ = torch.no_grad()(make_rollout_loss(build_scene(**small, device="cpu"), device="cpu"))(
        init_v.cpu(), torch.ones(2), gt)
    rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    log(f"[small] loss card {float(l_gpu):.7f} cpu {float(l_cpu):.7f} rel gap {rel:.2e} (bound 1e-4)")
    if not rel <= 1e-4:
        return 1
    report.update(headline=dict(loss=float(loss_h), ms_per_frame=ms_h, launches=launches_fwd),
                  realworld=dict(loss=float(loss_r), ms_per_frame=ms_r, launches=launches_fwd_r),
                  small_rel_gap=rel)

    # 7-11. the training path
    ok, launches = training_phases(scenes, report, init_v)
    report.update(kernels=rec, launches_train_headline=launches,
                  seconds=time.perf_counter() - t_start)
    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if not ok:
        log("[train] FAILED")
        return 1

    sources = {
        "p2g": ("neuma_tpu_torch/csrc/p2g.cu", "neuma_tpu/sim/p2g_kernel.py:426"),
        "g2p": ("neuma_tpu_torch/csrc/g2p.cu", "neuma_tpu/sim/p2g_kernel.py:562"),
        "g2p_derivs": ("neuma_tpu_torch/csrc/g2p_bwd.cu", "neuma_tpu/sim/p2g_kernel.py:684"),
        "composite": ("neuma_tpu_torch/csrc/composite.cu", "neuma_tpu/render/pallas_raster.py:127"),
        "composite_bwd": ("neuma_tpu_torch/csrc/composite_bwd.cu",
                          "neuma_tpu/render/pallas_raster.py:245"),
    }
    summary = []
    for name, (src, repl) in sources.items():
        r = rec[name]["headline"]
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches.get(name, 0), "launches_forward": launches_fwd.get(name, 0),
            "check": "pass", "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    log(f"[done] {report['seconds']:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
