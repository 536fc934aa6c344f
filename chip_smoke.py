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
   CUDA kernel a wrapper launches is read with torch.profiler. Each
   bound counts the bytes the function needs (K1-K3: the payload columns
   it reads; K2/K3: the slab cells its taps touch), with the older
   all-48-column figure beside it; K2 also gets a launch floor, the device
   time of one launch writing its output only. It also
   prints the work each kernel gets (K1: occupied blocks and chunks per
   block; K2 and K3: rows, CTAs, threads per row, live rows per occupied
   block, slab cells read; K4: the tiles' pair counts, the pixels that stop on the 1e-4
   test, the (tile, segment) items and those walked again, the scratch
   bytes; K5: the tiles' walk lengths and the (tile, segment) work items).
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
12. A dense-grid scene (``num_grids = 24``, the largest grid on the dense
    branch; 5,000 particles, one 400x400 view, 2 frames x 4 substeps):
    the forward and the value-and-grad on the card against the same code
    on the CPU (loss within rtol 1e-4, each gradient leaf within a scaled
    1e-3, the bounds of phases 6 and 10), two card value-and-grads with a
    bitwise-equal loss and gradient leaves, K1-K3 never launched and K4/K5
    launched on that path, and ms/frame forward and forward + backward.
13. The training CLI, ``neuma_tpu_torch.apps.finetune.main``, end to end
    from ``configs/synthetic/finetune-bb.yaml`` at its widths (SH degree
    3, InvariantFull (64, 64) with LoRA r 16, ``num_grids`` 32, max_pairs
    262,144, volumetric mesh sampling at resolution 32 by the native
    sampler, one 800x800 view ``d_2`` on white) on a BouncyBall-like scene
    it fabricates with the port's own code (an icosphere mesh, ~10,000
    Gaussians). Depth is cut: 5 dataset steps (4 frames per stage), 2
    epochs per stage, random base weights (``APP_CUTS``). It prints the
    seconds of data preparation and of each stage, checks finite losses,
    the artifacts (``init.npz``, the LoRA ring, ``metrics.jsonl`` rows of
    both stages, ``train_state.npz``) and K1-K5 each launched during the
    CLI run, and that the native sampler (not its Python fallback) ran;
    then holds K1-K5 to their plain versions, as phase 2 does, on inputs
    from the CLI's stage-2 scene; then reruns with ``resume=true
    constitution.num_epochs=3`` (the full train state restored, one more
    finite epoch); then runs a small copy of the config on the card and
    on the CPU (``app_card_vs_cpu``: losses within rtol 1e-4 per epoch,
    the prepared particles bitwise equal, the bindings equal, the stage-1
    velocity within a scaled 1e-3, and one value-and-grad of the stage-2
    loss at the card run's end state plus a strain rate within the bounds
    of phase 10).
14. The serving CLIs end to end (``SERVE_CUTS``): (a)
    ``neuma_tpu_torch.apps.render.main`` for 20 steps on phase 13's
    scene and outputs (``init.npz``, the last ``*_lora.npz`` by ``-l``;
    24,034 particles, 32^3, one 800x800 view, SH 3, InvariantFull (64,
    64), LoRA r 16) with ``-sp``; (b) ``neuma_tpu_torch.apps.inference.main``
    for 20 steps on ``configs/demo/multiobj-bb-cc.yaml`` at its widths
    (two objects, ``num_grids`` 42, SH 3, InvariantFull (64, 64), LoRA r
    16 on object 1, ``max_pairs`` 262,144, one 800x800 view ``e_2`` on
    white), both objects fabricated and prepared by the port at
    finetune-bb.yaml's sampling with reference-form ``.pt`` base files
    from seed 42 and phase 13's last LoRA file on object 1. Gates: the
    frames (20 per view; 21 with inference's frame 0), the PLYs and a
    video or GIF per view; the launch counts of each CLI run (counts set
    to 0 just before it and read just after: K1 and K2 once per step, K4
    once per rendered view, K3 and K5 never); K1, K2 and K4 against their
    plain versions at the inference scene's shapes (phase 2's bounds);
    a second inference run byte-equal in every PNG and PLY; small copies
    of both CLIs on the card and on the CPU (``SERVE_SMALL``: every PNG
    pixel within 1 of 255 levels, every step's positions within a scaled
    1e-5); and ``sim.rollout.rollout`` at the headline shape for 4 frames
    bitwise equal to a loop of ``make_step_fn`` steps. It prints each
    CLI's sim ms per step and render ms per view (host clock, each step
    ended by a synchronize) and whether ``imageio`` is installed.
15. The registration and evaluation CLIs (``REGIST_CUTS``): (a)
    ``neuma_tpu_torch.apps.regist.main`` from
    ``configs/realworld/regist-bun.yaml`` at its widths (SH 0, three
    RealCapture views r_0-r_2 at 1920x1080, ``max_pairs`` 524,288, the
    config's INIT, learning rates and cosine alpha, volumetric sampling
    at 36) on a capture it fabricates: 30,000 Gaussians and an icosphere
    mesh in a raw frame, first frames rendered by the port at a Sim(3)
    about 1 degree, 5 mm and 1 % of scale from INIT; 200 iterations.
    Gates: each view's pairs fit the budget at INIT and at the true pose,
    the three files, finite logged losses with the last below the
    first, K4 = K5 = 3 per iteration and K1-K3 never launched, K4 and K5
    against their plain versions on view r_0's pair features at INIT
    (phase 2's bounds), and a second CLI run that launches nothing and
    leaves the files byte-equal. (b) A small copy (``tests/test_register.py``'s
    scene, SH 1, ``lambda_dssim`` 0.2) for 10 iterations on the card
    twice and on the CPU: losses rtol 1e-4, params a scaled 1e-4, the
    card runs bitwise. (c) ``neuma_tpu_torch.apps.evaluate.main`` on
    phase 14's render-CLI frames against phase 13's ground truth (800x800,
    the default crop, ``--video``): ``metrics.txt`` with finite
    ``psnr``, ``ssim`` and ``lpips_vgg_rand``, the video, and each
    frame's metrics on the card within rtol 1e-5 (PSNR, SSIM) and 1e-4
    (LPIPS) of the CPU's. It prints ms per iteration (host clock between
    log points, median), each stage's seconds, the peak memory, and ms
    per frame of each metric (CUDA events), and profiles 5 iterations
    (the device's idle share, time by kernel).

The scenes follow ``bench.py``'s recipe with random weights from seed 0.
Output: one JSON line ``{"kernels": [...]}`` (launches counted on the
headline training path; ``launches_app`` in the CLI run of phase 13;
``launches_render`` and ``launches_inference`` in the CLI runs of phase 14;
``launches_regist`` in the registration CLI run of phase 15),
the card's ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Details go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
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
# Payload columns (of 48) each function reads, counted by its bound: K1
# weights, lines, b_eff, A dx, mass (0-30); K2 weights, lines, fx (0-17,
# 41-43); K3 all of those and the spline derivatives (0-30, 32-43).
PAYLOAD_COLS_READ = {"p2g": 31, "g2p": 21, "g2p_derivs": 43}


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

    seg = kernels.library().neuma_composite_seg()
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
def composite_fwd_work(inp, lk, seg):
    """K4's work on tiles with pairs: their pair counts; the pixels that
    stop on the 1e-4 test (a pixel stops at the first slot after its
    ``last`` that passes the guard, since that slot would have
    contributed); the slot where each tile's walk ends (every pixel
    stopped, else its count); the (tile, ``seg``-slot segment) items, and
    those that hold a stop, which the kernel's combine launch walks again."""
    pf, counts = inp["pf"], inp["counts"].to(torch.int64)
    nz = torch.nonzero(counts > 0).squeeze(1)
    cnt, starts = counts[nz], inp["tile_start"][:-1].to(torch.int64)[nz]
    lane = torch.arange(256, device=pf.device)
    px = ((nz % inp["tiles_x"]) * 16)[:, None] + (lane % 16)[None, :]
    py = ((nz // inp["tiles_x"]) * 16)[:, None] + (lane // 16)[None, :]
    px, py, last = px.to(torch.float32), py.to(torch.float32), lk[nz]
    stop = torch.full(last.shape, -1, dtype=torch.int64, device=pf.device)
    for s in range(int(cnt.max())):
        idx = starts + s
        f = pf[torch.clamp(idx, max=pf.shape[0] - 1)]
        col = lambda j: f[:, j : j + 1]
        dx, dy = col(0) - px, col(1) - py
        power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
        alpha = torch.clamp(col(5) * torch.exp(power), max=0.99)
        hit = ((s < cnt)[:, None] & (power <= 0.0) & (alpha >= 1.0 / 255.0)
               & (idx.to(torch.float32)[:, None] > last) & (stop < 0))
        stop = torch.where(hit, s, stop)
    stopped = stop >= 0
    walk_end = torch.where(stopped.all(1), stop.max(1).values + 1, cnt).to(torch.float64)
    c = cnt.to(torch.float64)
    seg_of_stop = torch.unique((torch.arange(nz.numel(), device=pf.device)[:, None] * 4096
                                + stop // seg)[stopped])
    return dict(tiles=int(counts.numel()), tiles_with_pairs=int(nz.numel()),
                count_mean=float(c.mean()), count_p99=float(torch.quantile(c, 0.99)),
                count_max=int(cnt.max()), walk_end_mean=float(walk_end.mean()),
                walk_end_p99=float(torch.quantile(walk_end, 0.99)),
                walk_end_max=int(walk_end.max()), tiles_all_stopped=int(stopped.all(1).sum()),
                pixels_stopped=int(stopped.sum()), pixels_contributing=int((last >= 0).sum()),
                segment=seg, items=int(((cnt + seg - 1) // seg).sum()),
                items_with_a_stop=int(seg_of_stop.numel()))


def gather_slab_cells(payload, c2b):
    """Distinct (block, x, y, z) slab cells that the live rows' in-range
    taps read: the slab bytes a gather needs are these cells' 4 channels."""
    from neuma_tpu_torch.sim import p2g_kernel as pk

    rows, S = payload.shape[0], pk.S
    live = payload[:, pk._W0 : pk._W0 + 9].abs().sum(1) > 0
    blk = torch.repeat_interleave(c2b.to(torch.int64), rows // c2b.shape[0])[live]
    lines = payload[live, pk._L0 : pk._L0 + 9].to(torch.int64).reshape(-1, 3, 3)
    o = [torch.as_tensor(pk._OFFSETS[:, a], device=payload.device) for a in range(3)]
    lx, ly, lz = lines[:, 0, o[0]], lines[:, 1, o[1]], lines[:, 2, o[2]]  # (live, 27)
    inside = ((lx >= 0) & (lx < S) & (ly >= 0) & (ly < S) & (lz >= 0) & (lz < S))
    cell = ((blk[:, None] * S + lx) * S + ly) * S + lz
    return int(torch.unique(cell[inside]).numel())


def g2p_work(inp, rows_per_cta, threads_per_row):
    """K2's or K3's work: payload rows, CTAs, threads per row, and the live
    rows per occupied block (a chunk's rows share one block's slab)."""
    p, c2b = inp["payload_g"], inp["c2b_g"].to(torch.int64)
    rows, M = p.shape[0], c2b.shape[0]
    live = p[:, 0:9].abs().sum(1) > 0  # spline weights: nonzero on every live row
    occ = torch.bincount(torch.repeat_interleave(c2b, rows // M)[live])
    occ = occ[occ > 0].to(torch.float64)
    return dict(rows=rows, live_rows=int(live.sum()), ctas=-(-rows // rows_per_cta),
                threads_per_row=threads_per_row, threads_per_cta=rows_per_cta * threads_per_row,
                occupied_blocks=int(occ.numel()), rows_per_occupied_block_mean=float(occ.mean()),
                rows_per_occupied_block_max=int(occ.max()))


@torch.no_grad()
def check_and_time(tag, inp, rec):
    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.sim import p2g_kernel as pk

    lib = kernels.library()
    ok = True
    # K1
    k = pk.run_p2g_fwd(inp["payload"], inp["c2b"], inp["NB"])
    p = pk.run_p2g_fwd_plain(inp["payload"], inp["c2b"], inp["NB"])
    torch.cuda.synchronize()
    e1 = scaled_err(k, p)
    ok &= e1 <= K12_TOL
    rows, M, NB = inp["payload"].shape[0], inp["c2b"].shape[0], inp["NB"]
    # bound_ms counts the payload columns read; bound_ms_48col (the older
    # formula, kept for comparison) counts all 48 and, for K2/K3, whole slabs.
    b1 = bound_ms(rows * PAYLOAD_COLS_READ["p2g"] * 4 + M * 4 + NB * 16384 * 4,
                  inp["live"] * 27 * 28)
    b1_48 = bound_ms(rows * 48 * 4 + M * 4 + NB * 16384 * 4, inp["live"] * 27 * 28)
    lib1 = p2g_library_call(inp)
    rec["p2g"][tag] = dict(
        max_abs_err=e1, tol=K12_TOL,
        ms=cuda_ms(lambda: pk.run_p2g_fwd(inp["payload"], inp["c2b"], NB), 20),
        plain_ms=cuda_ms(lambda: pk.run_p2g_fwd_plain(inp["payload"], inp["c2b"], NB), 3),
        library_ms=cuda_ms(lib1, 5), bound_ms=b1[0], bound_by=b1[1],
        bound_ms_48col=b1_48[0], M=M, NB=NB,
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
    cells = gather_slab_cells(inp["payload_g"], inp["c2b_g"])
    fixed = M * 4 + rows * 16 * 4  # c2b in, (rows, 16) out
    b2 = bound_ms(rows * PAYLOAD_COLS_READ["g2p"] * 4 + cells * 16 + fixed, inp["live"] * 27 * 34)
    b2_48 = bound_ms(rows * 48 * 4 + inp["slabs"].numel() * 4 + fixed, inp["live"] * 27 * 34)
    out2 = torch.empty((rows, 16), device=k.device)
    rec["g2p"][tag] = dict(
        max_abs_err=e2, tol=K12_TOL,
        ms=cuda_ms(lambda: pk.run_apic_gather(*args), 20),
        plain_ms=cuda_ms(lambda: pk.run_apic_gather_plain(*args), 3),
        library_ms=None, bound_ms=b2[0], bound_by=b2[1], bound_ms_48col=b2_48[0], rows=rows,
        device_rows=device_rows(lambda: pk.run_apic_gather(*args)),
        # the launch floor: one launch that writes K2's output and nothing else
        output_only_ms=sum(device_rows(lambda: out2.zero_()).values()),
        work=dict(g2p_work(inp, lib.neuma_g2p_rows_per_cta(), lib.neuma_g2p_threads_per_row()),
                  slab_cells_read=cells),
    )
    # K3: both gathers of the step backward; each output group (dgm, db,
    # dA, dx) is scaled by its own largest value (absolute where all zero,
    # as dgm is in the second gather).
    groups = (slice(0, 1), slice(1, 4), slice(4, 13), slice(13, 16))
    e3, ms3, plain3, rows3, cells3 = 0.0, 0.0, 0.0, {}, 0
    for payload, slabs in inp["k3"]:
        cells3 += gather_slab_cells(payload, inp["c2b_g"]) / 2
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
    b3 = bound_ms(rows * PAYLOAD_COLS_READ["g2p_derivs"] * 4 + cells3 * 16 + fixed,
                  inp["live"] * 27 * 71)
    b3_48 = bound_ms(rows * 48 * 4 + inp["slabs"].numel() * 4 + fixed, inp["live"] * 27 * 71)
    rec["g2p_derivs"][tag] = dict(
        max_abs_err=e3, tol=K3_TOL, ms=ms3, plain_ms=plain3, library_ms=None,
        bound_ms=b3[0], bound_by=b3[1], bound_ms_48col=b3_48[0], rows=rows, device_rows=rows3,
        work=dict(g2p_work(inp, lib.neuma_g2p_derivs_rows_per_cta(),
                           lib.neuma_g2p_derivs_threads_per_row()), slab_cells_read=cells3),
    )
    ok &= check_composite(tag, inp, rec)
    log(f"[check:{tag}] first view at rest needs {inp['pairs_needed']} (gaussian, tile) "
        f"pairs, max_pairs {inp['max_pairs']}: overflow {inp['raster_overflow']}")
    log_checks(tag, rec, KERNELS)
    return ok


def check_composite(tag, inp, rec) -> bool:
    """K4 and K5 against their plain versions on ``inp``'s pair features
    (``pf``, ``tile_start``, ``counts``, ``tiles_x``) and random ``dT``,
    ``dC``, at phase 2's bounds; times and bounds into ``rec``."""
    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.render import raster_kernel as rk

    lib = kernels.library()
    ok = True
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
        work=dict(composite_fwd_work(inp, lk, lib.neuma_composite_seg()),
                  scratch_bytes=4 * lib.neuma_composite_fwd_scratch_words(inp["pf"].shape[0], nt)),
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
    return ok


def log_checks(tag, rec, names):
    for name in names:
        r = rec[name][tag]
        log(
            f"[check:{tag}] {name}: max err {r['max_abs_err']:.3e} (bound {r['tol']:.0e})"
            + (f", last mismatches {r['last_mismatch']}" if name == "composite" else "")
            + f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
            + (f" (all 48 columns {r['bound_ms_48col']:.5f})" if "bound_ms_48col" in r else "")
            + (f", index_add_ {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
            + (f", output-only launch {r['output_only_ms']:.5f} ms device"
               if "output_only_ms" in r else "")
        )
    for name in names:
        r = rec[name][tag]
        if "work" in r:
            log(f"[work:{tag}] {name}: {json.dumps(r['work'])}")
        for key, ms in r["device_rows"].items():
            log(f"[work:{tag}] {name} device {ms:.4f} ms  {key}")


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


DENSE_SCENE = dict(n_particles=5000, grid=24, substeps=4, width=400, height=400, n_views=1,
                   force_mask=False, max_pairs=1 << 15, max_per_tile=512)


def dense_phase(report, init_v):
    """Phase 12: the dense-grid step (no K1-K3) through the rollout, on the
    card and on the CPU."""
    from neuma_tpu_torch.train.grounding import build_scene, make_rollout_loss

    t0 = time.perf_counter()
    frames, size = 2, (DENSE_SCENE["height"], DENSE_SCENE["width"])
    gt = torch.rand((frames, 1, 3, *size), generator=torch.Generator().manual_seed(2))
    scenes = {dev: build_scene(**DENSE_SCENE, seed=0, device=dev) for dev in ("cuda", "cpu")}
    args = {"cuda": (init_v, torch.ones(frames, device="cuda"), gt.cuda()),
            "cpu": (init_v.cpu(), torch.ones(frames), gt)}
    fwd = torch.no_grad()(make_rollout_loss(scenes["cuda"], device="cuda"))
    (loss_f, aux), sec_f, launches_f = timed(fwd, args["cuda"])
    vg = value_and_grad_fn(scenes["cuda"], "cuda")
    (loss_a, _, grads_a), sec_vg, launches_vg = timed(vg, args["cuda"])
    loss_b, _, grads_b = vg(*args["cuda"])
    n_same = sum(torch.equal(a, b) for a, b in zip(grads_a, grads_b))
    same = bool(torch.equal(loss_a, loss_b)) and n_same == len(grads_a)
    # one CPU value-and-grad: its loss is the forward's (the same code)
    l_cpu, _, g_cpu = value_and_grad_fn(scenes["cpu"], "cpu")(*args["cpu"])
    rel = abs(float(loss_a) - float(l_cpu)) / abs(float(l_cpu))
    rel_f = abs(float(loss_f) - float(l_cpu)) / abs(float(l_cpu))
    errs = [scaled_err(a.cpu(), b) for a, b in zip(grads_a, g_cpu)]
    finite = bool(torch.isfinite(loss_a)) and all(bool(torch.isfinite(g).all()) for g in grads_a)
    slab_free = all(launches.get(k, 0) == 0 for launches in (launches_f, launches_vg)
                    for k in ("p2g", "g2p", "g2p_derivs"))
    rendered = launches_f.get("composite", 0) > 0 and all(
        launches_vg.get(k, 0) > 0 for k in ("composite", "composite_bwd"))
    ms_f, ms_vg = sec_f / frames * 1e3, sec_vg / frames * 1e3
    log(f"[dense] num_grids 24, 5000 particles, one 400x400 view, 2 frames x 4 substeps: "
        f"loss {float(loss_a):.6f} overflow {bool(aux['overflow'])}; {ms_f:.2f} ms/frame forward, "
        f"{ms_vg:.2f} ms/frame forward+backward; launches forward {dict(launches_f)} "
        f"forward+backward {dict(launches_vg)}")
    log(f"[dense] card vs CPU: forward loss rel gap {rel_f:.2e}, value-and-grad loss rel gap "
        f"{rel:.2e} (bound 1e-4); gradient scaled max error {max(errs):.2e} over {len(errs)} "
        f"leaves (bound {GRAD_TOL:.0e}); two card runs: loss bitwise equal "
        f"{bool(torch.equal(loss_a, loss_b))}, {n_same} of {len(grads_a)} leaves bitwise equal; "
        f"phase {time.perf_counter() - t0:.1f} s")
    report["dense"] = dict(seconds=time.perf_counter() - t0, loss=float(loss_a), overflow=bool(aux["overflow"]), ms_per_frame_forward=ms_f,
                           ms_per_frame_train=ms_vg, launches_forward=dict(launches_f),
                           launches_train=dict(launches_vg), loss_rel_gap=rel,
                           forward_loss_rel_gap=rel_f, grad_errs=errs, bitwise=same)
    ok = (finite and same and slab_free and rendered and rel <= 1e-4 and rel_f <= 1e-4
          and max(errs) <= GRAD_TOL)
    if not ok:
        log("[dense] FAILED")
    return ok


APP_CONFIG = REPO / "configs" / "synthetic" / "finetune-bb.yaml"
# The app phase's cuts of finetune-bb.yaml: depth only (the widths stay).
APP_CUTS = {
    "dataset steps": "5 (4 frames per stage; the config trains on 400 and 20)",
    "epochs": "2 per stage (the config runs 200 and 1000), then 1 resumed",
    "pretrained_ckpt": "null: random base weights from seed 42 (jelly_0300.pt is not in the repo)",
    "data": "a fabricated BouncyBall-like scene: an icosphere mesh, ~10,000 Gaussians in it, "
            "one 800x800 view d_2 of a falling disk on white",
}
# The card-vs-CPU copy: small enough for the CPU, still on the slab grid.
APP_SMALL = ["sim.num_grids=32", "particle_data.mesh_sample_mode=uniform",
             "particle_data.mesh_sample_resolution=10",
             "constitution.elasticity.layer_widths=[16, 16]",
             "constitution.plasticity.layer_widths=[16, 16]",
             "constitution.lora.r=4", "constitution.lora.alpha=4"]


def fabricate_ball(root: Path, n_gaussians: int, seed: int = 0, device=None):
    """A BouncyBall-like object on disk, made with the port's own code: an
    icosphere mesh (``mesh.obj``) of radius 0.2 at (0, 0.45, 0), inside
    the configs' ``ori_bounds``, and ``n_gaussians`` SH-3 Gaussians in the
    ball (``kernels.ply``). Returns the ball's centre."""
    from neuma_tpu_torch.data.mesh import TriMesh, make_icosphere
    from neuma_tpu_torch.render.gaussians import create_from_points

    rng = np.random.default_rng(seed)
    center, radius = np.array([0.0, 0.45, 0.0]), 0.2
    root.mkdir(parents=True, exist_ok=True)
    ico = make_icosphere(radius=radius, subdivisions=3)
    TriMesh(vertices=ico.vertices + center, faces=ico.faces).export_obj(root / "mesh.obj")
    d = rng.standard_normal((n_gaussians, 3))
    d *= (radius * 0.97 * rng.random((n_gaussians, 1)) ** (1 / 3)) / np.linalg.norm(d, axis=1,
                                                                                      keepdims=True)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    with torch.no_grad():
        pack = create_from_points((center + d).astype(np.float32),
                                  rng.random((n_gaussians, 3)).astype(np.float32), sh_degree=3,
                                  device=device)
    pack.to_ply(root / "kernels.ply")
    return center


def fabricate_views(root: Path, size: int, n_steps: int, target, eye_offset, view: str = "d_2",
                    subfolder: str = "data_dynamic"):
    """One view ``view`` of ``n_steps`` RGBA frames of a disk falling
    across a transparent background, with the NeuMA-Synthetic camera JSON
    (``<root>/<subfolder>.json``), the camera looking at ``target``."""
    from PIL import Image

    from neuma_tpu_torch.render.camera import Camera, fov2focal

    sub = root / subfolder
    sub.mkdir(parents=True)
    cam = Camera.look_at(eye=target + np.asarray(eye_offset), target=target, fov=0.8,
                         width=size, height=size)
    c2w = np.linalg.inv(cam.world_view.numpy().T.astype(np.float64))
    c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL axes, undone by the reader
    focal = fov2focal(cam.fov_x, size)
    yy, xx = np.mgrid[:size, :size]
    meta = []
    for step in range(n_steps):
        cy, cx = size * (0.45 + 0.02 * step), size * 0.5
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 < (0.17 * size) ** 2
        rgba = np.zeros((size, size, 4), np.uint8)
        rgba[inside] = (200, 60, 40, 255)
        name = f"{view}_{step:03d}.png"
        Image.fromarray(rgba, "RGBA").save(sub / name)
        meta.append({"file_path": f"./{subfolder}/{name}", "c2w": c2w.tolist(),
                     "intrinsic": [[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]]})
    (root / f"{subfolder}.json").write_text(json.dumps(meta))


def fabricate_app_scene(root: Path, n_gaussians: int, size: int, n_steps: int, seed: int = 0):
    """The training CLI's BouncyBall-like scene: ``fabricate_ball`` in
    ``root`` and one view ``d_2`` of it under ``root / "dataset"``."""
    center = fabricate_ball(root, n_gaussians, seed)
    fabricate_views(root / "dataset", size, n_steps, center, (0.0, 0.15, -1.5))


def app_config(root: Path, name: str, extra=()) -> Path:
    """finetune-bb.yaml with the phase's cuts and the fabricated paths."""
    from neuma_tpu_torch.utils.config import load_config

    cfg = load_config(APP_CONFIG, [
        f"root={root / 'logs'}", f"name={name}", f"data_root={root / 'sim_data'}",
        "pretrained_ckpt=null", f"gaussian.kernels_path={root / 'kernels.ply'}",
        f"video_data.data.path={root / 'dataset'}", f"particle_data.mesh_path={root / 'mesh.obj'}",
        "constitution.num_epochs=2", "constitution.num_frames=4",
        "velocity.num_epochs=2", "velocity.num_frames=4", *extra])
    path = root / f"{name}.yaml"
    cfg.save(path)
    return path


def _stage_losses(exp_root: Path):
    rows = [json.loads(line) for line in (exp_root / "metrics.jsonl").open()]
    return ([r["loss"] for r in rows if r["stage"] == 1.0],
            [r["loss_rgb"] for r in rows if r["stage"] == 2.0], rows)


# A pure strain rate (1/s, symmetric) added to the stage-1 velocity in
# app_value_and_grad: the CLI's cut run stays rest-shaped (F = I up to
# rounding, where a no-bias material with normalized input has zero
# gradient), so without it the LoRA gradients would be rounding only.
APP_STRAIN_RATE = torch.tensor([[2.0, 1.0, 0.0], [1.0, -1.0, 0.5], [0.0, 0.5, -1.0]])


def app_value_and_grad(cfg, data_root: Path, init_v, lora) -> dict:
    """One value-and-grad of the CLI's stage-2 loss (``finetune.stage_scene``
    from ``data_root``, the LoRA leaves ``lora`` overlaid, every frame
    weighted 1) on the card and on the CPU, from the per-particle velocity
    ``init_v + APP_STRAIN_RATE (x - mean x)``: the loss's relative gap and
    each gradient leaf's scaled error ([d init_v] + the LoRA leaves)."""
    from neuma_tpu_torch.apps import common, finetune
    from neuma_tpu_torch.data.readers import VideoDataset

    out, v0 = {}, None
    for device in ("cuda", "cpu"):
        e, p = common.build_materials(cfg)
        scene, gt, _ = finetune.stage_scene(cfg, data_root, VideoDataset(cfg.video_data.to_dict()),
                                            e, p, "constitution", device)
        common.overlay_lora(scene.elasticity, lora["elasticity"])
        common.overlay_lora(scene.plasticity, lora["plasticity"])
        _, n_e = lora_params(scene)
        if v0 is None:
            x = scene.init_x.cpu()
            v0 = init_v.reshape(1, 3) + (x - x.mean(0)) @ APP_STRAIN_RATE.T
        loss, _, grads = value_and_grad_fn(scene, device)(
            v0.to(device), torch.ones(gt.shape[0], device=device), gt)
        out[device] = (float(loss), [g.cpu() for g in grads], grad_norms(grads, n_e))
    (l_gpu, g_gpu, norms), (l_cpu, g_cpu, _) = out["cuda"], out["cpu"]
    errs = [scaled_err(a, b) for a, b in zip(g_gpu, g_cpu)]
    return dict(loss_card=l_gpu, loss_cpu=l_cpu, loss_rel_gap=abs(l_gpu - l_cpu) / abs(l_cpu),
                grad_errs=errs, grad_norms_card=norms)


def app_card_vs_cpu(root: Path) -> dict:
    """The small copy of the app config: the CLI on the card (its data
    prepared on the card), the same preparation on the CPU into another
    folder (particles.ply bitwise, bindings.npz weights equal and indices
    equal where the weight is above 0), and the CLI on the CPU from the
    card's prepared folder. Returns both runs' per-epoch losses and the
    largest relative gap, the stage-1 init_v's scaled gap, and
    ``app_value_and_grad`` at the card run's end state."""
    from neuma_tpu_torch.apps import common, finetune
    from neuma_tpu_torch.data.ply import load_ply_points
    from neuma_tpu_torch.utils.config import load_config

    root.mkdir(parents=True, exist_ok=True)
    fabricate_app_scene(root, n_gaussians=300, size=64, n_steps=5, seed=1)
    cfg_path = app_config(root, "small", APP_SMALL)
    finetune.main(["-c", str(cfg_path)])
    common.run_data_preparation(load_config(cfg_path), root / "sim_data_cpu", device="cpu")
    finetune.main(["-c", str(cfg_path), "--set", "name=small_cpu"], device="cpu")
    card, cpu = (_stage_losses(root / "logs" / n)[:2] for n in ("small", "small_cpu"))
    gaps = [abs(a - b) / abs(b) for xs, ys in zip(card, cpu) for a, b in zip(xs, ys)]
    a, b = (np.load(root / d / "bindings.npz") for d in ("sim_data", "sim_data_cpu"))
    live = b["weights"] > 0
    tunes = [root / "logs" / n / "finetune" for n in ("small", "small_cpu")]
    init_v = [torch.as_tensor(np.load(t / "init.npz")["init_v"]) for t in tunes]
    # The LoRA files themselves are not compared: at this depth the stage-2
    # gradient is rounding-level (the scene stays rest-shaped), so their B
    # leaves differ by rounding; the value-and-grad below holds the LoRA
    # gradient instead.
    lora_card, _ = common.load_latest_lora(tunes[0])
    return dict(
        init_v_card=init_v[0].tolist(), init_v_cpu=init_v[1].tolist(),
        init_v_err=scaled_err(*init_v),
        value_and_grad=app_value_and_grad(load_config(cfg_path), root / "sim_data", init_v[0],
                                          lora_card),
        card=card, cpu=cpu, max_rel_gap=max(gaps), n_losses=len(gaps),
        particles_bitwise=(root / "sim_data" / "particles.ply").read_bytes()
        == (root / "sim_data_cpu" / "particles.ply").read_bytes(),
        bindings_equal=bool(np.array_equal(a["weights"], b["weights"])
                            and np.array_equal(a["indices"][live], b["indices"][live])),
        n_kernels=len(np.load(root / "sim_data" / "n_particles.npy")),
        n_particles=len(load_ply_points(root / "sim_data" / "particles.ply")),
    )


def app_phase(report, rec) -> bool:
    """Phase 13: the training CLI end to end on the card (see the module
    docstring)."""
    import shutil

    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.apps import common, finetune
    from neuma_tpu_torch.data import sampling
    from neuma_tpu_torch.data.ply import load_ply_points
    from neuma_tpu_torch.data.readers import VideoDataset
    from neuma_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    root = REPO / "build" / "chip_smoke_app"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for k, v in APP_CUTS.items():
        log(f"[app] cut: {k}: {v}")
    t0 = time.perf_counter()
    fabricate_app_scene(root, n_gaussians=10000, size=800, n_steps=5)
    fab_s = time.perf_counter() - t0
    cfg_path = app_config(root, "bb")
    cfg = load_config(cfg_path)
    t0 = time.perf_counter()
    common.run_data_preparation(cfg, root / "sim_data", device="cuda")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    route = sampling.last_volumetric_route
    n_particles = len(load_ply_points(root / "sim_data" / "particles.ply"))

    kernels.reset_launches()
    t0 = time.time()
    result = finetune.main(["-c", str(cfg_path)])
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches = dict(kernels.launches)
    exp = root / "logs" / "bb"
    v_losses, c_losses, rows = _stage_losses(exp)
    end_1 = max(r["time"] for r in rows if r["stage"] == 1.0)
    stage1_s = end_1 - t0
    stage2_s = max(r["time"] for r in rows if r["stage"] == 2.0) - end_1
    tune = exp / "finetune"
    files = ["init.npz", "0001_lora.npz", "0002_lora.npz", "train_state.npz"]
    missing = [f for f in files if not (tune / f).is_file()]
    finite = all(np.isfinite(v_losses + c_losses + result.losses))
    log(f"[app] {n_particles} particles, {cfg.gaussian.max_particles} per kernel; fabricate "
        f"{fab_s:.1f} s, prep {prep_s:.2f} s (volumetric res 32 by the {route} sampler + "
        f"two-pass binding on the card), "
        f"stage 1 {stage1_s:.2f} s (dataset read, scene, 2 epochs x 4 frames), stage 2 "
        f"{stage2_s:.2f} s (2 epochs x 4 frames), whole CLI {main_s:.2f} s")
    log(f"[app] losses stage 1 {v_losses} stage 2 {c_losses}; launches {launches}; "
        f"missing artifacts {missing}")

    # every kernel against its plain version at the CLI's own shapes (the
    # stage-2 scene the CLI trained on; random state and cotangents)
    e, p = common.build_materials(cfg)
    scene, _, _ = finetune.stage_scene(cfg, root / "sim_data", VideoDataset(cfg.video_data.to_dict()),
                                       e, p, "constitution", "cuda")
    checks_ok = check_and_time("app", kernel_inputs(scene, torch.Generator().manual_seed(0)), rec)
    del scene

    t0 = time.perf_counter()
    resumed = finetune.main(["-c", str(cfg_path), "--set", "resume=true",
                             "constitution.num_epochs=3"])
    resume_s = time.perf_counter() - t0
    text = (exp / "log.txt").read_text()
    steps_2 = [r["step"] for r in _stage_losses(exp)[2] if r["stage"] == 2.0]
    resumed_ok = ("Resuming full train state" in text and len(resumed.losses) == 1
                  and bool(np.isfinite(resumed.losses[0])) and steps_2 == [1, 2, 3])
    log(f"[app] resume=true, num_epochs 3: full train state restored "
        f"{'Resuming full train state' in text}, stage-2 steps {steps_2}, epoch 3 loss "
        f"{resumed.losses}; {resume_s:.2f} s")

    t0 = time.perf_counter()
    small = app_card_vs_cpu(root / "small")
    small_s = time.perf_counter() - t0
    log(f"[app:small] 64x64 view, uniform res 10, (16, 16), r 4, num_grids 32: "
        f"{small['n_kernels']} kernels, {small['n_particles']} particles; losses card {small['card']} cpu {small['cpu']}; "
        f"max rel gap {small['max_rel_gap']:.2e} over {small['n_losses']} epochs (bound 1e-4); "
        f"particles.ply bitwise {small['particles_bitwise']}, bindings.npz equal "
        f"{small['bindings_equal']}; {small_s:.1f} s")
    vg = small["value_and_grad"]
    log(f"[app:small] stage-1 init_v card {small['init_v_card']} cpu {small['init_v_cpu']}: "
        f"scaled gap {small['init_v_err']:.2e} (bound {GRAD_TOL:.0e})")
    log(f"[app:small] value-and-grad at the card run's end state: loss card {vg['loss_card']:.9f} "
        f"cpu {vg['loss_cpu']:.9f} rel gap {vg['loss_rel_gap']:.2e} (bound 1e-4); gradient scaled "
        f"error per leaf {[f'{x:.2e}' for x in vg['grad_errs']]} (bound {GRAD_TOL:.0e}); card "
        f"grad norms {vg['grad_norms_card']}")
    phase_s = time.perf_counter() - t_phase
    log(f"[app] phase {phase_s:.1f} s")
    report["app"] = dict(
        cuts=APP_CUTS, n_particles=n_particles, fabricate_s=fab_s, prep_s=prep_s,
        stage1_s=stage1_s, stage2_s=stage2_s, cli_s=main_s, resume_s=resume_s, small_s=small_s,
        seconds=phase_s, losses_stage1=v_losses, losses_stage2=c_losses, launches=launches,
        resumed_loss=resumed.losses, small=small, volumetric_route=route)
    ok = (checks_ok and route == "native" and finite and not missing
          and all(launches.get(k, 0) > 0 for k in KERNELS)
          and len(v_losses) == len(c_losses) == 2 and resumed_ok
          and small["max_rel_gap"] <= 1e-4 and small["particles_bitwise"]
          and small["bindings_equal"] and small["init_v_err"] <= GRAD_TOL
          and small["value_and_grad"]["loss_rel_gap"] <= 1e-4
          and max(small["value_and_grad"]["grad_errs"]) <= GRAD_TOL)
    if not ok:
        log("[app] FAILED")
    return ok


SERVE_CONFIG = REPO / "configs" / "demo" / "multiobj-bb-cc.yaml"
SERVE_STEPS = 20
# The serving phase's cuts: depth and data only (the widths stay).
SERVE_CUTS = {
    "eval_steps": f"{SERVE_STEPS} per CLI (their default is 600)",
    "data": "fabricated scenes: render on phase 13's BouncyBall-like scene and its trained "
            "init.npz and last LoRA file; inference on two BouncyBall-like objects (an icosphere "
            "mesh, 10,000 Gaussians each) prepared by the port's data/prepare.py at "
            "finetune-bb.yaml's sampling (volumetric, resolution 32) inside the config's "
            "sim_bounds, and one 800x800 view e_2 of 2 eval_dynamic frames on white",
    "pretrained_ckpt": "reference-form .pt files of random weights from seed 42 "
                       "(jelly_0300.pt and plasticine_0300.pt are not in the repo)",
    "load_lora": "object 1 takes phase 13's last *_lora.npz, object 2 none (the config's "
                 "1000-epoch LoRA files are not in the repo)",
}
# The card-vs-CPU copies: small enough for the CPU, still on the slab grid.
SERVE_SMALL = dict(size=64, n_gaussians=300, mode="uniform", resolution=10, widths=(16, 16),
                   r=4, num_grids=32)
KERNELS_SERVED = ("p2g", "g2p", "composite")  # the serving path's kernels (K1, K2, K4)


def reference_state_dict(rng, widths):
    """A reference-form InvariantFullMeta state dict (``layers.{i}.fc.weight``
    (out, in), ``final_layer.fc.weight``; no bias, no norm), Xavier-uniform."""
    sd, w_in = {}, 13
    names = [f"layers.{i}.fc" for i in range(len(widths))] + ["final_layer.fc"]
    for name, w_out in zip(names, list(widths) + [9]):
        bound = np.sqrt(6.0 / (w_in + w_out))
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.uniform(-bound, bound, (w_out, w_in)).astype(np.float32))
        w_in = w_out
    return sd


def random_lora_file(path: Path, base_pt: Path, widths, r: int, alpha: float, seed: int):
    """A LoRA ``.npz`` holding every LoRA leaf (nonzero B) for the base
    weights of ``base_pt``."""
    from neuma_tpu_torch.data.torch_ckpt import load_base_model, save_params_npz
    from neuma_tpu_torch.materials import InvariantFullMetaElasticity, MetaMaterialConfig
    from neuma_tpu_torch.nn.mlp import lora_params

    gen = torch.Generator().manual_seed(seed)
    cfg = MetaMaterialConfig(layer_widths=tuple(widths))
    out = {}
    for key, tree in zip(("elasticity", "plasticity"), load_base_model(base_pt, len(widths))):
        m = InvariantFullMetaElasticity(cfg, tree)
        m.init_lora(gen, r=r, alpha=alpha)
        with torch.no_grad():
            for layer in list(m.mlp.layers) + [m.mlp.final]:
                layer.lora_b.copy_(0.2 * torch.randn(layer.lora_b.shape, generator=gen))
        out[key] = lora_params(m.params())
    save_params_npz(path, out)


def serve_config(root: Path, small: bool, lora: Path = None, device="cuda") -> Path:
    """multiobj-bb-cc.yaml with both objects fabricated under ``root``
    (prepared on the card), reference-form base files, object 1's LoRA
    (``lora``, or a random one for the small copy) and the fabricated
    ``e_2`` view; the small copy also takes ``SERVE_SMALL``'s cuts."""
    from neuma_tpu_torch.data.prepare import prepare_simulation_data
    from neuma_tpu_torch.utils.config import load_config

    sc = SERVE_SMALL
    cfg = load_config(SERVE_CONFIG, [f"root={root / 'out'}",
                                     f"video_data.data.path={root / 'dataset'}"]
                      + ([f"sim.num_grids={sc['num_grids']}"] if small else []))
    wrng = np.random.default_rng(42)
    for i, obj in enumerate(cfg.objects):
        obj_root = root / f"obj{i}"
        fabricate_ball(obj_root, sc["n_gaussians"] if small else 10000, seed=10 + i, device=device)
        prepare_simulation_data(
            save_dir=obj_root / "assets", kernels_path=obj_root / "kernels.ply",
            mesh_path=obj_root / "mesh.obj",
            mesh_sample_mode=sc["mode"] if small else "volumetric",
            mesh_sample_resolution=sc["resolution"] if small else 32,
            particles_downsample_factor=1,  # as run_data_preparation takes a mesh
            sh_degree=int(obj.gaussian.sh_degree), opacity_thres=float(obj.gaussian.opacity_thres),
            confidence=float(obj.gaussian.confidence),
            max_particles=int(obj.gaussian.max_particles), device=device)
        con = obj.constitution
        if small:
            con.elasticity.layer_widths = list(sc["widths"])
            con.plasticity.layer_widths = list(sc["widths"])
            con.lora.r = sc["r"]
        widths = list(con.elasticity.layer_widths)
        torch.save({"elasticity": reference_state_dict(wrng, widths),
                    "plasticity": reference_state_dict(wrng, widths)}, obj_root / "base.pt")
        obj.data_root = str(obj_root / "assets")
        obj.pretrained_ckpt = str(obj_root / "base.pt")
        obj.constitution.load_lora = None
    if small:
        lora = root / "obj0" / "lora.npz"
        random_lora_file(lora, root / "obj0" / "base.pt", sc["widths"], sc["r"],
                         float(cfg.objects[0].constitution.lora.alpha), seed=7)
    cfg.objects[0].constitution.load_lora = str(lora)
    # the view looks at both objects in the sim box (x, z = 0.5; y 0.23-0.92)
    fabricate_views(root / "dataset", sc["size"] if small else 800, 2,
                    np.array([0.5, 0.55, 0.5]), (0.0, 0.1, -1.5), view="e_2",
                    subfolder="eval_dynamic")
    path = root / "multiobj.yaml"
    cfg.save(path)
    return path


def _ms(values):
    """Median of the per-step host times after the first (warm-up) step."""
    return statistics.median(values[1:]) if len(values) > 1 else values[0]


def _png_gap(dir_a: Path, dir_b: Path, pattern: str):
    """(names equal, number of frames, largest |a - b| of any pixel in
    uint8 units)."""
    from PIL import Image

    names = sorted(p.name for p in dir_a.glob(pattern))
    same = bool(names) and names == sorted(p.name for p in dir_b.glob(pattern))
    worst = 0
    for n in names if same else []:
        a = np.asarray(Image.open(dir_a / n), np.int16)
        b = np.asarray(Image.open(dir_b / n), np.int16)
        worst = max(worst, int(np.abs(a - b).max()))
    return same, len(names), worst


def _ply_gap(dir_a: Path, dir_b: Path):
    """(names equal, number of files, largest scaled error of any step's
    positions)."""
    from neuma_tpu_torch.data.ply import load_ply_points

    names = sorted(p.name for p in dir_a.glob("*.ply"))
    same = bool(names) and names == sorted(p.name for p in dir_b.glob("*.ply"))
    worst = 0.0
    for n in names if same else []:
        a, b = (torch.as_tensor(load_ply_points(d / n)) for d in (dir_a, dir_b))
        worst = max(worst, scaled_err(a, b))
    return same, len(names), worst


def _bytes_equal(dir_a: Path, dir_b: Path, pattern: str) -> bool:
    names = sorted(p.name for p in dir_a.glob(pattern))
    return bool(names) and names == sorted(p.name for p in dir_b.glob(pattern)) and all(
        (dir_a / n).read_bytes() == (dir_b / n).read_bytes() for n in names)


def _launch_gate(launches, steps, views, frames_extra=0):
    """K1 and K2 once per step, K4 once per rendered view, K3 and K5 never."""
    want = {"p2g": steps, "g2p": steps, "composite": views * (steps + frames_extra),
            "g2p_derivs": 0, "composite_bwd": 0}
    return all(launches.get(k, 0) == v for k, v in want.items()), want


def serve_kernel_checks(scene, tag):
    """K1, K2 and K4 against their plain versions at a serving scene's own
    shapes (``kernel_inputs`` on a stand-in with the scene's constants,
    statics, positions, Gaussians and first camera), at phase 2's bounds."""
    from types import SimpleNamespace

    from neuma_tpu_torch.render import raster_kernel as rk
    from neuma_tpu_torch.render.gaussians import GaussianPack
    from neuma_tpu_torch.sim import p2g_kernel as pk

    stand_in = SimpleNamespace(
        constants=scene.constants, statics=scene.statics, init_x=scene.state0.x,
        gaussians=GaussianPack.concatenate(scene.packs), cameras=list(scene.cameras.values()),
        scaling_modifier=1.0, force_mask_data=False, raster_cfg=scene.raster_cfg)
    inp = kernel_inputs(stand_in, torch.Generator().manual_seed(0))
    e1 = scaled_err(pk.run_p2g_fwd(inp["payload"], inp["c2b"], inp["NB"]),
                    pk.run_p2g_fwd_plain(inp["payload"], inp["c2b"], inp["NB"]))
    args = (inp["payload_g"], inp["slabs"], inp["c2b_g"], inp["inv_dx"])
    e2 = scaled_err(pk.run_apic_gather(*args), pk.run_apic_gather_plain(*args))
    args = (inp["pf"], inp["tile_start"], inp["counts"], inp["tiles_x"])
    (Tk, Ck, lk), (Tp, Cp, lp) = rk.composite_fwd(*args), rk.composite_fwd_plain(*args)
    e4 = max(float((Tk - Tp).abs().max()), float((Ck - Cp).abs().max()))
    mism = int((lk != lp).sum())
    ok = e1 <= K12_TOL and e2 <= K12_TOL and e4 <= K4_TOL and mism == 0
    log(f"[serve:{tag}] kernels at the CLI's shapes ({scene.state0.x.shape[0]} particles, "
        f"{scene.constants.num_grids}^3, {int(inp['counts'].sum())} live pairs of "
        f"{inp['max_pairs']}): p2g {e1:.3e}, g2p {e2:.3e} (bound {K12_TOL:.0e}), "
        f"composite {e4:.3e} (bound {K4_TOL:.0e}), last mismatches {mism}")
    return ok, dict(p2g=e1, g2p=e2, composite=e4, last_mismatch=mism,
                    n_particles=int(scene.state0.x.shape[0]), pairs=int(inp["counts"].sum()))


def rollout_vs_step_loop(scene, frames: int = 4) -> bool:
    """``sim.rollout.rollout`` (one block sort carried and refreshed) for
    ``frames`` frames against a Python loop of ``make_step_fn`` steps
    (layouts built per step), on the card: bitwise equal states."""
    from neuma_tpu_torch.core.types import ParticleState
    from neuma_tpu_torch.sim.rollout import make_step_fn, rollout

    c = scene.constants
    step = make_step_fn(c, scene.statics, scene.elasticity, scene.plasticity)
    n = scene.init_x.shape[0]
    v0 = torch.tensor([0.3, 0.0, 0.0], device=scene.init_x.device).expand(n, 3).contiguous()
    s0 = ParticleState.initial(scene.init_x, v0)
    with torch.no_grad():
        final, traj = rollout(step, s0, frames, substeps=scene.substeps, constants=c)
        loop, same = s0, True
        for f in range(frames):
            for _ in range(scene.substeps):
                loop = step(loop)
            same &= all(torch.equal(getattr(traj, k)[f], getattr(loop, k)) for k in "xvCF")
    same &= all(torch.equal(getattr(final, k), getattr(loop, k)) for k in "xvCF")
    return bool(same)


def serve_render_card_vs_cpu(app_root: Path) -> dict:
    """The render CLI on phase 13's small copy (its card run's init.npz and
    last LoRA file) on the card and on the CPU: the PNG gap and every
    step's positions."""
    from neuma_tpu_torch.apps import render

    cfg = app_root / "small" / "small.yaml"
    tune = app_root / "small" / "logs" / "small" / "finetune"
    lora = sorted(tune.glob("*_lora.npz"))[-1]
    results = app_root / "small" / "logs" / "small" / "results"
    for name, device in (("card", None), ("cpu", "cpu")):
        render.main(["-c", str(cfg), "-s", str(SERVE_STEPS), "-vn", name, "-dv", "d_2",
                     "-sp", f"particles_{name}", "-l", str(lora)], device=device)
    png = _png_gap(results / "card", results / "cpu", "*.png")
    ply = _ply_gap(results / "particles_card", results / "particles_cpu")
    return dict(png_names_equal=png[0], n_png=png[1], png_gap=png[2], ply_names_equal=ply[0],
                n_ply=ply[1], ply_err=ply[2])


def serve_inference_card_vs_cpu(root: Path) -> dict:
    """The inference CLI on a small copy of multiobj-bb-cc.yaml
    (``SERVE_SMALL``, prepared on the card) on the card and on the CPU."""
    from neuma_tpu_torch.apps import inference

    cfg = serve_config(root, small=True)
    args = ["-c", str(cfg), "-s", str(SERVE_STEPS), "-dv", "e_2", "-sp", "particles"]
    inference.main(args + ["-vn", "card"])
    inference.main(args + ["-vn", "cpu"], device="cpu")
    out = root / "out"
    png = _png_gap(out / "card" / "images", out / "cpu" / "images", "*.png")
    ply = _ply_gap(out / "card" / "particles", out / "cpu" / "particles")
    from neuma_tpu_torch.data.ply import load_ply_points

    return dict(png_names_equal=png[0], n_png=png[1], png_gap=png[2], ply_names_equal=ply[0],
                n_ply=ply[1], ply_err=ply[2],
                n_particles=len(load_ply_points(out / "card" / "particles" / "001.ply")))


def serve_phase(report, scenes) -> bool:
    """Phase 14: the serving CLIs end to end on the card (see the module
    docstring)."""
    import importlib.util
    import shutil

    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.apps import inference, render
    from neuma_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    app_root = REPO / "build" / "chip_smoke_app"
    root = REPO / "build" / "chip_smoke_serve"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for k, v in SERVE_CUTS.items():
        log(f"[serve] cut: {k}: {v}")
    imageio = importlib.util.find_spec("imageio") is not None
    log(f"[serve] {nvidia_smi()}; imageio installed: {imageio}")
    n = SERVE_STEPS

    # (a) the render CLI on phase 13's outputs
    lora = sorted((app_root / "logs" / "bb" / "finetune").glob("*_lora.npz"))[-1]
    kernels.reset_launches()
    t0 = time.perf_counter()
    res_r = render.main(["-c", str(app_root / "bb.yaml"), "-s", str(n), "-vn", "serve",
                         "-dv", "d_2", "-sp", "particles", "-l", str(lora)])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches_r = dict(kernels.launches)
    gate_r, want_r = _launch_gate(launches_r, n, 1)
    out_r = app_root / "logs" / "bb" / "results"
    files_r = (len(list((out_r / "serve").glob("d_2_*.png"))) == n
               and len(list((out_r / "particles").glob("particles_*.ply"))) == n
               and len(res_r.videos) == 1 and res_r.videos[0] is not None
               and res_r.videos[0].is_file())
    log(f"[serve:render] finetune-bb.yaml, {n} steps, one 800x800 view d_2, LoRA {lora.name}: "
        f"sim {_ms(res_r.sim_ms):.2f} ms/step, render d_2 {_ms(res_r.render_ms['d_2']):.2f} "
        f"ms/view (host clock, median after step 1); CLI {render_s:.2f} s; launches "
        f"{launches_r} (want {want_r}); frames, PLYs and {res_r.videos[0].name if res_r.videos[0] else None} "
        f"written {files_r}; overflow {res_r.overflow}")

    # (b) the inference CLI on multiobj-bb-cc.yaml at its widths
    t0 = time.perf_counter()
    cfg_path = serve_config(root / "full", small=False, lora=lora)
    prep_s = time.perf_counter() - t0
    args = ["-c", str(cfg_path), "-s", str(n), "-dv", "e_2", "-sp", "particles"]
    runs, cli_s, launches_i = [], [], None
    for name in ("a", "b"):
        kernels.reset_launches()
        t0 = time.perf_counter()
        runs.append(inference.main(args + ["-vn", name]))
        torch.cuda.synchronize()
        cli_s.append(time.perf_counter() - t0)
        launches_i = launches_i or dict(kernels.launches)
    res_i = runs[0]
    gate_i, want_i = _launch_gate(launches_i, n, 1, frames_extra=1)
    out_i = root / "full" / "out"
    files_i = (len(list((out_i / "a" / "images").glob("e_2_*.png"))) == n + 1
               and len(list((out_i / "a" / "particles").glob("*.ply"))) == n
               and res_i.videos[0] is not None and res_i.videos[0].is_file())
    bitwise_i = (_bytes_equal(out_i / "a" / "images", out_i / "b" / "images", "*.png")
                 and _bytes_equal(out_i / "a" / "particles", out_i / "b" / "particles", "*.ply"))
    scene_i = inference.load_scene(load_config(cfg_path), n, ["e_2"], "cuda")
    checks_ok, checks = serve_kernel_checks(scene_i, "inference")
    log(f"[serve:inference] multiobj-bb-cc.yaml, 2 objects, {checks['n_particles']} particles, "
        f"{scene_i.constants.num_grids}^3, one 800x800 view e_2, {n} steps: sim "
        f"{_ms(res_i.sim_ms):.2f} ms/step, render e_2 {_ms(res_i.render_ms['e_2']):.2f} ms/view "
        f"(host clock, median after step 1); prep {prep_s:.2f} s, CLI {cli_s[0]:.2f} / "
        f"{cli_s[1]:.2f} s; launches {launches_i} (want {want_i}); frames, PLYs and "
        f"{res_i.videos[0].name if res_i.videos[0] else None} written {files_i}; second run "
        f"byte-equal PNGs and PLYs {bitwise_i}; overflow {res_i.overflow}")
    del scene_i

    # (c) small copies on the card and the CPU
    t0 = time.perf_counter()
    small_r = serve_render_card_vs_cpu(app_root)
    small_i = serve_inference_card_vs_cpu(root / "small")
    small_s = time.perf_counter() - t0
    for tag, sm in (("render", small_r), ("inference", small_i)):
        log(f"[serve:small] {tag}: {sm['n_png']} PNGs, largest pixel gap card vs CPU "
            f"{sm['png_gap']} (bound 1), {sm['n_ply']} PLYs, positions scaled error "
            f"{sm['ply_err']:.2e} (bound 1e-5)")
    log(f"[serve:small] inference copy: 64x64, uniform res 10, (16, 16), r 4, num_grids 32, "
        f"{small_i['n_particles']} particles; both copies {small_s:.1f} s")

    # (d) rollout vs the step loop at the headline shape
    t0 = time.perf_counter()
    roll_ok = rollout_vs_step_loop(scenes["headline"], 4)
    log(f"[serve] sim.rollout.rollout, headline shape, 4 frames: bitwise equal to a loop of "
        f"make_step_fn steps {roll_ok} ({time.perf_counter() - t0:.2f} s)")
    phase_s = time.perf_counter() - t_phase
    log(f"[serve] phase {phase_s:.1f} s")
    report["serve"] = dict(
        cuts=SERVE_CUTS, imageio=imageio, seconds=phase_s,
        render=dict(sim_ms=res_r.sim_ms, render_ms=res_r.render_ms, cli_s=render_s,
                    launches=launches_r, video=str(res_r.videos[0])),
        inference=dict(sim_ms=res_i.sim_ms, render_ms=res_i.render_ms, prep_s=prep_s,
                       cli_s=cli_s, launches=launches_i,
                       video=str(res_i.videos[0]), checks=checks, bitwise=bitwise_i),
        small_render=small_r, small_inference=small_i, rollout_bitwise=roll_ok)
    ok = (gate_r and files_r and gate_i and files_i and bitwise_i and checks_ok and roll_ok
          and all(sm["png_names_equal"] and sm["ply_names_equal"] and sm["png_gap"] <= 1
                  and sm["ply_err"] <= 1e-5 for sm in (small_r, small_i)))
    if not ok:
        log("[serve] FAILED")
    return ok


REGIST_CONFIG = REPO / "configs" / "realworld" / "regist-bun.yaml"
REGIST_ITERS = 200
REGIST_LOG_EVERY = 20
# The registration phase's cuts of regist-bun.yaml: depth and data only
# (SH 0, three 1920x1080 views, max_pairs, the INIT pose, the learning
# rates, the schedule's alpha and volumetric sampling at 36 stay).
REGIST_CUTS = {
    "iterations": f"{REGIST_ITERS} (the config runs 20,000), register.scheduler.max_steps "
                  f"{REGIST_ITERS} to match; the loss read every {REGIST_LOG_EVERY} "
                  "(register.log_every)",
    "capture": "2 steps per view (r_0-r_2, init frame 0 is the one registered)",
    "data": "fabricated: 30,000 SH-0 Gaussians in a ball and an icosphere mesh around it (raw "
            "frame, radius 2), first frames rendered by the port at a Sim(3) 1 deg, 5 mm and "
            "1 % of scale from the config's INIT, full masks, black background",
}
REGIST_TRUE_OFFSET = dict(r_deg=(0.6, -0.6, 0.5), t=(0.003, -0.003, 0.0025), s=1.01)
REGIST_VIEWS = ("r_0", "r_1", "r_2")
EVAL_TOL = dict(psnr=1e-5, ssim=1e-5, lpips=1e-4)  # per-frame rtol, card vs CPU


def fabricate_raw_gaussians(root: Path, n: int, center, radius: float, seed: int):
    """``n`` SH-0 Gaussians filling a ball (the raw 3DGS frame) with random
    colours, anisotropic extents near 1 % of the radius, random rotations
    and opacity 0.6 (``kernels.ply``), and the ball's icosphere
    (``mesh.obj``)."""
    from neuma_tpu_torch.data.mesh import TriMesh, make_icosphere
    from neuma_tpu_torch.ops.sh import rgb_to_sh
    from neuma_tpu_torch.render.gaussians import GaussianPack

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    ico = make_icosphere(radius=radius, subdivisions=3)
    TriMesh(vertices=ico.vertices + center, faces=ico.faces).export_obj(root / "mesh.obj")
    d = rng.standard_normal((n, 3))
    d *= (radius * rng.random((n, 1)) ** (1 / 3)) / np.linalg.norm(d, axis=1, keepdims=True)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    pack = GaussianPack(
        xyz=f32(center + d),
        features_dc=rgb_to_sh(f32(rng.random((n, 3))))[:, None, :],
        features_rest=torch.zeros((n, 0, 3)),
        scaling=f32(np.log(radius * 0.015 * rng.uniform(0.7, 1.3, (n, 3)))),
        rotation=f32(rng.standard_normal((n, 4))),
        opacity=torch.full((n, 1), float(np.log(0.6 / 0.4))),
        sh_degree=0,
    )
    pack.to_ply(root / "kernels.ply")
    return pack


def write_capture_metadata(root: Path, target, views, width: int, height: int,
                           fov: float = 0.9, dist: float = 1.4):
    """A RealCapture folder's cameras: COLMAP ``sparse/0/cameras.bin``
    (PINHOLE at the 4752x2672 capture scale, focals chosen so the
    reader's rescale gives ``fov`` both ways) and ``cameras_calib.json``
    (Rodrigues extrinsics of cameras ``dist`` from ``target``)."""
    import struct

    from neuma_tpu_torch.render.camera import fov2focal

    (root / "sparse" / "0").mkdir(parents=True)
    (root / "dynamics").mkdir()
    (root / "dynamic_masks").mkdir()
    with open(root / "sparse" / "0" / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 4752, 2672))  # camera 1, PINHOLE
        f.write(struct.pack("<4d", fov2focal(fov, height) * 4752 / width,
                            fov2focal(fov, width) * 2672 / height, 4752 / 2, 2672 / 2))
    calib = {}
    for vi, view in enumerate(views):
        eye = target + np.array([dist * np.cos(0.8 * vi), 0.4, dist * np.sin(0.8 * vi)])
        fwd = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        R_wc = np.stack([right, np.cross(fwd, right), fwd])  # x right, y down, z forward
        theta = np.arccos(np.clip((np.trace(R_wc) - 1) / 2, -1.0, 1.0))
        axis = np.array([R_wc[2, 1] - R_wc[1, 2], R_wc[0, 2] - R_wc[2, 0],
                         R_wc[1, 0] - R_wc[0, 1]]) / (2 * np.sin(theta))
        calib[view] = {"rvecs": (axis * theta).tolist(), "tvecs": (-R_wc @ eye).tolist()}
    (root / "cameras_calib.json").write_text(json.dumps(calib))


def write_capture_frames(root: Path, cfg, moved, raster_cfg, n_steps: int):
    """Each view's frames (``dynamics/{view}_{step}.jpg``, the render of
    ``moved`` on black through the reader's own cameras) and full masks.
    Returns the cameras."""
    from PIL import Image

    from neuma_tpu_torch.apps.common import to_uint8
    from neuma_tpu_torch.data.readers import VideoDataset
    from neuma_tpu_torch.render.rasterize import rasterize

    w, h = 1920, 1080
    for view in REGIST_VIEWS:  # placeholders, so the reader builds the cameras
        Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(root / "dynamics" / f"{view}_0.jpg")
        Image.fromarray(np.full((h, w), 255, np.uint8)).save(
            root / "dynamic_masks" / f"{view}_0.png")
    dev = moved.xyz.device
    ds = VideoDataset(cfg.video_data.to_dict())
    cams = [ds.get(v, 0).camera.to(dev) for v in ds.views]
    with torch.no_grad():
        cov = moved.get_covariance()
        for view, cam in zip(ds.views, cams):
            img = to_uint8(rasterize(moved.xyz, cov, moved.get_opacity, cam,
                                     torch.zeros(3, device=dev), shs=moved.get_features,
                                     sh_degree=0, cfg=raster_cfg))
            for step in range(n_steps):
                Image.fromarray(img).save(root / "dynamics" / f"{view}_{step}.jpg", quality=95)
                Image.fromarray(np.full((h, w), 255, np.uint8)).save(
                    root / "dynamic_masks" / f"{view}_{step}.png")
    return cams


@torch.no_grad()
def pairs_needed(pack, cam) -> int:
    """(Gaussian, tile) pairs one view of ``pack`` needs."""
    from neuma_tpu_torch.render.rasterize import _project, _tile_ranges

    _, visible, mean2d, _, radius = _project(pack.xyz, pack.get_covariance(), cam)
    x0, y0, x1, y1, _, _ = _tile_ranges(mean2d, radius, cam.width, cam.height)
    return int(torch.where(visible & (radius > 0), (x1 - x0) * (y1 - y0), 0).sum())


@torch.no_grad()
def regist_kernel_inputs(pack, cam, raster_cfg, gen):
    """K4/K5 inputs of one registration view: ``pack``'s pair features
    (SH 0 colours) and random dT, dC, in ``check_composite``'s layout."""
    from neuma_tpu_torch.render.rasterize import _build_aligned_pairs, _project, _sh_colors

    depth, visible, mean2d, conic, radius = _project(pack.xyz, pack.get_covariance(), cam)
    colors = _sh_colors(pack.get_features, pack.xyz, cam.camera_center, 0)
    pair_gid, counts, tile_start, tiles_x, _, overflow = _build_aligned_pairs(
        depth, visible, mean2d, radius, cam.width, cam.height, raster_cfg)
    feats = torch.cat([mean2d, conic, pack.get_opacity.reshape(-1, 1), colors], 1)
    nt = counts.shape[0]
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(pack.xyz.device)
    return dict(pf=feats[pair_gid].contiguous(), tile_start=tile_start.to(torch.int32),
                counts=counts.to(torch.int32), tiles_x=tiles_x, raster_overflow=bool(overflow),
                pairs_needed=pairs_needed(pack, cam), max_pairs=raster_cfg.max_pairs,
                dT=0.1 * rnd(nt, 256), dC=0.1 * rnd(nt, 768))


def regist_small_copy() -> dict:
    """``tests/test_register.py``'s scene (150 SH-1 Gaussians, three 48x48
    views, GT rendered by the port on the CPU at a known Sim(3)) with
    lambda_dssim 0.2: 10 iterations twice on the card and once on the
    CPU (losses rtol 1e-4, params a scaled 1e-4; card runs bitwise)."""
    from neuma_tpu_torch.render.camera import Camera
    from neuma_tpu_torch.render.gaussians import create_from_points
    from neuma_tpu_torch.render.rasterize import RasterConfig, rasterize
    from neuma_tpu_torch.train import register as reg

    rng = np.random.default_rng(0)
    pts = (0.2 * rng.standard_normal((150, 3))).astype(np.float32)
    pack = create_from_points(pts, rng.random((150, 3)).astype(np.float32), sh_degree=1)
    true = reg.init_sim3_params(reg.RegisterConfig(init_r_deg=(8.0, -5.0, 4.0),
                                                   init_t=(0.06, -0.04, 0.05), init_s=1.15))
    cams = [Camera.look_at(eye=np.array(e), target=np.zeros(3), fov=0.9, width=48, height=48)
            for e in ([0, 0.1, -1.5], [-1.5, 0.1, 0.0], [0.9, 1.2, 0.9])]
    rcfg = RasterConfig(max_pairs=8192, max_per_tile=256)
    with torch.no_grad():
        moved = reg.apply_sim3(true, pack)
        gt = torch.stack([rasterize(moved.xyz, moved.get_covariance(), moved.get_opacity, c,
                                    torch.ones(3), shs=moved.get_features, sh_degree=1, cfg=rcfg)
                          for c in cams])
    fit = reg.RegisterConfig(iterations=10, lr_r=0.02, lr_t=0.02, lr_s=0.02,
                             learning_rate_alpha=0.05, lambda_dssim=0.2)
    runs = [reg.register_gaussians(pack, cams, gt, fit, torch.ones(3), raster_cfg=rcfg,
                                   log_every=1, device=d) for d in ("cuda", "cuda", "cpu")]
    (a, b, cpu) = runs
    gap = max(abs(x - y) / abs(y) for x, y in zip(a.losses, cpu.losses))
    perr = max(scaled_err(torch.as_tensor(a.params[k]), torch.as_tensor(cpu.params[k]))
               for k in ("r", "t", "s"))
    bitwise = a.losses == b.losses and all(np.array_equal(a.params[k], b.params[k])
                                           for k in ("r", "t", "s"))
    return dict(losses_card=a.losses, losses_cpu=cpu.losses, loss_rel_gap=gap, params_err=perr,
                bitwise=bitwise)


def _metrics_means(path: Path):
    """The means of a metrics.txt."""
    head = path.read_text().split("\nper-frame:\n")[0]
    return {k: float(v) for k, v in (line.split(": ") for line in head.strip().splitlines())}


def evaluate_phase_part(app_root: Path) -> dict:
    """(c): the evaluation CLI on phase 14's render-CLI frames against
    phase 13's ground truth (800x800, the default crop, ``--video``);
    ``evaluate_frames`` on the card and the CPU; ms per frame of each
    metric on the card (CUDA events, one cropped frame pair)."""
    from neuma_tpu_torch.apps import evaluate
    from neuma_tpu_torch.train.losses import psnr, ssim
    from neuma_tpu_torch.train.lpips import LPIPSMetric, lpips
    from neuma_tpu_torch.utils.video import _natsorted

    render_dir = app_root / "logs" / "bb" / "results" / "serve"
    gt_dir = app_root / "dataset" / "data_dynamic"
    out = REPO / "build" / "chip_smoke_eval"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    evaluate.main(["-r", str(render_dir), "-g", str(gt_dir), "--render_glob", "d_2_*.png",
                   "--gt_glob", "d_2_*.png", "--video", "-o", str(out / "metrics.txt")])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    means = _metrics_means(out / "metrics.txt")
    video = list(render_dir.glob("side_by_side.*"))
    rp = _natsorted(render_dir.glob("d_2_*.png"))
    gp = _natsorted(gt_dir.glob("d_2_*.png"))
    n = min(len(rp), len(gp))
    crop = [220, 580, 220, 580]
    rows = {}
    for dev in ("cuda", "cpu"):
        rows[dev] = evaluate.evaluate_frames(rp[:n], gp[:n], crop,
                                             evaluate._lpips_model(device=dev), device=dev)
    gaps = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                   for a, b in zip(rows["cuda"], rows["cpu"]))
            for k in rows["cpu"][0]}
    r = torch.as_tensor(evaluate._read_rgb(rp[0])[220:580, 220:580].transpose(2, 0, 1).copy()).cuda()
    g = torch.as_tensor(evaluate._read_rgb(gp[0])[220:580, 220:580].transpose(2, 0, 1).copy()).cuda()
    metric = LPIPSMetric(device="cuda")
    with torch.no_grad():
        ms = dict(psnr=cuda_ms(lambda: psnr(r, g), 20), ssim=cuda_ms(lambda: ssim(r, g), 20),
                  lpips=cuda_ms(lambda: lpips(r, g, metric.params), 5))
    return dict(means=means, frames=n, cli_s=cli_s, video=[str(v) for v in video],
                rows_card=rows["cuda"], rows_cpu=rows["cpu"], rel_gaps=gaps, ms_per_frame=ms)


def regist_phase(report, rec) -> bool:
    """Phase 15: the registration CLI at regist-bun.yaml's widths, its
    small copy card vs CPU, and the evaluation CLI (see the module
    docstring)."""
    import shutil

    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.apps import regist
    from neuma_tpu_torch.data.ply import load_ply_points
    from neuma_tpu_torch.data.readers import VideoDataset
    from neuma_tpu_torch.render.rasterize import RasterConfig
    from neuma_tpu_torch.train import register as reg
    from neuma_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    root = REPO / "build" / "chip_smoke_regist"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    log(f"REGIST_CUTS {json.dumps(REGIST_CUTS)}")

    # (a) the registration CLI
    t0 = time.perf_counter()
    capture = root / "capture"
    cfg_path = root / "regist.yaml"
    cfg = load_config(REGIST_CONFIG, [
        f"root={root / 'logs'}", "name=bun", f"gaussian.kernels_path={root / 'kernels.ply'}",
        f"particle_data.mesh_path={root / 'mesh.obj'}", f"video_data.data.path={capture}",
        f"register.iterations={REGIST_ITERS}", f"register.scheduler.max_steps={REGIST_ITERS}",
        f"register.log_every={REGIST_LOG_EVERY}"])
    cfg.save(cfg_path)
    raw = fabricate_raw_gaussians(root, 30000, np.array([0.3, -0.2, 0.5]), 2.0, seed=0).to("cuda")
    init = reg.RegisterConfig(init_r_deg=tuple(cfg.register.INIT_R),
                              init_t=tuple(cfg.register.INIT_T), init_s=float(cfg.register.INIT_S))
    off = REGIST_TRUE_OFFSET
    true = reg.RegisterConfig(
        init_r_deg=tuple(a + b for a, b in zip(init.init_r_deg, off["r_deg"])),
        init_t=tuple(a + b for a, b in zip(init.init_t, off["t"])), init_s=init.init_s * off["s"])
    with torch.no_grad():
        moved_true = reg.apply_sim3(reg.init_sim3_params(true, "cuda"), raw)
        moved_init = reg.apply_sim3(reg.init_sim3_params(init, "cuda"), raw)
    capture.mkdir()
    write_capture_metadata(capture, moved_true.xyz.mean(0).cpu().numpy().astype(np.float64),
                           REGIST_VIEWS, 1920, 1080)
    rcfg = RasterConfig(max_pairs=int(cfg.raster.max_pairs), max_per_tile=int(cfg.raster.max_per_tile))
    cams = write_capture_frames(capture, cfg, moved_true, rcfg, n_steps=2)
    fab_s = time.perf_counter() - t0
    pairs = {v: dict(init=pairs_needed(moved_init, c), true=pairs_needed(moved_true, c))
             for v, c in zip(REGIST_VIEWS, cams)}
    fits = all(p["init"] <= rcfg.max_pairs and p["true"] <= rcfg.max_pairs for p in pairs.values())
    log(f"[regist] 30,000 SH-0 Gaussians, 3 views 1920x1080, max_pairs {rcfg.max_pairs}: pairs "
        f"needed {json.dumps(pairs)}; fit {fits}; fabricate {fab_s:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    run = regist.main(["-c", str(cfg_path)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    exp = root / "logs" / "bun"
    files = ("registered_params.npz", "registered_kernels.ply", "registered_particles.ply")
    written = all((exp / f).is_file() for f in files)
    per_iter = [(t1 - t0_) / (i1 - i0) * 1e3 for t0_, t1, i0, i1 in
                zip(run.log_times, run.log_times[1:], run.log_iters, run.log_iters[1:])]
    ms_iter = statistics.median(per_iter) if per_iter else float("nan")
    finite = bool(run.losses) and all(np.isfinite(run.losses))
    descends = len(run.losses) >= 2 and run.losses[-1] < run.losses[0]
    want = {"composite": 3 * REGIST_ITERS, "composite_bwd": 3 * REGIST_ITERS,
            "p2g": 0, "g2p": 0, "g2p_derivs": 0}
    gate_launch = all(launches.get(k, 0) == v for k, v in want.items())
    n_particles = len(load_ply_points(exp / files[2])) if written else 0
    log(f"[regist] CLI {cli_s:.2f} s (stage A {run.stage_a_s:.2f} s, stage B "
        f"{run.stage_b_s:.2f} s, {n_particles} particles); {ms_iter:.2f} ms/iteration (host "
        f"clock between log points, each ending in the loss read; median after the first); "
        f"peak {peak_gib:.2f} GiB; losses {[round(x, 6) for x in run.losses]}; params "
        f"{ {k: v.tolist() for k, v in run.params.items()} }; launches {launches} (want {want}); "
        f"files written {written}")

    before = {f: (exp / f).read_bytes() for f in files} if written else {}
    kernels.reset_launches()
    rerun = regist.main(["-c", str(cfg_path)])
    relaunch = dict(kernels.launches)
    noop = (rerun.stage_a_s is None and rerun.stage_b_s is None and not relaunch.get("composite")
            and all((exp / f).read_bytes() == before.get(f) for f in files))
    log(f"[regist] second run: no-op {noop} (launches {relaunch})")

    # K4 and K5 at the registration's shapes (view r_0 at INIT)
    inp = regist_kernel_inputs(moved_init, cams[0], rcfg, torch.Generator().manual_seed(0))
    checks_ok = check_composite("regist", inp, rec)
    log_checks("regist", rec, ("composite", "composite_bwd"))
    # the device's share of 5 iterations at the CLI's scene and frames
    ds = VideoDataset(cfg.video_data.to_dict())
    gt = torch.as_tensor(np.stack([ds.get(v, 0).image for v in ds.views]))
    fit5 = dataclasses.replace(init, iterations=5, lr_r=float(cfg.register.lr_r),
                               lr_t=float(cfg.register.lr_t), lr_s=float(cfg.register.lr_s))
    prof = profile_step(lambda: reg.register_gaussians(raw, cams, gt, fit5, torch.zeros(3),
                                                       raster_cfg=rcfg, log_every=5), ())

    # (b) the small copy
    t0 = time.perf_counter()
    small = regist_small_copy()
    small_s = time.perf_counter() - t0
    log(f"[regist:small] 150 SH-1 Gaussians, 3 views 48x48, lambda_dssim 0.2, 10 iterations: "
        f"losses card {small['losses_card']} cpu {small['losses_cpu']}; rel gap "
        f"{small['loss_rel_gap']:.2e} (bound 1e-4), params scaled err {small['params_err']:.2e} "
        f"(bound 1e-4); two card runs bitwise {small['bitwise']}; {small_s:.1f} s")

    # (c) the evaluation CLI
    ev = evaluate_phase_part(REPO / "build" / "chip_smoke_app")
    eval_ok = (set(ev["means"]) == {"psnr", "ssim", "lpips_vgg_rand"}
               and all(np.isfinite(v) for v in ev["means"].values()) and bool(ev["video"])
               and ev["frames"] > 0
               and all(ev["rel_gaps"][k] <= EVAL_TOL["lpips" if k.startswith("lpips") else k]
                       for k in ev["rel_gaps"]))
    log(f"[eval] {ev['frames']} frames 800x800 (crop 220:580), means {ev['means']}, video "
        f"{ev['video']}; CLI {ev['cli_s']:.2f} s; per-frame rel gap card vs CPU "
        f"{ {k: f'{v:.2e}' for k, v in ev['rel_gaps'].items()} } (bounds {EVAL_TOL}); ms per "
        f"frame on the card {ev['ms_per_frame']}")

    phase_s = time.perf_counter() - t_phase
    log(f"[regist] phase {phase_s:.1f} s")
    report["regist"] = dict(
        cuts=REGIST_CUTS, pairs=pairs, fabricate_s=fab_s, cli_s=cli_s, stage_a_s=run.stage_a_s,
        stage_b_s=run.stage_b_s, ms_per_iteration=ms_iter, per_iteration_ms=per_iter,
        peak_gib=peak_gib, losses=run.losses, launches=launches, rerun_noop=noop, profile=prof,
        n_particles=n_particles, small=small, small_s=small_s, evaluate=ev, seconds=phase_s)
    ok = (fits and written and finite and descends and gate_launch and noop and checks_ok
          and small["loss_rel_gap"] <= 1e-4 and small["params_err"] <= 1e-4 and small["bitwise"]
          and eval_ok)
    if not ok:
        log("[regist] FAILED")
    return ok


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
    # 12. the dense-grid step
    ok_dense = ok and dense_phase(report, init_v)
    # 13. the training CLI
    ok_app = ok_dense and app_phase(report, rec)
    # 14. the serving CLIs
    ok_serve = ok_app and serve_phase(report, scenes)
    # 15. the registration and evaluation CLIs
    ok_regist = ok_serve and regist_phase(report, rec)
    report.update(kernels=rec, launches_train_headline=launches,
                  seconds=time.perf_counter() - t_start)
    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if not ok:
        log("[train] FAILED")
        return 1
    if not (ok_dense and ok_app and ok_serve and ok_regist):
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
            "launches_app": report["app"]["launches"].get(name, 0),
            "launches_render": report["serve"]["render"]["launches"].get(name, 0),
            "launches_inference": report["serve"]["inference"]["launches"].get(name, 0),
            "launches_regist": report["regist"]["launches"].get(name, 0),
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
