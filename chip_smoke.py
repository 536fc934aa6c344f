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
   bound (at ``utils/roofline.py``'s ``H100_SXM`` peaks, NVIDIA's data
   sheet) counts the bytes the function needs (K1-K3: the payload columns
   it reads; K2/K3: the slab cells its taps touch), with the older
   all-48-column figure beside it; K2 also gets a launch floor, the device
   time of one launch writing its output only. It also
   prints the work each kernel gets (K1: occupied blocks and chunks per
   block; K2 and K3: rows, CTAs, threads per row, live rows per occupied
   block, slab cells read; K4: the tiles' pair counts, the pixels that stop on the 1e-4
   test, the (tile, segment) items and those walked again, the scratch
   bytes; K5: the tiles' walk lengths and the (tile, segment) work items).
   2b. K6 (svd3) and K7 (svd3_bwd) against their plain versions (the
   component SVD on the card) at the bench's 30,000 matrices, bit for bit
   and repeatable, each timed beside its bound, its plain version and
   ``torch.linalg.svd`` (``report["svd3"]``).
3. Headline forward (10k particles, 32^3 grid, one 800x800 view, 4
   frames x 1 substep) under ``torch.no_grad()``: loss, overflow,
   ms/frame (median of 3 after a warm-up) and the forward's launch counts
   (K1, K2, K4 must be > 0).
4. Determinism: two headline rollouts give a bitwise-equal loss and
   final particle positions.
5. Realworld forward (30k particles, 70^3 grid, three 1920x1080 mask
   views, 2 frames x 20 substeps): loss, overflow, ms/frame.
   Phases 3 and 5 also profile one forward (device idle share, time by
   kernel) and each layer of one substep and one view. Phases 3, 5, 7
   and 9 each print the whole step's share of the roofline: ``sol_ms``
   from ``roofline.grounding_step_frame`` (``bwd_factor`` 1 forward, 3
   forward + backward; the first view's pairs counted as ``bench.py``
   counts them) over the measured ms/frame, beside the card's name and
   power limit; a card whose name is not an H100 SXM's fails the phase.
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
16. The viewer CLI (``VIEW_CUTS``) on multiobj-bb-cc.yaml at its widths
    (phase 14's two fabricated objects, 48,068 particles, ``num_grids``
    42, SH 3, InvariantFull (64, 64), LoRA r 16, ``max_pairs`` 262,144,
    640x640 views), 40 frames: (a) ``python -m
    neuma_tpu_torch.apps.visualize`` as a subprocess in
    ``build/chip_smoke_view/`` (which holds ``base_models/`` with both
    reference-form base files and the two ``NEUMA_TO_LORA`` LoRA files:
    phase 13's last and a random one), polled on ``/info`` with a
    deadline, then the page, ``/info`` (40 frames, both objects,
    ``adaptors == ["bouncy", "clay"]``), three ``/render`` at 640x640 with
    at least 1% of the pixels off the background, ``/resimulate`` (an
    object off; then an adaptor switch through the lazy loader) and both
    ``/render_path`` payloads (as many frames as ``spline_path``), then
    terminated; (b) in process, the same CLI's ``main`` with a
    non-blocking server: launches (``simulate`` K1 = K2 = 40, each
    ``render_frame`` K4 once, K3 = K5 = 0), K1, K2, K4 and K5 against
    their plain versions at the scene's shapes (phase 2's bounds; K4's
    pixels on the plain walk counted), two
    ``simulate`` runs bitwise, byte-equal JPEGs, 8 concurrent ``/render``
    requests byte-equal to direct renders, the stages timed with the
    port's ``PhaseTimer`` (simulate ms per frame, ``/render`` median of 20
    on the client clock, ``/render_path``, ``/resimulate``, peak memory),
    one render profiled and three traced by ``profiler_trace``; (c) the
    small copy (``SERVE_SMALL``, 10 frames, the same panel edits) on the
    card and the CPU: frames within a scaled 1e-5, 64 px renders within
    1/255; (d) ``p2g(method="scatter" | "matmul")`` against ``"auto"`` on
    the scene's first step (a scaled 1e-5, bitwise reruns); on one
    640x640 view, ``RasterConfig(backend="pallas")`` gives auto's bits,
    ``"pallas_interpret"`` refuses CUDA tensors, and ``overflow`` fires
    when ``max_pairs`` is too small.
17. Scale-out (``HALO_SHAPE``: the realworld shape with RGB ground truth,
    particles spread 0.7 around 0.525, ``max_pairs`` 2^22 and a strain
    rate on the stage-1 velocity): (a) K1, K2 and K3 against their plain
    versions (phase 2's bounds) in each of the four halo views of a
    4-rank cut (slab width 18, tol 2: 26x70x70 cells at x origins -4, 14,
    32, 50, nbs (2, 5, 5)), on each view's own particles and on every
    particle in one view (taps outside it on line -1), and on a payload
    with tap lines -1 and 16 planted on each axis; each view's rows,
    blocks and chunks and the kernels' CUDA-event ms. (b) Four ranks on
    the card (``parallel.dryrun.spawn``, gloo: NCCL refuses two ranks on
    one card; the exchanges stage through pinned host buffers) run the
    ``grid_mode="halo"`` value-and-grad (bins with >= 25 % slack over the
    particles per slab at the start; views on ranks 0-2) twice: loss within rtol 1e-4
    and each gradient leaf within a scaled 1e-3 of the single-process
    replicated path on the card, every rank equal, reruns bitwise, no
    pair or halo overflow, K1-K3 launched on every rank and K4/K5 on the
    ranks with views; each rank's ms/frame forward + backward, the
    exchange's bytes and host ms per substep, beside the single-process
    ms/frame. (c) An NCCL world of one through the same code (its
    neighbour is a local copy), held to (b) and to the single process;
    two NCCL ranks where two cards exist, else the line ``nccl
    multi-rank: not run (1 card)``. (d) ``dryrun_multichip(4)`` (gloo,
    mesh 2 x 2): a finite loss.
18. The particle-sharded replicated-grid rollout at phase 17's scene:
    (a) K1, K2 and K3 against their plain versions (phase 2's bounds,
    times and bounds) on shard 0's payload, its 7,500 particles on the
    whole 70^3 grid; (b) four gloo ranks on the card run ``grid_mode="replicated"`` over a dp
    = 4 mesh (7,500 particles per shard; K1's per-block sums, 125 x 4 x
    16 x 256 f32 = 8.2 MB, added over the ranks in rank order once per
    substep forward and once in the backward, K3 in both roles on each
    shard; views on ranks 0-2) with phase 17b's gates against the same
    single-process path: loss within rtol 1e-4, each gradient leaf within
    a scaled 1e-3, every rank equal, reruns bitwise, no overflow, K1-K3
    launched on every rank and K4/K5 on the ranks with views; each rank's
    ms/frame forward + backward and forward alone, and the grid sums'
    bytes, calls and host ms per substep (forward, and forward +
    backward), beside phase 17b's halo figures and the single process.
19. ``python -m neuma_tpu_torch.examples.smoke_e2e`` (the port's
    end-to-end example: a fabricated 64x64 scene, both training stages of
    the CLI for 5 epochs over 4 frames, the render CLI) as a subprocess
    under ``build/chip_smoke_e2e/``: exit 0, its JSON line with the device
    ``cuda``, 5 frames, finite losses and K4/K5 launched (its 16^3 grid
    takes the dense branch: K1-K3 are not).
20. Image-tile sharding (``RasterConfig.tile_sharding``): (a) at the
    realworld 1920x1080 view (8,160 tiles, P = 523,264 pair slots), K4
    and K5 with a tile base over four ranges of the frame (the tiles
    before the first one with a pair, which hold none, then three
    near-equal ranges): each range's T, C, ``last`` and pair rows equal
    the whole-frame kernels' bit for bit (rows outside the range zero),
    each within phase 2's bounds of its plain version run with the same
    base, and each range's CUDA-event ms against its own bound and its
    plain version's; (b) four gloo ranks (``parallel.dryrun.spawn``) run
    one render of that view and the gradient of a seeded weighting of the
    image with respect to the means, covariances, opacity and SH with the
    tiles split over them (2,040 each): the image and every gradient equal
    the rank's unsharded render bit for bit, every rank equal, reruns
    bitwise, K4 = K5 = 1 per rank; each rank's ms, the gathers' calls,
    bytes and host ms, and K4/K5 and their plain versions alone on its
    range; (c) in the same world, phase 18's scene with
    ``raster_cfg.tile_sharding`` over dp (every rank renders a quarter of
    each of the 3 views, each adding a quarter of the view's loss) with
    phase 17b's gates against the single process (K4/K5 on every rank),
    ms/frame per rank and the tile gathers per frame beside phase 18's
    figures; (d) ``dryrun_multichip(4)``'s tile-sharded render (phase
    17d's run): its line names it (the dry run asserts the image finite
    and equal to the unsharded render).
21. The JAX package's jnp raster backend (``RasterConfig(backend="jnp")``:
    each tile's depth list cut at ``max_per_tile``, composited by K4/K5):
    (a) with ``max_per_tile`` 2,048, above every headline tile's count,
    one render's value-and-grad at the headline view (the image and the
    gradients with respect to the means, covariances, opacity and SH of a
    seeded weighting of it) and the headline rollout's value-and-grad are
    bitwise the default path's (loss, every gradient leaf, ``overflow``),
    with K4 = K5 = 1 per rendered view; (b) at the configs' 512, on the
    headline view and the realworld first view, K4 and K5 on the cut
    layout against their plain versions (phase 2's bounds), ``overflow``
    true, the tiles cut, the pairs the cap dropped and the deepest tile
    before and after the cut, and K4/K5's CUDA-event ms on the cut and the
    whole layouts, each beside its bound over the pairs it composites;
    (c) the headline rollout forward at 512: a finite loss with
    ``overflow`` true, its ms/frame beside the default path's, timed again
    in the phase, and phase 3's.

The scenes follow ``bench.py``'s recipe with random weights from seed 0.
Output: one JSON line ``{"kernels": [...]}`` (launches counted on the
headline training path; ``launches_app`` in the CLI run of phase 13;
``launches_render`` and ``launches_inference`` in the CLI runs of phase 14;
``launches_regist`` in the registration CLI run of phase 15;
``launches_view`` in one ``simulate`` and three renders of phase 16;
``launches_halo_rank0`` on rank 0 in one value-and-grad of phase 17b;
``launches_replicated_rank0`` likewise in phase 18; ``launches_smoke_e2e``
over phase 19's two CLI runs; ``launches_tile_rank0`` on rank 0 in one
value-and-grad of phase 20c; ``launches_jnp`` in phase 21a's rollout
value-and-grad),
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
    """The bytes' time at the card's HBM rate or the operations' at its
    FP32 rate (``roofline.H100_SXM``, NVIDIA's data sheet), whichever is
    larger, in ms, and which it was."""
    from neuma_tpu_torch.utils.roofline import H100_SXM

    t_bytes = nbytes / H100_SXM.hbm_bps * 1e3
    t_ops = flops / H100_SXM.f32_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@torch.no_grad()
def roofline_share(tag, scene, shape, ms_per_frame: float, bwd_factor: float, smi: str):
    """The whole step's share of the roofline: ``grounding_step_frame``
    at ``H100_SXM``'s peaks over the measured ms/frame (``bwd_factor`` 1
    for the forward, 3 for forward + backward). The pairs are the first
    view's, counted as ``bench.py`` counts them: the sum of the pair
    build's counts at the initial positions. None (the phase fails) on
    a card that is not an H100, whose peaks these are not."""
    from neuma_tpu_torch.render.rasterize import _build_aligned_pairs, _project
    from neuma_tpu_torch.utils import roofline

    if "H100" not in smi or "PCIe" in smi or "NVL" in smi:
        log(f"[{tag}] FAILED: the roofline's peaks are the H100 SXM's, the card is {smi}")
        return None
    cam = scene.cameras[0]
    depth, visible, mean2d, _, radius = _project(
        scene.init_x, scene.gaussians.get_covariance(), cam)
    counts = _build_aligned_pairs(depth, visible, mean2d, radius, cam.width, cam.height,
                                  scene.raster_cfg)[1]
    n_pairs = int(counts.sum())
    sol_ms = roofline.grounding_step_frame(
        shape["n_particles"], shape["grid"], cam.width, cam.height, n_pairs,
        scene.raster_cfg.max_pairs, substeps=shape["substeps"], n_views=shape["n_views"],
        bwd_factor=bwd_factor) * 1e3
    share = sol_ms / ms_per_frame
    log(f"[{tag}] roofline: sol {sol_ms:.6f} ms/frame (bwd_factor {bwd_factor:g}, {n_pairs} "
        f"pairs in view 0), share {share:.4e} of {ms_per_frame:.2f} ms/frame on {smi}")
    return dict(sol_ms=sol_ms, n_pairs=n_pairs, bwd_factor=bwd_factor,
                ms_per_frame=ms_per_frame, share=share, card=smi)


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

    return dict(
        payload=payload, c2b=lay.c2b, NB=NB, live=int(lay.valid.sum()),
        payload_g=payload_g, slabs=slabs, c2b_g=glay.c2b, inv_dx=float(c.inv_dx), k3=k3,
        **composite_inputs(scene, gen),
    )


@torch.no_grad()
def composite_inputs(scene, gen, max_per_tile=None):
    """K4/K5 inputs: the pair features of the scene's first view at rest
    (as ``rasterize`` builds them; each tile cut at ``max_per_tile`` when it
    is given, as the jnp backend builds them), random dT/dC for K5."""
    from neuma_tpu_torch.render.rasterize import (
        _build_aligned_pairs, _project, _sh_colors, _tile_ranges)

    dev = scene.init_x.device
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
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
        depth, visible, mean2d, radius, cam.width, cam.height, scene.raster_cfg,
        max_per_tile=max_per_tile,
    )
    feats = torch.cat([mean2d, conic, opacity[:, None], colors], 1)
    x0, y0, x1, y1, _, _ = _tile_ranges(mean2d, radius, cam.width, cam.height)
    shown = visible & (radius > 0)
    pairs_needed = int(torch.where(shown, (x1 - x0) * (y1 - y0), 0).sum())
    nt = counts.shape[0]
    return dict(
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
def check_and_time(tag, inp, rec, composite: bool = True):
    """K1-K3 (and with ``composite`` K4/K5) against their plain versions
    on ``inp`` at phase 2's bounds, timed, into ``rec[name][tag]``."""
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
    if not composite:
        log_checks(tag, rec, KERNELS[:3])
        return ok
    ok &= check_composite(tag, inp, rec)
    log(f"[check:{tag}] first view at rest needs {inp['pairs_needed']} (gaussian, tile) "
        f"pairs, max_pairs {inp['max_pairs']}: overflow {inp['raster_overflow']}")
    log_checks(tag, rec, KERNELS)
    return ok


SVD3_N = 30000  # the bench's particles (perfbench/configs/bun.json)
# Float operations per matrix, counted from csrc/svd3.cu: K6 18 rotations of
# ~69 and ~110 for sigma, the sort, U and the signs; K7 ~430.
SVD3_OPS = {"svd3": 18 * 69 + 110, "svd3_bwd": 430}
# Bytes per matrix: K6 9 floats in, 21 out; K7 21 + 21 in, 9 out.
SVD3_BYTES = {"svd3": (9 + 21) * 4, "svd3_bwd": (21 + 21 + 9) * 4}


def svd3_checks(report, n: int = SVD3_N) -> bool:
    """2b. K6 (``svd3``) and K7 (``svd3_bwd``) against their plain
    versions (the component path on the card) on n matrices F = I + 0.05 N
    (the sim's regime) given as the strided views of one (n, 9) buffer, and
    21 random cotangents: bit for bit, and bit for bit on a second launch.
    Each is timed (CUDA-event mean of 200 wrapper calls, device time by
    torch.profiler) beside its bound, its plain version's ms and, as the
    library's yardstick (other conventions; the port never calls it),
    ``torch.linalg.svd`` on the (n, 3, 3) tensor and its backward."""
    from neuma_tpu_torch.ops.svd3 import (run_svd3_bwd, run_svd3_fwd, svd3_bwd_plain,
                                          svd3_fwd_plain, unpack33)

    gen = torch.Generator().manual_seed(20)
    F = (torch.eye(3) + 0.05 * torch.randn((n, 3, 3), generator=gen)).cuda()
    F9 = unpack33(F)
    cots = list(torch.randn((21, n), generator=gen).cuda())
    bits = lambda t: t.contiguous().view(torch.int32)
    out, ref = run_svd3_fwd(F9), svd3_fwd_plain(F9)
    dA, dA_ref = run_svd3_bwd(out, cots), svd3_bwd_plain(ref, cots)
    equal = {"svd3": bool(torch.equal(bits(out), bits(ref))),
             "svd3_bwd": bool(torch.equal(bits(dA), bits(dA_ref)))}
    repeat = {"svd3": bool(torch.equal(bits(out), bits(run_svd3_fwd(F9)))),
              "svd3_bwd": bool(torch.equal(bits(dA), bits(run_svd3_bwd(out, cots))))}
    Fg = F.clone().requires_grad_(True)
    lib = torch.linalg.svd(Fg)
    lib_cots = [torch.randn_like(t) for t in lib]
    calls = {"svd3": (lambda: run_svd3_fwd(F9), lambda: svd3_fwd_plain(F9),
                      lambda: torch.linalg.svd(F)),
             "svd3_bwd": (lambda: run_svd3_bwd(out, cots), lambda: svd3_bwd_plain(ref, cots),
                          lambda: torch.autograd.grad(lib, Fg, lib_cots, retain_graph=True))}
    rec = {}
    for name, (kernel, plain, library) in calls.items():
        bound = bound_ms(n * SVD3_BYTES[name], n * SVD3_OPS[name])
        rec[name] = dict(n=n, bitwise=equal[name], repeats=repeat[name],
                         ms=cuda_ms(kernel, 200), plain_ms=cuda_ms(plain, 5),
                         library_ms=cuda_ms(library, 20), bound_ms=bound[0], bound_by=bound[1],
                         device_rows=device_rows(kernel))
        log(f"[{name}] n {n} bitwise {equal[name]} repeats {repeat[name]} ms {rec[name]['ms']:.4f} "
            f"plain {rec[name]['plain_ms']:.3f} library {rec[name]['library_ms']:.3f} bound "
            f"{bound[0]:.5f} ({bound[1]}) device {rec[name]['device_rows']}")
    report["svd3"] = rec
    return all(equal.values()) and all(repeat.values())


def composite_bounds(tile_start, counts, lk):
    """K4's and K5's bounds on tiles described by ``tile_start`` /
    ``counts`` (a frame or a range of it) with K4's ``last`` ``lk``: K4
    reads each live pair row once and writes T, C and ``last``
    (operations: 22 per visited (pixel, slot)); K5 reads the rows each
    tile walks (up to its largest ``last``) twice, and T, ``last``, dT,
    dC, writing the rows (operations: 60 per visited (pixel, slot))."""
    nt = counts.shape[0]
    starts = tile_start[:-1].to(torch.float32)[:, None]
    visited = torch.where(lk >= 0, lk - starts + 1, torch.zeros_like(lk)).sum()
    b4 = bound_ms(int(counts.sum()) * 36 + (2 * nt + 1) * 4 + nt * 5 * 256 * 4, float(visited) * 22)
    walked = (lk.max(1).values - starts[:, 0] + 1).clamp(min=0)
    walked = torch.minimum(walked, counts.to(torch.float32)).sum()
    b5 = bound_ms(2 * float(walked) * 36 + (2 * nt + 1) * 4 + nt * 6 * 256 * 4, float(visited) * 60)
    return b4, b5


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
    Tk, Ck, lk, exact = rk.composite_fwd(*args, with_exact=True)
    Tp, Cp, lp = rk.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    e4 = max(float((Tk - Tp).abs().max()), float((Ck - Cp).abs().max()))
    last_mismatch = int((lk != lp).sum())
    ok &= e4 <= K4_TOL and last_mismatch == 0
    nt = inp["counts"].shape[0]
    b4, b5 = composite_bounds(inp["tile_start"], inp["counts"], lk)
    rec["composite"][tag] = dict(
        max_abs_err=e4, tol=K4_TOL, last_mismatch=last_mismatch,
        ms=cuda_ms(lambda: rk.composite_fwd(*args), 20),
        plain_ms=cuda_ms(lambda: rk.composite_fwd_plain(*args), 2),
        library_ms=None, bound_ms=b4[0], bound_by=b4[1], tiles=nt,
        pairs=inp["pf"].shape[0], live_pairs=int(inp["counts"].sum()),
        raster_overflow=inp["raster_overflow"], pairs_needed=inp["pairs_needed"],
        device_rows=device_rows(lambda: rk.composite_fwd(*args)),
        work=dict(composite_fwd_work(inp, lk, lib.neuma_composite_seg()),
                  exact_walk_pixels=int(exact.sum()), exact_walk_tiles=int((exact > 0).sum()),
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
            + (f", last mismatches {r['last_mismatch']}, pixels on the plain walk "
               f"{r['work']['exact_walk_pixels']}" if name == "composite" else "")
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


def counted(fn, *args):
    """``fn(*args)`` and the kernel launches of that call (every count set
    to 0 just before it and read just after)."""
    from neuma_tpu_torch import kernels

    kernels.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, dict(kernels.launches)


def timed(fn, args, reps=3):
    """Median host seconds of ``reps`` synchronized calls after a warm-up,
    and the kernel launches of the warm-up call (``counted``). Returns the
    warm-up's output."""
    out, launches = counted(fn, *args)
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
    share = roofline_share("train:headline", h_scene, hp, ms_h, 3.0, report["nvidia_smi"])
    report["roofline"]["train_headline"] = share
    if share is None:
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
    share = roofline_share("train:realworld", r_scene, rp, ms_r, 3.0, report["nvidia_smi"])
    report["roofline"]["train_realworld"] = share
    if share is None:
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


def serve_kernel_checks(scene, tag, k5=False):
    """K1, K2 and K4 (and with ``k5`` K5, on K4's T and ``last`` and random
    cotangents) against their plain versions at a serving scene's own
    shapes (``kernel_inputs`` on a stand-in with the scene's constants,
    statics, positions, Gaussians and first camera), at phase 2's bounds;
    K4's count of pixels on the plain walk."""
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
    (Tk, Ck, lk, exact), (Tp, Cp, lp) = (rk.composite_fwd(*args, with_exact=True),
                                         rk.composite_fwd_plain(*args))
    e4 = max(float((Tk - Tp).abs().max()), float((Ck - Cp).abs().max()))
    mism, n_exact = int((lk != lp).sum()), int(exact.sum())
    ok = e1 <= K12_TOL and e2 <= K12_TOL and e4 <= K4_TOL and mism == 0
    out = dict(p2g=e1, g2p=e2, composite=e4, last_mismatch=mism, exact_walk_pixels=n_exact,
               n_particles=int(scene.state0.x.shape[0]), pairs=int(inp["counts"].sum()))
    k5_text = ""
    if k5:
        a5 = (*args[:3], Tk, lk, inp["dT"], inp["dC"], inp["tiles_x"])
        end = int(inp["tile_start"][-1])
        out["composite_bwd"] = scaled_err_cols(rk.composite_bwd(*a5)[:end],
                                               rk.composite_bwd_plain(*a5)[:end],
                                               [slice(j, j + 1) for j in range(9)])
        ok = ok and out["composite_bwd"] <= K5_TOL
        k5_text = f", composite_bwd {out['composite_bwd']:.3e} (bound {K5_TOL:.0e})"
    log(f"[serve:{tag}] kernels at the CLI's shapes ({scene.state0.x.shape[0]} particles, "
        f"{scene.constants.num_grids}^3, {int(inp['counts'].sum())} live pairs of "
        f"{inp['max_pairs']}): p2g {e1:.3e}, g2p {e2:.3e} (bound {K12_TOL:.0e}), "
        f"composite {e4:.3e} (bound {K4_TOL:.0e}), last mismatches {mism}, pixels on the "
        f"plain walk {n_exact}" + k5_text)
    return ok, out


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



VIEW_FRAMES = 40
VIEW_SMALL_FRAMES = 10
VIEW_SIZE = 640  # the viewer's default width and height
# The viewer phase's cuts of multiobj-bb-cc.yaml run by apps/visualize.py:
# depth and data only (the widths stay).
VIEW_CUTS = {
    "frames": f"{VIEW_FRAMES} of the CLI's default 100, 1 substep (its default)",
    "data": "phase 14's two fabricated BouncyBall-like objects (prepared assets, the config's "
            "sim_bounds, SH 3)",
    "pretrained_ckpt": "jelly_0300.pt and plasticine_0300.pt of random reference-form weights "
                       "from seed 42 in one directory (the reference base models are not in "
                       "the repo)",
    "load_lora": "logs/bouncyball-v1/finetune/1000_lora.npz is phase 13's last LoRA file, "
                 "logs/claycat-v1/finetune/1000_lora.npz a random one (seed 8), both in the "
                 "CLI's working directory",
}
# Cameras (eye, target) around the objects' Gaussians (a ball of radius
# 0.2 at (0, 0.45, 0) in the raw frame, where the viewer draws them).
VIEW_CAMERAS = (((0.0, 0.6, -1.2), (0.0, 0.45, 0.0)), ((1.0, 0.7, -0.6), (0.0, 0.45, 0.0)),
                ((-0.8, 0.3, 0.9), (0.0, 0.45, 0.0)))
VIEW_KEYS = [{"eye": [0.0, 0.6, -1.2], "target": [0.0, 0.45, 0.0], "hold_sec": 0.2},
             {"eye": [1.0, 0.7, -0.6], "target": [0.0, 0.45, 0.0], "transition_sec": 0.5},
             {"eye": [-0.8, 0.3, 0.9], "target": [0.0, 0.45, 0.0], "transition_sec": 0.4,
              "hold_sec": 0.1}]


def view_config(root: Path, serve_cfg: Path, lora: Path) -> Path:
    """Phase 14's multiobj config with the viewer's layout under ``root``:
    both base files in ``base_models/`` and the two LoRA files at the
    cwd-relative paths of ``NEUMA_TO_LORA`` (object 1's is ``lora``)."""
    import shutil

    from neuma_tpu_torch.apps.visualize import NEUMA_TO_BASE, NEUMA_TO_LORA
    from neuma_tpu_torch.utils.config import load_config

    cfg = load_config(serve_cfg)
    base = root / "base_models"
    base.mkdir(parents=True)
    widths = list(cfg.objects[0].constitution.elasticity.layer_widths)
    wrng = np.random.default_rng(42)
    for name in ("bouncy", "clay"):
        torch.save({"elasticity": reference_state_dict(wrng, widths),
                    "plasticity": reference_state_dict(wrng, widths)}, base / NEUMA_TO_BASE[name])
    for i, name in enumerate(("bouncy", "clay")):
        rel = NEUMA_TO_LORA[name] + ".npz"
        (root / rel).parent.mkdir(parents=True)
        if i == 0:
            shutil.copy(lora, root / rel)
        else:
            con = cfg.objects[1].constitution
            random_lora_file(root / rel, base / NEUMA_TO_BASE[name], widths, int(con.lora.r),
                             float(con.lora.alpha), seed=8)
        cfg.objects[i].pretrained_ckpt = str(base / NEUMA_TO_BASE[name])
        cfg.objects[i].constitution.load_lora = rel
    path = root / "view.yaml"
    cfg.save(path)
    return path


def http(url: str, payload=None, timeout: float = 600.0):
    """(status, content type, body) of a GET, or of a POST of ``payload``
    as JSON."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers["Content-Type"], r.read()


def render_query(frame: int, eye, target) -> str:
    return (f"/render?frame={frame}&ex={eye[0]!r}&ey={eye[1]!r}&ez={eye[2]!r}"
            f"&tx={target[0]!r}&ty={target[1]!r}&tz={target[2]!r}")


def jpeg(arr) -> bytes:
    """The viewer's encoding of a render (PIL, quality 90)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def off_background(body: bytes):
    """((H, W) of a JPEG, share of its pixels more than 16 levels off white)."""
    import io

    from PIL import Image

    arr = np.asarray(Image.open(io.BytesIO(body)), np.int16)
    return arr.shape[:2], float((np.abs(arr - 255).max(axis=2) > 16).mean())


def video_frames(path: Path) -> int:
    """The frames ``/render_path`` wrote and packed into the video or GIF
    at ``path`` (its ``path_*.png`` beside it; a GIF writer may merge
    equal neighbours)."""
    return len(list(path.parent.glob("path_*.png"))) if path.is_file() else 0


def view_endpoint_checks(base: str, frames: int, names, adaptors) -> dict:
    """Phase 16a's requests against a running viewer at ``base``."""
    from neuma_tpu_torch.vis.campath import spline_path

    out, t = {}, {}
    page = http(base + "/")[2].decode()
    out["page"] = f'width="{VIEW_SIZE}" height="{VIEW_SIZE}"' in page
    info = json.loads(http(base + "/info")[2])
    out["info"] = (info["num_frames"] == frames and [o["name"] for o in info["objects"]] == names
                   and info["adaptors"] == adaptors)
    shown = []
    for f, (eye, target) in zip((0, frames // 2, frames - 1), VIEW_CAMERAS):
        _, ctype, body = http(base + render_query(f, eye, target))
        shape, share = off_background(body)
        shown.append(share)
        out.setdefault("renders", True)
        out["renders"] &= ctype == "image/jpeg" and shape == (VIEW_SIZE, VIEW_SIZE) and share >= 0.01
    t0 = time.perf_counter()
    http(base + "/resimulate", {"objects": {"claycat": {"exists": False}}})
    t["resimulate_s"] = time.perf_counter() - t0
    info = json.loads(http(base + "/info")[2])
    _, _, body = http(base + render_query(1, *VIEW_CAMERAS[0]))
    out["resimulate"] = ([o["enabled"] for o in info["objects"]] == [True, False]
                         and info["num_frames"] == frames and off_background(body)[1] >= 0.01)
    t0 = time.perf_counter()
    http(base + "/resimulate", {"objects": {"bouncyball": {"adaptor": adaptors[-1], "weight": 0.5,
                                                           "drop_vel": 0.3}}})
    t["resimulate_adaptor_s"] = time.perf_counter() - t0
    o = json.loads(http(base + "/info")[2])["objects"][0]
    out["adaptor"] = (o["adaptor"], o["weight"], o["drop_vel"]) == (adaptors[-1], 0.5, 0.3)
    t0 = time.perf_counter()
    body = http(base + "/render_path", {"keyframes": VIEW_KEYS, "fps": 10, "loop": True})[2]
    t["render_path_s"] = time.perf_counter() - t0
    video = Path(json.loads(body)["path"])
    want = len(spline_path(VIEW_KEYS, fps=10, default_transition_sec=0.4, loop=True,
                           default_fov=0.9))
    out["render_path"] = video.is_file() and video_frames(video) == want
    body = http(base + "/render_path", {"keyframes": VIEW_KEYS[:2], "spline": False,
                                        "steps_per_segment": 4})[2]
    legacy = Path(json.loads(body)["path"])
    out["render_path_legacy"] = legacy.is_file() and video_frames(legacy) == 4
    return dict(checks=out, seconds=t, off_background=shown, path_frames=want, video=str(video))


def view_cli(root: Path, cfg_path: Path, frames: int) -> dict:
    """16a: ``python -m neuma_tpu_torch.apps.visualize`` as a subprocess in
    ``root``, polled on ``/info`` until it answers, checked, terminated."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), TMPDIR=str(root / "tmp"))
    log_path = root / "visualize.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "neuma_tpu_torch.apps.visualize", "-c", str(cfg_path),
             "--port", str(port), "--frames", str(frames)],
            cwd=root, env=env, stdout=log_file, stderr=subprocess.STDOUT)
        try:
            base, up = f"http://127.0.0.1:{port}", None
            while time.perf_counter() - t0 < 600 and proc.poll() is None:
                try:
                    http(base + "/info", timeout=5)
                    up = time.perf_counter() - t0
                    break
                except OSError:
                    time.sleep(1.0)
            if up is None:
                return dict(ok=False, up_s=None, exit=proc.poll(),
                            log=log_path.read_text()[-3000:])
            res = view_endpoint_checks(base, frames, ["bouncyball", "claycat"], ["bouncy", "clay"])
            res.update(ok=all(res["checks"].values()) and proc.poll() is None, up_s=up)
            return res
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def run_visualize(cfg_path: Path, frames: int, device):
    """``apps.visualize.main`` in this process (the working directory holds
    the LoRA files) with ``DynamicViewer.serve`` made non-blocking on a
    free port. Returns (viewer, server)."""
    from unittest import mock

    from neuma_tpu_torch.apps import visualize
    from neuma_tpu_torch.vis.viewer import DynamicViewer

    servers, original = [], DynamicViewer.serve

    def serve(self, port=8080, blocking=True):
        servers.append(original(self, port=0, blocking=False))
        return servers[-1]

    with mock.patch.object(DynamicViewer, "serve", serve):
        viewer = visualize.main(["-c", str(cfg_path), "--frames", str(frames)], device=device)
    return viewer, servers[0]


def view_camera(i: int, size: int = VIEW_SIZE, device="cpu"):
    from neuma_tpu_torch.render.camera import Camera

    eye, target = VIEW_CAMERAS[i]
    return Camera.look_at(eye=np.array(eye), target=np.array(target), fov=0.9, width=size,
                          height=size, device=device)


def view_scene(inst, device):
    """The instance's enabled objects as one particle system: (constants,
    statics, state, stress, packs)."""
    from neuma_tpu_torch.materials.compose import ComposeMaterial
    from neuma_tpu_torch.sim.initializers import build_initial_state, build_statics

    objs = [o for o in inst.objects if o.enabled]
    groups = [o.init_data for o in objs]
    state, sections = build_initial_state(groups, device=device)
    statics = build_statics(groups, device=device)
    with torch.no_grad():
        stress = ComposeMaterial([o.elasticity for o in objs], sections)(state.F)
    return inst.constants.to(device), statics, state, stress, [o.gaussians.to(device) for o in objs]


def view_backends(inst, device) -> dict:
    """16d: ``p2g`` scatter and matmul against auto on the scene's first
    step; the raster backends on one view of the last frame: ``"pallas"``
    gives auto's bits on CUDA tensors, ``"pallas_interpret"`` refuses
    them, and the kernel path's ``overflow`` fires when ``max_pairs`` is
    too small."""
    from neuma_tpu_torch.render.rasterize import rasterize_with_aux
    from neuma_tpu_torch.sim import mpm

    c, statics, state, stress, packs = view_scene(inst, device)
    out = {}
    with torch.no_grad():
        auto = mpm.p2g(c, statics, state, stress)
        for method in ("scatter", "matmul"):
            a = mpm.p2g(c, statics, state, stress, method=method)
            b = mpm.p2g(c, statics, state, stress, method=method)
            out[f"p2g_{method}"] = dict(
                grid_m=scaled_err(a[0], auto[0]), grid_mv=scaled_err(a[1], auto[1]),
                bitwise=bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])))

        frame = inst.frames[-1]
        means = torch.as_tensor(frame["means"], device=device)
        cov = torch.as_tensor(frame["cov"], device=device)
        opac = torch.cat([p.get_opacity for p in packs])
        shs = torch.cat([p.get_features for p in packs])
        rcfg = inst.raster_cfg
        render = lambda cfg: rasterize_with_aux(means, cov, opac, view_camera(0, device=device),
                                                inst.background.to(device), shs=shs,
                                                sh_degree=packs[0].sh_degree, cfg=cfg)
        img_auto, aux = render(rcfg)
        img_pallas, _ = render(dataclasses.replace(rcfg, backend="pallas"))
        try:
            render(dataclasses.replace(rcfg, backend="pallas_interpret"))
            refused = False
        except RuntimeError:
            refused = True
        out["raster"] = dict(
            pallas_equals_auto=bool(torch.equal(img_pallas, img_auto)),
            pallas_interpret_refuses_cuda=refused, overflow=bool(aux["overflow"]),
            overflow_small_max_pairs=bool(
                render(dataclasses.replace(rcfg, max_pairs=1024))[1]["overflow"]))
    r = out["raster"]
    out["ok"] = (all(v["grid_m"] <= K12_TOL and v["grid_mv"] <= K12_TOL and v["bitwise"]
                     for k, v in out.items() if k.startswith("p2g_"))
                 and r["pallas_equals_auto"] and r["pallas_interpret_refuses_cuda"]
                 and not r["overflow"] and r["overflow_small_max_pairs"])
    return out


def view_small_copy(small_cfg: Path) -> dict:
    """16c: phase 14's small multiobj copy (``SERVE_SMALL``) through the
    CLI's ``main`` on the card and on the CPU, the same panel edits on
    both: every frame's means and covariances, and a 64 px render of
    three."""
    edits = [("bouncyball", {"drop_vel": 0.8, "weight": 0.5}), ("claycat", {"drop_vel": 0.2})]
    runs = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        viewer, server = run_visualize(small_cfg, VIEW_SMALL_FRAMES, device)
        server.shutdown()
        server.server_close()
        inst = viewer.instance
        for obj, settings in edits:
            inst.apply_object_settings(obj, settings)
        inst.simulate()
        renders = [inst.render_frame(f, view_camera(i, 64)) for i, f in
                   enumerate((0, VIEW_SMALL_FRAMES // 2, VIEW_SMALL_FRAMES - 1))]
        runs[name] = ([dict(f) for f in inst.frames], renders)
    (fc, rc), (fp, rp) = runs["card"], runs["cpu"]
    pos_err = max(scaled_err(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                  for a, b in zip(fc, fp) for k in ("means", "cov"))
    px_gap = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) for a, b in zip(rc, rp))
    return dict(n_particles=int(sum(o.init_data.num_particles for o in inst.objects)),
                frames=len(fc), frames_equal_count=len(fc) == len(fp) == VIEW_SMALL_FRAMES,
                pos_err=pos_err, px_gap=px_gap,
                moved=float(np.abs(fc[-1]["means"] - fc[0]["means"]).max()))


def view_phase(report, serve_root: Path, lora: Path) -> bool:
    """Phase 16: the viewer CLI end to end on the card (see the module
    docstring)."""
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.utils.profiling import PhaseTimer, profiler_trace

    t_phase = time.perf_counter()
    root = REPO / "build" / "chip_smoke_view"
    shutil.rmtree(root, ignore_errors=True)
    (root / "tmp").mkdir(parents=True)  # the viewer's /render_path frames
    log(f"VIEW_CUTS {json.dumps(VIEW_CUTS)}")
    smi = nvidia_smi()
    cfg_path = view_config(root, serve_root / "full" / "multiobj.yaml", lora)

    # (a) the CLI as a subprocess
    cli = view_cli(root, cfg_path, VIEW_FRAMES)
    log(f"[view:cli] python -m neuma_tpu_torch.apps.visualize --frames {VIEW_FRAMES}: up after "
        f"{cli.get('up_s')} s; checks {cli.get('checks')}; pixels off the background "
        f"{cli.get('off_background')}; spline path {cli.get('path_frames')} frames "
        f"({cli.get('video')}); host seconds {cli.get('seconds')}")
    if not cli["ok"]:
        log(f"[view:cli] FAILED; exit {cli.get('exit')}; log tail:\n{cli.get('log', '')}")

    # (b) in process: the same CLI's main, its instance and a viewer on port 0
    prev_cwd, prev_tmp = os.getcwd(), tempfile.tempdir
    os.chdir(root)
    tempfile.tempdir = str(root / "tmp")  # /render_path's frames stay under build/
    timer = PhaseTimer()
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with timer.phase("main (load + simulate)"):
            viewer, server = run_visualize(cfg_path, VIEW_FRAMES, "cuda")
        launches_main = dict(kernels.launches)
        inst = viewer.instance
        first = [dict(f) for f in inst.frames]
        kernels.reset_launches()
        with timer.phase("simulate"):
            inst.simulate()
        launches = dict(kernels.launches)
        bitwise_sim = len(first) == len(inst.frames) == VIEW_FRAMES and all(
            np.array_equal(a[k], b[k]) for a, b in zip(first, inst.frames) for k in a)
        per_render, imgs = [], []
        for i in range(3):
            kernels.reset_launches()
            with timer.phase("render_frame"):
                imgs.append(inst.render_frame(i * 13, view_camera(i)))
            per_render.append(dict(kernels.launches))
        launches["composite"] = sum(r.get("composite", 0) for r in per_render)
        want = {"p2g": VIEW_FRAMES, "g2p": VIEW_FRAMES, "g2p_derivs": 0, "composite": 3,
                "composite_bwd": 0}
        gate = (all(launches.get(k, 0) == v for k, v in want.items())
                and all(launches_main.get(k, 0) == want[k] for k in ("p2g", "g2p", "g2p_derivs",
                                                                     "composite_bwd"))
                and not launches_main.get("composite")
                and all(r.get("composite", 0) == 1 and len(r) == 1 for r in per_render))
        jpeg_equal = jpeg(inst.render_frame(26, view_camera(2))) == jpeg(imgs[2])
        shown = [float((np.abs(a.astype(np.int16) - 255).max(axis=2) > 16).mean()) for a in imgs]

        # K1, K2, K4 against their plain versions on this scene's inputs
        from types import SimpleNamespace

        c, statics, state, _, packs = view_scene(inst, "cuda")
        stand_in = SimpleNamespace(constants=c, statics=statics, state0=state, packs=packs,
                                   cameras={"view": view_camera(0, device="cuda")},
                                   raster_cfg=inst.raster_cfg)
        checks_ok, checks = serve_kernel_checks(stand_in, "view", k5=True)

        # 8 concurrent /render requests against direct renders
        base = f"http://127.0.0.1:{server.server_address[1]}"
        reqs = [(f * 5, VIEW_CAMERAS[f % 3]) for f in range(8)]
        with ThreadPoolExecutor(max_workers=8) as pool:
            bodies = list(pool.map(lambda r: http(base + render_query(r[0], *r[1]))[2], reqs))
        direct = [jpeg(inst.render_frame(f, view_camera(f // 5 % 3))) for f, _ in reqs]
        concurrent_ok = bodies == direct

        # host times of the endpoints (client clock)
        render_ms = []
        for k in range(20):
            t0 = time.perf_counter()
            http(base + render_query(k % VIEW_FRAMES, *VIEW_CAMERAS[k % 3]))
            render_ms.append((time.perf_counter() - t0) * 1e3)
        with timer.phase("/render_path"):
            body = http(base + "/render_path", {"keyframes": VIEW_KEYS, "fps": 10, "loop": True})[2]
        path_frames = video_frames(Path(json.loads(body)["path"]))
        with timer.phase("/resimulate"):
            http(base + "/resimulate", {"objects": {"claycat": {"drop_vel": 0.7}}})
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        render_prof = profile_step(lambda: inst.render_frame(0, view_camera(0)), ())
        with profiler_trace(str(root / "trace")):
            for i in range(3):
                inst.render_frame(i, view_camera(i))
        trace = root / "trace" / "trace.json"
        trace_ok = trace.is_file() and trace.stat().st_size > 0
        server.shutdown()
        server.server_close()
        log(f"[view] {smi}; {sum(o.init_data.num_particles for o in inst.objects)} particles, "
            f"{inst.constants.num_grids}^3, {VIEW_SIZE}x{VIEW_SIZE} views:\n{timer.report()}")
        sim_s = timer.totals["simulate"]
        log(f"[view] simulate {sim_s:.3f} s = {sim_s / VIEW_FRAMES * 1e3:.2f} ms/frame; /render "
            f"median {statistics.median(render_ms):.2f} ms (client clock, 20 requests); "
            f"/render_path {timer.totals['/render_path']:.2f} s for {path_frames} frames; "
            f"/resimulate {timer.totals['/resimulate']:.2f} s; peak {peak_gib:.2f} GiB")
        log(f"[view] launches: main {launches_main}, simulate + 3 renders {launches} (want "
            f"{want}), per render {per_render}; simulate twice bitwise {bitwise_sim}; JPEG "
            f"byte-equal {jpeg_equal}; pixels off the background {shown}; 8 concurrent /render "
            f"byte-equal to direct renders {concurrent_ok}; trace {trace.stat().st_size if trace_ok else 0} "
            f"bytes")

        # (c) the small copy, card vs CPU
        t0 = time.perf_counter()
        small = view_small_copy(serve_root / "small" / "multiobj.yaml")
        small_s = time.perf_counter() - t0
        log(f"[view:small] {small['n_particles']} particles, 2 objects, {small['frames']} frames, "
            f"64 px: positions and covariances scaled err {small['pos_err']:.2e} (bound 1e-5), "
            f"pixel gap {small['px_gap']} (bound 1), moved {small['moved']:.3e}; {small_s:.1f} s")

        # (d) the alternative backends
        t0 = time.perf_counter()
        backends = view_backends(inst, "cuda")
        log(f"[view:backends] {json.dumps(backends)} ({time.perf_counter() - t0:.1f} s)")
    finally:
        os.chdir(prev_cwd)
        tempfile.tempdir = prev_tmp

    phase_s = time.perf_counter() - t_phase
    log(f"[view] phase {phase_s:.1f} s")
    report["view"] = dict(
        cuts=VIEW_CUTS, nvidia_smi=smi, cli={k: v for k, v in cli.items() if k != "log"},
        launches=launches, launches_main=launches_main, per_render=per_render,
        timer=dict(timer.totals), render_ms=render_ms, peak_gib=peak_gib, profile=render_prof,
        checks=checks, bitwise_sim=bitwise_sim, jpeg_equal=jpeg_equal, concurrent=concurrent_ok,
        trace_ok=trace_ok, small=small, backends=backends, seconds=phase_s,
        off_background=shown, path_frames=path_frames)
    ok = (cli["ok"] and gate and bitwise_sim and jpeg_equal and concurrent_ok and checks_ok
          and trace_ok and min(shown) >= 0.01
          and small["frames_equal_count"] and small["pos_err"] <= 1e-5 and small["px_gap"] <= 1
          and small["moved"] > 0 and backends["ok"])
    if not ok:
        log("[view] FAILED")
    return ok


# Phase 17: the realworld shape (bench.py's 30,000 particles, 70^3, 2
# frames x 20 substeps, three 1920x1080 views, InvariantFull (64, 64) with
# LoRA r 16, SH 3) with the particles spread 0.7 around 0.525 (as JAX's
# test_halo_train_step_at_realcapture_shape spreads them, so every slab
# holds particles), RGB ground truth, and the pair budget raised to 2^22
# (such a view needs ~3.4M pairs). The stage-1 velocity gets a strain rate
# so the LoRA gradient is not rounding (see APP_STRAIN_RATE).
HALO_SHAPE = dict(n_particles=30000, grid=70, frames=2, substeps=20, width=1920, height=1080,
                  n_views=3, force_mask=False, max_pairs=1 << 22, max_per_tile=512)
HALO_SPREAD = 0.7
HALO_RANKS = 4
HALO_TOL = 2  # the grounding halo step's drift tolerance
HALO_STRAIN_RATE = 5.0 * APP_STRAIN_RATE


def halo_scene(device, shape=None):
    """The phase's scene, its per-particle stage-1 velocity and its RGB
    ground truth, from seeds 0 and 5; ``shape`` overrides ``HALO_SHAPE``'s
    keys."""
    from neuma_tpu_torch.train.grounding import build_scene

    p = dict(HALO_SHAPE, **(shape or {}))
    frames = p.pop("frames")
    scene = build_scene(**p, spread=HALO_SPREAD, seed=0, device=device)
    x = scene.init_x.cpu()
    v0 = torch.tensor([0.3, 0.0, 0.0]) + (x - x.mean(0)) @ HALO_STRAIN_RATE.T
    gt = 0.25 + 0.5 * torch.rand((frames, p["n_views"], 3, p["height"], p["width"]),
                                 generator=torch.Generator().manual_seed(5))
    return scene, v0.to(device), gt.to(device)


def halo_value_and_grad(scene, device):
    """``(init_v, gt) -> (loss, aux, grads)``: [d init_v] + the LoRA
    leaves' gradients, added over the world when the scene has a mesh."""
    from neuma_tpu_torch.train.grounding import _sum_over_ranks, make_rollout_loss

    loss_fn = make_rollout_loss(scene, device=device)
    params, _ = lora_params(scene)

    def vg(init_v, gt):
        iv = init_v.detach().clone().requires_grad_(True)
        loss, aux = loss_fn(iv, torch.ones(gt.shape[0], device=device), gt)
        grads = _sum_over_ranks(scene, torch.autograd.grad(loss, [iv] + params))
        return loss.detach(), aux, grads

    return vg, loss_fn


def halo_capacity(scene, n_shards: int):
    """Particles per slab at the start, and a bin capacity with >= 25 %
    slack over the fullest (a multiple of 128)."""
    from neuma_tpu_torch.parallel import halo

    c = scene.constants
    w = halo.slab_width(c.num_grids, n_shards)
    counts = torch.bincount(halo.owner_of(c, scene.init_x, w, n_shards), minlength=n_shards)
    return counts.tolist(), -(-int(counts.max()) * 5 // 4 // 128) * 128


def counter_family(prefix: str) -> dict:
    """``calls``, ``bytes`` and host ``seconds`` of one family of the
    port's counters (``halo_exchange``, ``grid_sum``, ``tile_gather``)."""
    from neuma_tpu_torch.utils.profiling import counters

    return {k: counters[f"{prefix}.{k}"] for k in ("calls", "bytes", "seconds")}


def mesh_rank(device: str = "cuda", shape=None, profile: bool = False,
              grid_mode: str = "halo", tiles: bool = False) -> dict:
    """17b/17c, 18 and 20c, what each rank runs: the value-and-grad on the
    phase's scene over a one-axis mesh of the world, particles on it
    (``grid_mode="halo"``: bins sized by ``halo_capacity``;
    ``"replicated"``: the particle shards and the summed grid; with
    ``tiles`` every view's image tiles over the axis too), timed,
    twice, after a forward (and with ``profile`` a second forward, its
    device time read on rank 0; on the CPU only to try the code at a small
    ``shape``). The sim's collectives (the halo exchanges, or the grid
    sums) are counted in bytes and host seconds, and so are the
    tile-sharded composite's gathers."""
    import torch.distributed as dist

    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.parallel import sharding
    from neuma_tpu_torch.parallel.distributed import Mesh
    from neuma_tpu_torch.train.grounding import rank_views
    from neuma_tpu_torch.utils.profiling import reset_counters

    world = dist.get_world_size()
    mesh = Mesh(("dp",), (world,))
    scene, v0, gt = halo_scene(device, shape)
    if grid_mode == "halo":
        counts, capacity = halo_capacity(scene, world)
        family = "halo_exchange"
    else:  # particle shards of the padded count
        shard = -(-scene.init_x.shape[0] // world)
        counts, capacity = [min(shard, scene.init_x.shape[0] - r * shard) for r in range(world)], shard
        family = "grid_sum"
    scene = dataclasses.replace(scene, mesh=mesh, particle_axis="dp", grid_mode=grid_mode,
                                halo_capacity=capacity if grid_mode == "halo" else None)
    if tiles:
        scene = dataclasses.replace(scene, raster_cfg=dataclasses.replace(
            scene.raster_cfg, tile_sharding=sharding.tile_sharding(mesh, "dp")))
    vg, loss_fn = halo_value_and_grad(scene, device)
    frames, steps = gt.shape[0], gt.shape[0] * scene.substeps
    card = device == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    # the forward alone: the collectives' bytes and host seconds per substep
    reset_counters()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_fn(v0, torch.ones(frames, device=device), gt)
    sync()
    fwd_ms = (time.perf_counter() - t0) / frames * 1e3
    fwd_x = counter_family(family)
    # rank 0 profiles one more forward, device activity only (its own
    # kernels: the card is shared); the others run it too, so the
    # collectives line up
    prof = None
    if profile and card:
        import contextlib

        from torch.profiler import ProfilerActivity, profile as torch_profile

        rank0 = mesh.rank == 0
        with (torch_profile(activities=[ProfilerActivity.CUDA]) if rank0
              else contextlib.nullcontext()) as p:
            sync()
            t0 = time.perf_counter()
            with torch.no_grad():
                loss_fn(v0, torch.ones(frames, device=device), gt)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if rank0:
            busy_ms = sum(ev.self_device_time_total for ev in p.key_averages()
                          if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            prof = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms)
    runs = []
    for _ in range(2):
        kernels.reset_launches()
        reset_counters()
        if card:
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        loss, aux, grads = vg(v0, gt)
        sync()
        runs.append(dict(ms=(time.perf_counter() - t0) / frames * 1e3, loss=loss.cpu(),
                         grads=[g.cpu() for g in grads], launches=dict(kernels.launches),
                         exchange=counter_family(family),
                         tile_gathers=counter_family("tile_gather"),
                         overflow=bool(aux["overflow"]), halo_overflow=bool(aux["halo_overflow"]),
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30 if card else 0.0))
    a, b = runs
    per_substep = lambda x: dict(bytes=x["bytes"] / steps, ms=x["seconds"] / steps * 1e3,
                                 calls=x["calls"] / steps)
    views = rank_views(len(scene.cameras), mesh, scene.view_axis, "dp" if tiles else None)
    return dict(rank=mesh.rank, world=world, backend=dist.get_backend(), views=views,
                grid_mode=grid_mode, slab_counts=counts, capacity=capacity,
                profile_forward=prof, fwd_ms=fwd_ms,
                fwd_exchange_per_substep=per_substep(fwd_x),
                vg_exchange_per_substep=per_substep(b["exchange"]),
                bitwise=bool(torch.equal(a["loss"], b["loss"])) and all(
                    torch.equal(x, y) for x, y in zip(a["grads"], b["grads"])),
                **{k: v for k, v in b.items()}, launches_first=a["launches"])


def planted_payload(payload):
    """``payload`` with tap lines outside 0..15 planted on live rows: -1
    and 16 on each axis, and two x taps at -1 on one row set (a particle
    two lines below a view's edge)."""
    from neuma_tpu_torch.sim import p2g_kernel as pk

    live = torch.nonzero(payload[:, 0:9].abs().sum(1) > 0).squeeze(1)
    out = payload.clone()
    plants = [((0,), -1.0), ((2,), 16.0), ((3,), -1.0), ((5,), 16.0), ((6,), -1.0), ((8,), 16.0),
              ((0, 1), -1.0)]
    for k, (taps, line) in enumerate(plants):
        for t in taps:
            out[live[k::len(plants) + 1], pk._L0 + t] = line
    return out


@torch.no_grad()
def view_kernel_checks(scene, shards: int, tol: int, gen) -> dict:
    """17a: K1, K2 and K3 against their plain versions in each shard's
    halo view of ``scene`` at rest (random C, stress and cotangents), on
    the shard's own bin and on every particle in shard 1's view: K1 on the
    view's payload, K2 on the view's grid velocity (grid_op of K1's fold,
    unfolded), K3 in both roles of the step backward; then the
    planted-line payload (``planted_payload``) through all three on the
    full cube. Per view and kernel: the scaled error (K3 per output
    group), the kernel's and its plain version's CUDA-event ms on the
    prepared payload and slabs (the fold and unfold are not timed; K3 the
    mean of its two roles, as in phase 2) and the bound of phase 2's
    formula on this view's data (the in-view taps only); and each view's
    rows, blocks and chunks."""
    from neuma_tpu_torch.core.types import GridGeom, ParticleState
    from neuma_tpu_torch.parallel import halo
    from neuma_tpu_torch.sim import p2g_kernel as pk
    from neuma_tpu_torch.sim.mpm import _p2g_terms, grid_op

    c, dev = scene.constants, scene.init_x.device
    n = scene.init_x.shape[0]
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    state = ParticleState.initial(scene.init_x, 0.3 * rnd(n, 3))
    state = ParticleState(x=state.x, v=state.v, C=0.5 * rnd(n, 3, 3), F=state.F)
    stress = 1e-3 * rnd(n, 3, 3)
    w = halo.slab_width(c.num_grids, shards)
    lo = halo.HALO + tol
    part = halo.partition_particles(c, state, scene.statics, shards, n)
    groups = (slice(0, 1), slice(1, 4), slice(4, 13), slice(13, 16))
    kappa = 4.0 * float(c.inv_dx) ** 2
    out, ok = {"views": []}, True

    def timed(err, kernel, plain, nbytes, flops, reps=1):
        """One kernel's entry: ``kernel`` / ``plain`` time one call each;
        ``reps`` calls make up the entry (K3's two roles: their mean)."""
        bound = bound_ms(nbytes, flops)
        return dict(err=err, ms=cuda_ms(kernel, 10) / reps, plain_ms=cuda_ms(plain, 2) / reps,
                    bound_ms=bound[0], bound_by=bound[1])

    # each shard's own bin, then every particle in shard 1's view (most of
    # their taps lie outside it: line -1)
    for s, own in [(s, True) for s in range(shards)] + [(1, False)]:
        if own:
            live = int(part.valid[s].sum())
            idx = part.perm[s][:live]
        else:
            live, idx = n, torch.arange(n, device=dev)
        bst = ParticleState(*(t[idx] for t in (state.x, state.v, state.C, state.F)))
        bstat = type(scene.statics)(*(t[idx] for t in (
            scene.statics.vol, scene.statics.rho, scene.statics.clip_bound,
            scene.statics.enabled)))
        geom = GridGeom(dims=(w + 2 * lo, c.num_grids, c.num_grids),
                        origin=torch.tensor([s * w - lo, 0, 0], device=dev))
        nbs, NB = pk._num_blocks(c, geom)
        lay = pk.build_step_layouts(c, bst.x, geom)
        mass, b, affine = _p2g_terms(c, bstat, bst, stress[idx])
        srt = lay.sort
        payload = pk.pack_payload(c, lay.scatter, srt.fx, srt.loc, mass, b, affine)
        c2b = lay.scatter.c2b
        rows, M = payload.shape[0], c2b.shape[0]
        # taps in the view: the product over the axes of the in-view taps
        taps_in = int((srt.loc >= 0).sum(-1).prod(-1).sum())
        r = dict(shard=s, particles_of="own bin" if own else "all", origin=s * w - lo,
                 dims=list(geom.dims), nbs=list(nbs), particles=live, rows=rows, blocks=NB,
                 chunks=M, taps_inside=taps_in, taps_outside=int((srt.loc < 0).sum()),
                 occupied_blocks=int(torch.unique(c2b[lay.scatter.valid.reshape(-1, pk.CHUNK)
                                                      .sum(1) > 0]).numel()))
        r["p2g"] = timed(
            scaled_err(pk.run_p2g_fwd(payload, c2b, NB), pk.run_p2g_fwd_plain(payload, c2b, NB)),
            lambda: pk.run_p2g_fwd(payload, c2b, NB),
            lambda: pk.run_p2g_fwd_plain(payload, c2b, NB),
            rows * PAYLOAD_COLS_READ["p2g"] * 4 + M * 4 + NB * 16384 * 4, taps_in * 28)
        grid = pk._fold(pk.run_p2g_fwd_plain(payload, c2b, NB), geom.dims, nbs)
        vel = grid_op(c, grid[:, 3], grid[:, :3], geom)
        slabs_v = pk.unfold_blocks(vel, geom.dims, nbs)
        zeros3 = torch.zeros_like(bst.x)
        zeros33 = torch.zeros((live, 3, 3), device=dev)
        pay_g = pk.pack_payload(c, lay.gather, srt.fx, srt.loc, None, zeros3, zeros33)
        a2 = (pay_g, slabs_v, c2b, float(c.inv_dx))
        fixed = M * 4 + rows * 16 * 4  # c2b in, (rows, 16) out
        r["g2p"] = timed(
            scaled_err(pk.run_apic_gather(*a2), pk.run_apic_gather_plain(*a2)),
            lambda: pk.run_apic_gather(*a2), lambda: pk.run_apic_gather_plain(*a2),
            rows * PAYLOAD_COLS_READ["g2p"] * 4 + gather_slab_cells(pay_g, c2b) * 16 + fixed,
            taps_in * 34)
        d_new_v, A2 = rnd(live, 3), kappa * 1e-2 * rnd(live, 3, 3)
        a3s = [(pay, slabs, c2b, float(c.inv_dx), True) for pay, slabs in (
            (payload, pk.unfold_blocks(rnd(geom.num_cells, 4), geom.dims, nbs)),
            (pk.pack_payload(c, lay.gather, srt.fx, srt.loc, None, d_new_v, A2), slabs_v))]
        cells3 = sum(gather_slab_cells(a3[0], c2b) for a3 in a3s) / 2
        r["g2p_derivs"] = timed(
            max(scaled_err_cols(pk.run_apic_gather(*a3), pk.run_apic_gather_plain(*a3), groups)
                for a3 in a3s),
            lambda: [pk.run_apic_gather(*a3) for a3 in a3s],
            lambda: [pk.run_apic_gather_plain(*a3) for a3 in a3s],
            rows * PAYLOAD_COLS_READ["g2p_derivs"] * 4 + cells3 * 16 + fixed, taps_in * 71, 2)
        ok &= (r["p2g"]["err"] <= K12_TOL and r["g2p"]["err"] <= K12_TOL
               and r["g2p_derivs"]["err"] <= K3_TOL)
        out["views"].append(r)
    # the planted lines, full cube
    lay = pk.build_step_layouts(c, state.x)
    mass, b, affine = _p2g_terms(c, scene.statics, state, stress)
    srt = lay.sort
    payload = planted_payload(pk.pack_payload(c, lay.scatter, srt.fx, srt.loc, mass, b, affine))
    nbs, NB = pk._num_blocks(c)
    c2b = lay.scatter.c2b
    slabs = torch.randn((NB, 4, 16, 16, 16), generator=gen).to(dev)
    out["planted"] = dict(
        rows_planted=int((payload != pk.pack_payload(c, lay.scatter, srt.fx, srt.loc, mass, b,
                                                     affine)).any(1).sum()),
        p2g_err=scaled_err(pk.run_p2g_fwd(payload, c2b, NB), pk.run_p2g_fwd_plain(payload, c2b, NB)),
        p2g_bitwise=bool(torch.equal(pk.run_p2g_fwd(payload, c2b, NB),
                                     pk.run_p2g_fwd(payload, c2b, NB))),
        g2p_err=scaled_err(pk.run_apic_gather(payload, slabs, c2b, float(c.inv_dx)),
                           pk.run_apic_gather_plain(payload, slabs, c2b, float(c.inv_dx))),
        g2p_derivs_err=scaled_err_cols(
            pk.run_apic_gather(payload, slabs, c2b, float(c.inv_dx), True),
            pk.run_apic_gather_plain(payload, slabs, c2b, float(c.inv_dx), True), groups))
    pl = out["planted"]
    ok &= (pl["p2g_err"] <= K12_TOL and pl["p2g_bitwise"] and pl["g2p_err"] <= K12_TOL
           and pl["g2p_derivs_err"] <= K3_TOL)
    out["ok"] = ok
    return out


_single = {}


def single_reference() -> dict:
    """The single-process replicated path on the card at ``HALO_SHAPE``,
    which phases 17 and 18 are held to: loss, overflow, the gradients (on
    the host) and ms/frame of a value-and-grad after a warm-up. Run once."""
    if not _single:
        scene, v0, gt = halo_scene("cuda")
        vg, _ = halo_value_and_grad(scene, "cuda")
        vg(v0, gt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, aux, grads = vg(v0, gt)
        torch.cuda.synchronize()
        _single.update(loss=loss.cpu(), overflow=bool(aux["overflow"]),
                       grads=[g.cpu() for g in grads],
                       ms_per_frame=(time.perf_counter() - t0) / gt.shape[0] * 1e3)
        del scene, vg
        torch.cuda.empty_cache()
        log(f"[single] one process, replicated grid: loss {float(_single['loss']):.6f} overflow "
            f"{_single['overflow']} {_single['ms_per_frame']:.2f} ms/frame (forward+backward)")
    return _single


def mesh_gate(ranks, tag: str) -> dict:
    """Phase 17b's gates on ``mesh_rank`` results: loss within rtol 1e-4
    and each gradient leaf within a scaled ``GRAD_TOL`` of
    ``single_reference``, every rank equal, reruns bitwise, no overflow,
    K1-K3 launched on every rank and K4/K5 on the ranks with views. Logs
    each rank's times and the sim's collectives per substep."""
    from neuma_tpu_torch.parallel import halo

    ref, single = ranks[0], single_reference()
    loss_1, grads_1 = single["loss"], single["grads"]
    rel = abs(float(ref["loss"]) - float(loss_1)) / abs(float(loss_1))
    errs = [scaled_err(a, b) for a, b in zip(ref["grads"], grads_1)]
    same = all(torch.equal(r["loss"], ref["loss"]) and all(
        torch.equal(a, b) for a, b in zip(r["grads"], ref["grads"])) for r in ranks)
    launched = all(all(r["launches"].get(k, 0) > 0 for k in ("p2g", "g2p", "g2p_derivs"))
                   and all((r["launches"].get(k, 0) > 0) == bool(r["views"])
                           for k in ("composite", "composite_bwd")) for r in ranks)
    flags = not any(r["halo_overflow"] or r["overflow"] for r in ranks)
    bitwise = all(r["bitwise"] for r in ranks)
    halo_mode = ref["grid_mode"] == "halo"
    if halo_mode:
        log(f"[{tag}] {len(ranks)} rank(s) over {ref['backend']}, slab width "
            f"{halo.slab_width(HALO_SHAPE['grid'], len(ranks))}, tol {HALO_TOL}, particles per "
            f"slab {ref['slab_counts']}, bins of {ref['capacity']} (>= 25 % slack)")
    else:
        log(f"[{tag}] {len(ranks)} rank(s) over {ref['backend']}, particle shards of "
            f"{ref['capacity']} ({ref['slab_counts']} scene particles), grid replicated")
    what = "exchange" if halo_mode else "grid sum"
    for r in ranks:
        x, vgx = r["fwd_exchange_per_substep"], r["vg_exchange_per_substep"]
        log(f"[{tag}] rank {r['rank']} ({r['backend']}, views {r['views']}): "
            f"{r['ms']:.2f} ms/frame forward+backward ({r['fwd_ms']:.2f} forward; one process "
            f"{single['ms_per_frame']:.2f} forward+backward), peak {r['peak_gib']:.2f} GiB; "
            f"{what} per substep: forward {x['bytes'] / 1e6:.3f} MB in {x['calls']:.0f} calls, "
            f"{x['ms']:.3f} ms host incl. staging; forward+backward {vgx['bytes'] / 1e6:.3f} MB "
            f"in {vgx['calls']:.0f} calls, {vgx['ms']:.3f} ms; launches {r['launches']}")
    pf = ref["profile_forward"]
    if pf:
        log(f"[{tag}] rank 0's forward, its own kernels: wall {pf['wall_ms']:.2f} ms, "
            f"device busy {pf['busy_ms']:.2f} ms (idle share {pf['idle_share']:.3f})")
    log(f"[{tag}] vs one process: loss {float(ref['loss']):.6f} rel gap {rel:.2e} "
        f"(bound 1e-4), gradient scaled max error {max(errs):.2e} over {len(errs)} leaves "
        f"(bound {GRAD_TOL:.0e}); ranks equal {same}; reruns bitwise {bitwise}; "
        f"K1-K3 on every rank and K4/K5 where views {launched}; no overflow {flags}")
    return dict(loss_rel_gap=rel, grad_errs=errs, ranks_equal=same, bitwise=bitwise,
                launched=launched, no_overflow=flags, single_ms_per_frame=single["ms_per_frame"],
                ranks=[{k: v for k, v in r.items() if k not in ("grads", "loss")}
                       | {"loss": float(r["loss"])} for r in ranks],
                ok=rel <= 1e-4 and max(errs) <= GRAD_TOL and same and bitwise
                and launched and flags)


def halo_phase(report) -> bool:
    """Phase 17: scale-out on the card (see the module docstring)."""
    import chip_smoke as this  # the spawned ranks find mesh_rank by module
    from neuma_tpu_torch.parallel.dryrun import dryrun_multichip, spawn

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    out = {"nvidia_smi": smi, "shape": HALO_SHAPE, "spread": HALO_SPREAD}
    scene, _, _ = halo_scene("cuda")

    # (a) the geom forms of K1-K3, each shard's view
    t0 = time.perf_counter()
    views = view_kernel_checks(scene, HALO_RANKS, HALO_TOL, torch.Generator().manual_seed(17))
    out["views"] = views
    for r in views["views"]:
        log(f"[halo:views] shard {r['shard']} ({r['particles_of']}): view {r['dims']} at x "
            f"{r['origin']}, nbs "
            f"{r['nbs']}, {r['particles']} particles, {r['rows']} rows, {r['blocks']} blocks "
            f"({r['occupied_blocks']} occupied), {r['chunks']} chunks, {r['taps_outside']} of "
            f"{9 * r['particles']} tap lines outside, {r['taps_inside']} of "
            f"{27 * r['particles']} taps inside; "
            + "; ".join(f"{name} err {k['err']:.2e} kernel {k['ms']:.4f} ms, plain "
                        f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']})"
                        for name, k in (("K1", r["p2g"]), ("K2", r["g2p"]),
                                        ("K3 (mean of 2 roles)", r["g2p_derivs"])))
            + f" (gates {K12_TOL:.0e}, {K3_TOL:.0e}; kernels alone, no fold or unfold)")
    log(f"[halo:planted] {json.dumps(views['planted'])} ({time.perf_counter() - t0:.1f} s)")
    if not views["ok"]:
        log("[halo] FAILED: a geom kernel check")
        return False
    del scene
    torch.cuda.empty_cache()

    # the single-process replicated path on the card
    single = single_reference()
    out["single"] = dict(loss=float(single["loss"]), ms_per_frame=single["ms_per_frame"],
                         overflow=single["overflow"])

    # (b) four ranks on the one card (gloo: NCCL refuses two ranks on one card)
    t0 = time.perf_counter()
    ranks4 = spawn(this.mesh_rank, HALO_RANKS, args=("cuda", None, True), device="cuda",
                   backend="gloo")
    log(f"[halo:4] {HALO_RANKS} ranks on one card over gloo (faces staged through pinned "
        f"host buffers): {time.perf_counter() - t0:.1f} s")
    out["four"] = mesh_gate(ranks4, "halo:4")

    # (c) NCCL: a world of one through the same code, and two ranks where two cards exist
    t0 = time.perf_counter()
    ranks1 = spawn(this.mesh_rank, 1, device="cuda", backend="nccl")
    out["nccl1"] = mesh_gate(ranks1, "halo:nccl1")
    rel41 = abs(float(ranks1[0]["loss"]) - float(ranks4[0]["loss"])) / abs(float(ranks4[0]["loss"]))
    err41 = max(scaled_err(a, b) for a, b in zip(ranks1[0]["grads"], ranks4[0]["grads"]))
    out["nccl1"].update(vs_four=dict(loss_rel_gap=rel41, grad_err=err41))
    log(f"[halo:nccl1] vs four gloo ranks: loss rel gap {rel41:.2e}, gradient scaled max error "
        f"{err41:.2e} ({time.perf_counter() - t0:.1f} s)")
    ok_nccl = out["nccl1"]["ok"] and rel41 <= 1e-4 and err41 <= GRAD_TOL
    if torch.cuda.device_count() >= 2:
        out["nccl2"] = mesh_gate(spawn(this.mesh_rank, 2, device="cuda", backend="nccl"),
                                 "halo:nccl2")
        ok_nccl &= out["nccl2"]["ok"]
    else:
        log("nccl multi-rank: not run (1 card)")
        out["nccl2"] = "not run (1 card)"

    # (d) the dry run
    t0 = time.perf_counter()
    dry = dryrun_multichip(HALO_RANKS, device="cuda", backend="gloo")
    out["dryrun"] = dict(dry, seconds=time.perf_counter() - t0)
    log(f"[halo:dryrun] {dry['line']} ({out['dryrun']['seconds']:.1f} s)")
    ok_dry = bool(np.isfinite(dry["loss"])) and not dry["halo_overflow"]

    out["seconds"] = time.perf_counter() - t_phase
    log(f"[halo] {smi}; phase {out['seconds']:.1f} s")
    report["halo"] = out
    ok = out["four"]["ok"] and ok_nccl and ok_dry
    if not ok:
        log("[halo] FAILED")
    return ok


def replicated_phase(report) -> bool:
    """Phase 18: the particle-sharded replicated-grid rollout on the card
    (see the module docstring)."""
    import chip_smoke as this  # the spawned ranks find mesh_rank by module
    from neuma_tpu_torch.parallel.dryrun import spawn

    t0 = time.perf_counter()
    smi = nvidia_smi()
    # (a) K1-K3 against their plain versions on shard 0's payload (its
    # 7,500 particles on the whole 70^3 grid, as each rank runs them)
    scene, _, _ = halo_scene("cuda")
    m = scene.init_x.shape[0] // HALO_RANKS
    shard = dataclasses.replace(scene, init_x=scene.init_x[:m], statics=type(scene.statics)(
        **{f: getattr(scene.statics, f)[:m] for f in scene.statics.__dataclass_fields__}))
    rec = {name: {} for name in KERNELS}
    ok_k = check_and_time("shard", kernel_inputs(shard, torch.Generator().manual_seed(18)), rec,
                          composite=False)
    del scene, shard
    torch.cuda.empty_cache()
    # (b) four ranks on the card
    t_ranks = time.perf_counter()
    ranks = spawn(this.mesh_rank, HALO_RANKS, args=("cuda", None, False, "replicated"),
                  device="cuda", backend="gloo")
    log(f"[replicated:4] {HALO_RANKS} ranks on one card over gloo (grid sums staged through "
        f"pinned host buffers): {time.perf_counter() - t_ranks:.1f} s")
    out = {"nvidia_smi": smi, "shape": HALO_SHAPE, "spread": HALO_SPREAD,
           "shard_kernels": {name: rec[name]["shard"] for name in KERNELS[:3]},
           "four": mesh_gate(ranks, "replicated:4")}
    if "halo" in report:  # phase 17's figures, beside these
        halo_ms = ", ".join(f"{r['ms']:.2f}" for r in report["halo"]["four"]["ranks"])
        log(f"[replicated:4] beside halo mode (phase 17b): {halo_ms} ms/frame per rank")
    out["seconds"] = time.perf_counter() - t0
    log(f"[replicated] {smi}; phase {out['seconds']:.1f} s")
    report["replicated"] = out
    ok = ok_k and out["four"]["ok"]
    if not ok:
        log("[replicated] FAILED")
    return ok


def smoke_e2e_phase(report) -> bool:
    """Phase 19: ``python -m neuma_tpu_torch.examples.smoke_e2e`` on the
    card, as a user runs it (see the module docstring)."""
    t0 = time.perf_counter()
    work = REPO / "build" / "chip_smoke_e2e"
    proc = subprocess.run([sys.executable, "-m", "neuma_tpu_torch.examples.smoke_e2e",
                           "--workdir", str(work)], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
    launches = res.get("launches", {})
    ok = (proc.returncode == 0 and res.get("ok") is True and res.get("device") == "cuda"
          and res.get("frames") == 5 and bool(res.get("losses"))
          and all(np.isfinite(res["losses"]))
          and all(launches.get(k, 0) > 0 for k in ("composite", "composite_bwd")))
    out = dict(res, returncode=proc.returncode, seconds=time.perf_counter() - t0, ok=ok)
    log(f"[smoke_e2e] exit {proc.returncode}: train {res.get('train_s', float('nan')):.1f} s, "
        f"render {res.get('render_s', float('nan')):.1f} s, {res.get('frames')} frames, losses "
        f"{res.get('losses')}, launches {launches} ({out['seconds']:.1f} s with start-up)")
    if not ok:
        log(f"[smoke_e2e] FAILED: {proc.stderr[-2000:]}")
    report["smoke_e2e"] = out
    return ok


TILE_RANKS = 4


def tile_cut(counts):
    """20a's four ranges of a frame's tiles: the tiles before the first
    one with a pair (a range with no pair), then the rest in three
    near-equal ranges."""
    n = counts.shape[0]
    nz = torch.nonzero(counts > 0).squeeze(1)
    first = int(nz[0]) if nz.numel() else n
    k = -(-(n - first) // 3)
    edges = [0, first] + [min(first + i * k, n) for i in (1, 2)] + [n]
    return list(zip(edges[:-1], edges[1:]))


@torch.no_grad()
def tile_kernel_ranges(inp) -> dict:
    """20a: K4 and K5 with a tile base over each ``tile_cut`` range of
    ``inp``'s frame: T, C, ``last`` and the pair rows equal the
    whole-frame kernels' for those tiles bit for bit (rows outside the
    range's slots zero), the plain versions with the same base within
    phase 2's bounds, and each range's CUDA-event ms against its own
    bound and its plain version's."""
    from neuma_tpu_torch.render import raster_kernel as rk

    pf, start, counts, tx = inp["pf"], inp["tile_start"], inp["counts"], inp["tiles_x"]
    T, C, last = rk.composite_fwd(pf, start, counts, tx)
    rows = rk.composite_bwd(pf, start, counts, T, last, inp["dT"], inp["dC"], tx)
    out, ok = [], True
    for t0, t1 in tile_cut(counts):
        ts, cn = start[t0:t1 + 1], counts[t0:t1]
        Tr, Cr, lr = rk.composite_fwd(pf, ts, cn, tx, t0)
        Tp, Cp, lp = rk.composite_fwd_plain(pf, ts, cn, tx, t0)
        a5 = (pf, ts, cn, Tr, lr, inp["dT"][t0:t1].contiguous(), inp["dC"][t0:t1].contiguous(),
              tx, t0)
        rr, rp = rk.composite_bwd(*a5), rk.composite_bwd_plain(*a5)
        lo, hi = int(start[t0]), int(start[t1])
        torch.cuda.synchronize()
        whole = (torch.equal(Tr, T[t0:t1]) and torch.equal(Cr, C[t0:t1])
                 and torch.equal(lr, last[t0:t1]) and torch.equal(rr[lo:hi], rows[lo:hi])
                 and not bool(rr[:lo].any()) and not bool(rr[hi:].any()))
        e4 = max(float((Tr - Tp).abs().max()), float((Cr - Cp).abs().max())) if t1 > t0 else 0.0
        e5 = (scaled_err_cols(rr[lo:hi], rp[lo:hi], [slice(j, j + 1) for j in range(9)])
              if hi > lo else 0.0)
        mismatch = int((lr != lp).sum())
        b4, b5 = composite_bounds(ts, cn, lr)
        out.append(dict(
            tiles=[t0, t1], pairs=int(cn.sum()), slots=[lo, hi], whole_frame_bitwise=whole,
            k4_err=e4, last_mismatch=mismatch, k5_err=e5,
            k4_ms=cuda_ms(lambda: rk.composite_fwd(pf, ts, cn, tx, t0), 20),
            k5_ms=cuda_ms(lambda: rk.composite_bwd(*a5), 20),
            k4_plain_ms=cuda_ms(lambda: rk.composite_fwd_plain(pf, ts, cn, tx, t0), 1),
            k5_plain_ms=cuda_ms(lambda: rk.composite_bwd_plain(*a5), 1),
            k4_bound_ms=b4[0], k4_bound_by=b4[1], k5_bound_ms=b5[0], k5_bound_by=b5[1]))
        ok &= whole and e4 <= K4_TOL and mismatch == 0 and e5 <= K5_TOL
    a5 = (pf, start, counts, T, last, inp["dT"], inp["dC"], tx)
    frame = dict(k4_ms=cuda_ms(lambda: rk.composite_fwd(pf, start, counts, tx), 20),
                 k5_ms=cuda_ms(lambda: rk.composite_bwd(*a5), 20))
    ok &= any(r["pairs"] == 0 for r in out)
    return dict(ranges=out, frame=frame, tiles=int(counts.shape[0]), pair_slots=int(pf.shape[0]),
                ok=ok)


def tile_render_rank(device: str = "cuda", shape=None) -> dict:
    """20b, what each rank runs: one render of the realworld scene's first
    view (``shape`` overrides its keys) and the gradient of sum(w * image)
    with respect to the means, covariances, opacity and SH, with the tiles
    over a one-axis mesh of the world, twice, against this process's
    unsharded render and gradient; the tile gathers' calls, bytes and host
    seconds; then K4 and K5 and their plain versions alone on the rank's
    range of tiles (CUDA events; the ranks share the card)."""
    import hashlib

    import torch.distributed as dist

    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.parallel.distributed import Mesh
    from neuma_tpu_torch.parallel.sharding import tile_sharding
    from neuma_tpu_torch.render import raster_kernel as rk
    from neuma_tpu_torch.render.rasterize import rasterize
    from neuma_tpu_torch.train.grounding import BENCH_SHAPES, build_scene
    from neuma_tpu_torch.utils.profiling import reset_counters

    world = dist.get_world_size()
    mesh = Mesh(("dp",), (world,))
    p = {k: v for k, v in dict(BENCH_SHAPES["realworld"], **(shape or {})).items()
         if k != "frames"}
    scene = dataclasses.replace(build_scene(**p, seed=0, device=device), force_mask_data=False)
    g, cam = scene.gaussians, scene.cameras[0]
    w = torch.randn((3, cam.height, cam.width),
                    generator=torch.Generator().manual_seed(20)).to(device)
    card = device == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)

    def value_and_grad(cfg):
        leaves = [t.detach().clone().requires_grad_(True) for t in (
            g.xyz, g.get_covariance(), g.get_opacity, g.get_features)]
        img = rasterize(leaves[0], leaves[1], leaves[2], cam, scene.background, shs=leaves[3],
                        sh_degree=g.sh_degree, cfg=cfg)
        return [img.detach()] + list(torch.autograd.grad((w * img).sum(), leaves))

    one = value_and_grad(scene.raster_cfg)
    cfg_t = dataclasses.replace(scene.raster_cfg, tile_sharding=tile_sharding(mesh))
    runs = []
    for _ in range(2):
        kernels.reset_launches()
        reset_counters()
        sync()
        t0 = time.perf_counter()
        out = value_and_grad(cfg_t)
        sync()
        runs.append(dict(out=out, ms=(time.perf_counter() - t0) * 1e3,
                         launches=dict(kernels.launches), gathers=counter_family("tile_gather")))
    sync()
    t0 = time.perf_counter()
    value_and_grad(scene.raster_cfg)
    sync()
    one_ms = (time.perf_counter() - t0) * 1e3
    a, b = runs
    equal = lambda xs, ys: all(torch.equal(x, y) for x, y in zip(xs, ys))
    digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in a["out"])).hexdigest()
    # K4 and K5 alone on this rank's range of the same pairs
    inp = composite_inputs(scene, torch.Generator().manual_seed(21))
    pf, tx = inp["pf"], inp["tiles_x"]
    t0, t1, _ = rk.tile_range(inp["counts"].shape[0], world, mesh.coord("dp"))
    ts, cn = inp["tile_start"][t0:t1 + 1], inp["counts"][t0:t1]
    with torch.no_grad():
        Tr, _, lr = rk.composite_fwd(pf, ts, cn, tx, t0)
        a5 = (pf, ts, cn, Tr, lr, inp["dT"][t0:t1].contiguous(), inp["dC"][t0:t1].contiguous(),
              tx, t0)
        b4, b5 = composite_bounds(ts, cn, lr)
        k4_ms = cuda_ms(lambda: rk.composite_fwd(pf, ts, cn, tx, t0), 20) if card else None
        k5_ms = cuda_ms(lambda: rk.composite_bwd(*a5), 20) if card else None
        k4_plain_ms = (cuda_ms(lambda: rk.composite_fwd_plain(pf, ts, cn, tx, t0), 1)
                       if card else None)
        k5_plain_ms = cuda_ms(lambda: rk.composite_bwd_plain(*a5), 1) if card else None
    return dict(rank=mesh.rank, tiles=[t0, t1], pairs=int(cn.sum()), digest=digest,
                one_process_bitwise=equal(one, a["out"]), rerun_bitwise=equal(a["out"], b["out"]),
                image_finite=bool(torch.isfinite(a["out"][0]).all()), ms=b["ms"], one_ms=one_ms,
                launches=b["launches"], gathers=b["gathers"], k4_ms=k4_ms, k5_ms=k5_ms,
                k4_plain_ms=k4_plain_ms, k5_plain_ms=k5_plain_ms,
                k4_bound_ms=b4[0], k5_bound_ms=b5[0], pair_slots=int(pf.shape[0]))


def tile_rank(device: str = "cuda", render_shape=None, mesh_shape=None) -> dict:
    """20b and 20c, what each rank runs (one world for both)."""
    render = tile_render_rank(device, render_shape)
    if device == "cuda":
        torch.cuda.empty_cache()
    return dict(render=render, rollout=mesh_rank(device, mesh_shape, grid_mode="replicated",
                                                 tiles=True))


def tile_phase(report) -> bool:
    """Phase 20: the image tiles split over ranks (see the module
    docstring)."""
    import chip_smoke as this  # the spawned ranks find tile_rank by module
    from neuma_tpu_torch.parallel.dryrun import dryrun_multichip, spawn
    from neuma_tpu_torch.train.grounding import BENCH_SHAPES, build_scene

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    # (a) K4 and K5 over four ranges of the realworld view
    p = {k: v for k, v in BENCH_SHAPES["realworld"].items() if k != "frames"}
    scene = build_scene(**p, seed=0, device="cuda")
    kr = tile_kernel_ranges(composite_inputs(scene, torch.Generator().manual_seed(20)))
    del scene
    torch.cuda.empty_cache()
    for r in kr["ranges"]:
        log(f"[tiles:kernels] tiles {r['tiles']} ({r['pairs']} pairs, slots {r['slots']}): "
            f"whole-frame rows bitwise {r['whole_frame_bitwise']}; vs plain: K4 err "
            f"{r['k4_err']:.2e} (bound {K4_TOL:.0e}), last mismatches {r['last_mismatch']}, K5 "
            f"err {r['k5_err']:.2e} (bound {K5_TOL:.0e}); K4 {r['k4_ms']:.4f} ms (bound "
            f"{r['k4_bound_ms']:.5f}, {r['k4_bound_by']}; plain {r['k4_plain_ms']:.3f}), K5 "
            f"{r['k5_ms']:.4f} ms (bound {r['k5_bound_ms']:.5f}, {r['k5_bound_by']}; plain "
            f"{r['k5_plain_ms']:.3f})")
    log(f"[tiles:kernels] whole frame ({kr['tiles']} tiles, P = {kr['pair_slots']}): K4 "
        f"{kr['frame']['k4_ms']:.4f} ms, K5 {kr['frame']['k5_ms']:.4f} ms; ok {kr['ok']}")

    # (b, c) four ranks on the card: one render, then the rollout
    single_reference()
    t0 = time.perf_counter()
    ranks = spawn(this.tile_rank, TILE_RANKS, args=("cuda",), device="cuda", backend="gloo")
    log(f"[tiles:4] {TILE_RANKS} ranks on one card over gloo: {time.perf_counter() - t0:.1f} s")
    renders = [r["render"] for r in ranks]
    for r in renders:
        gx = r["gathers"]
        log(f"[tiles:render] rank {r['rank']} tiles {r['tiles']} ({r['pairs']} pairs): "
            f"value-and-grad {r['ms']:.2f} ms (one process {r['one_ms']:.2f}); gathers "
            f"{gx['calls']} calls, {gx['bytes'] / 1e6:.3f} MB sent, {gx['seconds'] * 1e3:.2f} ms "
            f"host incl. staging; launches {r['launches']}; K4 {r['k4_ms']:.4f} ms (bound "
            f"{r['k4_bound_ms']:.5f}, plain {r['k4_plain_ms']:.3f}), K5 {r['k5_ms']:.4f} ms "
            f"(bound {r['k5_bound_ms']:.5f}, plain {r['k5_plain_ms']:.3f}) on its range; one process's bits {r['one_process_bitwise']}, rerun bitwise "
            f"{r['rerun_bitwise']}")
    ok_b = (len({r["digest"] for r in renders}) == 1 and all(
        r["one_process_bitwise"] and r["rerun_bitwise"] and r["image_finite"]
        and r["launches"].get("composite") == 1 and r["launches"].get("composite_bwd") == 1
        for r in renders))
    rollout = mesh_gate([r["rollout"] for r in ranks], "tiles:rollout")
    frames = HALO_SHAPE["frames"]
    for r in ranks:
        gx = r["rollout"]["tile_gathers"]
        log(f"[tiles:rollout] rank {r['rollout']['rank']} views {r['rollout']['views']}: "
            f"{r['rollout']['ms']:.2f} ms/frame; tile gathers per frame {gx['calls'] / frames:.0f} "
            f"calls, {gx['bytes'] / frames / 1e6:.3f} MB sent, "
            f"{gx['seconds'] / frames * 1e3:.2f} ms host")
    ok_c = rollout["ok"] and all(r["rollout"]["views"] == [0, 1, 2] for r in ranks)
    if "replicated" in report:
        rep_ms = ", ".join(f"{r['ms']:.2f}" for r in report["replicated"]["four"]["ranks"])
        log(f"[tiles:rollout] beside phase 18 (the same ranks without tile sharding, views on "
            f"ranks 0-2): {rep_ms} ms/frame per rank")
    # (d) the dry run's tile-sharded render (phase 17d's run when there was one)
    t0 = time.perf_counter()
    dry = (report["halo"]["dryrun"] if "halo" in report
           else dryrun_multichip(TILE_RANKS, device="cuda", backend="gloo"))
    ok_d = "+ tile-sharded render" in dry["line"] and bool(np.isfinite(dry["loss"]))
    log(f"[tiles:dryrun] {dry['line']} ({time.perf_counter() - t0:.1f} s)")
    out = dict(nvidia_smi=smi, kernels=kr, renders=renders, rollout=rollout,
               dryrun_line=dry["line"], seconds=time.perf_counter() - t_phase)
    log(f"[tiles] {smi}; (a) {kr['ok']} (b) {ok_b} (c) {ok_c} (d) {ok_d}; phase "
        f"{out['seconds']:.1f} s")
    report["tiles"] = out
    ok = kr["ok"] and ok_b and ok_c and ok_d
    if not ok:
        log("[tiles] FAILED")
    return ok


# Phase 21: the jnp backend. 15 of the 18 configs under configs/ set
# raster.max_per_tile, all to 512; 2,048 is above every tile's count at the
# headline view (1,229 at rest).
JNP_CAP = 512
JNP_HIGH = 2048


def jnp_phase(report, scenes, rec, init_v) -> bool:
    """Phase 21: ``RasterConfig(backend="jnp")`` (see the module docstring)."""
    from neuma_tpu_torch.render import raster_kernel as rk
    from neuma_tpu_torch.render.rasterize import rasterize
    from neuma_tpu_torch.train.grounding import BENCH_SHAPES, make_rollout_loss

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    hp = BENCH_SHAPES["headline"]
    h = scenes["headline"]
    frames = hp["frames"]

    def with_jnp(scene, cap):
        return dataclasses.replace(scene, raster_cfg=dataclasses.replace(
            scene.raster_cfg, backend="jnp", max_per_tile=cap))

    equal = lambda xs, ys: all(torch.equal(x, y) for x, y in zip(xs, ys))

    # (a) a cap above every tile: one render's value-and-grad and the
    # rollout's, each bitwise the default path's
    g, cam = h.gaussians, h.cameras[0]
    w = torch.randn((3, cam.height, cam.width),
                    generator=torch.Generator().manual_seed(21)).to("cuda")

    def render_vg(scene):
        leaves = [t.detach().clone().requires_grad_(True) for t in (
            g.xyz, g.get_covariance(h.scaling_modifier), g.get_opacity, g.get_features)]
        img = rasterize(leaves[0], leaves[1], leaves[2], cam, h.background, shs=leaves[3],
                        sh_degree=g.sh_degree, cfg=scene.raster_cfg)
        return [img.detach()] + list(torch.autograd.grad((w * img).sum(), leaves))

    h_high = with_jnp(h, JNP_HIGH)
    render_auto = render_vg(h)
    render_jnp, render_launches = counted(render_vg, h_high)
    h_args = (init_v, torch.ones(frames, device="cuda"),
              torch.zeros((frames, 1, 3, hp["height"], hp["width"]), device="cuda"))
    loss_a, aux_a, grads_a = value_and_grad_fn(h, "cuda")(*h_args)
    (loss_j, aux_j, grads_j), launches = counted(value_and_grad_fn(h_high, "cuda"), *h_args)
    per_view = frames * hp["n_views"]
    ok_a = (equal(render_auto, render_jnp) and bool(torch.equal(loss_a, loss_j))
            and equal(grads_a, grads_j) and bool(aux_a["overflow"]) == bool(aux_j["overflow"])
            and render_launches.get("composite") == 1 and render_launches.get("composite_bwd") == 1
            and launches.get("composite") == per_view and launches.get("composite_bwd") == per_view)
    log(f"[jnp:high] max_per_tile {JNP_HIGH}: one render's image and 4 gradients bitwise the "
        f"default's {equal(render_auto, render_jnp)} (launches {render_launches}); rollout "
        f"value-and-grad loss bitwise {bool(torch.equal(loss_a, loss_j))}, "
        f"{sum(torch.equal(a, b) for a, b in zip(grads_a, grads_j))} of {len(grads_a)} "
        f"gradient leaves bitwise, launches {launches} ({per_view} views rendered)")

    # (b) the configs' cap at the headline and realworld first views
    views = {}
    ok_b = True
    for tag in ("headline", "realworld"):
        scene = scenes[tag]
        full = composite_inputs(scene, torch.Generator().manual_seed(21))
        cut = composite_inputs(scene, torch.Generator().manual_seed(21), max_per_tile=JNP_CAP)
        ctag = f"{tag}_jnp{JNP_CAP}"
        ok_b &= check_composite(ctag, cut, rec)
        log_checks(ctag, rec, KERNELS[3:])
        raw, kept = full["counts"].to(torch.int64), cut["counts"].to(torch.int64)
        args = (full["pf"], full["tile_start"], full["counts"], full["tiles_x"])
        with torch.no_grad():
            T, _, lk = rk.composite_fwd(*args)
            a5 = (*args[:3], T, lk, full["dT"], full["dC"], full["tiles_x"])
            b4, b5 = composite_bounds(full["tile_start"], full["counts"], lk)
            k4_ms = cuda_ms(lambda: rk.composite_fwd(*args), 20)
            k5_ms = cuda_ms(lambda: rk.composite_bwd(*a5), 20)
        c4, c5 = rec["composite"][ctag], rec["composite_bwd"][ctag]
        v = dict(tiles=int(raw.numel()), tiles_cut=int((raw > JNP_CAP).sum()),
                 pairs=int(raw.sum()), pairs_dropped=int(raw.sum() - kept.sum()),
                 deepest_before=int(raw.max()), deepest_after=int(kept.max()),
                 overflow_budget=full["raster_overflow"], overflow=cut["raster_overflow"],
                 k4_ms=c4["ms"], k4_bound_ms=c4["bound_ms"], k5_ms=c5["ms"],
                 k5_bound_ms=c5["bound_ms"], k4_ms_uncapped=k4_ms, k4_bound_ms_uncapped=b4[0],
                 k5_ms_uncapped=k5_ms, k5_bound_ms_uncapped=b5[0])
        views[tag] = v
        ok_b &= v["overflow"]
        log(f"[jnp:{tag}] max_per_tile {JNP_CAP}: {v['tiles_cut']} of {v['tiles']} tiles cut, "
            f"{v['pairs_dropped']} of {v['pairs']} pairs dropped by the cap, deepest tile "
            f"{v['deepest_before']} -> {v['deepest_after']}; overflow {v['overflow']} (max_pairs "
            f"alone {v['overflow_budget']}); K4 {v['k4_ms']:.4f} ms (bound "
            f"{v['k4_bound_ms']:.5f}) capped, {k4_ms:.4f} ms (bound {b4[0]:.5f}) uncapped; K5 "
            f"{v['k5_ms']:.4f} ms (bound {v['k5_bound_ms']:.5f}) capped, {k5_ms:.4f} ms (bound "
            f"{b5[0]:.5f}) uncapped; {smi}")

    # (c) the headline rollout forward at the configs' cap
    fwd = lambda scene: torch.no_grad()(make_rollout_loss(scene, device="cuda"))
    (loss_c, aux_c), sec_c, launches_c = timed(fwd(with_jnp(h, JNP_CAP)), h_args)
    _, sec_auto, _ = timed(fwd(h), h_args)
    ms_c, ms_auto = sec_c / frames * 1e3, sec_auto / frames * 1e3
    ok_c = bool(torch.isfinite(loss_c)) and bool(aux_c["overflow"])
    log(f"[jnp:rollout] headline forward, max_per_tile {JNP_CAP}: loss {float(loss_c):.6f} "
        f"overflow {bool(aux_c['overflow'])} {ms_c:.2f} ms/frame (auto now {ms_auto:.2f}, phase 3 "
        f"{report['headline']['ms_per_frame']:.2f}) launches {launches_c}")
    out = dict(nvidia_smi=smi, launches=launches, render_launches=render_launches, views=views,
               rollout=dict(loss=float(loss_c), ms_per_frame=ms_c, auto_ms_per_frame=ms_auto,
                            launches=launches_c),
               seconds=time.perf_counter() - t_phase)
    report["jnp"] = out
    log(f"[jnp] {smi}; (a) {ok_a} (b) {ok_b} (c) {ok_c}; phase {out['seconds']:.1f} s")
    ok = ok_a and ok_b and ok_c
    if not ok:
        log("[jnp] FAILED")
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
    ok &= svd3_checks(report)
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
    report["roofline"] = {"headline": roofline_share("headline", h_scene, hp, ms_h, 1.0, smi)}
    if report["roofline"]["headline"] is None:
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
    report["roofline"]["realworld"] = roofline_share("realworld", scenes["realworld"], rp, ms_r,
                                                     1.0, smi)
    if report["roofline"]["realworld"] is None:
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
    # 16. the viewer CLI
    lora = sorted((REPO / "build" / "chip_smoke_app" / "logs" / "bb" / "finetune").glob(
        "*_lora.npz"))[-1] if ok_app else None
    ok_view = ok_regist and view_phase(report, REPO / "build" / "chip_smoke_serve", lora)
    # 17. scale-out
    ok_halo = ok_view and halo_phase(report)
    # 18. the particle-sharded replicated-grid rollout
    ok_rep = ok_halo and replicated_phase(report)
    # 19. the port's end-to-end example
    ok_e2e = ok_rep and smoke_e2e_phase(report)
    # 20. the image tiles over ranks
    ok_tiles = ok_e2e and tile_phase(report)
    # 21. the jnp backend
    ok_jnp = ok_tiles and jnp_phase(report, scenes, rec, init_v)
    report.update(kernels=rec, launches_train_headline=launches,
                  seconds=time.perf_counter() - t_start)
    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if not ok:
        log("[train] FAILED")
        return 1
    if not (ok_dense and ok_app and ok_serve and ok_regist and ok_view and ok_halo and ok_rep
            and ok_e2e and ok_tiles and ok_jnp):
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
            "launches_view": report["view"]["launches"].get(name, 0),
            "launches_halo_rank0": report["halo"]["four"]["ranks"][0]["launches"].get(name, 0),
            "launches_replicated_rank0":
                report["replicated"]["four"]["ranks"][0]["launches"].get(name, 0),
            "launches_smoke_e2e": report["smoke_e2e"]["launches"].get(name, 0),
            "launches_tile_rank0": report["tiles"]["rollout"]["ranks"][0]["launches"].get(name, 0),
            "launches_jnp": report["jnp"]["launches"].get(name, 0),
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
