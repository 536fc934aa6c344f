"""Analytic speed-of-light (roofline) models for the hot phases.

Counterpart of ``neuma_tpu/utils/roofline.py``: the same models with the
same formulae and signatures. Each returns ``(flops, bytes)`` for the
*algorithmic minimum* work of a phase — the taps/pairs/pixels that must
be touched and the HBM traffic that must move, NOT the work the kernels
happen to do. ``sol_time`` turns that into a lower-bound time on the
card; ``sol / achieved`` is then the share of the roofline (wasted
kernel work counts as inefficiency, never as progress).

The models are plain Python on floats; only ``sol_time`` reads a chip.
The one chip is the NVIDIA H100 SXM, from NVIDIA's H100 data sheet:
989 TFLOP/s dense BF16 on the tensor cores, 67 TFLOP/s FP32 outside
them (the sim and the materials contract in full FP32, no TF32), and
3.35 TB/s of HBM3.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipPeaks:
    name: str
    bf16_flops: float
    f32_flops: float
    hbm_bps: float


H100_SXM = ChipPeaks(
    name="h100-sxm",
    bf16_flops=989e12,
    f32_flops=67e12,
    hbm_bps=3.35e12,
)


def sol_time(
    flops: float, bytes_: float, f32: bool = True, chip: ChipPeaks = H100_SXM
) -> float:
    """max(compute, memory) lower bound in seconds."""
    peak = chip.f32_flops if f32 else chip.bf16_flops
    return max(flops / peak, bytes_ / chip.hbm_bps)


# Per-particle f32 state traffic for one MPM step:
# read x(12) v(12) C(36) F(36) stress(36) vol+rho(8); write v C F x.
_P_READ = 140
_P_WRITE = 96


def p2g(n: int, grid: int) -> tuple[float, float]:
    """27-tap APIC scatter (mass + momentum). Per tap: 3-axis weight
    product (4), mass mul-add (2), momentum b + A@dpos then *W and
    accumulate (~29) => ~35 flops. Minimal traffic: particle inputs once
    + the 4-channel grid written once."""
    flops = 27.0 * n * 35.0
    bytes_ = n * _P_READ + grid**3 * 4 * 4
    return flops, bytes_


def grid_op(grid: int) -> tuple[float, float]:
    """Momentum->velocity + gravity + BC: ~12 flops/cell, grid read+write."""
    g3 = grid**3
    return 12.0 * g3, 2.0 * g3 * 4 * 4


def g2p(n: int, grid: int) -> tuple[float, float]:
    """27-tap gather + affine/velocity update + F update (3x3 matmul,
    ~45) => ~30 flops/tap + 100. Minimal traffic: grid velocities read
    once + particle state read/write."""
    flops = 27.0 * n * 30.0 + n * 100.0
    bytes_ = grid**3 * 3 * 4 + n * (_P_READ + _P_WRITE)
    return flops, bytes_


def sim_step(n: int, grid: int) -> tuple[float, float]:
    f1, b1 = p2g(n, grid)
    f2, b2 = grid_op(grid)
    f3, b3 = g2p(n, grid)
    return f1 + f2 + f3, b1 + b2 + b3


def material_mlp(n: int, widths=(64, 64), feat_in: int = 5,
                 feat_out: int = 9, lora_r: int = 16) -> tuple[float, float]:
    """Per-particle meta-material MLP (elasticity or plasticity) with
    LoRA branches: 2*N*sum(fan_in*fan_out) flops; params stream from
    HBM once per batch, activations stay on chip."""
    dims = (feat_in, *widths, feat_out)
    mm = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    lora = sum(lora_r * (a + b) for a, b in zip(dims[:-1], dims[1:]))
    flops = 2.0 * n * (mm + lora)
    bytes_ = n * (feat_in + feat_out) * 4 + (mm + lora) * 4
    return flops, bytes_


def svd3(n: int) -> tuple[float, float]:
    """Batched 3x3 Jacobi SVD: ~500 flops/matrix, stream 9+15 f32."""
    return 500.0 * n, n * 24 * 4


def composite(n_pairs: int, width: int, height: int,
              tile: int = 16) -> tuple[float, float]:
    """Tile compositing: every (pair, pixel-in-tile) does the conic
    quadratic form + exp + alpha blend (~25 flops). Minimal traffic:
    per-pair payload (mean2d, conic, opacity, rgb = 36B) once + the
    image + final T/index maps."""
    flops = n_pairs * tile * tile * 25.0
    bytes_ = n_pairs * 36.0 + width * height * (3 + 2) * 4
    return flops, bytes_


def pair_build(n_pairs: int, max_pairs: int) -> tuple[float, float]:
    """Dominated by one sort of the static pair buffer: uint32 keys,
    charged at the radix bound of 4 passes reading and writing keys +
    index payload."""
    del n_pairs
    passes = 4
    return 0.0, passes * 2.0 * max_pairs * 8.0


def projection(n: int) -> tuple[float, float]:
    """Per-gaussian EWA projection (~200 flops: two 3x3 products,
    inverse, eigen bound), stream cov+mean in, conic/depth/radius out."""
    return 200.0 * n, n * (9 + 3 + 3 + 1 + 1) * 4 * 2


def sh_eval(n: int, sh_degree: int = 3) -> tuple[float, float]:
    k = (sh_degree + 1) ** 2
    return n * k * 3 * 2.0 + n * k * 8.0, n * (k * 3 + 3) * 4


def grounding_step_frame(
    n_particles: int,
    grid: int,
    img_w: int,
    img_h: int,
    n_pairs: int,
    max_pairs: int,
    substeps: int = 1,
    n_views: int = 1,
    bwd_factor: float = 3.0,
) -> float:
    """Analytic lower bound (seconds) for ONE grounding frame: material
    MLPs + svd3 + sim step (x substeps), binding, projection, SH, pair
    build, compositing, loss — forward AND backward (backward charged
    at the standard 3x fwd for the differentiated phases; the pair
    build runs forward-only, its layout saved for the backward)."""
    n = n_particles
    t = 0.0
    for f, b in (
        sim_step(n, grid),
        material_mlp(n),
        material_mlp(n),
        svd3(n),
    ):
        t += sol_time(f * bwd_factor * substeps, b * bwd_factor * substeps)
    per_view = 0.0
    for f, b in (
        projection(n),
        sh_eval(n),
        composite(n_pairs, img_w, img_h),
    ):
        per_view += sol_time(f * bwd_factor, b * bwd_factor)
    f, b = pair_build(n_pairs, max_pairs)
    per_view += sol_time(f, b)
    # l2 loss + image reductions
    per_view += sol_time(img_w * img_h * 3 * 4.0,
                         img_w * img_h * 3 * 4 * 2.0)
    return t + n_views * per_view
