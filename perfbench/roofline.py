"""The yardstick: a frozen copy of the port's roofline models
(``neuma_tpu_torch/utils/roofline.py``) and the H100 SXM's data-sheet
peaks, kept here so that no change to the program moves them.

Each model returns ``(flops, bytes)`` for the algorithmic minimum of a
phase; ``sol_time`` turns that into the least time the card could take.
The sim and the materials run in full FP32 (no TF32), so their
bound is the FP32 peak outside the tensor cores. The peaks assume the
card's full 700 W; a card set lower reaches less, so the benchmark
reports its power limit beside every share.
"""
from __future__ import annotations

H100_SXM = {"name": "h100-sxm", "bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bps": 3.35e12}

# per-particle f32 state traffic of one MPM step: read x v C F stress vol+rho; write v C F x
_P_READ = 140
_P_WRITE = 96


def sol_time(flops: float, bytes_: float, chip: dict = H100_SXM) -> float:
    """max(compute, memory) in seconds, at the FP32 peak."""
    return max(flops / chip["f32_flops"], bytes_ / chip["hbm_bps"])


def p2g(n: int, grid: int):
    """27-tap APIC scatter: ~35 flops a tap; particle inputs once and the
    4-channel grid written once."""
    return 27.0 * n * 35.0, n * _P_READ + grid ** 3 * 4 * 4


def grid_op(grid: int):
    g3 = grid ** 3
    return 12.0 * g3, 2.0 * g3 * 4 * 4


def g2p(n: int, grid: int):
    """27-tap gather, affine and velocity update and the F update."""
    return 27.0 * n * 30.0 + n * 100.0, grid ** 3 * 3 * 4 + n * (_P_READ + _P_WRITE)


def sim_step(n: int, grid: int):
    f1, b1 = p2g(n, grid)
    f2, b2 = grid_op(grid)
    f3, b3 = g2p(n, grid)
    return f1 + f2 + f3, b1 + b2 + b3


def material_mlp(n: int, widths=(64, 64), feat_in: int = 5, feat_out: int = 9, lora_r: int = 16):
    dims = (feat_in, *widths, feat_out)
    mm = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    lora = sum(lora_r * (a + b) for a, b in zip(dims[:-1], dims[1:]))
    return 2.0 * n * (mm + lora), n * (feat_in + feat_out) * 4 + (mm + lora) * 4


def svd3(n: int):
    return 500.0 * n, n * 24 * 4


def composite(n_pairs: int, width: int, height: int, tile: int = 16):
    """Every (pair, pixel of its tile): ~25 flops; the pair payload once
    and the image with its T and index maps."""
    return n_pairs * tile * tile * 25.0, n_pairs * 36.0 + width * height * (3 + 2) * 4


def pair_build(n_pairs: int, max_pairs: int):
    return 0.0, 4 * 2.0 * max_pairs * 8.0


def projection(n: int):
    return 200.0 * n, n * (9 + 3 + 3 + 1 + 1) * 4 * 2


def sh_eval(n: int, sh_degree: int = 3):
    k = (sh_degree + 1) ** 2
    return n * k * 3 * 2.0 + n * k * 8.0, n * (k * 3 + 3) * 4


def grounding_step_frame(n_particles: int, grid: int, img_w: int, img_h: int, n_pairs: int,
                         max_pairs: int, substeps: int = 1, n_views: int = 1,
                         bwd_factor: float = 3.0) -> float:
    """Least time of one grounding frame: material MLPs, SVD and sim step
    per substep, then per view projection, SH, pair build, compositing and
    the loss; the differentiated phases charged ``bwd_factor`` times."""
    n = n_particles
    t = 0.0
    for f, b in (sim_step(n, grid), material_mlp(n), material_mlp(n), svd3(n)):
        t += sol_time(f * bwd_factor * substeps, b * bwd_factor * substeps)
    per_view = 0.0
    for f, b in (projection(n), sh_eval(n), composite(n_pairs, img_w, img_h)):
        per_view += sol_time(f * bwd_factor, b * bwd_factor)
    f, b = pair_build(n_pairs, max_pairs)
    per_view += sol_time(f, b)
    per_view += sol_time(img_w * img_h * 3 * 4.0, img_w * img_h * 3 * 4 * 2.0)
    return t + n_views * per_view
