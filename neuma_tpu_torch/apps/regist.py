"""Real-capture registration CLI: fit one Sim(3) that aligns the raw 3DGS
reconstruction to the first video frame, then move the mesh's sampled
particles by it.

Counterpart of ``neuma_tpu/apps/regist.py`` and of the reference's
``experiments/regist.py``, with its two idempotent stages:

A. ``register_gaussians`` on the first frame of every view ->
   ``registered_params.npz`` (``r``, ``t``, ``s``, ``origin``) and
   ``registered_kernels.ply``; skipped when both files exist (either
   package's files will do);
B. the mesh sampled by ``particle_data`` and moved by the same Sim(3) ->
   ``registered_particles.ply``; skipped when that file exists.

Usage:

    python -m neuma_tpu_torch.apps.regist -c configs/realworld/regist-bun.yaml \\
        [--set key.path=value ...]

``register.log_every`` (default 500, the JAX function's) sets how often
the loss is read and printed. ``main(argv, device)`` runs on ``cuda``
unless ``device="cpu"`` is passed; without a CUDA device it raises. It
returns a ``RegistRun`` (the fitted params, the logged losses and the
host clock at each log point, and each stage's seconds).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.ply import save_ply_points
from ..data.readers import VideoDataset
from ..data.sampling import sample_particles
from ..interop import sim3_params_from_numpy
from ..render.gaussians import GaussianPack
from ..render.rasterize import RasterConfig
from ..train.register import RegisterConfig, apply_sim3, apply_sim3_points, register_gaussians
from ..utils.config import load_config
from ..utils.logging import Logger
from .common import background_color


@dataclasses.dataclass
class RegistRun:
    params: dict  # numpy r, t, s
    origin: np.ndarray  # (1, 3)
    losses: List[float]  # empty when stage A was skipped
    log_times: List[float]  # host clock (s) at each log point
    log_iters: List[int]
    stage_a_s: Optional[float]  # None when skipped
    stage_b_s: Optional[float]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", "-c", type=str, required=True)
    p.add_argument("--set", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv=None, device=None) -> RegistRun:
    args = parse_args(argv)
    device = resolve_device(device)
    cfg = load_config(args.config, args.set)
    exp_root = Path(cfg.root) / cfg.name
    exp_root.mkdir(parents=True, exist_ok=True)
    cfg.save(exp_root / "config.yaml")
    logger = Logger.tee(exp_root / "log.txt")
    try:
        return _run(cfg, exp_root, device)
    finally:
        logger.close()


def _run(cfg, exp_root: Path, device) -> RegistRun:
    params_path = exp_root / "registered_params.npz"
    kernels_path = exp_root / "registered_kernels.ply"
    particles_path = exp_root / "registered_particles.ply"
    background, _ = background_color(cfg)
    losses, log_times, log_iters, stage_a_s, stage_b_s = [], [], [], None, None

    # Stage A: fit the Sim(3) on the first frame (idempotent).
    if params_path.is_file() and kernels_path.is_file():
        print("Registration already done; loading saved Sim(3).")
        d = np.load(params_path)
        params_np, origin = {k: d[k] for k in ("r", "t", "s")}, d["origin"]
    else:
        t0 = time.perf_counter()
        vd_cfg = cfg.video_data.to_dict()
        vd_cfg["data"]["init_frame"] = vd_cfg["data"].get("init_frame", 0)
        dataset = VideoDataset(vd_cfg)
        first_step = dataset.steps[0]
        cameras = [dataset.get(v, first_step).camera for v in dataset.views]
        gt = torch.as_tensor(np.stack([dataset.get(v, first_step).image for v in dataset.views]))
        pack = GaussianPack.from_ply(cfg.gaussian.kernels_path, cfg.gaussian.sh_degree,
                                     device=device)
        reg = cfg.register
        raster = cfg.get("raster", {})
        rcfg = RasterConfig(max_pairs=int(raster.get("max_pairs", 1 << 18)),
                            max_per_tile=int(raster.get("max_per_tile", 512)))

        def log_fn(i, loss, _params):
            log_times.append(time.perf_counter())
            log_iters.append(i)
            print(f"[regist] iter {i} loss {loss:.5f}")

        fit_cfg = RegisterConfig(
            init_r_deg=tuple(reg.get("INIT_R", (0, 0, 0))),
            init_t=tuple(reg.get("INIT_T", (0, 0, 0))),
            init_s=float(reg.get("INIT_S", 1.0)),
            lr_r=float(reg.get("lr_r", 1e-3)),
            lr_t=float(reg.get("lr_t", 1e-3)),
            lr_s=float(reg.get("lr_s", 1e-3)),
            iterations=int(reg.get("iterations", 20000)),
            lambda_dssim=float(reg.get("lambda_dssim", 0.0)),
            learning_rate_alpha=float(reg.get("scheduler", {}).get("learning_rate_alpha", 0.05)),
        )
        result = register_gaussians(pack, cameras, gt, fit_cfg, background,
                                    raster_cfg=rcfg, log_fn=log_fn,
                                    log_every=int(reg.get("log_every", 500)), device=device)
        losses, params_np, origin = result.losses, result.params, result.origin
        np.savez(params_path, **params_np, origin=origin)
        with torch.no_grad():
            apply_sim3(sim3_params_from_numpy(params_np, device), pack).to_ply(kernels_path)
        print(f"Saved registered kernels -> {kernels_path}")
        stage_a_s = time.perf_counter() - t0

    # Stage B: sample mesh particles and apply the same Sim(3) (idempotent).
    if particles_path.is_file():
        print("Registered particles already exist; skipping.")
    else:
        t0 = time.perf_counter()
        pd = cfg.particle_data
        particles = sample_particles(pd.mesh_path, pd.mesh_sample_mode,
                                     pd.mesh_sample_resolution).astype(np.float32)
        with torch.no_grad():
            moved = apply_sim3_points(
                sim3_params_from_numpy(params_np, device),
                torch.as_tensor(particles, device=device),
                torch.as_tensor(np.asarray(origin, np.float32), device=device),
            ).cpu().numpy()
        save_ply_points(particles_path, moved)
        print(f"Saved {len(moved)} registered particles -> {particles_path}")
        stage_b_s = time.perf_counter() - t0
    return RegistRun(params=params_np, origin=np.asarray(origin), losses=losses,
                     log_times=log_times, log_iters=log_iters, stage_a_s=stage_a_s,
                     stage_b_s=stage_b_s)


if __name__ == "__main__":
    main()
