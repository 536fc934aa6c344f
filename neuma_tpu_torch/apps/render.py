"""Forward rollout and rendering CLI (no gradients).

Counterpart of ``neuma_tpu/apps/render.py`` and of the reference's
``experiments/render.py``: load the prepared data, the learned initial
velocity and optional LoRA weights, run the MPM rollout, render the
chosen views every frame, and write PNGs, optional particle PLYs and one
video (or GIF) per view. Usage:

    python -m neuma_tpu_torch.apps.render -c config.yaml -vn out \\
        [-s eval_steps] [-l lora.npz|lora.pt] [-dv view ...] [-sp particles_dir]

Frames go to ``<root>/<name>/results/<video_name>/{view}_{step:04d}.png``
and the world-space particles to ``.../<save_particles>/particles_{step:04d}.ply``.
On grids above 24 cells one block sort is carried across the rollout
and refreshed per step. ``main(argv, device)`` runs on ``cuda`` unless
``device="cpu"`` is passed; without a CUDA device it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import ParticleState
from ..data.ply import save_ply_points
from ..data.readers import VideoDataset
from ..parallel.distributed import initialize
from ..render.binding import apply_binding_F, apply_binding_xyz, deform_cov_by_F
from ..render.rasterize import rasterize_with_aux
from ..sim.mpm import mpm_step
from ..sim.p2g_kernel import build_step_layouts, refresh_step_layouts
from ..sim.rollout import denormalize_points
from ..utils.config import load_config
from ..utils.video import save_video
from .common import (
    OverflowWarning,
    ServeResult,
    assemble_scene,
    background_color,
    build_materials,
    load_lora,
    run_data_preparation,
    sync,
    to_uint8,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", "-c", type=str, required=True)
    p.add_argument("--eval_steps", "-s", type=int, default=600)
    p.add_argument("--skip_frames", "-f", type=int, default=1)
    p.add_argument("--init_frame", type=int, default=None)
    p.add_argument("--load_lora", "-l", type=str, default=None)
    p.add_argument("--video_name", "-vn", type=str, required=True)
    p.add_argument("--sim_dt", "-dt", type=float, default=None)
    p.add_argument("--debug_views", "-dv", nargs="+", default=[])
    p.add_argument("--save_particles", "-sp", type=str, default=None)
    p.add_argument(
        "--change_base_model", "-cbm", type=str, default=None,
        help="Replace the pretrained base model for rendering.",
    )
    p.add_argument("--alpha", type=float, default=None, help="Rewrite the plasticity adaptor alpha.")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--set", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv=None, device=None) -> ServeResult:
    args = parse_args(argv)
    device = resolve_device(device)
    cfg = load_config(args.config, args.set)
    initialize(device)
    if args.sim_dt is not None:
        cfg.sim.dt = args.sim_dt
    if args.change_base_model is not None:
        cfg.pretrained_ckpt = args.change_base_model
    if args.alpha is not None:
        cfg.constitution.plasticity.alpha = args.alpha

    exp_root = Path(cfg.root) / cfg.name
    result_root = exp_root / "results"
    result_root.mkdir(parents=True, exist_ok=True)
    data_root = Path(cfg.get("data_root", exp_root / "sim_data"))
    data_root.mkdir(parents=True, exist_ok=True)

    background, force_mask = background_color(cfg)
    run_data_preparation(cfg, data_root, device=device)

    # Only the init frame's cameras are needed.
    vd_cfg = cfg.video_data.to_dict()
    if args.init_frame is not None:
        vd_cfg["data"]["init_frame"] = args.init_frame
    dataset = VideoDataset(vd_cfg)

    elasticity, plasticity = build_materials(cfg)
    views = args.debug_views or dataset.views
    scene, _, init_data = assemble_scene(
        cfg, data_root, dataset, elasticity, plasticity, num_frames=1, substeps=1,
        used_views=sorted(views)[:1], pixel_loss="l2", background=background,
        force_mask=force_mask, device=device,
    )
    cameras = {v: dataset.get(v, dataset.steps[0]).camera.to(device) for v in views}
    if args.load_lora:
        load_lora(scene.elasticity, scene.plasticity, args.load_lora,
                  int(cfg.constitution.lora.r), float(cfg.constitution.lora.alpha),
                  int(cfg.get("seed", 42)))

    # init state: the learned velocity when present
    init_path = exp_root / "finetune" / "init.npz"
    if init_path.is_file():
        d = np.load(init_path)
        init_x = torch.as_tensor(np.asarray(d["init_x"], np.float32), device=device)
        init_v = torch.as_tensor(np.asarray(d["init_v"], np.float32), device=device)
    else:
        init_x = scene.init_x
        init_v = torch.zeros(3, device=device)
    n = init_x.shape[0]
    state = ParticleState.initial(init_x, init_v.reshape(-1, 3).expand(n, 3).contiguous())

    skip = int(cfg.sim.get("skip_frame", 1))
    with torch.no_grad():
        return _rollout(args, scene, state, cameras, scene.background, force_mask, init_data,
                        result_root, skip, device)


def _rollout(args, scene, state, cameras, background, force_mask, init_data, result_root,
             skip, device):
    from PIL import Image

    constants, statics = scene.constants, scene.statics
    elasticity, plasticity = scene.elasticity, scene.plasticity
    cov0 = scene.gaussians.get_covariance(scene.scaling_modifier)
    opacity = scene.gaussians.get_opacity
    shs = scene.gaussians.get_features
    colors = torch.ones((cov0.shape[0], 3), device=device) if force_mask else None

    # One block sort carried across the rollout, refreshed per step.
    layouts = build_step_layouts(constants, state.x) if constants.num_grids > 24 else None

    def sim_frame(state, layouts):
        if layouts is not None:
            layouts, _ = refresh_step_layouts(constants, state.x, layouts)
        new = mpm_step(constants, statics, state, elasticity(state.F), layouts)
        return dataclasses.replace(new, F=plasticity(new.F)), layouts

    def render_frame(means3d, cov_def, cam):
        if force_mask:
            return rasterize_with_aux(means3d, cov_def, opacity, cam, background,
                                      colors_precomp=colors, cfg=scene.raster_cfg)
        return rasterize_with_aux(means3d, cov_def, opacity, cam, background, shs=shs,
                                  sh_degree=scene.gaussians.sh_degree, cfg=scene.raster_cfg)

    check_overflow = OverflowWarning()
    frames_dir = result_root / args.video_name
    frames_dir.mkdir(exist_ok=True)
    if args.save_particles:
        particles_dir = result_root / args.save_particles
        particles_dir.mkdir(exist_ok=True)

    result = ServeResult(frames_dir, [], [], [], [], {v: [] for v in cameras}, False)
    de_x_prev = denormalize_points(state.x, init_data.size, init_data.center)
    g_prev = scene.gaussians.xyz
    for step in range(1, args.eval_steps + 1):
        t0 = time.perf_counter()
        state, layouts = sim_frame(state, layouts)
        sync(device)
        result.sim_ms.append((time.perf_counter() - t0) * 1e3)
        if step % skip != 0:
            continue
        de_x = denormalize_points(state.x, init_data.size, init_data.center)
        means3d = apply_binding_xyz(scene.binding, de_x, de_x_prev, g_prev)
        cov_def = deform_cov_by_F(cov0, apply_binding_F(scene.binding, state.F))
        for view, cam in cameras.items():
            t0 = time.perf_counter()
            img, aux = render_frame(means3d, cov_def, cam)
            sync(device)
            result.render_ms[view].append((time.perf_counter() - t0) * 1e3)
            check_overflow(aux, f"step {step} view {view}")
            path = frames_dir / f"{view}_{step:04d}.png"
            Image.fromarray(to_uint8(img)).save(path)
            result.frames.append(path)
        if args.save_particles:
            path = particles_dir / f"particles_{step:04d}.ply"
            save_ply_points(path, de_x.cpu().numpy())
            result.particles.append(path)
        de_x_prev = de_x
        g_prev = means3d

    for view in cameras:
        result.videos.append(save_video(
            frames_dir, f"{view}_*.png", result_root / f"{args.video_name}_{view}.mp4",
            skip_frame=args.skip_frames, fps=args.fps,
        ))
    result.overflow = check_overflow.warned
    print(f"Render finished -> {result_root}")
    return result


if __name__ == "__main__":
    main()
