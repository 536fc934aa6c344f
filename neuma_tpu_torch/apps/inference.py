"""Multi-object generalization rollout CLI.

Counterpart of ``neuma_tpu/apps/inference.py`` and of the reference's
``experiments/inference.py``: N objects, each with its own prepared
Gaussians, binding, base materials (a reference ``.pt``) and optional
LoRA, concatenated into one particle system whose sections
``ComposeMaterial`` routes to each object's materials; random initial
velocities (``sample_vel``) where an object gives none; Gaussians moved
into the sim box unless ``denormalize``; a render of every view each
step and an optional particle export. Usage:

    python -m neuma_tpu_torch.apps.inference -c configs/demo/multiobj-bb-cc.yaml \\
        -vn out [-s eval_steps] [-dv view ...] [-sp particles_dir]

Frames go to ``<root>/<video_name>/images/{view}_{step:03d}.png`` (frame
0 undeformed), the sim-box positions to
``<root>/<video_name>/<save_particles>/{first_step + step:03d}.ply``.
Every object is enabled on [0, eval_steps), so the last step moves no
particle, as in the JAX package. ``main(argv, device)`` runs on
``cuda`` unless ``device="cpu"`` is passed; without a CUDA device it
raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import MPMConstants
from ..data.ply import save_ply_points
from ..data.prepare import load_prepared
from ..data.readers import VideoDataset
from ..data.torch_ckpt import load_torch_file, mlp_params_from_state_dict
from ..materials import (
    ComposeMaterial,
    InvariantFullMetaElasticity,
    InvariantFullMetaPlasticity,
    MetaMaterialConfig,
)
from ..render.binding import apply_binding_F, apply_binding_xyz, deform_cov_by_F
from ..render.gaussians import GaussianPack
from ..render.rasterize import RasterConfig, rasterize_with_aux
from ..render.transforms import transform_gaussians
from ..sim.initializers import MPMInitData, build_initial_state, build_statics
from ..sim.mpm import mpm_step
from ..sim.p2g_kernel import build_step_layouts, refresh_step_layouts
from ..utils.config import Config, load_config
from ..utils.video import save_video
from .common import (
    TRAIN_EPS,
    OverflowWarning,
    ServeResult,
    background_color,
    load_lora,
    run_data_preparation,
    sync,
    to_uint8,
)


def sample_vel(cfg=None, seed=None):
    """Random initial (linear, angular) velocities from numpy's PCG64 (the
    reference's ``nclaw/utils.py``; the same draws as the JAX package)."""
    rng = np.random.Generator(np.random.PCG64(seed if seed is not None else 42))
    lin_dir = rng.uniform(-1, 1, size=3)
    if lin_dir[1] > 0:
        lin_dir[1] = -lin_dir[1]
    lin_dir /= np.linalg.norm(lin_dir)
    lin_bound = cfg["lin_vel_bound"] if cfg and "lin_vel_bound" in cfg else (0.5, 1.5)
    ang_bound = cfg["ang_vel_bound"] if cfg and "ang_vel_bound" in cfg else (-6.0, 6.0)
    lin_vel = lin_dir * rng.uniform(*lin_bound)
    ang_vel = rng.uniform(*ang_bound, size=3)
    return lin_vel, ang_vel


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", "-c", type=str, required=True)
    p.add_argument("--eval_steps", "-s", type=int, default=600)
    p.add_argument("--skip_frames", "-f", type=int, default=1)
    p.add_argument("--video_name", "-vn", type=str, required=True)
    p.add_argument("--debug_views", "-dv", nargs="+", default=[])
    p.add_argument("--save_particles", "-sp", type=str, default=None)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--set", nargs="*", default=[])
    return p.parse_args(argv)


def _load_object(obj_cfg: Config, eval_steps: int, seed: int, device) -> dict:
    """One object's prepared data, materials (base ``.pt`` plus optional
    LoRA) and particle group."""
    data_root = Path(obj_cfg.get("data_root", f"assets/{obj_cfg.sim_data_name}"))
    data_root.mkdir(parents=True, exist_ok=True)
    run_data_preparation(obj_cfg, data_root, device=device)
    gaussians, _, table = load_prepared(data_root, obj_cfg.gaussian.sh_degree, device=device)

    e_cfg = MetaMaterialConfig.from_cfg(obj_cfg.constitution.elasticity)
    p_cfg = MetaMaterialConfig.from_cfg(obj_cfg.constitution.plasticity)
    n_layers = len(e_cfg.layer_widths)
    ckpt = load_torch_file(obj_cfg.pretrained_ckpt)
    elasticity = InvariantFullMetaElasticity(
        e_cfg, mlp_params_from_state_dict(ckpt["elasticity"], n_layers)).to(device)
    plasticity = InvariantFullMetaPlasticity(
        p_cfg, mlp_params_from_state_dict(ckpt["plasticity"], n_layers)).to(device)

    lora_path = obj_cfg.constitution.get("load_lora")
    if lora_path:
        load_lora(elasticity, plasticity, lora_path, int(obj_cfg.constitution.lora.r),
                  float(obj_cfg.constitution.lora.alpha), seed)
        print(f"Loaded lora weights from {lora_path}")

    pd = obj_cfg.particle_data.copy()
    pd.span = [0, eval_steps]
    pd.shape.name = "particles"
    pd.shape.asset_root = str(data_root)
    init_data = MPMInitData.from_cfg(pd.to_dict())
    vel_cfg = obj_cfg.particle_data.get("vel")
    if vel_cfg is not None:
        init_data.set_lin_vel(np.array(vel_cfg.lin_vel))
        init_data.set_ang_vel(np.array(vel_cfg.ang_vel))
    else:
        lin, ang = sample_vel(seed=seed)
        init_data.set_lin_vel(lin)
        init_data.set_ang_vel(ang)
    return {
        "gaussians": gaussians,
        "binding": table,
        "elasticity": elasticity,
        "plasticity": plasticity,
        "init_data": init_data,
        "scaling": float(obj_cfg.gaussian.get("scaling_modifier", 1.0)),
    }


@dataclasses.dataclass
class InferenceScene:
    """The concatenated particle system of all objects, its materials and
    what the renders need: the objects (``_load_object``), their Gaussian
    packs (in the sim box unless ``denormalize``), the initial state, the
    statics and constants, the composed materials, the raster config and
    the cameras by view."""

    objs: list
    packs: List[GaussianPack]
    state0: object
    statics: object
    constants: MPMConstants
    elasticity: ComposeMaterial
    plasticity: ComposeMaterial
    raster_cfg: RasterConfig
    cameras: dict
    background: torch.Tensor
    denormalize: bool
    first_step: int


def load_scene(cfg: Config, eval_steps: int, debug_views=(), device=None) -> InferenceScene:
    """Every object of ``cfg.objects`` loaded and joined, on ``cuda``
    unless ``device="cpu"``."""
    device = resolve_device(device)
    seed = int(cfg.get("seed", 42))
    background, _ = background_color(cfg)
    if debug_views:
        cfg.video_data.data.used_views = list(debug_views)
    dataset = VideoDataset(cfg.video_data.to_dict())
    first_step = dataset.steps[0]
    views = list(debug_views) or cfg.get("debug_views", dataset.views)

    objs = [_load_object(Config(o.to_dict()), eval_steps, seed, device) for o in cfg.objects]
    denormalize = bool(cfg.get("denormalize", False))

    # One particle system; the materials routed by section.
    groups = [o["init_data"] for o in objs]
    state0, sections = build_initial_state(groups, device=device)
    statics = build_statics(groups, device=device)
    sim_cfg = cfg.sim.to_dict()
    sim_cfg.setdefault("eps", TRAIN_EPS)
    constants = MPMConstants.from_cfg(sim_cfg, device=device)
    elasticity = ComposeMaterial([o["elasticity"] for o in objs], sections)
    plasticity = ComposeMaterial([o["plasticity"] for o in objs], sections)

    # Staying in the sim box: the Gaussians are moved into it.
    packs: List[GaussianPack] = []
    for o in objs:
        pack = o["gaussians"]
        if not denormalize:
            data = o["init_data"]
            pack = transform_gaussians(
                pack,
                scale=torch.tensor(np.float32(data.size[0]), device=device),
                origin=torch.zeros((1, 3), device=device),
                t=torch.as_tensor(np.asarray(data.center, np.float32), device=device),
            )
        packs.append(pack)

    raster = cfg.get("raster", {})
    rcfg = RasterConfig(max_pairs=int(raster.get("max_pairs", 1 << 18)),
                        max_per_tile=int(raster.get("max_per_tile", 512)), segment=32)
    cameras = {v: dataset.get(v, first_step).camera.to(device) for v in views}
    return InferenceScene(objs, packs, state0, statics, constants, elasticity, plasticity, rcfg,
                          cameras, background.to(device), denormalize, first_step)


def main(argv=None, device=None) -> ServeResult:
    args = parse_args(argv)
    device = resolve_device(device)
    cfg = load_config(args.config, args.set)
    out_root = Path(cfg.get("root", "results")) / args.video_name
    image_root = out_root / "images"
    image_root.mkdir(parents=True, exist_ok=True)
    scene = load_scene(cfg, args.eval_steps, args.debug_views, device)
    with torch.no_grad():
        return _rollout(args, scene, out_root, image_root, device)


def _rollout(args, scene: InferenceScene, out_root, image_root, device):
    from PIL import Image

    objs, packs, cameras = scene.objs, scene.packs, scene.cameras
    constants, elasticity, plasticity = scene.constants, scene.elasticity, scene.plasticity
    covs = [p.get_covariance(o["scaling"]) for p, o in zip(packs, objs)]
    opac = torch.cat([p.get_opacity for p in packs])
    shs = torch.cat([p.get_features for p in packs])
    sh_degree = packs[0].sh_degree
    cov0 = torch.cat(covs)
    counts = [o["init_data"].num_particles for o in objs]

    def maybe_denorm(x):
        if not scene.denormalize:
            return x
        outs, off = [], 0
        for o, n in zip(objs, counts):
            data = o["init_data"]
            center = torch.as_tensor(np.asarray(data.center, np.float32), device=x.device)
            size = torch.as_tensor(np.asarray(data.size, np.float32), device=x.device)
            outs.append((x[off : off + n] - center) / size)
            off += n
        return torch.cat(outs)

    def sim_frame(state, statics, layouts):
        if layouts is not None:
            layouts, _ = refresh_step_layouts(constants, state.x, layouts)
        new = mpm_step(constants, statics, state, elasticity(state.F), layouts)
        return dataclasses.replace(new, F=plasticity(new.F)), layouts

    check_overflow = OverflowWarning()
    result = ServeResult(out_root, [], [], [], [], {v: [] for v in cameras}, False)

    def render(means3d, cov_def, view, where, path):
        t0 = time.perf_counter()
        img, aux = rasterize_with_aux(means3d, cov_def, opac, cameras[view], scene.background,
                                      shs=shs, sh_degree=sh_degree, cfg=scene.raster_cfg)
        sync(device)
        result.render_ms[view].append((time.perf_counter() - t0) * 1e3)
        check_overflow(aux, where)
        Image.fromarray(to_uint8(img)).save(path)
        result.frames.append(path)

    # Frame 0: the undeformed Gaussians.
    first_means = torch.cat([p.xyz for p in packs])
    for view in cameras:
        render(first_means, cov0, view, "frame 0", image_root / f"{view}_{0:03d}.png")

    state, statics = scene.state0, scene.statics
    de_x_prev = maybe_denorm(state.x)
    k_prev = [p.xyz for p in packs]
    if args.save_particles:
        particles_root = out_root / args.save_particles
        particles_root.mkdir(exist_ok=True)

    spans = [tuple(o["init_data"].span) for o in objs]
    dynamic_spans = any(s[0] > 0 or s[1] <= args.eval_steps for s in spans)
    # One block sort carried across the rollout, refreshed per step: the
    # layouts depend only on positions, not on the enabled spans.
    layouts = build_step_layouts(constants, state.x) if constants.num_grids > 24 else None
    for step in range(1, args.eval_steps + 1):
        t0 = time.perf_counter()
        if dynamic_spans:
            statics = statics.with_enabled_at_step(counts, spans, step)
        state, layouts = sim_frame(state, statics, layouts)
        sync(device)
        result.sim_ms.append((time.perf_counter() - t0) * 1e3)
        de_x = maybe_denorm(state.x)
        # per-object binding, then one concatenation
        means_list, cov_list, off = [], [], 0
        for i, (o, n) in enumerate(zip(objs, counts)):
            means_list.append(apply_binding_xyz(o["binding"], de_x[off : off + n],
                                                de_x_prev[off : off + n], k_prev[i]))
            F_k = apply_binding_F(o["binding"], state.F[off : off + n])
            cov_list.append(deform_cov_by_F(covs[i], F_k))
            off += n
        means3d, cov_def = torch.cat(means_list), torch.cat(cov_list)
        for view in cameras:
            render(means3d, cov_def, view, f"step {step}", image_root / f"{view}_{step:03d}.png")
        if args.save_particles:
            path = particles_root / f"{scene.first_step + step:03d}.ply"
            save_ply_points(path, state.x.cpu().numpy())
            result.particles.append(path)
        de_x_prev = de_x
        k_prev = means_list

    for view in cameras:
        result.videos.append(save_video(
            image_root, f"{view}_*.png", out_root / f"{args.video_name}_{view}.mp4",
            skip_frame=args.skip_frames, fps=args.fps,
        ))
    result.overflow = check_overflow.warned
    print(f"Inference finished -> {out_root}")
    return result


if __name__ == "__main__":
    main()
