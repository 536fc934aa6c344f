"""End-to-end smoke demo of the port: fabricate a tiny synthetic scene on
disk, run the two-stage grounding CLI (initial velocity, then LoRA) and
then the render CLI over its outputs, on the card (or the CPU when asked).

Counterpart of the JAX package's ``examples/smoke_e2e.py``, which drives
``neuma_tpu/apps/finetune.py`` and ``neuma_tpu/apps/render.py`` the same
way. The scene is made with numpy, PIL and this package (a copy of what
the script needs of ``tests/test_apps.py``: the NeuMA-Synthetic dataset,
the kernels PLY, the mesh and the config):

    python -m neuma_tpu_torch.examples.smoke_e2e [--device cpu] [--workdir DIR] \\
        [--size 64] [--frames 4] [--epochs 5]

It prints one JSON line: ``{"ok": true, "train_s": ..., "render_s": ...,
"frames": ..., "losses": [...], "device": ..., "launches": {...}}``, the
last with each CUDA kernel's launches over both CLIs (none on the CPU,
where the plain versions run).
"""
from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent


def make_synthetic_dataset(root: Path, rng, size: int, n_steps: int):
    """One view ``d_0`` of ``n_steps`` frames of random pixels,
    ``data_dynamic/d_0_<step:03d>.png``, and ``data_dynamic.json`` with its
    OpenGL c2w and intrinsic, as the NeuMA-Synthetic reader takes them.
    Returns the view names."""
    from PIL import Image

    from ..render.camera import Camera, fov2focal

    sub = root / "data_dynamic"
    sub.mkdir(parents=True)
    cam = Camera.look_at(eye=np.array([0.5, 0.55, -1.2]), target=np.array([0.5, 0.5, 0.5]),
                         fov=0.9, width=size, height=size)
    c2w = np.linalg.inv(cam.world_view.numpy().T.astype(np.float64))
    c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL axes, undone by the reader
    focal = fov2focal(cam.fov_x, size)
    intrinsic = [[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]]
    meta = []
    for step in range(n_steps):
        name = f"d_0_{step:03d}.png"
        Image.fromarray((rng.random((size, size, 3)) * 255).astype(np.uint8)).save(sub / name)
        meta.append({"file_path": f"./data_dynamic/{name}", "c2w": c2w.tolist(),
                     "intrinsic": intrinsic})
    (root / "data_dynamic.json").write_text(json.dumps(meta))
    return ["d_0"]


def make_assets(root: Path, rng):
    """An icosphere mesh (OBJ) in the unit box and a kernels PLY of 80
    Gaussians on its surface. Returns (kernels_path, mesh_path)."""
    from ..data.mesh import TriMesh, make_icosphere
    from ..render.gaussians import create_from_points

    sphere = make_icosphere(radius=0.25, subdivisions=2)
    mesh = TriMesh(vertices=sphere.vertices + np.array([0.5, 0.55, 0.5]), faces=sphere.faces)
    mesh_path = root / "mesh.obj"
    mesh.export_obj(mesh_path)
    pts = mesh.sample_surface(80, rng).astype(np.float32)
    pack = create_from_points(pts, rng.random((80, 3)).astype(np.float32), sh_degree=2)
    kernels_path = root / "kernels.ply"
    pack.to_ply(kernels_path)
    return kernels_path, mesh_path


def write_config(root: Path, kernels_path, mesh_path, data_path, views, frames: int,
                 epochs: int) -> Path:
    """The training config of the scene: a 16^3 grid, (16, 16) materials
    with LoRA r 4, ``epochs`` per stage over ``frames`` frames (the
    velocity stage over at most 3)."""
    import yaml

    def scheduler(alpha):
        return {"type": "cos", "max_steps": 2, "learning_rate_alpha": alpha}

    def net(**kw):
        return {"layer_widths": [16, 16], "norm": None, "nonlinearity": "gelu", "no_bias": True,
                "normalize_input": True, **kw}

    cfg = {
        "seed": 42, "debug": False, "resume": False, "overwrite": False,
        "root": str(root / "logs"), "name": "smoke", "data_root": str(root / "sim_data"),
        "pretrained_ckpt": None,
        "gaussian": {"sh_degree": 2, "opacity_thres": 0.02, "confidence": 0.95,
                     "max_particles": 8, "kernels_path": str(kernels_path)},
        "video_data": {
            "eval": False, "camera_type": "NeuMASynthetic",
            "data": {"path": str(data_path), "transformsfile": "data_dynamic.json",
                     "white_background": True, "exclude_steps": [-1], "used_views": views},
            "camera": {"resolution": 1, "data_device": "cpu"},
        },
        "sim": {"gravity": [0.0, -9.8, 0.0], "bc": "noslip", "num_grids": 16, "dt": 0.001,
                "bound": 1, "eps": 0.0, "skip_frame": 1},
        "particle_data": {
            "shape": {"asset_root": None, "sort": None,
                      "ori_bounds": [[0.2, 0.25, 0.2], [0.8, 0.85, 0.8]],
                      "sim_bounds": [[0.2, 0.25, 0.2], [0.8, 0.85, 0.8]]},
            "rho": 1000.0, "clip_bound": 0.1, "mesh_path": str(mesh_path),
            "mesh_sample_mode": "uniform", "mesh_sample_resolution": 10,
        },
        "raster": {"max_pairs": 8192, "max_per_tile": 256, "segment": 16},
        "constitution": {
            "elasticity": net(), "elasticity_lr": 0.008, "elasticity_wd": 0.0,
            "elasticity_grad_max_norm": 1.0, "elasticity_scheduler": scheduler(0.025),
            "plasticity": net(alpha=0.001), "plasticity_lr": 0.0008, "plasticity_wd": 0.0,
            "plasticity_grad_max_norm": 1.0, "plasticity_scheduler": scheduler(0.025),
            "warmup_step": 0, "decay_init": 0.5, "decay_final": 1.0, "decay_steps": 80,
            "lambda_max_decay": 0.33, "lora": {"r": 4, "alpha": 4}, "num_epochs": epochs,
            "substeps": 1, "num_frames": frames, "views": views,
        },
        "velocity": {"num_epochs": epochs, "num_frames": min(frames, 3), "substeps": 1,
                     "lambda_reg": 0.005, "views": views, "lr": 0.5,
                     "scheduler": scheduler(0.01)},
    }
    cfg_path = root / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    return cfg_path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", type=str, default=str(_ROOT / "build" / "smoke_e2e"))
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from .. import kernels
    from ..apps import finetune, render
    from ..core.device import resolve_device

    device = resolve_device(args.device)
    work = Path(args.workdir)
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    rng = np.random.default_rng(0)
    data_path = work / "dataset"
    views = make_synthetic_dataset(data_path, rng, size=args.size, n_steps=args.frames + 1)
    kernels_path, mesh_path = make_assets(work, rng)
    cfg_path = write_config(work, kernels_path, mesh_path, data_path, views, args.frames,
                            args.epochs)

    kernels.reset_launches()
    t0 = time.perf_counter()
    result = finetune.main(["-c", str(cfg_path)], device=device)
    train_s = time.perf_counter() - t0
    print(f"[smoke] finetune done in {train_s:.1f} s, losses "
          f"{[round(float(v), 4) for v in result.losses]}")
    t0 = time.perf_counter()
    render.main(["-c", str(cfg_path), "-s", "5", "-vn", "smoke", "-dv", views[0]], device=device)
    render_s = time.perf_counter() - t0
    out = work / "logs" / "smoke" / "results" / "smoke"
    pngs = sorted(out.glob("*.png"))
    if not pngs:
        raise RuntimeError(f"no rendered frames under {out}")
    print(f"[smoke] render done in {render_s:.1f} s: {len(pngs)} frames under {out}")
    summary = {"ok": True, "train_s": train_s, "render_s": render_s, "frames": len(pngs),
               "losses": [float(v) for v in result.losses], "device": str(device),
               "launches": dict(kernels.launches)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
