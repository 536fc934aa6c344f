"""Multi-rank dry run: one full LoRA training step over a world of ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` in the JAX package
(``neuma_tpu/`` has no module of its own for it):

    python -m neuma_tpu_torch.parallel.dryrun --ranks 4 [--device cpu] [--backend gloo]

``dryrun_multichip(n_ranks)`` spawns ``n_ranks`` ranks (or joins the
world it runs in), lays them out as ``dp = n/2 x vp = 2`` for an even
``n >= 4`` (else ``dp = n``), and runs one training step on a tiny scene
(``16 n`` particles spread 0.7 around 0.525, grid 48, ``grid_mode="halo"``,
2 frames, ``2 vp`` views of 32x32 split over ``vp``): the rollout loss,
its gradient added over the world, and RAdam on the LoRA leaves. Then it
renders camera 0 once with the image tiles split over ``dp``
(``RasterConfig.tile_sharding``), the rasterizer's third parallel axis.
It asserts a finite loss, a finite tile-sharded image equal bit for bit
to the rank's unsharded render, and prints one line. ``spawn`` is the
process launcher it uses: a world of fresh processes
(``torch.multiprocessing`` spawn, a ``file://`` rendezvous in a scratch
directory), each returning its result through a file. A card run of several ranks on one card asks for gloo: NCCL refuses
two ranks on one device.
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from .distributed import initialize

_ROOT = Path(__file__).resolve().parent.parent.parent


def _rank_main(rank, fn, world, args, device, backend, init, out_dir):
    torch.set_num_threads(1)
    initialize(device=device, backend=backend, init_method=init, world_size=world, rank=rank)
    try:
        torch.save(fn(*args), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, args=(), device=None, backend=None, workdir=None):
    """Run ``fn(*args)`` on ``n_ranks`` fresh processes that form one world
    (``initialize`` with ``device``, ``cuda`` unless given, and
    ``backend``; one torch thread each) and return each rank's return
    value, in rank order. ``fn`` must be importable by module from a
    module that imports no JAX. A fresh directory under ``workdir``
    (``build/spawn`` by default) holds the rendezvous file and the
    results until they are read."""
    device = resolve_device(device)
    base = Path(workdir) if workdir is not None else _ROOT / "build" / "spawn"
    out = base / uuid.uuid4().hex[:12]
    out.mkdir(parents=True)
    init = (out / "rendezvous").resolve().as_uri()
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n_ranks, args, str(device), backend, init, str(out)),
            nprocs=n_ranks, start_method="spawn", join=True)
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n_ranks)]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def build_tiny_scene(n_particles=128, grid=16, frames=2, substeps=1, img=32, seed=0, n_views=1,
                     n_gaussians=None, spread=0.15, device="cpu"):
    """``__graft_entry__._build_tiny_scene`` with this package: the same
    points and colours from ``numpy`` seed ``seed``, InvariantFull (64, 64)
    materials from torch generator seeds 0 and 1 (base weights scaled by
    0.05). Returns (scene, gt_images)."""
    from ..core.types import MPMConstants, Statics
    from ..materials.meta import (
        InvariantFullMetaElasticity,
        InvariantFullMetaPlasticity,
        MetaMaterialConfig,
    )
    from ..render.binding import compute_binding_table
    from ..render.camera import Camera
    from ..render.gaussians import create_from_points
    from ..render.rasterize import RasterConfig
    from ..train.grounding import GroundingScene

    rng = np.random.default_rng(seed)
    lo = 0.525 - spread / 2
    pts = (lo + spread * rng.random((n_particles, 3))).astype(np.float32)
    if n_gaussians is None:
        n_gaussians = n_particles
    g_pts = pts[:: max(1, n_particles // n_gaussians)]
    colors = rng.random((g_pts.shape[0], 3)).astype(np.float32)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    constants = MPMConstants(num_grids=grid, bound=2, bc="freeslip", dt=f32(5e-4),
                             gravity=f32([0.0, -9.8, 0.0]), eps=f32(6e-7))
    statics = Statics(vol=f32(np.full(n_particles, 2e-6)), rho=f32(np.full(n_particles, 1000.0)),
                      clip_bound=f32(np.full(n_particles, 0.1)),
                      enabled=torch.ones(n_particles, dtype=torch.int32, device=device))
    cfg = MetaMaterialConfig(layer_widths=(64, 64))
    materials = []
    for k, cls in enumerate((InvariantFullMetaElasticity, InvariantFullMetaPlasticity)):
        mat = cls.init(cfg, torch.Generator().manual_seed(k), device)
        with torch.no_grad():
            for p in mat.parameters():
                p.mul_(0.05)
        materials.append(mat)
    with torch.no_grad():
        gaussians = create_from_points(g_pts, colors, sh_degree=0, device=device)
        table = compute_binding_table(gaussians, f32(pts), max_particles=8)
    cams = [Camera.look_at(eye=np.array([0.5 + 1.2 * np.sin(0.4 * v), 0.55,
                                         0.5 - 1.2 * np.cos(0.4 * v)]),
                           target=np.array([0.5, 0.5, 0.5]), fov=0.9, width=img, height=img,
                           device=device)
            for v in range(n_views)]
    scene = GroundingScene(
        constants=constants, statics=statics, elasticity=materials[0], plasticity=materials[1],
        gaussians=gaussians, binding=table, cameras=cams, init_x=f32(pts), size=np.ones(3),
        center=np.zeros(3), background=torch.ones(3, device=device), substeps=substeps,
        pixel_loss="l2", raster_cfg=RasterConfig(max_pairs=8192, max_per_tile=64, segment=16),
    )
    return scene, torch.zeros((frames, n_views, 3, img, img), device=device)


def _dryrun_rank(n_ranks: int, device: str) -> dict:
    """What each rank runs: the mesh, the scene and one training step."""
    from ..core.types import ParticleState
    from ..render.rasterize import rasterize
    from ..sim.mpm import trainable_params
    from ..train.grounding import _sum_over_ranks, make_rollout_loss
    from ..train.optim import apply_updates, radam
    from .distributed import Mesh
    from .sharding import pad_scene_particles, tile_sharding

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_ranks:
        raise RuntimeError(f"dryrun_multichip({n_ranks}) in a world of {world} ranks")
    n_vp = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    n_dp = n_ranks // n_vp
    mesh = Mesh(("dp", "vp"), (n_dp, n_vp))
    scene, gt = build_tiny_scene(n_particles=16 * n_ranks, grid=48, n_views=2 * n_vp, spread=0.7,
                                 device=device)
    state0 = ParticleState.initial(scene.init_x, torch.zeros_like(scene.init_x))
    state0, statics, _ = pad_scene_particles(state0, scene.statics, n_ranks)
    scene = dataclasses.replace(scene, statics=statics, init_x=state0.x, mesh=mesh,
                                particle_axis="dp", view_axis="vp", grid_mode="halo")
    gen = torch.Generator().manual_seed(2)
    for mat in (scene.elasticity, scene.plasticity):
        mat.init_lora(gen, r=4, alpha=4.0)
    params = trainable_params(scene.elasticity) + trainable_params(scene.plasticity)
    n_e = len(trainable_params(scene.elasticity))
    loss_fn = make_rollout_loss(scene, device=device)
    loss, aux = loss_fn(torch.zeros(3), torch.ones(gt.shape[0]), gt)
    grads = _sum_over_ranks(scene, torch.autograd.grad(loss, params))
    for lr, ps, gs in ((1e-3, params[:n_e], grads[:n_e]), (1e-4, params[n_e:], grads[n_e:])):
        opt = radam(lr)
        updates, _ = opt.update(gs, opt.init(ps), ps)
        apply_updates(ps, updates)
    loss = float(loss.detach())
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss from the sharded step: {loss}")

    # the third rasterizer axis: camera 0's image tiles split over dp
    g = scene.gaussians
    with torch.no_grad():
        cov = g.get_covariance()
        render = lambda cfg: rasterize(g.xyz, cov, g.get_opacity, scene.cameras[0],
                                       torch.zeros(3, device=device), shs=g.get_features,
                                       sh_degree=g.sh_degree, cfg=cfg)
        img = render(dataclasses.replace(scene.raster_cfg, tile_sharding=tile_sharding(mesh)))
        img_one = render(scene.raster_cfg)
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("tile-sharded render NaN")
    if not torch.equal(img, img_one):
        raise AssertionError("the tile-sharded render differs from the unsharded one")
    backend = dist.get_backend() if dist.is_initialized() else "one process"
    line = (f"dryrun_multichip({n_ranks}): one sharded train step OK (mesh dp={n_dp} x "
            f"vp={n_vp}, halo-exchange grid slabs at 48^3 + tile-sharded render, {backend} on "
            f"{device}), loss={loss:.6f}")
    if mesh.rank == 0:
        print(line, flush=True)
    return dict(loss=loss, line=line, dp=n_dp, vp=n_vp, overflow=bool(aux["overflow"]),
                halo_overflow=bool(aux["halo_overflow"]),
                grad_norm=float(torch.sqrt(sum((g * g).sum() for g in grads))))


def dryrun_multichip(n_ranks: int, device=None, backend=None) -> dict:
    """One full LoRA training step over ``n_ranks`` ranks on ``device``
    (``cuda`` unless given): spawned, or in the world already running.
    Returns rank 0's result (loss, mesh, flags, the gradient's norm)."""
    device = resolve_device(device)
    if dist.is_initialized():
        return _dryrun_rank(n_ranks, str(device))
    return spawn(_dryrun_rank, n_ranks, args=(n_ranks, str(device)), device=device,
                 backend=backend)[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--backend", default=None, help="gloo or nccl (default: from the device)")
    args = p.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device, backend=args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
