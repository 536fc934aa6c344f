"""Grounding rollout loss and the two training stages.

Counterpart of ``neuma_tpu/train/grounding.py`` (``GroundingScene``,
``_remat_policy``, ``make_rollout_loss`` for ``grid_mode="replicated"``
and ``"halo"``, ``rollout_decay_weights``, ``decay_rate_for_epoch``, the
error classes, ``optimize_init_velocity`` and ``finetune_constitutive``
with its train-state file). Per frame:
``substeps`` x (elasticity MLP -> MPM step -> plasticity MLP, one
``make_packed_substep`` Function), then binding, then one Particle-GS
render per view (the unrolled per-view loop the JAX package runs for up
to 8 views without a mesh), then the pixel loss weighted by
``frame_weights``. The frame ``scan`` is a Python loop. The loss is
differentiable with respect to ``init_v`` and the materials' LoRA
leaves (full BPTT); serving callers run it under ``torch.no_grad()``.
The previous-frame references carried between frames are detached, as
the JAX package stops their gradient. With the ``'frame'`` remat policy
each frame runs under ``torch.utils.checkpoint`` and is recomputed in
the backward.

The material weights live in the scene's material modules; the trainers
update their LoRA leaves in place. The ground-truth images are an
argument of the loss and of the trainers, not part of the scene.

With ``scene.mesh`` (a ``parallel.distributed.Mesh``, one rank per
shard) the rollout runs over a world. With ``grid_mode="halo"`` once per
frame every rank partitions the replicated particles into slab bins,
steps its own bin through the substeps with ``parallel/halo.py``'s bins
step (drift tolerance 2 cells; the materials on the bin, the padding
slots' stress zeroed), and the bins are gathered back by an all-gather
whose backward is a reduce-scatter. With ``grid_mode="replicated"`` (the
default) and a ``particle_axis`` the particles are padded to a multiple
of that axis (disabled, F = I) and each rank steps its contiguous shard
through the packed substeps with the grid summed over the axis
(``parallel.sharding.particle_grid_sum``: K1's per-block sums forward,
the grid cotangent backward), keeping one block sort per shard; the
shards are gathered back once per frame in the same way. Without a
particle axis every rank runs the whole sim. Each view is rendered by
exactly one rank (``rank_views``). The returned loss has the value of
the global loss (the ranks' partial losses added in rank order) and the
gradient of this rank's partial loss, so the ranks' gradients sum to the
single-process gradient; the trainers add them over the world before
clipping. A rank that renders no view still runs the backward through
the sim's collectives; the ``'frame'`` remat checkpoints the sim alone,
with early stop off, so every rank reruns its collectives in one order.
With a ``vp`` axis the sim is replicated along it and each copy's
backward carries its own rank's views.

With ``raster_cfg.tile_sharding`` over axis ``a`` of the scene's mesh
(the particle axis or another, never the view axis) each view goes to
one group of ranks, the ``size(a)`` ranks along ``a`` that share the
other coordinates (``rank_views`` over the mesh with ``a`` collapsed),
and every rank of the group renders its range of the view's tiles
(``render/raster_kernel.py::composite_pairs_sharded``): every rank of
the group holds the whole image and, through the gathered pair rows,
the gradient of its own loss of the whole image. Each rank of the group
therefore adds the view's pixel loss times ``1 / size(a)``: the group's
losses, hence its cotangents, are equal (the composite's condition),
the global loss counts the view once, and the trainers' sum over the
world adds the group's gradients to the view's gradient.

``build_scene`` makes the scene of ``bench.py``'s recipe (seed-0 points in
[0.4, 0.6]^3, InvariantFull materials with LoRA, SH Gaussians on the
points, look-at cameras around the box), made with this package alone.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..core.device import resolve_device
from ..core.types import MPMConstants, ParticleState, Statics
from ..materials.meta import (
    InvariantFullMetaElasticity,
    InvariantFullMetaPlasticity,
    MetaMaterialConfig,
)
from ..parallel.distributed import is_primary
from ..parallel.halo import (
    gather_bins,
    make_halo_bins_step,
    partition_particles,
    shard_of,
    unpartition,
)
from ..parallel.sharding import (
    pad_scene_particles,
    pad_to_multiple,
    particle_grid_sum,
    shard_particles,
)
from ..render.binding import (
    BindingTable,
    apply_binding_F,
    apply_binding_xyz,
    compute_binding_table,
    deform_cov_by_F,
)
from ..render.camera import Camera
from ..render.gaussians import GaussianPack, create_from_points
from ..render.raster_kernel import CHUNK as RASTER_CHUNK
from ..render.rasterize import RasterConfig, rasterize_with_aux
from ..sim.mpm import _step_sort, make_packed_substep, trainable_params
from ..sim.p2g_kernel import refresh_step_layouts
from ..sim.rollout import denormalize_points
from ..utils.profiling import span
from .checkpoint import load_into, load_train_state, save_train_state
from .losses import l1_loss, l2_loss
from .optim import apply_updates, clip_by_global_norm_strict, radam
from .schedulers import fetch_schedule

PIXEL_LOSSES = {"l1": l1_loss, "l2": l2_loss}
_REMAT_BUDGET_BYTES = 4 << 30  # the JAX package's default remat budget


@dataclasses.dataclass
class GroundingScene:
    """Everything static for the rollout loss. The ground-truth images
    are an argument of the loss, not part of the scene."""

    constants: MPMConstants
    statics: Statics
    elasticity: InvariantFullMetaElasticity
    plasticity: InvariantFullMetaPlasticity
    gaussians: GaussianPack
    binding: BindingTable
    cameras: Sequence[Camera]
    init_x: torch.Tensor  # (N, 3) sim-box positions
    size: np.ndarray  # denormalization scale (sim <- world)
    center: np.ndarray
    background: torch.Tensor  # (3,)
    substeps: int = 1
    pixel_loss: str = "l2"
    force_mask_data: bool = False
    scaling_modifier: float = 1.0
    raster_cfg: RasterConfig = dataclasses.field(default_factory=RasterConfig)
    exclude_frames: Sequence[int] = ()
    # The world the rollout runs over (``parallel.distributed.Mesh``): the
    # particles go along ``particle_axis`` (halo mode: the grid's slabs,
    # default "dp"; replicated mode: particle shards, none without it),
    # and the views are split over ``view_axis`` (the sim replicated along
    # it), or round-robin over the world without it (``rank_views``); with
    # ``raster_cfg.tile_sharding`` each view's tiles over that axis's ranks.
    mesh: Optional[object] = None
    particle_axis: Optional[str] = None
    view_axis: Optional[str] = None
    # 'replicated' (the whole grid on every rank; over a mesh the
    # particles are sharded and the grid summed) or 'halo' (slab-
    # decomposed grid with the ring exchange of parallel/halo.py;
    # requires ``mesh``)
    grid_mode: str = "replicated"
    # per-shard particle-bin capacity for halo mode (None: N, always safe)
    halo_capacity: Optional[int] = None
    # 'frame' (per-frame checkpoint), 'none' (keep every substep's
    # residuals) or 'auto' ('none' when the estimate fits the budget;
    # 'frame' in halo mode)
    remat: str = "auto"

    def to(self, device) -> "GroundingScene":
        return dataclasses.replace(
            self,
            constants=self.constants.to(device),
            statics=self.statics.to(device),
            elasticity=self.elasticity.to(device),
            plasticity=self.plasticity.to(device),
            gaussians=self.gaussians.to(device),
            binding=self.binding.to(device),
            cameras=[c.to(device) for c in self.cameras],
            init_x=self.init_x.to(device),
            background=self.background.to(device),
        )


def _remat_policy(scene: GroundingScene, num_frames: int) -> str:
    """Resolve ``scene.remat``: 'auto' picks 'none' when the whole
    rollout's substep residuals fit ``_REMAT_BUDGET_BYTES`` (4 GiB), with
    the JAX package's estimate: per substep 4 f32 grid channels +
    114 words per particle (state, stress, G2P outputs, pre-plasticity F
    and the layouts), per frame ~10 f32 per pair slot + 5 x 256 f32 per
    tile for each view."""
    if scene.remat in ("frame", "none"):
        return scene.remat
    if scene.remat != "auto":
        raise ValueError(
            f"unknown remat policy: {scene.remat!r} (expected 'frame', 'none', or 'auto')"
        )
    if scene.grid_mode != "replicated":
        return "frame"  # halo bins change the residual shape; keep remat
    g3 = int(scene.constants.num_grids) ** 3
    n = int(scene.init_x.shape[0])
    per_substep = 4 * (4 * g3 + 54 * n + 60 * n)
    cam = scene.cameras[0]
    tiles = ((cam.width + 15) // 16) * ((cam.height + 15) // 16)
    pair_slots = scene.raster_cfg.max_pairs + RASTER_CHUNK * tiles
    per_frame_render = len(scene.cameras) * 4 * (10 * pair_slots + 5 * 256 * tiles)
    total = num_frames * (scene.substeps * per_substep + per_frame_render)
    return "none" if total <= _REMAT_BUDGET_BYTES else "frame"


def rank_views(n_views: int, mesh, view_axis: Optional[str] = None,
               tile_axis: Optional[str] = None) -> List[int]:
    """The views this rank renders, each view on exactly one rank of the
    mesh with ``tile_axis`` (the image tiles' axis, when they are split)
    collapsed: the ranks along ``tile_axis`` render the same views.
    Without ``view_axis`` the views go round-robin over the (collapsed)
    ranks. With it, view ``v`` goes to the ranks at coordinate ``v %
    size`` on that axis, and among those round-robin over the other axes'
    coordinates."""
    axes = [a for a in mesh.axis_names if a != tile_axis]
    world = int(np.prod([mesh.shape[a] for a in axes]))
    if view_axis is None:
        slot = 0
        for axis in axes:
            slot = slot * mesh.shape[axis] + mesh.coord(axis)
    else:
        if view_axis not in mesh.shape:
            raise ValueError(f"view_axis {view_axis!r} is not an axis of the mesh "
                             f"{mesh.axis_names}")
        rest = 0
        for axis in axes:
            if axis != view_axis:
                rest = rest * mesh.shape[axis] + mesh.coord(axis)
        slot = mesh.coord(view_axis) + mesh.shape[view_axis] * rest
    return [v for v in range(n_views) if v % world == slot]


def make_rollout_loss(scene: GroundingScene, device=None) -> Callable:
    """Builds ``loss(init_v, frame_weights, gt_images) -> (loss, aux)``
    on ``device`` (``cuda`` unless given; the scene's material modules
    move there in place). ``init_v`` is (3,) or (N, 3);
    ``frame_weights`` (frames,); ``gt_images`` (frames, views, 3, H, W).
    ``aux`` holds the device bools ``overflow`` and ``halo_overflow``
    (ORed over the world on a mesh). The loss is differentiable with
    respect to ``init_v`` and the materials' trainable (LoRA) parameters."""
    device = resolve_device(device)
    mesh = scene.mesh
    halo = scene.grid_mode == "halo"
    if halo:
        if mesh is None:
            raise ValueError("grid_mode='halo' requires scene.mesh")
    elif scene.grid_mode != "replicated":
        raise ValueError(f"unknown grid_mode: {scene.grid_mode!r}")
    scene = scene.to(device)
    constants = scene.constants
    n_particles = scene.init_x.shape[0]
    table = scene.binding.with_inverse(n_particles)
    pixel_loss = PIXEL_LOSSES[scene.pixel_loss]
    with torch.no_grad():
        cov0 = scene.gaussians.get_covariance(scene.scaling_modifier)
        opacity = scene.gaussians.get_opacity
        shs = scene.gaussians.get_features
    sh_degree = scene.gaussians.sh_degree
    k_xyz0 = scene.gaussians.xyz.detach()
    views = list(range(len(scene.cameras)))
    # The axis the particles are split along: the halo grid's slabs, or
    # the replicated grid's particle shards (none: each rank runs the sim).
    sim_axis = (scene.particle_axis or "dp") if halo else scene.particle_axis
    sharded = mesh is not None and not halo and sim_axis is not None
    statics, x0 = scene.statics, scene.init_x
    grid_sum = None
    tiles = scene.raster_cfg.tile_sharding
    tile_ranks = 1  # the ranks that render each of this rank's views
    if tiles is not None:
        if mesh is None or tiles.mesh is not mesh:
            raise ValueError("raster_cfg.tile_sharding must split an axis of scene.mesh")
        if tiles.axis == scene.view_axis:
            raise ValueError(f"the tile axis {tiles.axis!r} is the view axis: a view's tiles "
                             "split over the ranks that render it")
        tile_ranks = mesh.shape[tiles.axis]
    if mesh is not None:  # each view on one rank (one group of ranks with tile sharding)
        if scene.view_axis is not None and scene.view_axis == sim_axis:
            raise ValueError(f"view_axis {sim_axis!r} is the particle axis: the sim must be "
                             "replicated along the view axis")
        views = rank_views(len(views), mesh, scene.view_axis,
                           tiles.axis if tiles is not None else None)
    if halo or sharded:
        n_shards = mesh.shape[sim_axis]
    if halo:
        halo_step = make_halo_bins_step(constants, mesh, sim_axis, tol=2)
        shard = mesh.coord(sim_axis)
        capacity = scene.halo_capacity or n_particles
    if sharded:  # padded particles are disabled, with F = I
        padded, statics, _ = pad_scene_particles(
            ParticleState.initial(x0, torch.zeros_like(x0)), statics, n_shards)
        x0 = padded.x
        statics = shard_particles(statics, mesh, sim_axis)
        grid_sum = particle_grid_sum(mesh, sim_axis)
    substep = make_packed_substep(constants, statics, scene.elasticity, scene.plasticity,
                                  grid_sum=grid_sum)

    def render_one(cam, means3d, cov_def):
        if scene.force_mask_data:
            colors = torch.ones((means3d.shape[0], 3), dtype=means3d.dtype, device=device)
            kw = dict(colors_precomp=colors)
        else:
            kw = dict(shs=shs, sh_degree=sh_degree)
        img, aux = rasterize_with_aux(
            means3d, cov_def, opacity, scene.cameras[cam], scene.background,
            cfg=scene.raster_cfg, **kw
        )
        return img, aux["overflow"]

    def render_frame(state, de_x_prev, g_prev, gt_frame):
        # the binding reads the scene's particles (no padding)
        x, F = state.x[:n_particles], state.F[:n_particles]
        de_x = denormalize_points(x, scene.size, scene.center)
        means3d = apply_binding_xyz(table, de_x, de_x_prev, g_prev)
        if not views:
            zero = torch.zeros((), device=device)
            return de_x, means3d, zero, zero.bool()
        # stop-grad covariance path (reference)
        cov_def = deform_cov_by_F(cov0, apply_binding_F(table, F.detach()))
        out = [render_one(v, means3d, cov_def) for v in views]
        imgs = torch.stack([o[0] for o in out])
        overflow = torch.stack([o[1] for o in out]).any()
        # with tile sharding each rank of the view's group adds its share
        frame_loss = pixel_loss(imgs, gt_frame[views]) * (len(views) / tile_ranks)
        return de_x, means3d, frame_loss, overflow

    def substeps(state, layouts):
        for _ in range(scene.substeps):
            if layouts is not None:  # the slab branch's block sort, amortized
                layouts, _ = refresh_step_layouts(constants, state.x, layouts)
            state = substep(state, layouts)
        return state, layouts

    @span("loss.frame")
    def frame_body(state, layouts, de_x_prev, g_prev, gt_frame):
        state, layouts = substeps(state, layouts)
        return (state, layouts) + render_frame(state, de_x_prev, g_prev, gt_frame)

    def halo_sim(x, v, C, F, layouts):
        """One frame's substeps in bins space: partition once, step this
        rank's bin, gather the bins back. Returns the state and the
        frame's halo overflow (bin capacity or this rank's margin)."""
        state = ParticleState(x, v, C, F)
        part = partition_particles(constants, state, scene.statics, n_shards, capacity)
        bins, bin_statics, valid = shard_of(part, shard)
        margin = torch.zeros((), dtype=torch.bool, device=device)
        for _ in range(scene.substeps):
            with span("material.elasticity"):
                stress = torch.where(valid[:, None, None], scene.elasticity(bins.F), 0.0)
            bins, bad = halo_step(bin_statics, bins, stress)
            with span("material.plasticity"):
                bins = dataclasses.replace(bins, F=scene.plasticity(bins.F))
            margin = margin | bad
        gathered = gather_bins(mesh, sim_axis, bins)
        out = unpartition(dataclasses.replace(part, state=gathered), n_particles, state)
        return out.x, out.v, out.C, out.F, None, part.overflow | margin

    def sharded_sim(x, v, C, F, layouts):
        """One frame's substeps on this rank's particle shard (the grid
        summed over the axis in each step), then every shard gathered back:
        the carried state is the whole (padded) state on every rank."""
        state, layouts = substeps(shard_particles(ParticleState(x, v, C, F), mesh, sim_axis),
                                  layouts)
        full = gather_bins(mesh, sim_axis, state)
        flat = lambda t: t.reshape((-1,) + t.shape[2:])
        return flat(full.x), flat(full.v), flat(full.C), flat(full.F), layouts, None

    # the sim's collectives run in a checkpoint of the sim alone
    mesh_sim = halo_sim if halo else sharded_sim if sharded else None

    def loss_fn(init_v, frame_weights, gt_images):
        init_v = torch.as_tensor(init_v, dtype=torch.float32, device=device)
        frame_weights = torch.as_tensor(frame_weights, dtype=torch.float32, device=device)
        gt_images = torch.as_tensor(gt_images, dtype=torch.float32, device=device)
        n_frames = gt_images.shape[0]
        remat = _remat_policy(scene, n_frames) == "frame" and torch.is_grad_enabled()
        v0 = init_v.reshape(-1, 3).expand(n_particles, 3).contiguous()
        if sharded:
            v0, _ = pad_to_multiple(v0, n_shards)
        state = ParticleState.initial(x0, v0)
        de_x_prev = denormalize_points(scene.init_x, scene.size, scene.center)
        g_prev = k_xyz0
        # None on a dense grid and in halo mode
        layouts = (None if halo else
                   _step_sort(constants, shard_particles(x0, mesh, sim_axis) if sharded else x0))
        frame_losses, overflows, halo_flags = [], [], []
        for f in range(n_frames):
            if mesh_sim is not None:
                with span("loss.frame"):
                    args = (state.x, state.v, state.C, state.F, layouts)
                    if remat:  # the sim's collectives rerun in the same order on every rank
                        with set_checkpoint_early_stop(False):
                            *parts, layouts, halo_flag = checkpoint(mesh_sim, *args,
                                                                    use_reentrant=False)
                    else:
                        *parts, layouts, halo_flag = mesh_sim(*args)
                    state = ParticleState(*parts)
                    if halo_flag is not None:
                        halo_flags.append(halo_flag)
                    out = render_frame(state, de_x_prev, g_prev, gt_images[f])
            else:
                args = (state, layouts, de_x_prev, g_prev, gt_images[f])
                if remat:
                    out = checkpoint(frame_body, *args, use_reentrant=False)
                else:
                    out = frame_body(*args)
                state, layouts, *out = out
            de_x, means3d, frame_loss, overflow = out
            overflows.append(overflow)
            # Excluded frames add no loss and keep the previous refs.
            if f in scene.exclude_frames:
                frame_losses.append(frame_weights[f] * 0.0 * frame_loss)
                continue
            frame_losses.append(frame_weights[f] * 1.0 * frame_loss)
            de_x_prev, g_prev = de_x.detach(), means3d.detach()
        loss = torch.stack(frame_losses).sum()
        overflow = torch.stack(overflows).any()
        halo_overflow = (torch.stack(halo_flags).any() if halo_flags
                         else torch.zeros((), dtype=torch.bool, device=device))
        if mesh is not None:
            if not views and torch.is_grad_enabled():
                # no view here: the backward must still run the sim's collectives
                loss = loss + 0.0 * state.x.sum()
            # the value of the global loss, the gradient of this rank's part
            loss = loss - loss.detach() + mesh.all_sum(loss.detach())
            overflow, halo_overflow = mesh.any(overflow), mesh.any(halo_overflow)
        return loss, {"overflow": overflow, "halo_overflow": halo_overflow}

    return loss_fn


def _sum_over_ranks(scene: GroundingScene, grads):
    """The trained leaves' gradients added over the world (rank order) when
    the scene has a mesh: the ranks' partial losses sum to the loss."""
    if scene.mesh is None:
        return list(grads)
    flat = scene.mesh.all_sum(torch.cat([g.reshape(-1) for g in grads]))
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].reshape(g.shape))
        i += g.numel()
    return out


class NonFiniteGradientError(RuntimeError):
    """A non-finite total gradient norm (the reference's
    ``clip_grad_norm_(error_if_nonfinite=True)``)."""


class PairBudgetOverflowError(RuntimeError):
    """A rendered frame exceeded ``RasterConfig.max_pairs``: pairs were
    dropped, so the image and every gradient through it are wrong. The
    fix is a larger budget, not a smaller loss."""


class HaloOverflowError(RuntimeError):
    """The halo-sharded step dropped particles: a shard bin overflowed its
    capacity or a particle's stencil left its slab view."""


def _raise_on_overflow(aux: dict, where: str) -> None:
    """Any fired budget flag means the step just taken was wrong."""
    if bool(aux["overflow"]):
        raise PairBudgetOverflowError(
            f"raster pair budget exceeded at {where}: raise "
            f"raster.max_pairs/max_per_tile (pairs were dropped — the "
            f"rendered image and its gradients are wrong)"
        )
    if bool(aux["halo_overflow"]):
        raise HaloOverflowError(
            f"halo shard budget exceeded at {where}: a shard bin "
            f"overflowed or a particle's stencil escaped its slab view"
        )


def rollout_decay_weights(num_frames: int, decay_rate, decay_steps: int) -> torch.Tensor:
    """weight[f] = decay_rate ** (f // decay_steps), float32."""
    exponents = torch.as_tensor(np.arange(num_frames) // max(decay_steps, 1), dtype=torch.float32)
    return torch.pow(torch.as_tensor(decay_rate, dtype=torch.float32), exponents)


def decay_rate_for_epoch(cfg, epoch: int, num_epochs: int) -> float:
    """The decay rate's linear ramp from ``decay_init`` to ``decay_final``."""
    lam = float(cfg.get("lambda_max_decay", 0.0))
    ratio = min((1.0 / lam) * epoch / num_epochs, 1.0) if lam > 0 else 1.0
    d0 = float(cfg["decay_init"])
    d1 = float(cfg["decay_final"])
    return d0 + (d1 - d0) * ratio


# --- Stage 1: initial velocity ---------------------------------------------


@dataclasses.dataclass
class VelocityStageResult:
    init_v: np.ndarray
    losses: List[float]


def optimize_init_velocity(
    scene: GroundingScene,
    gt_images,
    num_epochs: int,
    lr: float,
    schedule: Callable,
    lambda_reg: Optional[float] = 0.005,
    reg_all: bool = False,
    init_v0: Optional[np.ndarray] = None,
    log_fn: Optional[Callable] = None,
    device=None,
) -> VelocityStageResult:
    """Stage 1: RAdam on the global initial velocity against the ground
    truth, with the x/z (or full) sparsity regularizer switched on after
    the first 10% of epochs. ``lr`` is carried for the reference's
    signature; ``schedule`` sets the rate."""
    device = resolve_device(device)
    loss_fn = make_rollout_loss(scene, device=device)
    gt = torch.as_tensor(gt_images, dtype=torch.float32, device=device)
    weights = torch.ones(gt.shape[0], dtype=torch.float32, device=device)
    init_v = torch.as_tensor(
        init_v0 if init_v0 is not None else np.zeros(3), dtype=torch.float32, device=device
    ).clone()
    opt = radam(schedule)
    opt_state = opt.init([init_v])
    losses = []
    warmup_gate = int(0.1 * num_epochs)
    for epoch in range(1, num_epochs + 1):
        reg_w = float(lambda_reg) if (lambda_reg is not None and epoch > warmup_gate) else 0.0
        iv = init_v.detach().requires_grad_(True)
        loss_rgb, aux = loss_fn(iv, weights, gt)
        if reg_all:
            reg = torch.mean(torch.abs(iv))
        else:
            ivr = iv.reshape(-1, 3)
            reg = (torch.mean(torch.abs(ivr[:, 0])) + torch.mean(torch.abs(ivr[:, 2]))) / 2.0
        if scene.mesh is not None and scene.mesh.rank != 0:
            reg = reg.detach()  # its gradient is added over the world once
        loss = loss_rgb + reg_w * reg
        (g,) = _sum_over_ranks(scene, torch.autograd.grad(loss, [iv]))
        loss = loss.detach()
        updates, opt_state = opt.update([g], opt_state, [init_v])
        apply_updates([init_v], updates)
        _raise_on_overflow(aux, f"velocity epoch {epoch}")
        losses.append(float(loss))
        if log_fn:
            log_fn(epoch, float(loss), float(loss_rgb.detach()), init_v.cpu().numpy())
    return VelocityStageResult(init_v=init_v.cpu().numpy(), losses=losses)


# --- Stage 2: LoRA constitutive finetune ------------------------------------


@dataclasses.dataclass
class ConstitutiveStageResult:
    params_e: object
    params_p: object
    losses: List[float]
    grad_norms_e: List[float]
    grad_norms_p: List[float]


def finetune_constitutive(
    scene: GroundingScene,
    gt_images,
    init_v,
    cfg: dict,
    checkpoint_fn: Optional[Callable] = None,
    log_fn: Optional[Callable] = None,
    start_epoch: int = 1,
    train_state_path=None,
    resume_state: bool = False,
    write_state: bool = True,
    device=None,
) -> ConstitutiveStageResult:
    """Stage 2: masked RAdam on the LoRA leaves of both materials (updated
    in place in the scene's modules) with the rollout-decay-weighted loss,
    per-net schedules after a linear warmup, strict clipping, and the
    ``on_nonfinite`` policy ('raise', or 'skip' up to
    ``max_nonfinite_skips`` consecutive epochs: both nets' gradients are
    zeroed and the optimizer state still advances). ``log_fn`` receives
    ``(epoch, loss, e_norm, p_norm, decay, lr_e, lr_p)``;
    ``checkpoint_fn(epoch, params_e, params_p, loss)`` runs at epoch 1,
    every 10th and the last.

    ``train_state_path`` keeps the full train state (both materials'
    parameters, the RAdam moments and the step; ``train/checkpoint.py``,
    the JAX package's file): it is written at every checkpoint epoch when
    ``write_state``, and, when ``resume_state`` and the file exists,
    restored before the first epoch, overriding ``start_epoch`` and the
    materials' leaves. Over a mesh (either grid mode) the gradients are
    added over the world before the clip, as the JAX package's jitted
    step does implicitly, and only the primary rank writes the file."""
    device = resolve_device(device)
    num_epochs = int(cfg["num_epochs"])
    warmup = int(cfg.get("warmup_step", 0))
    decay_steps = int(cfg.get("decay_steps", 80))
    e_lr = float(cfg["elasticity_lr"])
    p_lr = float(cfg["plasticity_lr"])
    on_nonfinite = str(cfg.get("on_nonfinite", "raise"))
    if on_nonfinite not in ("raise", "skip"):
        raise ValueError(
            f"unknown on_nonfinite policy: {on_nonfinite!r} (expected 'raise' or 'skip')"
        )
    max_skips = int(cfg.get("max_nonfinite_skips", 30))

    loss_fn = make_rollout_loss(scene, device=device)
    gt = torch.as_tensor(gt_images, dtype=torch.float32, device=device)
    init_v = torch.as_tensor(init_v, dtype=torch.float32, device=device)

    def with_warmup(base, lr0):
        if warmup == 0:
            return base

        def sched(count):
            c = torch.as_tensor(count, dtype=torch.float32)
            ramp = lr0 * (c + 1.0) / warmup
            return torch.where(c < warmup, ramp, base(max(int(count) - warmup, 0)))

        return sched

    e_sched = with_warmup(fetch_schedule(cfg["elasticity_scheduler"], e_lr), e_lr)
    p_sched = with_warmup(fetch_schedule(cfg["plasticity_scheduler"], p_lr), p_lr)
    # The trainable leaves are the LoRA mask: every other leaf of the
    # material modules has requires_grad=False (``nn/mlp.py``).
    e_params, p_params = trainable_params(scene.elasticity), trainable_params(scene.plasticity)
    e_opt = radam(e_sched, float(cfg.get("elasticity_wd", 0.0)))
    p_opt = radam(p_sched, float(cfg.get("plasticity_wd", 0.0)))
    e_state, p_state = e_opt.init(e_params), p_opt.init(p_params)
    ts_path = Path(train_state_path) if train_state_path else None
    if ts_path is not None and resume_state and ts_path.is_file():
        step, restored, (e_state, p_state) = load_train_state(
            ts_path, {"e": scene.elasticity.params(), "p": scene.plasticity.params()}, device
        )
        load_into(scene.elasticity, restored["e"])
        load_into(scene.plasticity, restored["p"])
        start_epoch = step + 1
    e_max_norm = float(cfg.get("elasticity_grad_max_norm", 1.0))
    p_max_norm = float(cfg.get("plasticity_grad_max_norm", 1.0))

    losses, e_norms, p_norms = [], [], []
    consecutive_bad = 0
    for epoch in range(start_epoch, num_epochs + 1):
        decay_rate = decay_rate_for_epoch(cfg, epoch, num_epochs)
        weights = rollout_decay_weights(gt.shape[0], decay_rate, decay_steps)
        with span("train.loss"):
            loss, aux = loss_fn(init_v, weights, gt)
        with span("train.grad"):
            grads = _sum_over_ranks(scene, torch.autograd.grad(loss, e_params + p_params))
        loss = loss.detach()
        with span("train.optim"):
            ge, e_norm, e_bad = clip_by_global_norm_strict(grads[: len(e_params)], e_max_norm)
            gp, p_norm, p_bad = clip_by_global_norm_strict(grads[len(e_params) :], p_max_norm)
            with span("train.read"):
                bad = bool(e_bad | p_bad)
            if bad and on_nonfinite == "skip":
                ge = [torch.zeros_like(g) for g in ge]
                gp = [torch.zeros_like(g) for g in gp]
            e_updates, e_state = e_opt.update(ge, e_state, e_params)
            p_updates, p_state = p_opt.update(gp, p_state, p_params)
            if bad:
                consecutive_bad += 1
                if on_nonfinite == "raise" or consecutive_bad > max_skips:
                    raise NonFiniteGradientError(
                        f"non-finite gradient at epoch {epoch}: "
                        f"loss={float(loss):.7f} e_norm={float(e_norm)} p_norm={float(p_norm)}"
                        + (f" ({consecutive_bad} consecutive skipped epochs exceeded "
                           f"max_nonfinite_skips={max_skips})" if on_nonfinite == "skip" else "")
                    )
                print(
                    f"[grounding] non-finite gradient at epoch {epoch} "
                    f"(e_norm={float(e_norm)}, p_norm={float(p_norm)}) — "
                    f"update skipped ({consecutive_bad}/{max_skips})",
                    file=sys.stderr,
                )
            else:
                consecutive_bad = 0
            apply_updates(e_params, e_updates)
            apply_updates(p_params, p_updates)
        # the host reads close before ``log_fn``, which may start or stop a trace
        with span("train.read"):
            _raise_on_overflow(aux, f"constitutive epoch {epoch}")
            losses.append(float(loss))
            e_norms.append(float(e_norm))
            p_norms.append(float(p_norm))
        if log_fn:
            log_fn(epoch, losses[-1], e_norms[-1], p_norms[-1], decay_rate,
                   float(e_sched(epoch - 1)), float(p_sched(epoch - 1)))
        at_ckpt = epoch == 1 or epoch % 10 == 0 or epoch == num_epochs
        if checkpoint_fn and at_ckpt:
            checkpoint_fn(epoch, scene.elasticity.params(), scene.plasticity.params(), float(loss))
        if ts_path is not None and write_state and at_ckpt and is_primary():
            save_train_state(
                ts_path, epoch,
                {"e": scene.elasticity.params(), "p": scene.plasticity.params()},
                (e_state, p_state),
            )
    return ConstitutiveStageResult(
        params_e=scene.elasticity.params(),
        params_p=scene.plasticity.params(),
        losses=losses,
        grad_norms_e=e_norms,
        grad_norms_p=p_norms,
    )


BENCH_SHAPES = {
    # the two shapes bench.py times (bench.py SCENARIOS)
    "headline": dict(
        n_particles=10000, grid=32, frames=4, substeps=1, width=800, height=800,
        n_views=1, force_mask=False, max_pairs=1 << 16, max_per_tile=512,
    ),
    "realworld": dict(
        n_particles=30000, grid=70, frames=2, substeps=20, width=1920, height=1080,
        n_views=3, force_mask=True, max_pairs=1 << 18, max_per_tile=512,
    ),
}


def build_scene(
    n_particles: int,
    grid: int,
    substeps: int,
    width: int,
    height: int,
    n_views: int,
    force_mask: bool,
    max_pairs: int,
    max_per_tile: int,
    seed: int = 0,
    layer_widths=(64, 64),
    lora_r: int = 16,
    lora_alpha: float = 16.0,
    sh_degree: int = 3,
    spread: Optional[float] = None,
    device=None,
) -> GroundingScene:
    """The bench scene recipe with random weights from ``seed`` (base
    weights scaled by 0.05, then LoRA r / alpha on every linear). The
    points fill [0.4, 0.6]^3, or with ``spread`` a cube of that side
    around 0.525 (0.7 puts particles in every slab of a halo grid)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if spread is None:
        pts = (0.4 + 0.2 * rng.random((n_particles, 3))).astype(np.float32)
    else:
        pts = (0.525 - spread / 2 + spread * rng.random((n_particles, 3))).astype(np.float32)
    colors = rng.random((n_particles, 3)).astype(np.float32)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    constants = MPMConstants(
        num_grids=grid,
        bound=1,
        bc="noslip",
        dt=f32(1e-3 / substeps),
        gravity=f32([0.0, -9.8, 0.0]),
        eps=f32(6e-7),
    )
    statics = Statics(
        vol=f32(np.full(n_particles, 2e-8)),
        rho=f32(np.full(n_particles, 1000.0)),
        clip_bound=f32(np.full(n_particles, 0.1)),
        enabled=torch.ones(n_particles, dtype=torch.int32, device=device),
    )
    gen = torch.Generator().manual_seed(seed)
    mat_cfg = MetaMaterialConfig(layer_widths=tuple(layer_widths))
    materials = []
    for cls in (InvariantFullMetaElasticity, InvariantFullMetaPlasticity):
        mat = cls.init(mat_cfg, gen, device)
        with torch.no_grad():
            for p in mat.parameters():
                p.mul_(0.05)
        mat.init_lora(gen, r=lora_r, alpha=lora_alpha)
        materials.append(mat)
    with torch.no_grad():
        gaussians = create_from_points(pts, colors, sh_degree=sh_degree, device=device)
        table = compute_binding_table(gaussians, f32(pts), max_particles=10)
    cams = [
        Camera.look_at(
            eye=np.array([0.5 + 1.6 * np.sin(2.1 * v), 0.55, 0.5 - 1.6 * np.cos(2.1 * v)]),
            target=np.array([0.5, 0.5, 0.5]),
            fov=0.8,
            width=width,
            height=height,
            device=device,
        )
        for v in range(n_views)
    ]
    return GroundingScene(
        constants=constants,
        statics=statics,
        elasticity=materials[0],
        plasticity=materials[1],
        gaussians=gaussians,
        binding=table,
        cameras=cams,
        init_x=f32(pts),
        size=np.ones(3),
        center=np.zeros(3),
        background=f32(np.ones(3)),
        substeps=substeps,
        pixel_loss="l2",
        force_mask_data=force_mask,
        raster_cfg=RasterConfig(max_pairs=max_pairs, max_per_tile=max_per_tile),
    )
