"""The system under test: the port's scene built from the benchmark's
inputs, and the two traffic runners that call its entry points.

Only this module (and ``run.py``, for the kernel counters) imports the
port, ``neuma_tpu_torch``. ``train`` drives stage 2
(``train.grounding.finetune_constitutive``) as the training CLI does;
``serve`` runs the render CLI's per-step sequence
(``apps/render.py::_rollout``): a no-grad step of
``sim.rollout.make_step_fn(diff=False)`` after ``refresh_step_layouts``,
the binding, and ``rasterize_with_aux`` for every view, each image copied
without blocking into a pinned host buffer made in set-up; one
synchronize ends the frame. The float-to-uint8 conversion, the PNG
encoding and the video are host-only and stay out of the window.

A configuration of several objects (``inputs.py``) is one particle
system whose materials are the port's ``ComposeMaterial`` of each
object's InvariantFull pair, routed by the objects' particle counts, with
a binding table per object; ``serve`` then follows the frame of
``apps/inference.py::_rollout``: each object bound on its own, the
objects joined once, then every view rendered. Stage 2 fine-tunes one
object at a time, so ``train`` takes one object only.

Both runners return what the check (``check.py``) compares and what the
metric readers (``metrics/``) read; neither writes to disk.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

import numpy as np
import torch


class _WindowClosed(Exception):
    """Raised from the trainer's ``log_fn`` to end the run."""


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tree(layers) -> dict:
    """The port's MLP parameter tree from the raw layers (copies: the
    trainer updates the LoRA leaves in place)."""
    copy = [{k: v.detach().clone() for k, v in layer.items()} for layer in layers]
    return {"layers": copy[:-1], "final": copy[-1]}


def build_scene(cfg: dict, raw: dict, device):
    """The port's ``GroundingScene`` for the configuration; the binding
    tables and the camera matrices are the port's own. With several
    objects the materials are ``ComposeMaterial``s and ``binding`` holds
    one table per object."""
    from neuma_tpu_torch.core.types import MPMConstants, Statics
    from neuma_tpu_torch.materials.compose import ComposeMaterial
    from neuma_tpu_torch.materials.meta import (
        InvariantFullMetaElasticity,
        InvariantFullMetaPlasticity,
        MetaMaterialConfig,
    )
    from neuma_tpu_torch.render.binding import compute_binding_table
    from neuma_tpu_torch.render.camera import Camera
    from neuma_tpu_torch.render.gaussians import GaussianPack
    from neuma_tpu_torch.render.rasterize import RasterConfig
    from neuma_tpu_torch.train.grounding import GroundingScene

    from .inputs import per_particle

    sim, m = cfg["sim"], cfg["materials"]
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    constants = MPMConstants(num_grids=int(sim["num_grids"]), bound=int(sim["bound"]),
                             bc=str(sim["bc"]), dt=f32(sim["dt"]), gravity=f32(sim["gravity"]),
                             eps=f32(sim["eps"]))
    n = raw["x0"].shape[0]
    statics = Statics(vol=raw["vol"].clone(), rho=raw["rho"].clone(),
                      clip_bound=per_particle(raw, "clip_bound", device),
                      enabled=torch.ones(n, dtype=torch.int32, device=device))
    pairs = []
    for obj in raw["objects"]:
        mat_cfg = MetaMaterialConfig(layer_widths=tuple(m["layer_widths"]), norm=None,
                                     nonlinearity=m["nonlinearity"], no_bias=True,
                                     normalize_input=True, alpha=obj["alpha"])
        pairs.append((InvariantFullMetaElasticity(mat_cfg, _tree(obj["materials"]["elasticity"])),
                      InvariantFullMetaPlasticity(mat_cfg, _tree(obj["materials"]["plasticity"]))))
    if len(pairs) == 1:
        elasticity, plasticity = pairs[0]
    else:
        sections = [obj["particles"] for obj in raw["objects"]]
        elasticity = ComposeMaterial([e for e, _ in pairs], sections)
        plasticity = ComposeMaterial([p for _, p in pairs], sections)
    g = raw["gaussians"]
    gaussians = GaussianPack(
        xyz=g["xyz"].clone(), features_dc=g["features_dc"].clone(),
        features_rest=g["features_rest"].clone(), scaling=g["scaling"].clone(),
        rotation=g["rotation"].clone(), opacity=g["opacity"].clone(), sh_degree=int(cfg["sh_degree"]))
    size, center = raw["size"], raw["center"]
    de_x0 = (raw["x0"] - f32(center)) / f32(size)
    with torch.no_grad():
        if len(pairs) == 1:
            table = compute_binding_table(gaussians, de_x0)
        else:  # each object's Gaussians bound to its own particles
            table = []
            for ps, gs in sections_of(raw):
                pack = GaussianPack(**{f: getattr(gaussians, f)[gs] for f in (
                    "xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")},
                    sh_degree=gaussians.sh_degree)
                table.append(compute_binding_table(pack, de_x0[ps]))
    cams = [Camera.from_Rt(np.asarray(c["R_w2c"]).T, np.asarray(c["t"]), c["fov_x"], c["fov_y"],
                           c["width"], c["height"], device=device) for c in raw["cameras"]]
    r = cfg["raster"]
    return GroundingScene(
        constants=constants, statics=statics, elasticity=elasticity.to(device),
        plasticity=plasticity.to(device), gaussians=gaussians, binding=table, cameras=cams,
        init_x=raw["x0"].clone(), size=np.asarray(size, np.float64),
        center=np.asarray(center, np.float64), background=f32(cfg["background"]),
        substeps=int(sim["substeps"]), pixel_loss=cfg["pixel_loss"], force_mask_data=False,
        raster_cfg=RasterConfig(max_pairs=int(r["max_pairs"]), max_per_tile=int(r["max_per_tile"]),
                                segment=int(r["segment"])),
        remat=cfg["remat"],
    )


def sections_of(raw: dict) -> list:
    """Each object's (particle slice, Gaussian slice)."""
    out, p0, g0 = [], 0, 0
    for obj in raw["objects"]:
        p1, g1 = p0 + obj["particles"], g0 + obj["gaussians"]
        out.append((slice(p0, p1), slice(g0, g1)))
        p0, g0 = p1, g1
    return out


def lora_leaves(scene) -> dict:
    """The trained leaves by the reference's names."""
    out = {}
    for name, mat in (("elasticity", scene.elasticity), ("plasticity", scene.plasticity)):
        tree = mat.params()
        for i, layer in enumerate(list(tree["layers"]) + [tree["final"]]):
            for k in ("lora_a", "lora_b"):
                out[f"{name}.{i}.{k}"] = layer[k]
    return out


def _snapshot(leaves: dict) -> dict:
    return {k: v.detach().clone() for k, v in leaves.items()}


@dataclasses.dataclass
class Window:
    """What a runner hands back: the timed window, the stretch traced
    after it, and what the check compares."""

    t_start: float = 0.0  # perf_counter at the window's start
    ends: list = dataclasses.field(default_factory=list)  # perf_counter at each unit's end
    frames_per_unit: int = 1
    peak_bytes: int = 0
    failed: int = 0
    checked: dict = dataclasses.field(default_factory=dict)
    traced: dict = dataclasses.field(default_factory=dict)


def train(cfg: dict, traffic: dict, raw: dict, scene, seconds: float, tracer, device,
          on_window: Callable[[], None], on_close: Callable[[], None] = lambda: None) -> Window:
    """Stage 2 in one call of ``finetune_constitutive``: its first
    ``checked_steps`` epochs are set-up (the reference follows them), the
    window's epochs run until ``seconds`` have passed, and with a tracer
    one more epoch is profiled. ``on_window`` runs as the window opens,
    ``on_close`` as it closes."""
    from neuma_tpu_torch.train import grounding

    if len(raw["objects"]) > 1:
        raise ValueError(f"stage 2 fine-tunes one object at a time; the configuration has "
                         f"{len(raw['objects'])} objects")
    checked = int(traffic["checked_steps"])
    frames = int(cfg["train"]["num_frames"])
    win = Window(frames_per_unit=frames)
    leaves = lora_leaves(scene)
    snaps = {0: _snapshot(leaves)}
    losses = []
    state = {"tracing": False}

    def log_fn(epoch, loss, e_norm, p_norm, decay, lr_e, lr_p):
        now = time.perf_counter()
        if epoch <= checked:
            losses.append(loss)
            if epoch == checked:
                snaps[epoch] = _snapshot(leaves)
                on_window()
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                win.t_start = time.perf_counter()
            return
        if state["tracing"]:
            win.traced.update(tracer.stop(), frames=frames)
            raise _WindowClosed
        win.ends.append(now)
        if now - win.t_start < seconds:
            return
        on_close()
        if device.type == "cuda":
            win.peak_bytes = torch.cuda.max_memory_allocated(device)
        if tracer is None:
            raise _WindowClosed
        gc.enable()
        win.traced["leaves"] = _snapshot(leaves)
        state["tracing"] = True
        tracer.start()

    tcfg = dict(cfg["train"])
    first_mu = {}
    real_radam = grounding.radam

    def radam(*args, **kwargs):
        """The trainer's own optimizer; its first update's state is kept
        (its momentum is 1 - b1 times the gradient it got). The instance's
        wrapper removes itself after the checked steps."""
        opt = real_radam(*args, **kwargs)
        cls_update = opt.update

        def update(grads, st, params):
            out = cls_update(grads, st, params)
            if out[1].count == 1:
                first_mu[len(first_mu)] = [m.detach().clone() for m in out[1].mu]
            if out[1].count >= checked:
                del opt.update
            return out

        opt.update = update
        opt_b1[0] = opt.b1
        return opt

    opt_b1 = [None]
    grounding.radam = radam
    try:
        grounding.finetune_constitutive(scene, raw["gt"], raw["init_v"], tcfg, checkpoint_fn=None,
                                        log_fn=log_fn, train_state_path=None, write_state=False,
                                        device=device)
    except _WindowClosed:
        pass
    finally:
        grounding.radam = real_radam
    gc.enable()
    names = list(leaves)
    mus = first_mu[0] + first_mu[1]  # elasticity's leaves, then plasticity's
    win.checked.update(losses=losses, snaps=snaps,
                       first_grads={k: m / (1.0 - opt_b1[0]) for k, m in zip(names, mus)})
    return win


def serve(cfg: dict, traffic: dict, raw: dict, scene, seconds: float, tracer, device,
          on_window: Callable[[], None], sample: list,
          on_close: Callable[[], None] = lambda: None) -> Window:
    """The render CLI's rollout, frame by frame, back to back rollouts of
    ``rollout_steps`` from the initial state. Frames whose index is in
    ``sample`` keep their state before and after and their images; so
    does the window's last frame. ``on_window`` runs as the window opens,
    ``on_close`` as it closes."""
    from neuma_tpu_torch.core.types import ParticleState
    from neuma_tpu_torch.render.binding import (
        apply_binding_F,
        apply_binding_xyz,
        deform_cov_by_F,
    )
    from neuma_tpu_torch.render.rasterize import rasterize_with_aux
    from neuma_tpu_torch.sim.p2g_kernel import build_step_layouts, refresh_step_layouts
    from neuma_tpu_torch.sim.rollout import denormalize_points, make_step_fn

    torch.set_grad_enabled(False)
    constants, statics = scene.constants, scene.statics
    step_fn = make_step_fn(constants, statics, scene.elasticity, scene.plasticity, diff=False)
    cov0 = scene.gaussians.get_covariance(scene.scaling_modifier)
    opacity = scene.gaussians.get_opacity
    shs = scene.gaussians.get_features
    deg = scene.gaussians.sh_degree
    cams = scene.cameras
    h, w = cams[0].height, cams[0].width
    steps = int(traffic["rollout_steps"])
    n = scene.init_x.shape[0]
    if len(raw["objects"]) == 1:
        v0 = raw["init_v"].reshape(-1, 3).expand(n, 3).contiguous()

        def bind(de_x, de_x_prev, g_prev, F):
            means3d = apply_binding_xyz(scene.binding, de_x, de_x_prev, g_prev)
            return means3d, deform_cov_by_F(cov0, apply_binding_F(scene.binding, F))
    else:
        v0 = torch.cat([o["init_v"].reshape(1, 3).expand(o["particles"], 3)
                        for o in raw["objects"]])
        sections = list(zip(scene.binding, sections_of(raw)))

        def bind(de_x, de_x_prev, g_prev, F):
            """Each object bound on its own, then joined once."""
            means, covs = [], []
            for table, (ps, gs) in sections:
                means.append(apply_binding_xyz(table, de_x[ps], de_x_prev[ps], g_prev[gs]))
                covs.append(deform_cov_by_F(cov0[gs], apply_binding_F(table, F[ps])))
            return torch.cat(means), torch.cat(covs)
    de_x0 = denormalize_points(scene.init_x, scene.size, scene.center)
    xyz0 = scene.gaussians.xyz
    # the window's images: two ring slots, one for the traced stretch,
    # then one slot per sampled frame
    pin = device.type == "cuda"
    host = torch.empty((3 + len(sample), len(cams), 3, h, w), dtype=torch.float32, pin_memory=pin)
    slot_of = {f: 3 + i for i, f in enumerate(sample)}
    ring = [None, None]
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    spans = {"sim": 0.0, "render": 0.0}

    class Rollout:
        def __init__(self):
            self.reset()

        def reset(self):
            self.state = ParticleState.initial(scene.init_x, v0)
            self.layouts = build_step_layouts(constants, scene.init_x) \
                if constants.num_grids > 24 else None
            self.de_x_prev, self.g_prev, self.step = de_x0, xyz0, 0

        def frame(self, slot: int, keep_pre: Optional[int] = None, timed_spans: bool = False):
            nonlocal overflow
            if self.step == steps:
                self.reset()
            s = self.state
            if keep_pre is not None:  # no copies: the step makes new tensors
                ring[keep_pre] = {"x": s.x, "v": s.v, "C": s.C, "F": s.F,
                                  "de_x_prev": self.de_x_prev, "g_prev": self.g_prev}
            t0 = time.perf_counter()
            if self.layouts is not None:
                self.layouts, _ = refresh_step_layouts(constants, s.x, self.layouts)
            s = step_fn(s, self.layouts)
            if timed_spans:
                sync(device)
                t1 = time.perf_counter()
                spans["sim"] += t1 - t0
            de_x = denormalize_points(s.x, scene.size, scene.center)
            means3d, cov_def = bind(de_x, self.de_x_prev, self.g_prev, s.F)
            flags = []
            for v, cam in enumerate(cams):
                img, aux = rasterize_with_aux(means3d, cov_def, opacity, cam, scene.background,
                                              shs=shs, sh_degree=deg, cfg=scene.raster_cfg)
                host[slot, v].copy_(img, non_blocking=True)
                flags.append(aux["overflow"])
            overflow = overflow + torch.stack(flags).any()  # frames that dropped pairs
            if timed_spans:
                sync(device)
                spans["render"] += time.perf_counter() - t1
            self.state, self.de_x_prev, self.g_prev = s, de_x, means3d
            self.step += 1

    ro = Rollout()
    for _ in range(int(traffic["warmup_frames"])):
        ro.frame(0)
    sync(device)
    ro.reset()
    on_window()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    win = Window(frames_per_unit=1)
    checked = {}
    win.t_start = time.perf_counter()
    i = 0
    while True:
        ro.frame(slot_of.get(i, i % 2), keep_pre=i % 2)
        sync(device)
        now = time.perf_counter()
        win.ends.append(now)
        last = i
        i += 1
        if last in slot_of or now - win.t_start >= seconds:
            st = ro.state
            checked[last] = dict(ring[last % 2], post={"x": st.x, "v": st.v, "C": st.C, "F": st.F},
                                 images=slot_of.get(last, last % 2))
        if now - win.t_start >= seconds:
            break
    on_close()
    gc.enable()
    if device.type == "cuda":
        win.peak_bytes = torch.cuda.max_memory_allocated(device)
    win.failed = int(overflow)
    win.checked = {"frames": checked, "host": host}
    if tracer is not None:
        k = int(traffic["traced_frames"])
        if ro.step + 2 * k > steps:  # keep both stretches inside one rollout
            ro.reset()
        for _ in range(k):
            ro.frame(2, timed_spans=True)
        sync(device)
        win.traced["spans"] = {"sim_s": spans["sim"], "render_s": spans["render"], "frames": k,
                               "views": len(cams)}
        start = {"x": ro.state.x, "v": ro.state.v, "C": ro.state.C, "F": ro.state.F,
                 "de_x_prev": ro.de_x_prev, "g_prev": ro.g_prev}
        tracer.start()
        for _ in range(k):
            ro.frame(2)
            sync(device)
        win.traced.update(tracer.stop(), frames=k, start=start)
    torch.set_grad_enabled(True)
    return win
