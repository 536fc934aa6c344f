"""Pre-simulated NeuMA scene instance for interactive viewing.

Counterpart of ``neuma_tpu/vis/instance.py`` (``_set_lora_scale``,
``SceneObject``, ``NeuMAInstance`` with ``apply_object_settings``,
``simulate`` and ``render_frame``) and of the reference's
``NeuMAInstance``: runs the rollout once, keeps each frame's Gaussian
means and deformed covariances on the host as numpy arrays, and renders
any stored frame from any camera on demand. ``apply_object_settings``
takes the simulation panel's edits (existence, drop velocity, LoRA
weight, adaptor) before the next ``simulate``.

The port's materials are modules that hold their weights, where the JAX
package passes immutable parameter trees. So an object's materials are
its own: a registry entry (``{"params_e": tree, "params_p": tree}`` of
tensors, or a zero-argument callable returning one) is copied into the
object's modules, and a ``weight`` edit rewrites the ``lora_scale``
buffers of that object's modules only, never the registry's tree.

``simulate`` and ``render_frame`` run on ``cuda`` unless the instance
was given ``device="cpu"`` (without a CUDA device they raise). Each runs
under ``torch.no_grad()`` itself: grad mode is per thread, and the
viewer answers every request on a new thread. The step carries one block
sort across the rollout and refreshes it per substep; the positions are
those of a fresh sort per substep, as the JAX class makes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import MPMConstants
from ..materials.compose import ComposeMaterial
from ..nn.mlp import MLP
from ..render.binding import BindingTable, apply_binding_F, apply_binding_xyz, deform_cov_by_F
from ..render.camera import Camera
from ..render.gaussians import GaussianPack
from ..render.rasterize import RasterConfig, rasterize
from ..sim.initializers import build_initial_state, build_statics
from ..sim.mpm import mpm_step
from ..sim.p2g_kernel import build_step_layouts, refresh_step_layouts


def _set_lora_scale(material, weight: float) -> None:
    """Rewrite every ``lora_scale`` buffer of ``material`` to ``weight``
    (= alpha/r; the reference panel sets alpha = weight * r,
    viewer.py:135), in place. A material without LoRA is left as it is."""
    with torch.no_grad():
        for module in material.modules():
            scale = getattr(module, "lora_scale", None)
            if isinstance(scale, torch.Tensor):
                scale.fill_(float(weight))


def _load_params(material, tree) -> None:
    """Copy an MLP parameter tree into ``material``'s own weights: a new
    ``MLP`` of cloned leaves on the material's device."""
    device = next(material.parameters()).device
    clone = lambda p: {k: torch.as_tensor(v).detach().clone().to(device) for k, v in p.items()}
    material.mlp = MLP(material.mlp_cfg, {"layers": [clone(p) for p in tree["layers"]],
                                          "final": clone(tree["final"])})


@dataclasses.dataclass
class SceneObject:
    """One simulated object with its render/binding/material bundle.

    The editable fields mirror the reference's per-object simulation
    panel (simulation_panel.py:3-37): drop velocity along the up axis,
    LoRA weight (= alpha/r, written into the ``lora_scale`` buffers),
    adaptor choice (by registry name), and existence. ``elasticity`` and
    ``plasticity`` are material modules holding this object's weights
    (the JAX class's ``params_e`` / ``params_p``)."""

    name: str
    gaussians: GaussianPack
    binding: BindingTable
    elasticity: torch.nn.Module
    plasticity: torch.nn.Module
    init_data: object  # MPMInitData
    enabled: bool = True
    scaling_modifier: float = 1.0
    drop_vel: float = 0.0
    lora_weight: float = 1.0
    adaptor: Optional[str] = None
    up_axis: int = 1


class NeuMAInstance:
    def __init__(
        self,
        constants: MPMConstants,
        objects: Sequence[SceneObject],
        num_frames: int = 100,
        substeps: int = 1,
        background: Optional[torch.Tensor] = None,
        raster_cfg: RasterConfig = RasterConfig(),
        adaptor_registry: Optional[Dict[str, dict]] = None,
        device=None,
    ):
        """``adaptor_registry`` maps adaptor names (the reference's
        bouncy/clay/honey/jelly/rubber/sand dropdown, viewer.py:16-32) to
        ``{"params_e": ..., "params_p": ...}`` trees (or zero-arg
        callables returning such a dict) used when the panel switches an
        object's NeuMA. ``device`` is resolved when the instance
        simulates or renders (``cuda`` unless ``"cpu"``)."""
        self.constants = constants
        self.objects = list(objects)
        self.num_frames = num_frames
        self.substeps = substeps
        self.background = background if background is not None else torch.ones(3)
        self.raster_cfg = raster_cfg
        self.adaptor_registry = adaptor_registry or {}
        self.device = device
        self.frames: List[Dict[str, np.ndarray]] = []

    # -- simulation panel edits (reference simulation_panel.py:3-37) -----

    def apply_object_settings(self, name: str, settings: Dict) -> None:
        """Apply panel edits to one object: ``exists`` (bool),
        ``drop_vel`` (float, applied NEGATIVE along the up axis —
        reference viewer.py:134 'NOTE: drop_vel is negative'),
        ``weight`` (LoRA alpha/r, rewrites the lora_scale buffers),
        ``adaptor`` (registry name; the entry is copied into the
        object's materials)."""
        obj = next(o for o in self.objects if o.name == name)
        if "exists" in settings:
            obj.enabled = bool(settings["exists"])
        if "drop_vel" in settings:
            obj.drop_vel = float(settings["drop_vel"])
            vel = np.zeros(3)
            vel[obj.up_axis] = -obj.drop_vel
            obj.init_data.set_lin_vel(vel)
        if "weight" in settings:
            obj.lora_weight = float(settings["weight"])
            _set_lora_scale(obj.elasticity, obj.lora_weight)
            _set_lora_scale(obj.plasticity, obj.lora_weight)
        if "adaptor" in settings and settings["adaptor"]:
            adaptor = str(settings["adaptor"])
            if adaptor != obj.adaptor:
                entry = self.adaptor_registry[adaptor]
                if callable(entry):
                    entry = self.adaptor_registry[adaptor] = entry()
                _load_params(obj.elasticity, entry["params_e"])
                _load_params(obj.plasticity, entry["params_p"])
                obj.adaptor = adaptor
                # re-apply the current weight to the fresh params
                _set_lora_scale(obj.elasticity, obj.lora_weight)
                _set_lora_scale(obj.plasticity, obj.lora_weight)

    # -- simulation ------------------------------------------------------

    @torch.no_grad()
    def simulate(self) -> None:
        """Full rollout; stores per-frame packs on the host (reference
        neuma_instance.py:254-336)."""
        device = resolve_device(self.device)
        objs = [o for o in self.objects if o.enabled]
        if not objs:
            self.frames = []
            return
        groups = [o.init_data for o in objs]
        state, sections = build_initial_state(groups, device=device)
        statics = build_statics(groups, device=device)
        constants = self.constants.to(device)
        elasticity = ComposeMaterial([o.elasticity.to(device) for o in objs], sections)
        plasticity = ComposeMaterial([o.plasticity.to(device) for o in objs], sections)
        packs = [o.gaussians.to(device) for o in objs]
        bindings = [o.binding.to(device) for o in objs]

        covs = [p.get_covariance(o.scaling_modifier) for p, o in zip(packs, objs)]
        splits, off = [], 0
        for n in sections:
            splits.append((off, off + n))
            off += n
        prev_x = [state.x[a:b] for a, b in splits]
        prev_k = [p.xyz for p in packs]

        layouts = build_step_layouts(constants, state.x) if constants.num_grids > 24 else None
        self.frames = []
        for _ in range(self.num_frames):
            for _ in range(self.substeps):
                if layouts is not None:
                    layouts, _ = refresh_step_layouts(constants, state.x, layouts)
                state = mpm_step(constants, statics, state, elasticity(state.F), layouts)
                state = dataclasses.replace(state, F=plasticity(state.F))
            means_list, cov_list = [], []
            for i, (a, b) in enumerate(splits):
                m = apply_binding_xyz(bindings[i], state.x[a:b], prev_x[i], prev_k[i])
                F_k = apply_binding_F(bindings[i], state.F[a:b])
                cov_list.append(deform_cov_by_F(covs[i], F_k))
                means_list.append(m)
                prev_x[i] = state.x[a:b]
                prev_k[i] = m
            self.frames.append({"means": torch.cat(means_list).cpu().numpy(),
                                "cov": torch.cat(cov_list).cpu().numpy()})

    # -- rendering -------------------------------------------------------

    @torch.no_grad()
    def render_frame(self, frame_idx: int, camera: Camera) -> np.ndarray:
        """(H, W, 3) uint8 render of stored frame ``frame_idx``
        (reference neuma_instance.py:338-386)."""
        device = resolve_device(self.device)
        objs = [o for o in self.objects if o.enabled]
        packs = [o.gaussians.to(device) for o in objs]
        opac = torch.cat([p.get_opacity for p in packs])
        shs = torch.cat([p.get_features for p in packs])
        sh_degree = packs[0].sh_degree
        frame = self.frames[int(np.clip(frame_idx, 0, len(self.frames) - 1))]
        img = rasterize(
            torch.as_tensor(frame["means"], device=device),
            torch.as_tensor(frame["cov"], device=device),
            opac,
            camera.to(device),
            self.background.to(device),
            shs=shs,
            sh_degree=sh_degree,
            cfg=self.raster_cfg,
        )
        return np.clip(img.cpu().numpy().transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
