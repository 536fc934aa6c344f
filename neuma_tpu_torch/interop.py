"""Weight and state bridge between the JAX package's trees and the port.

The inputs are the JAX package's objects with numpy leaves (for
example ``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side);
they are read by attribute and key only, so nothing of the JAX package
is imported here. Converted:

* MLP param trees (``nn/mlp.py``): ``layers[i]`` and ``final`` with the
  leaves ``kernel``, ``kernel_v``/``kernel_g``, ``bias``, ``lora_a``,
  ``lora_b`` and ``lora_scale``;
* ``MPMConstants``, ``Statics`` and ``ParticleState``;
* ``GaussianPack``'s arrays, ``BindingTable``'s ``indices`` and
  ``weights``, and ``Camera``'s matrices, fov and size;
* ``LPIPSParams`` (``lpips_params_from_numpy``: its ``convs`` pairs,
  ``heads`` and ``pretrained``) and the registration's Sim(3) params
  (``sim3_params_from_numpy``: ``r``, ``t``, ``s``);
* materials (``material_from_numpy``): every preset (``log_E`` and its
  ``sigma_y`` / ``friction_angle``), every meta family (its MLP tree,
  or the Spline pair's knot values ``yk_f`` / ``yk_g`` / ``yk_h``), and
  ``ComposeMaterial`` from a list of trees (``compose_from_numpy``). The
  class is named as in the JAX package (both packages use the same
  names) and built from its config mapping (a meta family also takes the
  JAX package's ``MetaMaterialConfig`` dataclass);
* the viewer's ``SceneObject`` (``scene_object_from_numpy``): its
  Gaussians, binding, ``MPMInitData`` (``init_data_from_numpy``), panel
  fields, and both materials built from ``params_e`` / ``params_p``.

``to_numpy`` maps any of the port's trees back to numpy (bit-exact).

Gradients and optimizer state: the port trains the LoRA leaves of each
material as a flat list in module order (``layers[0].lora_a``,
``layers[0].lora_b``, ..., ``final.lora_b``). ``lora_leaves`` reads the
same list from a JAX-form tree (params, a gradient tree, or RAdam's
``mu``/``nu``), and ``radam_state_to_numpy`` /
``radam_state_from_numpy`` move the port's RAdam state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import materials
from .core.types import MPMConstants, ParticleState, Statics
from .materials.meta import _MetaBase
from .nn.mlp import LORA_LEAVES
from .render.binding import BindingTable
from .render.camera import Camera
from .render.gaussians import GaussianPack
from .train.lpips import LPIPSParams
from .sim.initializers import MPMInitData
from .train.optim import RAdamState
from .vis.instance import SceneObject


def _t(a, device, dtype=None) -> torch.Tensor:
    arr = np.array(a, copy=True)
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def mlp_params_from_numpy(tree, device="cpu"):
    """A JAX MLP param tree (nested dicts / lists of numpy leaves) ->
    the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: mlp_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(mlp_params_from_numpy(v, device) for v in tree)
    return _t(tree, device)


def to_numpy(tree):
    """Tensors, dicts, lists, tuples and the port's dataclasses -> numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return {f.name: to_numpy(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return tree


def constants_from_numpy(c, device="cpu") -> MPMConstants:
    return MPMConstants(
        num_grids=int(c.num_grids),
        bound=int(c.bound),
        bc=str(c.bc),
        dt=_t(np.float32(c.dt), device),
        gravity=_t(np.asarray(c.gravity, np.float32), device),
        eps=_t(np.float32(c.eps), device),
    )


def statics_from_numpy(s, device="cpu") -> Statics:
    return Statics(
        vol=_t(s.vol, device),
        rho=_t(s.rho, device),
        clip_bound=_t(s.clip_bound, device),
        enabled=_t(s.enabled, device, torch.int32),
    )


def state_from_numpy(s, device="cpu") -> ParticleState:
    return ParticleState(x=_t(s.x, device), v=_t(s.v, device), C=_t(s.C, device), F=_t(s.F, device))


def gaussians_from_numpy(g, device="cpu") -> GaussianPack:
    return GaussianPack(
        xyz=_t(g.xyz, device),
        features_dc=_t(g.features_dc, device),
        features_rest=_t(g.features_rest, device),
        scaling=_t(g.scaling, device),
        rotation=_t(g.rotation, device),
        opacity=_t(g.opacity, device),
        sh_degree=int(g.sh_degree),
    )


def binding_from_numpy(t, device="cpu") -> BindingTable:
    return BindingTable(
        indices=_t(t.indices, device, torch.int64), weights=_t(t.weights, device)
    )


def camera_from_numpy(c, device="cpu") -> Camera:
    return Camera(
        world_view=_t(c.world_view, device),
        full_proj=_t(c.full_proj, device),
        camera_center=_t(c.camera_center, device),
        width=int(c.width),
        height=int(c.height),
        fov_x=float(c.fov_x),
        fov_y=float(c.fov_y),
        znear=float(c.znear),
        zfar=float(c.zfar),
    )


def lpips_params_from_numpy(p, device="cpu") -> LPIPSParams:
    return LPIPSParams.from_numpy(p.convs, p.heads, bool(p.pretrained), device)


def sim3_params_from_numpy(params, device="cpu") -> dict:
    """{"r", "t", "s"} numpy (a ``RegistrationResult.params`` or the
    arrays of ``registered_params.npz``) -> float32 tensors."""
    return {k: _t(np.asarray(params[k], np.float32), device) for k in ("r", "t", "s")}


def lora_leaves(tree) -> list:
    """The LoRA leaves of an MLP-form tree, in the port's module order."""
    layers = list(tree["layers"]) + [tree["final"]]
    return [layer[k] for layer in layers for k in LORA_LEAVES if k in layer]


def radam_state_to_numpy(state: RAdamState) -> dict:
    return {"count": state.count, "mu": to_numpy(state.mu), "nu": to_numpy(state.nu)}


def radam_state_from_numpy(count, mu, nu, device="cpu") -> RAdamState:
    conv = lambda xs: [None if x is None else _t(x, device) for x in xs]
    return RAdamState(int(count), conv(mu), conv(nu))


def material_from_numpy(name: str, cfg, params, device="cpu"):
    """The port's material ``name`` with the numpy tree ``params`` of the
    JAX package's same-named material, built from ``cfg``."""
    cls = getattr(materials, name)
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    if issubclass(cls, _MetaBase):
        return cls(materials.MetaMaterialConfig.from_cfg(cfg), mlp_params_from_numpy(params, device))
    return cls(cfg, {k: _t(v, device) for k, v in params.items()}).to(device)


def compose_from_numpy(specs, params_list, sections, device="cpu"):
    """``ComposeMaterial`` over ``specs`` [(name, cfg), ...] with the JAX
    package's list of trees ``params_list``."""
    return materials.ComposeMaterial(
        [material_from_numpy(n, c, p, device) for (n, c), p in zip(specs, params_list)], sections
    )


def init_data_from_numpy(d) -> MPMInitData:
    """The JAX package's ``MPMInitData`` (copied field by field)."""
    opt = lambda a: None if a is None else np.array(a, copy=True)
    return MPMInitData(
        rho=float(d.rho), clip_bound=float(d.clip_bound), span=tuple(d.span),
        num_particles=int(d.num_particles), vol=float(d.vol), pos=np.array(d.pos, copy=True),
        lin_vel=np.array(d.lin_vel, copy=True), ang_vel=np.array(d.ang_vel, copy=True),
        center=opt(d.center), ind_vel=opt(d.ind_vel), size=opt(d.size),
    )


def _material_spec(material):
    """(class name, config) of a JAX material: a meta family's ``cfg``, or
    a preset's attributes (``E``, ``nu``, ...)."""
    cfg = getattr(material, "cfg", None)
    return type(material).__name__, (cfg if cfg is not None else dict(vars(material)))


def scene_object_from_numpy(obj, device="cpu") -> SceneObject:
    """The port's ``SceneObject`` from a JAX ``vis/instance.py::SceneObject``:
    each material is the port's same-named class with the object's
    ``params_e`` / ``params_p`` tree (its own module)."""
    (e_name, e_cfg), (p_name, p_cfg) = _material_spec(obj.elasticity), _material_spec(obj.plasticity)
    to_np = lambda tree: {k: to_np(v) for k, v in tree.items()} if isinstance(tree, dict) else (
        [to_np(v) for v in tree] if isinstance(tree, (list, tuple)) else np.asarray(tree))
    return SceneObject(
        name=obj.name,
        gaussians=gaussians_from_numpy(obj.gaussians, device),
        binding=binding_from_numpy(obj.binding, device),
        elasticity=material_from_numpy(e_name, e_cfg, to_np(obj.params_e), device),
        plasticity=material_from_numpy(p_name, p_cfg, to_np(obj.params_p), device),
        init_data=init_data_from_numpy(obj.init_data),
        enabled=bool(obj.enabled),
        scaling_modifier=float(obj.scaling_modifier),
        drop_vel=float(obj.drop_vel),
        lora_weight=float(obj.lora_weight),
        adaptor=obj.adaptor,
        up_axis=int(obj.up_axis),
    )
