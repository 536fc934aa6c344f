"""Initial conditions of MPM scenes: object groups in the unit sim box,
their statics and initial velocities.

Counterpart of ``neuma_tpu/sim/initializers.py`` (``bounds_alignment``,
``MPMInitData`` with ``from_points``, ``from_cfg`` and the velocity
setters, ``build_initial_state``, ``build_statics``): the same numpy
scene setup, ending in the port's tensors on ``device``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core.device import resolve_device
from ..core.types import ParticleState, Statics
from ..data.ply import load_ply_points


def bounds_alignment(
    min1: np.ndarray, max1: np.ndarray, min2: np.ndarray, max2: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Scale + translation mapping bound1 onto bound2 (reference
    ``MPMInitData.alignment``, mpm.py:576-594)."""
    center1 = (min1 + max1) / 2
    center2 = (min2 + max2) / 2
    scale = (max2 - min2) / (max1 - min1)
    translation = center2 - center1 * scale
    return scale, translation


@dataclasses.dataclass
class MPMInitData:
    """One object group: particle positions in the unit sim box + material
    statics + initial velocity spec (reference mpm.py:554-692)."""

    rho: float
    clip_bound: float
    span: Tuple[int, int]
    num_particles: int
    vol: float
    pos: np.ndarray
    lin_vel: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )
    ang_vel: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )
    center: Optional[np.ndarray] = None
    ind_vel: Optional[np.ndarray] = None
    size: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.center is None:
            self.center = self.pos.mean(0)

    @classmethod
    def from_points(
        cls,
        points: np.ndarray,
        total_volume: float,
        rho: float,
        clip_bound: float,
        span: Tuple[int, int],
        ori_bounds: Optional[np.ndarray] = None,
        sim_bounds: Optional[np.ndarray] = None,
    ) -> "MPMInitData":
        """Rescale ``points`` from ``ori_bounds`` into ``sim_bounds``
        (both (2, 3)), asserting the result lies in [0, 1]^3 (reference
        mpm.py:656-675)."""
        p = np.asarray(points, np.float64).reshape(-1, 3).copy()
        vol = float(total_volume) / p.shape[0]
        size = np.ones(3)
        center = np.zeros(3)
        if ori_bounds is not None and sim_bounds is not None:
            ori_bounds = np.asarray(ori_bounds, np.float64)
            sim_bounds = np.asarray(sim_bounds, np.float64)
            size, center = bounds_alignment(
                ori_bounds[0], ori_bounds[1], sim_bounds[0], sim_bounds[1]
            )
            vol = vol * float(np.prod(size))
            p = p * size + center
        if not (p.min() >= 0.0 and p.max() <= 1.0):
            raise ValueError(
                f"particles out of the unit sim box: [{p.min(0)}, {p.max(0)}]"
            )
        return cls(
            rho=rho,
            clip_bound=clip_bound,
            span=tuple(span),
            num_particles=p.shape[0],
            vol=vol,
            pos=p.astype(np.float32),
            center=center,
            size=size,
        )

    @classmethod
    def from_cfg(cls, cfg, asset_root: Optional[Path] = None) -> "MPMInitData":
        """Load a cached/raw point cloud per the reference's config contract
        (``MPMInitData.get``, mpm.py:596-677). Requires ``shape.name``
        resolving to ``<asset_root>/<name>.npz`` (keys p_x, vol) or
        ``<name>.ply``."""
        shape = cfg["shape"]
        name = shape["name"]
        root = Path(shape.get("asset_root") or asset_root or ".")
        npz = root / f"{name}.npz"
        if npz.is_file():
            file = np.load(npz)
            p_x = file["p_x"]
            vol = float(file["vol"]) * p_x.shape[0]
        else:
            p_x = load_ply_points(root / f"{name}.ply")
            sort = shape.get("sort")
            if sort is not None:
                order = np.argsort(-p_x[:, sort], stable=True)
                p_x = p_x[order]
            # Convex-hull volume fallback (mpm.py:647-653).
            try:
                from scipy.spatial import ConvexHull

                vol = float(ConvexHull(p_x).volume)
            except (ImportError, RuntimeError, ValueError):  # no scipy, or a flat hull
                ext = p_x.max(0) - p_x.min(0)
                vol = float(np.prod(ext))
            np.savez(npz, p_x=p_x, vol=vol / p_x.shape[0])
        return cls.from_points(
            p_x,
            vol,
            rho=float(cfg["rho"]),
            clip_bound=float(cfg["clip_bound"]),
            span=tuple(cfg["span"]),
            ori_bounds=shape.get("ori_bounds"),
            sim_bounds=shape.get("sim_bounds"),
        )

    def set_lin_vel(self, value) -> None:
        self.lin_vel = np.asarray(value, np.float64)

    def set_ang_vel(self, value) -> None:
        self.ang_vel = np.asarray(value, np.float64)

    def set_ind_vel(self, value) -> None:
        self.ind_vel = np.asarray(value, np.float64)


def build_initial_state(
    groups: Sequence[MPMInitData], device=None
) -> Tuple[ParticleState, List[int]]:
    """Concatenate groups, seeding v = lin + omega x (x - center)
    (reference ``MPMStateInitializer.finalize``, mpm.py:707-735), on
    ``cuda`` unless ``device="cpu"``."""
    device = resolve_device(device)
    pos_groups, vel_groups, sections = [], [], []
    for group in groups:
        pos = group.pos.copy()
        if group.ind_vel is None:
            vel = group.lin_vel + np.cross(
                group.ang_vel, pos - group.center
            )
        else:
            vel = group.ind_vel.copy()
        pos_groups.append(pos.astype(np.float32))
        vel_groups.append(np.broadcast_to(vel, pos.shape).astype(np.float32))
        sections.append(group.num_particles)
    x = np.concatenate(pos_groups, axis=0)
    v = np.concatenate(vel_groups, axis=0)
    f32 = lambda a: torch.as_tensor(a, device=device)
    return ParticleState.initial(f32(x), f32(v)), sections


def build_statics(groups: Sequence[MPMInitData], step: int = 0, device=None) -> Statics:
    """Reference ``MPMStaticsInitializer.finalize`` (mpm.py:760-776), on
    ``cuda`` unless ``device="cpu"``."""
    device = resolve_device(device)
    sections = [g.num_particles for g in groups]
    return Statics.from_sections(
        sections,
        vols=[g.vol for g in groups],
        rhos=[g.rho for g in groups],
        clip_bounds=[g.clip_bound for g in groups],
        spans=[g.span for g in groups],
        step=step,
        device=device,
    )
