"""Simulation state containers.

Counterpart of ``neuma_tpu/core/types.py``: ``MPMConstants`` (with
``from_cfg``), ``GridGeom`` (a view of the grid), ``Statics`` (with
``from_sections`` and ``with_enabled_at_step``) and ``ParticleState`` as
plain dataclasses of float32 tensors, each with a ``.to(device)``, and
``GridState`` (the grid fields, flattened).

Conventions (as in the JAX package): the grid is a cube of
``num_grids`` cells per side in [0, 1]^3 with ``dx = 1 / num_grids``;
``F`` is the deformation gradient (identity at rest), ``C`` the APIC
affine matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .device import resolve_device


def _to(obj, device):
    return dataclasses.replace(
        obj,
        **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        },
    )


@dataclasses.dataclass(frozen=True)
class MPMConstants:
    """``num_grids``, ``bound`` and ``bc`` select shapes and branches;
    ``dt``, ``gravity`` and ``eps`` are float32 tensors."""

    num_grids: int = 32
    bound: int = 1
    bc: str = "freeslip"  # 'freeslip' | 'noslip'
    dt: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(1e-3, dtype=torch.float32)
    )
    gravity: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros(3, dtype=torch.float32)
    )
    eps: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(6e-7, dtype=torch.float32)
    )

    @property
    def dx(self) -> float:
        return 1.0 / self.num_grids

    @property
    def inv_dx(self) -> float:
        return float(self.num_grids)

    @classmethod
    def from_cfg(cls, cfg, device="cpu") -> "MPMConstants":
        """From a mapping with ``num_grids``, ``dt``, ``bound``,
        ``gravity``, ``bc`` and ``eps`` (the reference's
        ``MPMModelBuilder.parse_cfg``)."""
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
        return cls(
            num_grids=int(cfg["num_grids"]),
            bound=int(cfg["bound"]),
            bc=str(cfg["bc"]),
            dt=f32(cfg["dt"]),
            gravity=f32(cfg["gravity"]),
            eps=f32(cfg["eps"]),
        )

    def to(self, device) -> "MPMConstants":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class GridGeom:
    """A view of the simulation grid for the scatter and gather
    primitives: a (possibly non-cubic) box of ``dims`` cells whose local
    cell (0, 0, 0) sits at the global cell ``origin``.

    ``geom=None`` everywhere means the full cube ``[0, num_grids)^3``.
    The halo-exchange step (``parallel/halo.py``) passes each rank's
    slab view ``(w + lo + hi, G, G)`` at its own x origin. Positions stay
    global; the edge clamp to ``[0, G-1]`` runs in global coordinates
    before the translation into the view, and taps outside the view add
    nothing (they belong to a neighbouring rank's view).
    """

    dims: tuple  # (gx, gy, gz), static
    origin: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros(3, dtype=torch.int64)
    )  # (3,) int64 global cell of local (0, 0, 0)

    @property
    def num_cells(self) -> int:
        gx, gy, gz = self.dims
        return gx * gy * gz

    @classmethod
    def cube(cls, num_grids: int, device="cpu") -> "GridGeom":
        return cls(dims=(num_grids,) * 3, origin=torch.zeros(3, dtype=torch.int64, device=device))

    def to(self, device) -> "GridGeom":
        return _to(self, device)


def geom_dims(constants: MPMConstants, geom: Optional[GridGeom]) -> tuple:
    """The ``(gx, gy, gz)`` cells of ``geom``, the full cube without it
    (the JAX package's ``blocked._geom_dims``)."""
    if geom is None:
        return (constants.num_grids,) * 3
    return tuple(geom.dims)


@dataclasses.dataclass(frozen=True)
class Statics:
    """Per-particle static properties; ``enabled`` is int32 0/1."""

    vol: torch.Tensor  # (N,)
    rho: torch.Tensor  # (N,)
    clip_bound: torch.Tensor  # (N,) advection clamp margin in cells
    enabled: torch.Tensor  # (N,) int32

    @property
    def mass(self) -> torch.Tensor:
        return self.vol * self.rho

    @classmethod
    def from_sections(cls, sections, vols, rhos, clip_bounds, spans, step=0, device="cpu"):
        """Section-wise constant fill; a section is enabled where
        ``span[0] <= step < span[1]``."""
        fill = lambda values, dtype: torch.as_tensor(
            np.concatenate([np.full(n, v, dtype) for n, v in zip(sections, values)]),
            device=device,
        )
        return cls(
            vol=fill(vols, np.float32),
            rho=fill(rhos, np.float32),
            clip_bound=fill(clip_bounds, np.float32),
            enabled=fill([1 if s[0] <= step < s[1] else 0 for s in spans], np.int32),
        )

    def with_enabled_at_step(self, sections, spans, step) -> "Statics":
        """The same statics with ``enabled`` set per section for ``step``
        (``span[0] <= step < span[1]``): at ``step == span[1]`` a section
        is disabled, as in the JAX package."""
        en = np.concatenate(
            [np.full(n, 1 if s[0] <= step < s[1] else 0, np.int32) for n, s in zip(sections, spans)]
        )
        return dataclasses.replace(self, enabled=torch.as_tensor(en, device=self.enabled.device))

    def to(self, device) -> "Statics":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """Dynamic per-particle state."""

    x: torch.Tensor  # (N, 3)
    v: torch.Tensor  # (N, 3)
    C: torch.Tensor  # (N, 3, 3)
    F: torch.Tensor  # (N, 3, 3)

    @classmethod
    def initial(cls, x: torch.Tensor, v: torch.Tensor) -> "ParticleState":
        n = x.shape[0]
        eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(n, 3, 3)
        return cls(
            x=x,
            v=v,
            C=torch.zeros((n, 3, 3), dtype=x.dtype, device=x.device),
            F=eye.contiguous(),
        )

    @property
    def num_particles(self) -> int:
        return self.x.shape[0]

    def to(self, device) -> "ParticleState":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class GridState:
    """Background grid fields, stored flattened (G^3, ...); ``cube``
    gives the (G, G, G, ...) views."""

    m: torch.Tensor  # (G^3,) mass
    mv: torch.Tensor  # (G^3, 3) momentum
    v: torch.Tensor  # (G^3, 3) velocity

    @classmethod
    def zeros(cls, num_grids: int, dtype=torch.float32, device=None) -> "GridState":
        device = resolve_device(device)
        g3 = num_grids ** 3
        return cls(
            m=torch.zeros((g3,), dtype=dtype, device=device),
            mv=torch.zeros((g3, 3), dtype=dtype, device=device),
            v=torch.zeros((g3, 3), dtype=dtype, device=device),
        )

    def cube(self, num_grids: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        g = num_grids
        return (
            self.m.reshape(g, g, g),
            self.mv.reshape(g, g, g, 3),
            self.v.reshape(g, g, g, 3),
        )
