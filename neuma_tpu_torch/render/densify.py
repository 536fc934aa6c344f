"""3DGS densification as functions over ``GaussianPack``.

Counterpart of ``neuma_tpu/render/densify.py`` (``DensifyState`` with
``zeros`` and ``add_stats``, ``prune``, ``reset_opacity``,
``densify_and_clone``, ``densify_and_split``, ``densify_and_prune``): the
reference's adaptive density control (``gaussian_model.py:359-475``),
which NeuMA training itself never runs. The selections and shape changes
are made on the host in numpy, as in the JAX package; every returned
pack stays on the input pack's device. ``densify_and_split`` draws its
offsets with ``rng.normal(0, stds)`` from a numpy ``Generator``, so both
packages make the same children from the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.rotation import quat_to_rotmat
from .gaussians import GaussianPack


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class DensifyState:
    """Screen-space gradient accumulation (gaussian_model.py:471-475)."""

    xyz_gradient_accum: np.ndarray  # (K, 1)
    denom: np.ndarray  # (K, 1)
    max_radii2d: np.ndarray  # (K,)

    @classmethod
    def zeros(cls, k: int) -> "DensifyState":
        return cls(xyz_gradient_accum=np.zeros((k, 1), np.float32),
                   denom=np.zeros((k, 1), np.float32),
                   max_radii2d=np.zeros((k,), np.float32))

    def add_stats(self, viewspace_grad, update_filter, radii=None) -> None:
        g = np.linalg.norm(np.asarray(viewspace_grad)[update_filter, :2], axis=-1, keepdims=True)
        self.xyz_gradient_accum[update_filter] += g
        self.denom[update_filter] += 1
        if radii is not None:
            self.max_radii2d[update_filter] = np.maximum(
                self.max_radii2d[update_filter], np.asarray(radii)[update_filter])


def prune(pack: GaussianPack, mask) -> GaussianPack:
    """Remove the Gaussians where ``mask`` is true (gaussian_model.py:359-373)."""
    return pack.masked(~np.asarray(mask))


def reset_opacity(pack: GaussianPack, ceiling: float = 0.01) -> GaussianPack:
    """Clamp the activated opacity to at most ``ceiling``
    (gaussian_model.py:222-225)."""
    new_op = torch.clamp(pack.get_opacity, max=ceiling)
    return dataclasses.replace(pack, opacity=torch.log(new_op / (1.0 - new_op)))


def densify_and_clone(pack: GaussianPack, grads, grad_threshold: float, scene_extent: float,
                      percent_dense: float = 0.01) -> GaussianPack:
    """Clone the small high-gradient Gaussians (gaussian_model.py:482-499)."""
    grads = np.asarray(grads).reshape(-1)
    selected = (grads >= grad_threshold) & (
        _np(pack.get_scaling).max(axis=1) <= percent_dense * scene_extent)
    if not selected.any():
        return pack
    return GaussianPack.concatenate([pack, pack.masked(selected)])


def densify_and_split(pack: GaussianPack, grads, grad_threshold: float, scene_extent: float,
                      percent_dense: float = 0.01, n_split: int = 2,
                      rng: Optional[np.random.Generator] = None) -> GaussianPack:
    """Split the big high-gradient Gaussians into ``n_split`` samples with
    scales shrunk by 0.8 n_split, removing the originals
    (gaussian_model.py:441-466)."""
    rng = rng or np.random.default_rng(0)
    grads = np.asarray(grads).reshape(-1)
    selected = (grads >= grad_threshold) & (
        _np(pack.get_scaling).max(axis=1) > percent_dense * scene_extent)
    if not selected.any():
        return pack
    sel = pack.masked(selected)
    sel_scaling = _np(sel.get_scaling)
    samples = rng.normal(0.0, np.tile(sel_scaling, (n_split, 1))).astype(np.float32)
    rots = np.tile(_np(quat_to_rotmat(sel.rotation)), (n_split, 1, 1))
    new_xyz = np.einsum("kij,kj->ki", rots, samples) + np.tile(_np(sel.xyz), (n_split, 1))
    new_scaling = np.log(np.tile(sel_scaling, (n_split, 1)) / (0.8 * n_split))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=pack.xyz.device)
    children = GaussianPack(
        xyz=f32(new_xyz),
        features_dc=sel.features_dc.repeat(n_split, 1, 1),
        features_rest=sel.features_rest.repeat(n_split, 1, 1),
        scaling=f32(new_scaling),
        rotation=sel.rotation.repeat(n_split, 1),
        opacity=sel.opacity.repeat(n_split, 1),
        sh_degree=pack.sh_degree,
    )
    return GaussianPack.concatenate([pack.masked(~selected), children])


def densify_and_prune(pack: GaussianPack, state: DensifyState, max_grad: float,
                      min_opacity: float, extent: float, max_screen_size: Optional[float] = None,
                      percent_dense: float = 0.01, rng: Optional[np.random.Generator] = None
                      ) -> Tuple[GaussianPack, DensifyState]:
    """One round of adaptive density control (gaussian_model.py:452-468)."""
    grads = state.xyz_gradient_accum / np.maximum(state.denom, 1e-12)
    grads = np.nan_to_num(grads, nan=0.0).reshape(-1)
    n_before = pack.num_gaussians
    pack = densify_and_clone(pack, grads, max_grad, extent, percent_dense)
    # The clones start with zero accumulated gradient (the reference's
    # padded_grad in densify_and_split).
    grads = np.concatenate([grads, np.zeros(pack.num_gaussians - n_before, np.float32)])
    pack = densify_and_split(pack, grads, max_grad, extent, percent_dense, rng=rng)
    prune_mask = _np(pack.get_opacity).reshape(-1) < min_opacity
    if max_screen_size:
        prune_mask = prune_mask | (_np(pack.get_scaling).max(axis=1) > 0.1 * extent)
    pack = prune(pack, prune_mask)
    return pack, DensifyState.zeros(pack.num_gaussians)
