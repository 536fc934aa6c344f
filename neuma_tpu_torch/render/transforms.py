"""Rigid and similarity transforms of Gaussian packs.

Counterpart of ``neuma_tpu/render/transforms.py``
(``quaternion_multiply``, ``translate_points``, ``scale_points``,
``rotate_points``, ``transform_gaussians``): translation, scaling about
an origin (a log-scale offset on the extents), rotation of positions,
quaternions and SH coefficients (``ops/wigner.py``). Each returns new
tensors; nothing is changed in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops.rotation import rotmat_to_quat
from ..ops.wigner import rotate_sh
from .gaussians import GaussianPack


def quaternion_multiply(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """The product with ``q1`` applied first and ``q0`` after it, in the
    JAX package's argument order (wxyz)."""
    w0, x0, y0, z0 = torch.movedim(q0, -1, 0)
    w1, x1, y1, z1 = torch.movedim(q1, -1, 0)
    return torch.stack(
        [
            -x1 * x0 - y1 * y0 - z1 * z0 + w1 * w0,
            x1 * w0 + y1 * z0 - z1 * y0 + w1 * x0,
            -x1 * z0 + y1 * w0 + z1 * x0 + w1 * y0,
            x1 * y0 - y1 * x0 + z1 * w0 + w1 * z0,
        ],
        dim=-1,
    )


def translate_points(points: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return points + t[None, :]


def scale_points(
    points: torch.Tensor,
    log_scales: torch.Tensor,
    scale: torch.Tensor,
    origin: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale about ``origin`` (the mean point when None); the Gaussians'
    log scales move by log(scale)."""
    scale = torch.as_tensor(scale, dtype=points.dtype, device=points.device)
    if origin is None:
        origin = torch.mean(points, dim=0, keepdim=True)
    return scale * (points - origin), log_scales + torch.log(scale)


def rotate_points(
    points: torch.Tensor, rotations: torch.Tensor, R: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate positions and compose the Gaussians' quaternions with R's
    (the SH coefficients are rotated by the caller)."""
    points = points @ R.T
    quat = rotmat_to_quat(R)[None, :]
    rotations = quaternion_multiply(
        rotations / torch.linalg.norm(rotations, dim=-1, keepdim=True), quat
    )
    return points, rotations / torch.linalg.norm(rotations, dim=-1, keepdim=True)


def transform_gaussians(
    pack: GaussianPack,
    R: Optional[torch.Tensor] = None,
    t: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    origin: Optional[torch.Tensor] = None,
) -> GaussianPack:
    """Scale, then rotate, then translate (the registration's order);
    returns a new pack."""
    xyz, scaling, rotation, f_rest = pack.xyz, pack.scaling, pack.rotation, pack.features_rest
    if scale is not None:
        xyz, scaling = scale_points(xyz, scaling, scale, origin)
    if R is not None:
        xyz, rotation = rotate_points(xyz, rotation, R)
        if f_rest.shape[1] > 0:
            f_rest = rotate_sh(f_rest, R)
    if t is not None:
        xyz = translate_points(xyz, t)
    return dataclasses.replace(
        pack, xyz=xyz, scaling=scaling, rotation=rotation, features_rest=f_rest
    )
