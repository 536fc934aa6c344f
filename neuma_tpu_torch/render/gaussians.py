"""3D Gaussian parameter pack (Particle-GS scene representation).

Counterpart of ``neuma_tpu/render/gaussians.py`` (``strip_symmetric``,
``unstrip_symmetric``, ``build_covariance``, ``GaussianPack`` with its
getters, PLY I/O, ``masked`` and ``concatenate``, and
``create_from_points``). The PLY layout is 3DGS's, so either package
reads the other's ``kernels.ply``. Raw parameters are pre-activation, as in
3DGS: log scales, unnormalized wxyz quaternions, logit opacities, and
SH features (K, (deg+1)^2, 3) with the DC term first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..data.ply import load_ply, save_ply
from ..ops.rotation import quat_to_rotmat
from ..ops.sh import rgb_to_sh


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) as [xx, xy, xz, yy, yz, zz]."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def unstrip_symmetric(packed: torch.Tensor) -> torch.Tensor:
    xx, xy, xz, yy, yz, zz = [packed[..., i] for i in range(6)]
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def build_covariance(
    scaling: torch.Tensor, rotation: torch.Tensor, scaling_modifier: float = 1.0
) -> torch.Tensor:
    """Sigma = (R S)(R S)^T packed to 6; ``scaling`` is activated."""
    R = quat_to_rotmat(rotation)
    L = R * (scaling_modifier * scaling)[..., None, :]
    return strip_symmetric(L @ L.transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class GaussianPack:
    xyz: torch.Tensor  # (K, 3)
    features_dc: torch.Tensor  # (K, 1, 3)
    features_rest: torch.Tensor  # (K, (deg+1)^2 - 1, 3)
    scaling: torch.Tensor  # (K, 3) log scale
    rotation: torch.Tensor  # (K, 4) wxyz
    opacity: torch.Tensor  # (K, 1) logit
    sh_degree: int = 3

    @property
    def num_gaussians(self) -> int:
        return self.xyz.shape[0]

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        return self.rotation / torch.linalg.norm(self.rotation, dim=-1, keepdim=True)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        return build_covariance(self.get_scaling, self.rotation, scaling_modifier)

    def to(self, device) -> "GaussianPack":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if f.name != "sh_degree"
            },
        )

    # --- PLY I/O (the 3DGS layout) ---------------------------------------

    @classmethod
    def from_ply(cls, path, sh_degree: int = 3, device="cpu") -> "GaussianPack":
        """x/y/z, f_dc_*, f_rest_* (stored (C, coeff), held (coeff, C)),
        opacity, scale_* and rot_* fields."""
        d = load_ply(path)
        n = d["x"].shape[0]
        n_coeff = (sh_degree + 1) ** 2 - 1
        numbered = lambda prefix: sorted(
            (k for k in d if k.startswith(prefix)), key=lambda s: int(s.split("_")[-1])
        )
        rest_names = numbered("f_rest_")
        if len(rest_names) != 3 * n_coeff:
            raise ValueError(f"expected {3 * n_coeff} f_rest_* fields, found {len(rest_names)}")
        if n_coeff == 0:
            rest = np.zeros((n, 0, 3), np.float32)
        else:
            rest = np.stack([d[k] for k in rest_names], axis=1)
            rest = rest.reshape(n, 3, n_coeff).transpose(0, 2, 1)
        f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
        return cls(
            xyz=f32(np.stack([d["x"], d["y"], d["z"]], axis=1)),
            features_dc=f32(np.stack([d["f_dc_0"], d["f_dc_1"], d["f_dc_2"]], axis=1)[:, None, :]),
            features_rest=f32(rest),
            scaling=f32(np.stack([d[k] for k in numbered("scale_")], axis=1)),
            rotation=f32(np.stack([d[k] for k in numbered("rot_")], axis=1)),
            opacity=f32(d["opacity"][:, None]),
            sh_degree=sh_degree,
        )

    def to_ply(self, path) -> None:
        n = self.num_gaussians
        arr = lambda t: t.detach().cpu().numpy()
        props: Dict[str, np.ndarray] = {}
        props["x"], props["y"], props["z"] = arr(self.xyz).T
        props["nx"] = props["ny"] = props["nz"] = np.zeros(n, np.float32)
        for prefix, a in (("f_dc", arr(self.features_dc).transpose(0, 2, 1).reshape(n, -1)),
                          ("f_rest", arr(self.features_rest).transpose(0, 2, 1).reshape(n, -1))):
            for i in range(a.shape[1]):
                props[f"{prefix}_{i}"] = a[:, i]
        props["opacity"] = arr(self.opacity)[:, 0]
        for prefix, a in (("scale", arr(self.scaling)), ("rot", arr(self.rotation))):
            for i in range(a.shape[1]):
                props[f"{prefix}_{i}"] = a[:, i]
        save_ply(path, props)

    def masked(self, mask) -> "GaussianPack":
        """The Gaussians where ``mask`` (K,) is true (opacity pruning)."""
        mask = torch.as_tensor(np.asarray(mask, bool), device=self.xyz.device)
        return dataclasses.replace(
            self,
            **{f.name: getattr(self, f.name)[mask]
               for f in dataclasses.fields(self) if f.name != "sh_degree"},
        )

    @classmethod
    def concatenate(cls, packs) -> "GaussianPack":
        """Several objects' Gaussians as one pack."""
        return cls(
            **{f.name: torch.cat([getattr(p, f.name) for p in packs])
               for f in dataclasses.fields(cls) if f.name != "sh_degree"},
            sh_degree=packs[0].sh_degree,
        )


def create_from_points(
    points, colors=None, sh_degree: int = 3, device="cpu"
) -> GaussianPack:
    """Isotropic scales from the mean squared distance to the 3 nearest
    neighbours (chunked brute-force kNN), identity rotations, opacity 0.1."""
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    n = pts.shape[0]
    if colors is None:
        colors = np.full((n, 3), 0.5, np.float32)
    colors = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    k_nn = min(4, n)

    def mean_d2(chunk):
        d2 = torch.sum((chunk[:, None, :] - pts[None, :, :]) ** 2, dim=-1)
        knn = torch.topk(d2, k_nn, dim=1, largest=False, sorted=True).values[:, 1:]
        if knn.shape[1] == 0:
            return torch.full((chunk.shape[0],), 1e-4, dtype=chunk.dtype, device=device)
        return torch.mean(knn, dim=-1)

    dist2 = torch.clamp(
        torch.cat([mean_d2(pts[i : i + 4096]) for i in range(0, n, 4096)]), min=1e-7
    )
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    rots = torch.zeros((n, 4), dtype=torch.float32, device=device)
    rots[:, 0] = 1.0
    opacity = torch.full(
        (n, 1), float(np.float32(np.log(0.1 / 0.9))), dtype=torch.float32, device=device
    )
    n_rest = (sh_degree + 1) ** 2 - 1
    return GaussianPack(
        xyz=pts,
        features_dc=rgb_to_sh(colors)[:, None, :],
        features_rest=torch.zeros((n, n_rest, 3), dtype=torch.float32, device=device),
        scaling=scales,
        rotation=rots,
        opacity=opacity,
        sh_degree=sh_degree,
    )
