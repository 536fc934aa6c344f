"""Particle <-> Gaussian kernel binding.

Counterpart of ``neuma_tpu/render/binding.py`` (``BindingTable`` with
``counts``, ``save`` and ``load``,
``mahalanobis_field``, ``compute_binding_table``, ``binding_flags``,
``apply_binding_xyz``,
``apply_binding_F``, ``deform_cov_by_F``): a dense (K, M) index/weight
table from the chunked Mahalanobis field, applied by gathers and a
weighted sum. The JAX package's stop-gradients are kept: the previous
positions and Gaussian centres of ``apply_binding_xyz`` and both inputs
of ``deform_cov_by_F`` are detached, so the one live gradient path is
``p_curr -> means3d``.

That gather's transpose sums many Gaussians into one particle. It runs
through an inverse table (``BindingTable.with_inverse``): for each
particle, the flat (kernel, slot) positions that name it with a nonzero
weight, padded to the largest fan-in, summed in that fixed order. No
atomics, so the gradient repeats bit for bit on the card. Zero-weight
slots are left out: they add exactly 0 to a finite cotangent.

``torch.topk`` orders ties among the +inf (rejected) stats differently
from ``jax.lax.top_k``; those slots carry weight 0, so the table's
action is the same.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.profiling import span
from .gaussians import GaussianPack, strip_symmetric, unstrip_symmetric

CHI2_95_3 = 7.814727903251179  # chi2.ppf(0.95, 3)


def _chi2_ppf_3(confidence: float) -> float:
    if abs(confidence - 0.95) < 1e-9:
        return CHI2_95_3
    from scipy.stats import chi2

    return float(chi2.ppf(confidence, 3))


@dataclasses.dataclass(frozen=True)
class BindingTable:
    indices: torch.Tensor  # (K, M) int64
    weights: torch.Tensor  # (K, M) float32, rows sum to 1 (or 0 if unbound)
    # (N, fan) flat positions into (K*M,) per particle, K*M as padding
    inverse: Optional[torch.Tensor] = None

    @property
    def num_kernels(self) -> int:
        return self.indices.shape[0]

    def counts(self) -> torch.Tensor:
        """Bound particles per kernel: (K,)."""
        return torch.sum(self.weights > 0, dim=1)

    def save(self, path) -> None:
        """The JAX package's ``bindings.npz``: int32 ``indices``, float32
        ``weights``."""
        np.savez(
            path,
            indices=self.indices.cpu().numpy().astype(np.int32),
            weights=self.weights.cpu().numpy().astype(np.float32),
        )

    @classmethod
    def load(cls, path, device="cpu") -> "BindingTable":
        d = np.load(path)
        return cls(
            indices=torch.as_tensor(d["indices"].astype(np.int64), device=device),
            weights=torch.as_tensor(d["weights"].astype(np.float32), device=device),
        )

    def to(self, device) -> "BindingTable":
        inv = None if self.inverse is None else self.inverse.to(device)
        return BindingTable(self.indices.to(device), self.weights.to(device), inv)

    def with_inverse(self, n_particles: int) -> "BindingTable":
        """The table with its inverse for ``n_particles`` particles."""
        if self.inverse is not None and self.inverse.shape[0] == n_particles:
            return self
        return dataclasses.replace(self, inverse=_inverse_table(self, n_particles))


def _inverse_table(table: BindingTable, n: int) -> torch.Tensor:
    flat = table.indices.reshape(-1)
    pos = torch.nonzero(table.weights.reshape(-1) != 0).reshape(-1)
    part = flat[pos]
    order = torch.argsort(part, stable=True)
    part, pos = part[order], pos[order]
    counts = torch.bincount(part, minlength=n)
    first = torch.cumsum(counts, 0) - counts
    fan = max(int(counts.max()), 1) if part.numel() else 1
    inv = torch.full((n, fan), flat.numel(), dtype=torch.int64, device=flat.device)
    inv[part, torch.arange(part.numel(), device=flat.device) - first[part]] = pos
    return inv


class _BindingGather(torch.autograd.Function):
    """sum_m w[k, m] d[idx[k, m]] with the inverse-table transpose."""

    @staticmethod
    def forward(ctx, d, indices, weights, inverse):
        ctx.save_for_backward(weights, inverse)
        return torch.einsum("km,kmc->kc", weights, d[indices])

    @staticmethod
    def backward(ctx, g):
        weights, inverse = ctx.saved_tensors
        contrib = (weights[:, :, None] * g[:, None, :]).reshape(-1, g.shape[1])
        pad = torch.zeros((1, g.shape[1]), dtype=g.dtype, device=g.device)
        return torch.cat([contrib, pad])[inverse].sum(1), None, None, None


def mahalanobis_field(means, inv_covs, particles) -> torch.Tensor:
    """d^T Sigma^-1 d for every (kernel, particle) pair: (K, P)."""
    d = particles[None, :, :] - means[:, None, :]
    return torch.einsum("kpi,kij,kpj->kp", d, inv_covs, d)


def compute_binding_table(
    gaussians: GaussianPack,
    particles: torch.Tensor,
    confidence: float = 0.95,
    max_particles: int = 10,
    chunk: int = 1024,
) -> BindingTable:
    """Keep particles with stat <= chi2.ppf(confidence, 3), the nearest
    ``max_particles`` of them, with uniform weights over the kept set."""
    threshold = _chi2_ppf_3(confidence)
    inv_covs = torch.linalg.inv(unstrip_symmetric(gaussians.get_covariance()))
    means = gaussians.xyz
    K = means.shape[0]
    top_k = min(max_particles, particles.shape[0])
    inf = torch.tensor(float("inf"), device=means.device)
    indices, weights = [], []
    for start in range(0, K, chunk):
        p = mahalanobis_field(
            means[start : start + chunk], inv_covs[start : start + chunk], particles
        )
        stat = torch.where(p <= threshold, p, inf)
        vals, idx = torch.topk(stat, top_k, dim=1, largest=False, sorted=True)
        inside = torch.isfinite(vals)
        count = torch.clamp(inside.sum(dim=1, keepdim=True), min=1)
        w = torch.where(inside, 1.0 / count.to(torch.float32), 0.0)
        pad = max_particles - top_k
        if pad:
            idx = torch.nn.functional.pad(idx, (0, pad))
            w = torch.nn.functional.pad(w, (0, pad))
        indices.append(idx)
        weights.append(w.to(torch.float32))
    return BindingTable(torch.cat(indices), torch.cat(weights))


def binding_flags(
    gaussians: GaussianPack,
    particles: torch.Tensor,
    confidence: float = 0.95,
    max_particles: int = 10,
    chunk: int = 1024,
) -> torch.Tensor:
    """Boolean 'has any bound particle' per kernel: (K,)."""
    table = compute_binding_table(gaussians, particles, confidence, max_particles, chunk)
    return table.counts() > 0


@span("binding.xyz")
def apply_binding_xyz(table: BindingTable, p_curr, p_prev, k_prev) -> torch.Tensor:
    """Incremental kernel advection: k_prev + B @ (p_curr - p_prev), with
    ``p_prev`` and ``k_prev`` detached (reference stop-gradients)."""
    d = p_curr - p_prev.detach()
    if d.requires_grad:
        table = table.with_inverse(d.shape[0])
        moved = _BindingGather.apply(d, table.indices, table.weights, table.inverse)
    else:
        moved = torch.einsum("km,kmc->kc", table.weights, d[table.indices])
    return k_prev.detach() + moved


@span("binding.F")
def apply_binding_F(table: BindingTable, deform_grad: torch.Tensor) -> torch.Tensor:
    """Kernel deformation gradient = weighted particle F."""
    gathered = deform_grad.reshape(-1, 9)[table.indices]
    return torch.einsum("km,kmc->kc", table.weights, gathered).reshape(-1, 3, 3)


@span("binding.cov")
def deform_cov_by_F(cov3d: torch.Tensor, F: torch.Tensor, stop_gradient: bool = True) -> torch.Tensor:
    """Sigma' = F Sigma F^T, symmetrized and packed to 6; with
    ``stop_gradient`` (the reference's default) both inputs are detached."""
    if stop_gradient:
        cov3d, F = cov3d.detach(), F.detach()
    out = F @ unstrip_symmetric(cov3d) @ F.transpose(-1, -2)
    return strip_symmetric(0.5 * (out + out.transpose(-1, -2)))
