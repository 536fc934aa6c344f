"""Analytic constitutive laws: elasticity F -> Cauchy stress, plasticity
F -> corrected F.

Counterpart of ``neuma_tpu/materials/preset.py`` (``CorotatedElasticity``,
``StVKElasticity``, ``VolumeElasticity``, ``SigmaElasticity``,
``IdentityPlasticity``, ``SigmaPlasticity``, ``VonMisesPlasticity``,
``DruckerPragerPlasticity``). Each is an ``nn.Module`` built from its
config mapping; its learnable values (``log_E``, and ``sigma_y`` or
``friction_angle``) are (1,) float32 parameters, initialised as in the
JAX package's ``init`` (``random`` scales them by 0.8) unless ``params``
gives them. ``params()`` returns them as a dict of the JAX package's
form. The SVD is the port's ``ops/svd3.py`` with its closed-form
adjoint, and the plasticity return maps keep the sigma >= 0.05 clamp.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.svd3 import svd3

Params = Dict


def _lame(E, nu):
    mu = E / (2.0 * (1.0 + nu))
    la = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, la


def _eye(F: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=F.dtype, device=F.device)


class _Learnable(nn.Module):
    """Holds named (1,) float32 parameters."""

    def __init__(self, init: Params, params: Optional[Params]):
        super().__init__()
        values = init if params is None else params
        self.names = tuple(init)
        for k in self.names:
            v = torch.as_tensor(values[k], dtype=torch.float32).reshape(1).clone()
            self.register_parameter(k, nn.Parameter(v))

    def params(self) -> Params:
        return {k: getattr(self, k) for k in self.names}


class _ElasticBase(_Learnable):
    def __init__(self, cfg, params: Optional[Params] = None):
        self.E = float(cfg["E"])
        self.nu = float(cfg["nu"])
        self.random = bool(cfg.get("random", False))
        log_e = math.log(self.E)
        if self.random:
            log_e *= 0.8
        super().__init__({"log_E": [log_e]}, params)

    def _lame(self):
        return _lame(torch.exp(self.log_E), self.nu)


class CorotatedElasticity(_ElasticBase):
    """2 mu (F - R) F^T + la J (J - 1) I."""

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        mu, la = self._lame()
        U, sigma, Vh = svd3(F)
        R = U @ Vh
        corotated = 2.0 * mu * ((F - R) @ F.transpose(-1, -2))
        J = torch.prod(sigma, dim=-1)[..., None, None]
        return corotated + la * J * (J - 1.0) * _eye(F)


class StVKElasticity(_ElasticBase):
    """2 mu F E_green + la J (J - 1) I."""

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        mu, la = self._lame()
        _, sigma, _ = svd3(F)
        eye = _eye(F)
        green = 0.5 * (F.transpose(-1, -2) @ F - eye)
        J = torch.prod(sigma, dim=-1)[..., None, None]
        return 2.0 * mu * (F @ green) + la * J * (J - 1.0) * eye


class VolumeElasticity(_ElasticBase):
    """Pressure only, in the 'ziran' or 'taichi' form."""

    def __init__(self, cfg, params: Optional[Params] = None):
        super().__init__(cfg, params)
        self.mode = str(cfg.get("mode", "taichi")).casefold()
        if self.mode not in ("ziran", "taichi"):
            raise ValueError(f"invalid mode for volume elasticity: {self.mode}")

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        mu, la = self._lame()
        J = torch.linalg.det(F)[..., None, None]
        eye = _eye(F)
        if self.mode == "ziran":
            kappa = 2.0 / 3.0 * mu + la
            gamma = 2.0
            return kappa * (J - 1.0 / torch.pow(J, gamma - 1.0)) * eye
        return la * J * (J - 1.0) * eye


class SigmaElasticity(_ElasticBase):
    """Hencky-strain Kirchhoff stress U diag(2 mu log s + la tr(log s)) U^T."""

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        mu, la = self._lame()
        U, sigma, _ = svd3(F)
        epsilon = torch.log(sigma)
        tau = 2.0 * mu * epsilon + la * torch.sum(epsilon, dim=-1, keepdim=True)
        return (U * tau[..., None, :]) @ U.transpose(-1, -2)


class IdentityPlasticity(_Learnable):
    def __init__(self, cfg=None, params: Optional[Params] = None):
        super().__init__({}, params)

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        return F


class SigmaPlasticity(_Learnable):
    """Isotropic volume projection F -> J^(1/3) I."""

    def __init__(self, cfg=None, params: Optional[Params] = None):
        super().__init__({}, params)

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        J = torch.linalg.det(F)
        cbrt = torch.sign(J) * torch.abs(J) ** (1.0 / 3.0)
        return cbrt[..., None, None] * _eye(F)


def _log_strain(F: torch.Tensor):
    """U, Vh, epsilon = log(max(sigma, 0.05)), its trace and deviatoric
    part and that part's norm."""
    U, sigma, Vh = svd3(F)
    epsilon = torch.log(torch.clamp(sigma, min=0.05))  # NaN guard
    trace = torch.sum(epsilon, dim=-1, keepdim=True)
    epsilon_hat = epsilon - trace / 3
    ehn = torch.linalg.norm(epsilon_hat, dim=-1, keepdim=True)
    return U, Vh, epsilon, trace, epsilon_hat, ehn


class VonMisesPlasticity(_Learnable):
    """Log-sigma yield-surface projection."""

    def __init__(self, cfg, params: Optional[Params] = None):
        self.E = float(cfg["E"])
        self.nu = float(cfg["nu"])
        self.random = bool(cfg.get("random", False))
        log_e, sy = math.log(self.E), float(cfg["sigma_y"])
        if self.random:
            log_e *= 0.8
            sy *= 0.8
        super().__init__({"log_E": [log_e], "sigma_y": [sy]}, params)

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        mu, _ = _lame(torch.exp(self.log_E), self.nu)
        U, Vh, epsilon, _, epsilon_hat, ehn = _log_strain(F)
        delta_gamma = ehn - self.sigma_y / (2.0 * mu)
        safe_ehn = torch.where(ehn > 0, ehn, 1.0)
        yield_eps = epsilon - (delta_gamma / safe_ehn) * epsilon_hat
        yield_F = (U * torch.exp(yield_eps)[..., None, :]) @ Vh
        return torch.where((delta_gamma > 0.0)[..., None], yield_F, F)


class DruckerPragerPlasticity(_Learnable):
    """Friction-cone return map for granular media."""

    def __init__(self, cfg, params: Optional[Params] = None):
        self.E = float(cfg["E"])
        self.nu = float(cfg["nu"])
        self.cohesion = float(cfg.get("cohesion", 0.0))
        self.random = bool(cfg.get("random", False))
        log_e, fa = math.log(self.E), float(cfg["friction_angle"])
        if self.random:
            log_e *= 0.8
            fa *= 0.8
        super().__init__({"log_E": [log_e], "friction_angle": [fa]}, params)

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        mu, la = _lame(torch.exp(self.log_E), self.nu)
        sin_phi = torch.sin(torch.deg2rad(self.friction_angle))
        alpha = math.sqrt(2.0 / 3.0) * 2.0 * sin_phi / (3.0 - sin_phi)
        cohesion = self.cohesion
        U, Vh, epsilon, trace, epsilon_hat, ehn = _log_strain(F)
        expand_epsilon = torch.full_like(epsilon, cohesion)
        shifted_trace = trace - cohesion * 3
        delta_gamma = ehn + (3 * la + 2.0 * mu) / (2.0 * mu) * shifted_trace * alpha
        safe_ehn = torch.where(ehn > 0, ehn, 1.0)
        compress_epsilon = epsilon - (torch.clamp(delta_gamma, min=0.0) / safe_ehn) * epsilon_hat
        epsilon = torch.where(shifted_trace < 0.0, compress_epsilon, expand_epsilon)
        return (U * torch.exp(epsilon)[..., None, :]) @ Vh
