"""Neural material adaptors (NCLaw-style meta materials) with LoRA.

Counterpart of ``neuma_tpu/materials/meta.py``: ``MetaMaterialConfig``
and every family of the JAX package. The InvariantFull pair (the one the
apps build) runs in the same component form as there: F is carried as
nine (N,) tensors, featurized into [sigma - 1 (3), flat(F^T F - I) (9),
det(F) - 1 (1)], run through the MLP, and assembled as R sym(MLP(feat))
with R = U V^h. The Plain, Polar, Invariant and SVD families are in
tensor form, as there; the Spline pair edits the principal stretches
with three learnable cubic splines over uniform knots.

Each material is an ``nn.Module`` whose weights (an ``nn/mlp.py`` tree,
or the Spline pair's knot values) are its parameters; ``forward(F)``
gives the Cauchy stress (elasticity) or the corrected F (plasticity),
where the JAX package has ``apply(params, F)``. ``init`` draws a new
material, ``init_lora`` adds LoRA in place, ``params`` / ``lora_mask``
/ ``lora_params`` give the JAX package's trees.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.mlp import MLP, MLPConfig, Params, add_lora_to_mlp, init_mlp
from ..nn.mlp import lora_mask as _lora_mask
from ..nn.mlp import lora_params as _lora_params
from ..ops.svd3 import svd3, svd3c


@dataclasses.dataclass(frozen=True)
class MetaMaterialConfig:
    layer_widths: Sequence[int] = (64, 64)
    norm: Optional[str] = None
    nonlinearity: Optional[str] = "gelu"
    no_bias: bool = True
    normalize_input: bool = True
    alpha: float = 1e-3  # plasticity correction scale

    @classmethod
    def from_cfg(cls, cfg) -> "MetaMaterialConfig":
        return cls(
            layer_widths=tuple(cfg.get("layer_widths", (64, 64))),
            norm=cfg.get("norm"),
            nonlinearity=cfg.get("nonlinearity", "gelu"),
            no_bias=bool(cfg.get("no_bias", True)),
            normalize_input=bool(cfg.get("normalize_input", True)),
            alpha=float(cfg.get("alpha", 1e-3)),
        )


def _mm9(a, b):
    """Row-major component 3x3 matmul: c[3i+j] = sum_k a[3i+k] b[3k+j]."""
    return [
        sum(a[3 * i + k] * b[3 * k + j] for k in range(3))
        for i in range(3)
        for j in range(3)
    ]


def _unpack9(F: torch.Tensor) -> tuple:
    F9 = F.to(torch.float32).reshape(F.shape[:-2] + (9,))
    return tuple(F9[..., k] for k in range(9))


def _pack9(c9, dtype) -> torch.Tensor:
    return torch.stack(list(c9), dim=-1).reshape(c9[0].shape + (3, 3)).to(dtype)


def _rsym9(r9, y: torch.Tensor):
    """Components of R @ sym(Y) for y (N, 9) = flat(Y)."""
    y9 = [y[..., k] for k in range(9)]
    s = [0.5 * (y9[3 * i + j] + y9[3 * j + i]) for i in range(3) for j in range(3)]
    return _mm9(r9, s)


class _InvariantFullFeatures:
    @staticmethod
    def features_c(f9, normalize: bool):
        """f9: row-major components of F -> (x (N, 13), r9 of R = U Vh)."""
        u9, s3, vh9 = svd3c(f9)
        r9 = _mm9(u9, vh9)
        ftf = [
            sum(f9[3 * r + i] * f9[3 * r + j] for r in range(3))
            for i in range(3)
            for j in range(3)
        ]
        det = (
            f9[0] * (f9[4] * f9[8] - f9[5] * f9[7])
            - f9[1] * (f9[3] * f9[8] - f9[5] * f9[6])
            + f9[2] * (f9[3] * f9[7] - f9[4] * f9[6])
        )
        if normalize:
            feats = (
                [s - 1.0 for s in s3]
                + [c - 1.0 if k in (0, 4, 8) else c for k, c in enumerate(ftf)]
                + [det - 1.0]
            )
        else:
            feats = list(s3) + list(ftf) + [det]
        return torch.stack(feats, dim=-1), r9


class _MetaBase(nn.Module):
    in_dim: int = 13
    out_dim: int = 9

    def __init__(self, cfg: MetaMaterialConfig, params: Params):
        super().__init__()
        if not isinstance(cfg, MetaMaterialConfig):
            cfg = MetaMaterialConfig.from_cfg(cfg)
        self.cfg = cfg
        self.mlp_cfg = self._mlp_config(cfg)
        self.mlp = MLP(self.mlp_cfg, params)

    @classmethod
    def _mlp_config(cls, cfg: MetaMaterialConfig) -> MLPConfig:
        return MLPConfig(
            in_dim=cls.in_dim,
            out_dim=cls.out_dim,
            layer_widths=tuple(cfg.layer_widths),
            norm=cfg.norm,
            nonlinearity=cfg.nonlinearity,
            no_bias=cfg.no_bias,
        )

    @classmethod
    def init(
        cls, cfg: MetaMaterialConfig, generator: torch.Generator, device="cpu"
    ) -> "_MetaBase":
        """A material with freshly drawn weights."""
        return cls(cfg, init_mlp(cls._mlp_config(cfg), generator, device))

    def init_lora(self, generator: torch.Generator, r: int, alpha: float) -> None:
        """Add LoRA leaves to every linear, in place."""
        tree = self.mlp.tree()
        self.mlp = MLP(self.mlp_cfg, add_lora_to_mlp(tree, generator, r, alpha))

    def params(self) -> Params:
        return self.mlp.tree()

    def lora_mask(self) -> Params:
        return _lora_mask(self.params())

    def lora_params(self) -> Params:
        return _lora_params(self.params())


class InvariantFullMetaElasticity(_MetaBase):
    """F -> Cauchy stress = (R sym(MLP(feat))) F^T."""

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        f9 = _unpack9(F)
        x, r9 = _InvariantFullFeatures.features_c(f9, self.cfg.normalize_input)
        p9 = _rsym9(r9, self.mlp(x))
        c9 = [
            sum(p9[3 * i + k] * f9[3 * j + k] for k in range(3))
            for i in range(3)
            for j in range(3)
        ]
        return _pack9(c9, F.dtype)


class InvariantFullMetaPlasticity(_MetaBase):
    """F -> F + alpha * R sym(MLP(feat)); always normalized features."""

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        f9 = _unpack9(F)
        x, r9 = _InvariantFullFeatures.features_c(f9, True)
        d9 = _rsym9(r9, self.mlp(x))
        a = self.cfg.alpha
        return _pack9([f9[k] + a * d9[k] for k in range(9)], F.dtype)


def _sym(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (x + x.transpose(-1, -2))


def _flatten33(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-2] + (9,))


def _unflatten33(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (3, 3))


def _eye(F: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=F.dtype, device=F.device)


def _polar_input(cfg: MetaMaterialConfig, F: torch.Tensor):
    """R = U Vh and the MLP input flat(S - I) (or flat S) of the polar
    split F = R S."""
    U, sigma, Vh = svd3(F)
    V = Vh.transpose(-1, -2)
    S = (V * sigma[..., None, :]) @ Vh
    return U @ Vh, _flatten33(S - _eye(F)) if cfg.normalize_input else _flatten33(S)


class PlainMetaElasticity(_MetaBase):
    """MLP on flat(F - I) (or flat F) gives P; stress = P F^T."""

    in_dim = 9
    out_dim = 9

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        x = _flatten33(F - _eye(F)) if self.cfg.normalize_input else _flatten33(F)
        return _unflatten33(self.mlp(x)) @ F.transpose(-1, -2)


class PlainMetaPlasticity(_MetaBase):
    """F + alpha * MLP(flat(F - I))."""

    in_dim = 9
    out_dim = 9

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        x = _flatten33(F - _eye(F)) if self.cfg.normalize_input else _flatten33(F)
        return F + self.cfg.alpha * _unflatten33(self.mlp(x))


class PolarMetaElasticity(_MetaBase):
    """Polar split F = R S, MLP on S: stress = R sym(MLP) F^T."""

    in_dim = 9
    out_dim = 9

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        R, x = _polar_input(self.cfg, F)
        return (R @ _sym(_unflatten33(self.mlp(x)))) @ F.transpose(-1, -2)


class PolarMetaPlasticity(_MetaBase):
    """F + alpha * R sym(MLP(S))."""

    in_dim = 9
    out_dim = 9

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        R, x = _polar_input(self.cfg, F)
        return F + self.cfg.alpha * (R @ _sym(_unflatten33(self.mlp(x))))


class InvariantMetaElasticity(_MetaBase):
    """MLP on the invariants [tr sigma, tr F^T F, det F] (shifted by 3, 1
    and 1 when normalized, as in the JAX package): stress = R sym(MLP) F^T."""

    in_dim = 3
    out_dim = 9

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        U, sigma, Vh = svd3(F)
        Ft = F.transpose(-1, -2)
        tr_ftf = torch.diagonal(Ft @ F, dim1=-2, dim2=-1).sum(-1)
        det = torch.linalg.det(F)
        if self.cfg.normalize_input:
            x = torch.stack([torch.sum(sigma, dim=-1) - 3.0, tr_ftf - 1.0, det - 1.0], dim=-1)
        else:
            x = torch.stack([torch.sum(sigma, dim=-1), tr_ftf, det], dim=-1)
        return ((U @ Vh) @ _sym(_unflatten33(self.mlp(x)))) @ Ft


class SVDMetaElasticity(_MetaBase):
    """MLP on sigma (- 1): P = U diag(MLP) Vh, stress = P F^T."""

    in_dim = 3
    out_dim = 3

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        U, sigma, Vh = svd3(F)
        y = self.mlp(sigma - 1.0 if self.cfg.normalize_input else sigma)
        return ((U * y[..., None, :]) @ Vh) @ F.transpose(-1, -2)


class SVDMetaPlasticity(_MetaBase):
    """F + alpha * U diag(MLP(sigma - 1)) Vh."""

    in_dim = 3
    out_dim = 3

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        U, sigma, Vh = svd3(F)
        y = self.mlp(sigma - 1.0 if self.cfg.normalize_input else sigma)
        return F + self.cfg.alpha * ((U * y[..., None, :]) @ Vh)


_SPLINE_W = (
    (-1.0, 3.0, -3.0, 1.0),
    (3.0, -6.0, 3.0, 0.0),
    (-3.0, 3.0, 0.0, 0.0),
    (-1.0, 0.0, 0.0, 0.0),
)


class _SplineBase(nn.Module):
    """Xu et al. 2015 cubic-spline material editor: three learnable 1D
    splines, f of the principal stretches, g of the pairwise areas and h
    of the volume, over ``2 num_side_points + 1`` knots (uniform on
    [0, 1] and on [1, xk_max]). The knot values ``yk_f``, ``yk_g``,
    ``yk_h`` are the parameters."""

    zero_init = False

    def __init__(self, cfg, params: Optional[Params] = None):
        super().__init__()
        self.num_side_points = int(cfg["num_side_points"])
        self.xk_max = float(cfg["xk_max"])
        self.yk_max = float(cfg["yk_max"])
        self.alpha = float(cfg.get("alpha", 1e-3))
        left = np.linspace(0.0, 1.0, self.num_side_points + 1)
        right = np.linspace(1.0, self.xk_max, self.num_side_points + 1)
        xk = np.array(list(left[:-1]) + [1.0] + list(right[1:]), np.float32)
        self.register_buffer("xk", torch.as_tensor(xk))
        self.register_buffer("w", torch.tensor(_SPLINE_W, dtype=torch.float32))
        if params is None:
            params = self.default_params(len(xk))
        for k in ("yk_f", "yk_g", "yk_h"):
            v = torch.as_tensor(params[k], dtype=torch.float32).clone()
            self.register_parameter(k, nn.Parameter(v))

    def default_params(self, n: int) -> Params:
        if self.zero_init:
            yk = np.zeros((n,), np.float32)
        else:
            yk = np.linspace(-self.yk_max, self.yk_max, n, dtype=np.float32)
        return {"yk_f": yk, "yk_g": yk, "yk_h": yk}

    @classmethod
    def init(cls, cfg, generator=None, device="cpu") -> "_SplineBase":
        """The JAX package's ``init``: linear knots from -yk_max to yk_max
        (elasticity), zeros (plasticity); no draw."""
        return cls(cfg).to(device)

    def init_lora(self, generator=None, r: int = 0, alpha: float = 0.0) -> None:
        """Splines have no linear layers: nothing to add."""

    def params(self) -> Params:
        return {"yk_f": self.yk_f, "yk_g": self.yk_g, "yk_h": self.yk_h}

    def lora_mask(self) -> Params:
        return {k: False for k in self.params()}

    def lora_params(self) -> Params:
        return {}

    @staticmethod
    def _ak(yk):
        ak_1 = 2.0 / 3.0 * yk[0] + 2.0 / 3.0 * yk[1] - 1.0 / 3.0 * yk[2]
        ak_else = yk[1:-1] - yk[:-2] / 6.0 + yk[2:] / 6.0
        return torch.cat([ak_1[None], ak_else], dim=0)

    @staticmethod
    def _bk(yk):
        bk_else = yk[1:-1] + yk[:-2] / 6.0 - yk[2:] / 6.0
        bk_m = 2.0 / 3.0 * yk[-1] + 2.0 / 3.0 * yk[-2] - 1.0 / 3.0 * yk[-3]
        return torch.cat([bk_else, bk_m[None]], dim=0)

    def _spline(self, yk, lam):
        """The spline at ``lam`` (..., k), with the knot index clamped to
        [0, num_side_points - 1] as in the JAX package."""
        idx = torch.searchsorted(self.xk, lam.contiguous(), right=False)
        idx = torch.clamp(idx, 0, self.num_side_points - 1)
        right = torch.stack([yk[idx], self._ak(yk)[idx], self._bk(yk)[idx], yk[idx + 1]], dim=-1)
        xi = (lam - self.xk[idx]) / (self.xk[idx + 1] - self.xk[idx])
        xi_vec = torch.stack([xi ** 3, xi ** 2, xi, torch.ones_like(xi)], dim=-1)
        return torch.sum((xi_vec @ self.w) * right, dim=-1)

    def _new_sigma(self, F):
        U, sigma, Vh = svd3(F)
        s0, s1, s2 = sigma[..., 0], sigma[..., 1], sigma[..., 2]
        f = self._spline(self.yk_f, sigma)
        g = self._spline(self.yk_g, torch.stack([s0 * s1, s1 * s2, s0 * s2], dim=-1))
        g1 = g[..., (0, 0, 2)] * sigma[..., (1, 0, 0)]
        g2 = g[..., (2, 1, 1)] * sigma[..., (2, 2, 1)]
        volume = (s0 * s1 * s2)[..., None]
        h = self._spline(self.yk_h, volume) * sigma[..., (1, 0, 0)] * sigma[..., (2, 2, 1)]
        return U, f + g1 + g2 + h, Vh


class SplineMetaElasticity(_SplineBase):
    """P = U diag(new sigma) Vh, stress = P F^T."""

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        U, new_sigma, Vh = self._new_sigma(F)
        return ((U * new_sigma[..., None, :]) @ Vh) @ F.transpose(-1, -2)


class SplineMetaPlasticity(_SplineBase):
    """F + alpha * U diag(new sigma) Vh; zero knots at init."""

    zero_init = True

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        U, new_sigma, Vh = self._new_sigma(F)
        return F + self.alpha * ((U * new_sigma[..., None, :]) @ Vh)
