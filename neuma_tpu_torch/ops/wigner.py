"""Rotation of real spherical-harmonic coefficients (bands 1..3).

Counterpart of ``neuma_tpu/ops/wigner.py`` (``sh_rotation_matrices``,
``rotate_sh``): the band rotation matrices are built from the 3x3
rotation by the Ivanic-Ruedenberg recursion ("Rotation Matrices for Real
Spherical Harmonics", J. Phys. Chem. 1996, with its errata), entry by
entry in the same order, differentiable in R.

Basis: PlenOctree real SH ordering (``ops/sh.py``), band l indexed by
m = -l..l; the band-1 components are (y, z, x).
"""
from __future__ import annotations

import math
from typing import List

import torch


def _band1_matrix(R: torch.Tensor) -> torch.Tensor:
    """D^1 in the Ivanic-Ruedenberg convention: D1[m'][m] = R[P(m'), P(m)]
    with P = {-1: y, 0: z, 1: x}, no Condon-Shortley signs."""
    P = [1, 2, 0]
    return torch.stack([torch.stack([R[P[i], P[j]] for j in range(3)]) for i in range(3)])


def _cs_conjugate(D: torch.Tensor, l: int) -> torch.Tensor:
    """I-R basis -> PlenOctree basis (Condon-Shortley (-1)^m signs on its
    constants): S D S with S = diag((-1)^m), m = -l..l."""
    s = torch.tensor([(-1.0) ** m for m in range(-l, l + 1)], dtype=D.dtype, device=D.device)
    return D * s[:, None] * s[None, :]


def _next_band(M: torch.Tensor, Dl1: torch.Tensor, l: int) -> torch.Tensor:
    """D^l from D^1 (= M) and D^{l-1}."""

    def m1(i):  # M indexed by m in {-1, 0, 1}
        return M[i + 1]

    def dl1(a, b):  # D^{l-1} indexed by m in [-(l-1), l-1]
        return Dl1[a + l - 1, b + l - 1]

    def Pf(i, a, b):
        if abs(b) < l:
            return m1(i)[1] * dl1(a, b)
        if b == l:
            return m1(i)[2] * dl1(a, l - 1) - m1(i)[0] * dl1(a, -l + 1)
        return m1(i)[2] * dl1(a, -l + 1) + m1(i)[0] * dl1(a, l - 1)

    def Uf(m, n):
        return Pf(0, m, n)

    def Vf(m, n):
        if m == 0:
            return Pf(1, 1, n) + Pf(-1, -1, n)
        if m > 0:
            d = 1.0 if m == 1 else 0.0
            return Pf(1, m - 1, n) * math.sqrt(1 + d) - Pf(-1, -m + 1, n) * (1 - d)
        d = 1.0 if m == -1 else 0.0
        return Pf(1, m + 1, n) * (1 - d) + Pf(-1, -m - 1, n) * math.sqrt(1 + d)

    def Wf(m, n):
        if m > 0:
            return Pf(1, m + 1, n) + Pf(-1, -m - 1, n)
        return Pf(1, m - 1, n) - Pf(-1, -m + 1, n)

    zero = M.new_zeros(())
    rows = []
    for m in range(-l, l + 1):
        cols = []
        for n in range(-l, l + 1):
            denom = (l + n) * (l - n) if abs(n) < l else (2 * l) * (2 * l - 1)
            dm0 = 1.0 if m == 0 else 0.0
            u = math.sqrt((l + m) * (l - m) / denom)
            v = 0.5 * math.sqrt((1 + dm0) * (l + abs(m) - 1) * (l + abs(m)) / denom) * (1 - 2 * dm0)
            w = -0.5 * math.sqrt((l - abs(m) - 1) * (l - abs(m)) / denom) * (1 - dm0)
            entry = zero
            if u != 0.0:
                entry = entry + u * Uf(m, n)
            if v != 0.0:
                entry = entry + v * Vf(m, n)
            if w != 0.0:
                entry = entry + w * Wf(m, n)
            cols.append(entry)
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def sh_rotation_matrices(R: torch.Tensor, l_max: int = 3) -> List[torch.Tensor]:
    """[D^1, ..., D^l_max] for one 3x3 rotation R: the coefficients of the
    rotated function are c_rot^l = D^l @ c^l."""
    D1 = _band1_matrix(R)
    mats = [_cs_conjugate(D1, 1)]
    prev = D1
    for l in range(2, l_max + 1):
        prev = _next_band(D1, prev, l)
        mats.append(_cs_conjugate(prev, l))
    return mats


def rotate_sh(f_rest: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Rotate the SH 'rest' coefficients (N, (deg+1)^2 - 1, C) by R (the
    DC band is rotation invariant and not passed)."""
    n_rest = f_rest.shape[1]
    l_max = int(round(math.sqrt(n_rest + 1))) - 1
    mats = sh_rotation_matrices(R, l_max)
    out, start = [], 0
    for l in range(1, l_max + 1):
        width = 2 * l + 1
        out.append(torch.einsum("ij,njc->nic", mats[l - 1], f_rest[:, start : start + width, :]))
        start += width
    return torch.cat(out, dim=1)
