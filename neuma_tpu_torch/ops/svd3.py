"""Batched signed 3x3 SVD with the closed-form backward.

Counterpart of ``neuma_tpu/ops/svd3.py`` (``svd3c`` / ``svd3``). The
same scalarized one-sided Jacobi runs on nine (N,) component tensors
with a fixed sweep count, so the factors match the JAX package's: the
singular values are sorted by magnitude, descending, and ``det(U) > 0``,
``det(V) > 0`` are enforced by flipping the third column and the sign of
``sigma[2]``. ``torch.linalg.svd`` follows other conventions and is not
used. ``svd3c`` is a ``torch.autograd.Function`` whose backward is the
JAX package's closed-form adjoint (``_svd3c_bwd``), with the
``F_ij = sign(diff) / max(|diff|, 1e-10)`` clamp for near-equal singular
values; autograd through the Jacobi sweeps would give other values there.

On CUDA tensors the forward and the adjoint are one launch each of K6 and
K7 (``csrc/svd3.cu``), which repeat the component code below operation for
operation; that code is their plain version and runs on CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import torch

from .. import kernels

_JACOBI_SWEEPS = 6


def _svd3_core(b, sweeps: int = _JACOBI_SWEEPS):
    """One-sided Jacobi on column-major component lists: ``b[c][r]`` is
    A[r, c] as an (N,) tensor. Returns ``(u, sig, v)`` in the same form."""
    b = [list(col) for col in b]
    one = torch.ones_like(b[0][0])
    zero = torch.zeros_like(b[0][0])
    v = [[one if r == c else zero for r in range(3)] for c in range(3)]

    def rotate(p, q):
        bp, bq = b[p], b[q]
        alpha = bp[0] * bp[0] + bp[1] * bp[1] + bp[2] * bp[2]
        beta = bq[0] * bq[0] + bq[1] * bq[1] + bq[2] * bq[2]
        gamma = bp[0] * bq[0] + bp[1] * bq[1] + bp[2] * bq[2]
        # Identity rotation once the pair is numerically orthogonal.
        denom_ok = gamma * gamma > (1e-14 * alpha * beta + 1e-38)
        safe_gamma = torch.where(denom_ok, gamma, one)
        zeta = (beta - alpha) / (2.0 * safe_gamma)
        t = torch.sign(zeta) / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
        t = torch.where(denom_ok, t, zero)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = c * t
        b[p] = [c * bp[r] - s * bq[r] for r in range(3)]
        b[q] = [s * bp[r] + c * bq[r] for r in range(3)]
        vp, vq = v[p], v[q]
        v[p] = [c * vp[r] - s * vq[r] for r in range(3)]
        v[q] = [s * vp[r] + c * vq[r] for r in range(3)]

    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            rotate(p, q)

    sig = [
        torch.sqrt(b[c][0] ** 2 + b[c][1] ** 2 + b[c][2] ** 2) for c in range(3)
    ]

    # Sort columns by sigma, descending: comparator network (0,1)(1,2)(0,1).
    def cswap(i, j):
        swap = sig[i] < sig[j]

        def sel(x, y):
            return torch.where(swap, y, x), torch.where(swap, x, y)

        sig[i], sig[j] = sel(sig[i], sig[j])
        for r in range(3):
            b[i][r], b[j][r] = sel(b[i][r], b[j][r])
            v[i][r], v[j][r] = sel(v[i][r], v[j][r])

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)

    # U columns = normalized B columns; cross-product fallback for a
    # collapsed third column.
    u: List[List[torch.Tensor]] = [[None] * 3 for _ in range(3)]
    for c in range(3):
        inv = 1.0 / torch.clamp(sig[c], min=1e-30)
        for r in range(3):
            u[c][r] = b[c][r] * inv
    cx = u[0][1] * u[1][2] - u[0][2] * u[1][1]
    cy = u[0][2] * u[1][0] - u[0][0] * u[1][2]
    cz = u[0][0] * u[1][1] - u[0][1] * u[1][0]
    cn = torch.clamp(torch.sqrt(cx * cx + cy * cy + cz * cz), min=1e-30)
    tiny = sig[2] < 1e-8
    u[2][0] = torch.where(tiny, cx / cn, u[2][0])
    u[2][1] = torch.where(tiny, cy / cn, u[2][1])
    u[2][2] = torch.where(tiny, cz / cn, u[2][2])

    def det3(m):
        return (
            m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
            - m[1][0] * (m[0][1] * m[2][2] - m[0][2] * m[2][1])
            + m[2][0] * (m[0][1] * m[1][2] - m[0][2] * m[1][1])
        )

    # Sign fix: det(U) > 0, det(V) > 0 via third-column flips folded
    # into sigma[2].
    for cols in (u, v):
        sgn = torch.where(det3(cols) < 0.0, -one, one)
        for r in range(3):
            cols[2][r] = cols[2][r] * sgn
        sig[2] = sig[2] * sgn

    return u, sig, v


def _svd3c_fwd_impl(F9):
    b = [[F9[3 * r + c] for r in range(3)] for c in range(3)]
    u, sig, v = _svd3_core(b)
    u9 = tuple(u[c][r] for r in range(3) for c in range(3))
    vh9 = tuple(v[i][j] for i in range(3) for j in range(3))
    return u9, tuple(sig), vh9


def _svd3c_bwd(u9, s3, vh9, du9, ds3, dvh9):
    """Closed-form adjoint; ``None`` cotangents count as zero."""
    zero = torch.zeros_like(s3[0])
    du = [d if d is not None else zero for d in du9]
    dvh = [d if d is not None else zero for d in dvh9]
    ds = [d if d is not None else zero for d in ds3]
    s2 = [s * s for s in s3]

    def Fm(i, j):
        diff = s2[j] - s2[i]
        return torch.sign(diff) / torch.clamp(torch.abs(diff), min=1e-10)

    # UtdU[i][j] = sum_r U[r,i] dU[r,j];  VtdV[i][j] = sum_r Vh[i,r] dVh[j,r]
    UtdU = [[sum(u9[3 * r + i] * du[3 * r + j] for r in range(3)) for j in range(3)]
            for i in range(3)]
    VtdV = [[sum(vh9[3 * i + r] * dvh[3 * j + r] for r in range(3)) for j in range(3)]
            for i in range(3)]
    inner = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            if i == j:
                inner[i][j] = ds[i]
            else:
                f = Fm(i, j)
                J = f * (UtdU[i][j] - UtdU[j][i])
                K = f * (VtdV[i][j] - VtdV[j][i])
                inner[i][j] = J * s3[j] + s3[i] * K
    # dA[r, c] = sum_{i,j} U[r,i] inner[i][j] Vh[j,c]
    dA9 = []
    for r in range(3):
        for c in range(3):
            acc = zero
            for i in range(3):
                for j in range(3):
                    acc = acc + u9[3 * r + i] * inner[i][j] * vh9[3 * j + c]
            dA9.append(acc)
    return tuple(dA9)


def _addresses(ts):
    """Each tensor's address and element stride as ctypes arrays, with
    ``None`` as address 0. Every tensor is 1-D."""
    ptrs = (ctypes.c_void_p * len(ts))(*[0 if t is None else t.data_ptr() for t in ts])
    strides = (ctypes.c_int64 * len(ts))(*[0 if t is None else t.stride(0) for t in ts])
    return ptrs, strides


def _batch(ts, name: str, shape=None, device=None):
    """Check that the tensors of ``ts`` not None are float32 CUDA tensors
    of one shape on one device (by default the first one's); that shape
    and their 1-D forms (a view where one stride walks the tensor, else a
    copy)."""
    live = [t for t in ts if t is not None]
    shape = tuple(live[0].shape) if shape is None else tuple(shape)
    device = live[0].device if device is None else device
    for t in live:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must be CUDA tensors on {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must all have shape {shape}, got {tuple(t.shape)}")
    if math.prod(shape) >= 2 ** 31:
        raise ValueError(f"{name}: {math.prod(shape)} matrices exceed the kernels' int32 count")
    return shape, [t if t is None or t.dim() == 1 else t.reshape(-1) for t in ts]


def run_svd3_fwd(F9: Sequence[torch.Tensor]) -> torch.Tensor:
    """K6: nine float32 CUDA components ``F9[3r+c] = A[..., r, c]`` ->
    one (21, ...) buffer: rows 0-8 ``u9``, 9-11 ``s3``, 12-20 ``vh9``, as
    ``_svd3c_fwd_impl`` gives them. N = 0 launches nothing."""
    shape, flat = _batch(F9, "F9")
    out = torch.empty((21, *shape), dtype=torch.float32, device=F9[0].device)
    n = math.prod(shape)
    if n:
        rc = kernels.library().neuma_svd3_fwd(*_addresses(flat), n, out.data_ptr(),
                                              kernels.stream(out.device))
        kernels.check(rc, "neuma_svd3_fwd")
        kernels.launches["svd3"] += 1
    return out


def run_svd3_bwd(saved: torch.Tensor, cots: Sequence) -> torch.Tensor:
    """K7: K6's (21, ...) buffer and the 21 cotangents of its rows
    (``None`` counts as zero) -> (9, ...) ``dA9``, as ``_svd3c_bwd``
    gives it. N = 0 launches nothing."""
    shape = tuple(saved.shape[1:])
    kernels.require(saved, "saved", (21, *shape), torch.float32)
    out = torch.empty((9, *shape), dtype=torch.float32, device=saved.device)
    _, flat = _batch(cots, "cotangents", shape, saved.device)
    n = math.prod(shape)
    if n:
        rc = kernels.library().neuma_svd3_bwd(saved.data_ptr(), *_addresses(flat), n,
                                              out.data_ptr(), kernels.stream(out.device))
        kernels.check(rc, "neuma_svd3_bwd")
        kernels.launches["svd3_bwd"] += 1
    return out


def svd3_fwd_plain(F9: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of K6: the component code's factors stacked as K6
    writes them."""
    u9, s3, vh9 = _svd3c_fwd_impl(F9)
    return torch.stack([*u9, *s3, *vh9])


def svd3_bwd_plain(saved: torch.Tensor, cots: Sequence) -> torch.Tensor:
    """Plain version of K7: ``_svd3c_bwd`` on the rows of K6's buffer,
    stacked."""
    rows = saved.unbind(0)
    return torch.stack(_svd3c_bwd(rows[:9], rows[9:12], rows[12:], cots[:9], cots[9:12],
                                  cots[12:]))


def _on_card(F9) -> bool:
    return any(t.is_cuda for t in F9)


class _Svd3c(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *F9):
        ctx.set_materialize_grads(False)  # a None cotangent counts as zero
        if _on_card(F9):
            buf = run_svd3_fwd(F9)
            ctx.save_for_backward(buf)
            return tuple(buf.unbind(0))
        u9, s3, vh9 = _svd3c_fwd_impl(F9)
        ctx.save_for_backward(*u9, *s3, *vh9)
        return (*u9, *s3, *vh9)

    @staticmethod
    def backward(ctx, *cots):
        saved = ctx.saved_tensors
        if len(saved) == 1:
            return tuple(run_svd3_bwd(saved[0], cots).unbind(0))
        return _svd3c_bwd(saved[:9], saved[9:12], saved[12:], cots[:9], cots[9:12], cots[12:])


def svd3c(F9: Sequence[torch.Tensor]) -> Tuple[tuple, tuple, tuple]:
    """Component form: ``F9[3r+c] = A[..., r, c]`` -> ``(u9, s3, vh9)``
    row-major tuples with ``u9[3r+c] = U[r,c]``, ``vh9[3i+j] = Vh[i,j]``.
    Differentiable through the closed-form adjoint."""
    out = _Svd3c.apply(*F9)
    return tuple(out[:9]), tuple(out[9:12]), tuple(out[12:])


def unpack33(A: torch.Tensor) -> tuple:
    """(..., 3, 3) -> row-major 9-tuple of (...,) float32 components."""
    A9 = A.to(torch.float32).reshape(A.shape[:-2] + (9,))
    return tuple(A9[..., k] for k in range(9))


def pack33(c9, dtype=None) -> torch.Tensor:
    out = torch.stack(list(c9), dim=-1).reshape(c9[0].shape + (3, 3))
    return out if dtype is None else out.to(dtype)


def svd3(A: torch.Tensor):
    """Tensor form: ``A = U @ diag(sigma) @ Vh`` with the conventions above."""
    u9, s3, vh9 = svd3c(unpack33(A))
    return pack33(u9, A.dtype), torch.stack(s3, dim=-1).to(A.dtype), pack33(vh9, A.dtype)
