"""Rotation-representation conversions.

Counterpart of ``neuma_tpu/ops/rotation.py`` (``quat_to_rotmat``,
``rotmat_to_quat``, ``rot6d_to_rotmat``, ``rotmat_to_rot6d``,
``axis_angle_to_rotmat``, ``euler_to_rotmat``). Quaternions are (w, x,
y, z), as in 3DGS; every function broadcasts over leading dimensions.
"""
from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3); normalizes first."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz quaternion (Shepperd): of the four
    candidate constructions the one with the largest pivot (trace,
    then the diagonal terms; the first on a tie, as ``jnp.argmax``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = 0.5 * safe_sqrt(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = 0.5 * safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = 0.5 * safe_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = 0.5 * safe_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)

    cand = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    # first index of the maximum (torch.argmax does not promise which tie)
    best = scores.max(dim=-1, keepdim=True).values
    ids = torch.arange(4, device=R.device).expand(scores.shape)
    idx = torch.where(scores == best, ids, 4).min(dim=-1).values
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rot6d_to_rotmat(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) continuous 6D rotation (Zhou et al. 2019) -> (..., 3, 3)
    by Gram-Schmidt; the rows are b1, b2, b1 x b2."""
    a1, a2 = d6[..., 0:3], d6[..., 3:6]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def rotmat_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows, flattened."""
    return R[..., :2, :].reshape(R.shape[:-2] + (6,))


def axis_angle_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle (Rodrigues) -> (..., 3, 3)."""
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    k = aa / torch.clamp(theta, min=1e-12)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], dim=-1).reshape(
        aa.shape[:-1] + (3, 3))
    t = theta[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + torch.sin(t) * K + (1 - torch.cos(t)) * (K @ K)


def euler_to_rotmat(angles: torch.Tensor, order: str = "XYZ") -> torch.Tensor:
    """(..., 3) Euler angles (radians) -> (..., 3, 3), intrinsic rotations
    applied in ``order``."""

    def axis_rot(axis, a):
        c, s = torch.cos(a), torch.sin(a)
        one, zero = torch.ones_like(a), torch.zeros_like(a)
        if axis == "X":
            elems = [one, zero, zero, zero, c, -s, zero, s, c]
        elif axis == "Y":
            elems = [c, zero, s, zero, one, zero, -s, zero, c]
        else:
            elems = [c, -s, zero, s, c, zero, zero, zero, one]
        return torch.stack(elems, dim=-1).reshape(a.shape + (3, 3))

    R = axis_rot(order[0], angles[..., 0])
    for i, ax in enumerate(order[1:], start=1):
        R = R @ axis_rot(ax, angles[..., i])
    return R
