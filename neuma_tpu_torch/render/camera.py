"""Camera model with 3DGS conventions.

Counterpart of ``neuma_tpu/render/camera.py`` (``Camera``, ``look_at``,
``interpolate``, ``get_world2view``, ``get_projection_matrix``, ``fov2focal``,
``focal2fov``): matrices are stored
TRANSPOSED (row-vector convention, ``p_cam = [p, 1] @ world_view``) and
built in numpy float64 before the float32 cast, as the JAX package does,
so both packages hold the same numbers.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def get_world2view(R: np.ndarray, t: np.ndarray, translate=np.zeros(3), scale: float = 1.0):
    """R is the COLMAP-convention cam-to-world rotation (stored
    transposed), t the world-to-cam translation."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.linalg.inv(C2W).astype(np.float32)


def get_projection_matrix(znear: float, zfar: float, fov_x: float, fov_y: float) -> np.ndarray:
    tan_y = math.tan(fov_y / 2)
    tan_x = math.tan(fov_x / 2)
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = znear / (tan_x * znear)
    P[1, 1] = znear / (tan_y * znear)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


@dataclasses.dataclass(frozen=True)
class Camera:
    """``world_view`` / ``full_proj`` are the transposed 4x4 matrices."""

    world_view: torch.Tensor  # (4, 4)
    full_proj: torch.Tensor  # (4, 4)
    camera_center: torch.Tensor  # (3,)
    width: int = 800
    height: int = 800
    fov_x: float = 0.7
    fov_y: float = 0.7
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def tan_fov_x(self) -> float:
        return math.tan(self.fov_x * 0.5)

    @property
    def tan_fov_y(self) -> float:
        return math.tan(self.fov_y * 0.5)

    @property
    def focal_x(self) -> float:
        return fov2focal(self.fov_x, self.width)

    @property
    def focal_y(self) -> float:
        return fov2focal(self.fov_y, self.height)

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self,
            world_view=self.world_view.to(device),
            full_proj=self.full_proj.to(device),
            camera_center=self.camera_center.to(device),
        )

    @classmethod
    def from_Rt(
        cls, R, t, fov_x, fov_y, width, height, znear=0.01, zfar=100.0,
        trans=np.zeros(3), scale=1.0, device="cpu",
    ) -> "Camera":
        w2v = get_world2view(R, t, trans, scale).T
        proj = get_projection_matrix(znear, zfar, fov_x, fov_y).T
        full = w2v @ proj
        cam_center = np.linalg.inv(w2v)[3, :3]
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return cls(
            world_view=f32(w2v),
            full_proj=f32(full),
            camera_center=f32(cam_center),
            width=int(width),
            height=int(height),
            fov_x=float(fov_x),
            fov_y=float(fov_y),
            znear=float(znear),
            zfar=float(zfar),
        )

    @classmethod
    def interpolate(cls, cam1: "Camera", cam2: "Camera", steps: int) -> list:
        """``steps`` cameras from ``cam1`` to ``cam2``: the rotations
        slerped (the shorter arc; ``cam1``'s when the angle is below
        1e-6), the translations blended linearly, the intrinsics
        ``cam1``'s (reference ``interpolate_cameras``,
        camera_utils.py:261-290). On ``cam1``'s device."""
        from ..ops.rotation import quat_to_rotmat, rotmat_to_quat

        def decompose(cam):  # COLMAP R (stored transposed) and T
            w2v = cam.world_view.detach().cpu().numpy().T
            return w2v[:3, :3].T, w2v[:3, 3]

        R1, T1 = decompose(cam1)
        R2, T2 = decompose(cam2)
        q1 = rotmat_to_quat(torch.as_tensor(np.ascontiguousarray(R1.T))).numpy()
        q2 = rotmat_to_quat(torch.as_tensor(np.ascontiguousarray(R2.T))).numpy()
        if np.dot(q1, q2) < 0:
            q2 = -q2
        device = cam1.world_view.device
        cams = []
        for t in np.linspace(0.0, 1.0, steps):
            angle = math.acos(np.clip(np.dot(q1, q2), -1.0, 1.0))
            if abs(angle) < 1e-6:
                q = q1
            else:
                isin = 1.0 / math.sin(angle)
                q = math.sin((1 - t) * angle) * isin * q1 + math.sin(t * angle) * isin * q2
            R = quat_to_rotmat(torch.as_tensor(q)).numpy().T
            T = (1 - t) * T1 + t * T2
            cams.append(cls.from_Rt(R.T, T, cam1.fov_x, cam1.fov_y, cam1.width, cam1.height,
                                    cam1.znear, cam1.zfar, device=device))
        return cams

    @classmethod
    def look_at(
        cls, eye, target, up=np.array([0.0, 1.0, 0.0]), fov: float = 0.8,
        width: int = 256, height: int = 256, device="cpu",
    ) -> "Camera":
        eye = np.asarray(eye, np.float64)
        forward = np.asarray(target, np.float64) - eye
        forward /= np.linalg.norm(forward)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(forward, right)
        R_w2c = np.stack([right, true_up, forward], axis=0)
        t = -R_w2c @ eye
        return cls.from_Rt(R_w2c.T, t, fov, fov, width, height, device=device)
