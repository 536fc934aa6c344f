"""COLMAP binary/text camera readers and ``rodrigues``.

Counterpart of ``neuma_tpu/data/colmap.py`` (``CAMERA_MODELS``,
``ColmapCamera``, ``read_cameras_binary``, ``read_cameras_text``,
``rodrigues``), the same numpy code: what the RealCapture reader uses.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            cam_id, model_id, width, height = struct.unpack(
                "<iiQQ", f.read(24)
            )
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(
                struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            )
            cameras[cam_id] = ColmapCamera(
                id=cam_id,
                model=name,
                width=int(width),
                height=int(height),
                params=params,
            )
    return cameras


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cameras[cam_id] = ColmapCamera(
                id=cam_id,
                model=parts[1],
                width=int(parts[2]),
                height=int(parts[3]),
                params=np.array([float(p) for p in parts[4:]]),
            )
    return cameras


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """cv2.Rodrigues equivalent: axis-angle -> rotation matrix."""
    rvec = np.asarray(rvec, np.float64).reshape(3)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
