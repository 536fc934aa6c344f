"""COLMAP binary/text model readers (cameras, images, points3D),
``qvec_to_rotmat`` and ``rodrigues``.

Counterpart of ``neuma_tpu/data/colmap.py`` (``CAMERA_MODELS``,
``ColmapCamera``, ``read_cameras_binary``, ``read_cameras_text``,
``ColmapImage``, ``read_images_binary``, ``read_points3d_binary``,
``qvec_to_rotmat``, ``rodrigues``), the same numpy code.
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


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            data = struct.unpack("<idddddddi", f.read(64))
            image_id = data[0]
            qvec = np.array(data[1:5])
            tvec = np.array(data[5:8])
            camera_id = data[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n_pts = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n_pts)  # skip 2D points
            images[image_id] = ColmapImage(
                id=image_id,
                qvec=qvec,
                tvec=tvec,
                camera_id=camera_id,
                name=name.decode("utf-8"),
            )
    return images


def read_points3d_binary(path):
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            data = struct.unpack("<QdddBBBd", f.read(43))
            xyzs.append(data[1:4])
            rgbs.append(data[4:7])
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.read(8 * track_len)
    return np.array(xyzs), np.array(rgbs, np.uint8)


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


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
