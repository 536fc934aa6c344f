"""Numerical helpers (counterpart of ``neuma_tpu/ops``)."""
from .rotation import (
    axis_angle_to_rotmat,
    euler_to_rotmat,
    quat_to_rotmat,
    rot6d_to_rotmat,
    rotmat_to_quat,
    rotmat_to_rot6d,
)
from .sh import eval_sh, rgb_to_sh, sh_to_rgb
from .svd3 import svd3

__all__ = [
    "svd3",
    "quat_to_rotmat",
    "rotmat_to_quat",
    "rot6d_to_rotmat",
    "rotmat_to_rot6d",
    "axis_angle_to_rotmat",
    "euler_to_rotmat",
    "eval_sh",
    "rgb_to_sh",
    "sh_to_rgb",
]
