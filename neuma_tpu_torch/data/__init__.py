"""Dataset readers, particle sampling and data preparation (counterpart of ``neuma_tpu/data``)."""
from .ply import load_ply, load_ply_points, save_ply, save_ply_points

__all__ = [
    "load_ply",
    "save_ply",
    "load_ply_points",
    "save_ply_points",
]
