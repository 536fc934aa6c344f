"""Particle-GS rendering (counterpart of ``neuma_tpu/render``).

As in the JAX package, ``render.rasterize`` is the function; the module
is ``importlib.import_module("neuma_tpu_torch.render.rasterize")``.
"""
from .binding import (
    BindingTable,
    apply_binding_F,
    apply_binding_xyz,
    compute_binding_table,
    deform_cov_by_F,
)
from .camera import Camera
from .gaussians import GaussianPack, build_covariance, strip_symmetric, unstrip_symmetric
from .rasterize import RasterConfig, rasterize

__all__ = [
    "GaussianPack",
    "build_covariance",
    "strip_symmetric",
    "unstrip_symmetric",
    "Camera",
    "rasterize",
    "RasterConfig",
    "BindingTable",
    "compute_binding_table",
    "apply_binding_xyz",
    "apply_binding_F",
    "deform_cov_by_F",
]
