"""MLS-MPM simulator (counterpart of ``neuma_tpu/sim``)."""
from .initializers import MPMInitData, build_initial_state, build_statics
from .mpm import advect_extra, g2p, grid_op, mpm_step, mpm_step_diff, p2g

__all__ = [
    "p2g",
    "grid_op",
    "g2p",
    "mpm_step",
    "mpm_step_diff",
    "advect_extra",
    "MPMInitData",
    "build_initial_state",
    "build_statics",
]
