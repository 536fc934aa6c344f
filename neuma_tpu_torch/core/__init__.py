"""Containers and device resolution (counterpart of ``neuma_tpu/core``)."""
from .types import GridState, MPMConstants, ParticleState, Statics

__all__ = [
    "MPMConstants",
    "ParticleState",
    "Statics",
    "GridState",
]
