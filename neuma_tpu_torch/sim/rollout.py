"""Material-coupled MPM time stepping.

Counterpart of ``neuma_tpu/sim/rollout.py`` (``make_step_fn``,
``rollout``, ``denormalize_points``). One step is

    stress = elasticity(F); state = mpm_step(state, stress); F = plasticity(F)

The materials are modules (or callables on F) that carry their own
weights, so a step takes only the state (and the step layouts) where
the JAX package's takes ``(params_e, params_p, state, sort)``. The
rollout is a Python loop over frames in place of ``lax.scan``; with
``remat`` each frame runs under ``torch.utils.checkpoint`` when autograd
records, and its substeps are recomputed in the backward.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.types import MPMConstants, ParticleState, Statics
from ..utils.profiling import span
from .mpm import mpm_step, mpm_step_diff
from .p2g_kernel import build_step_layouts, refresh_step_layouts


def make_step_fn(
    constants: MPMConstants,
    statics: Statics,
    elasticity: Callable,
    plasticity: Callable,
    diff: bool = True,
) -> Callable:
    """``step(state, sort=None) -> state``; ``diff`` selects the step with
    the direct adjoint (``mpm_step_diff``) over the forward-only one."""
    step_impl = mpm_step_diff if diff else mpm_step

    def step(state: ParticleState, sort=None) -> ParticleState:
        with span("material.elasticity"):
            stress = elasticity(state.F)
        state = step_impl(constants, statics, state, stress, sort)
        with span("material.plasticity"):
            return dataclasses.replace(state, F=plasticity(state.F))

    return step


def rollout(
    step: Callable,
    state0: ParticleState,
    num_steps: int,
    substeps: int = 1,
    remat: bool = True,
    constants: Optional[MPMConstants] = None,
) -> Tuple[ParticleState, ParticleState]:
    """``num_steps`` frames of ``substeps`` steps each. Returns
    ``(final_state, trajectory)`` with the per-frame states stacked
    (num_steps, ...). With ``constants`` on a slab grid (``num_grids >
    24``) one block sort is carried across the whole rollout and
    refreshed per substep (rebuilt only when a particle crossed a block
    boundary)."""
    layouts = None
    if constants is not None and constants.num_grids > 24:
        layouts = build_step_layouts(constants, state0.x)

    def frame(state, layouts):
        for _ in range(substeps):
            if layouts is not None:
                layouts, _ = refresh_step_layouts(constants, state.x, layouts)
            state = step(state, layouts)
        return state, layouts

    state, frames = state0, []
    for _ in range(num_steps):
        if remat and torch.is_grad_enabled():
            state, layouts = checkpoint(frame, state, layouts, use_reentrant=False)
        else:
            state, layouts = frame(state, layouts)
        frames.append(state)
    traj = ParticleState(
        *(torch.stack([getattr(s, f.name) for s in frames]) for f in dataclasses.fields(state))
    )
    return state, traj


def denormalize_points(x: torch.Tensor, size, center) -> torch.Tensor:
    """Sim-box coordinates -> world coordinates: (x - center) / size."""
    size = torch.as_tensor(size, dtype=x.dtype, device=x.device)
    center = torch.as_tensor(center, dtype=x.dtype, device=x.device)
    return (x - center) / size
