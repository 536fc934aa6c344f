"""Learning-rate schedules: step -> lr callables.

Counterpart of ``neuma_tpu/train/schedulers.py``
(``cosine_decay_schedule``, ``exponential_decay_schedule``,
``fetch_schedule``), the reference's tune schedulers. Evaluated in
float32 as the JAX package does; each returns a 0-d float32 tensor.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def cosine_decay_schedule(
    lr_init: float,
    max_steps: int,
    learning_rate_alpha: float = 0.05,
    warm_up_end: int = 0,
) -> Callable:
    """Linear warmup, then cosine from 1 down to ``alpha`` of lr_init."""

    def schedule(step):
        step = _f32(step)
        warm = step / warm_up_end if warm_up_end > 0 else _f32(1.0)
        progress = (step - warm_up_end) / max(max_steps - warm_up_end, 1)
        alpha = learning_rate_alpha
        factor = (torch.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha
        return lr_init * torch.where(step < warm_up_end, warm, factor)

    return schedule


def exponential_decay_schedule(
    lr_init: float,
    max_steps: int,
    lr_final: Optional[float] = None,
    warmup_steps: int = 0,
    lr_pre_warmup: float = 1e-8,
    ramp: str = "linear",
) -> Callable:
    """Warmup (linear or cosine ramp), then log-linear lr_init -> lr_final."""
    if lr_final is None:
        lr_final = lr_init

    def schedule(step):
        step = _f32(step)
        if warmup_steps > 0:
            frac = torch.clamp(step / warmup_steps, 0, 1)
            if ramp == "cosine":
                warm = lr_pre_warmup + (lr_init - lr_pre_warmup) * torch.sin(0.5 * math.pi * frac)
            else:
                warm = lr_pre_warmup + (lr_init - lr_pre_warmup) * step / warmup_steps
        else:
            warm = _f32(lr_init)
        t = torch.clamp((step - warmup_steps) / max(max_steps - warmup_steps, 1), 0, 1)
        decayed = torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
        return torch.where(step < warmup_steps, warm, decayed)

    return schedule


def fetch_schedule(cfg, lr_init: float) -> Callable:
    """Dispatch on ``cfg['type'] in ('exp', 'cos')``."""
    kind = cfg["type"]
    if kind == "cos":
        return cosine_decay_schedule(
            lr_init,
            max_steps=int(cfg.get("max_steps", 1e5)),
            learning_rate_alpha=float(cfg.get("learning_rate_alpha", 0.05)),
            warm_up_end=int(cfg.get("warm_up_end", 0)),
        )
    if kind == "exp":
        return exponential_decay_schedule(
            lr_init,
            max_steps=int(cfg.get("max_steps", 1e5)),
            lr_final=cfg.get("lr_final"),
            warmup_steps=int(cfg.get("warmup_steps", 0)),
            lr_pre_warmup=float(cfg.get("lr_pre_warmup", 1e-8)),
            ramp=str(cfg.get("ramp", "linear")),
        )
    raise ValueError(f"Scheduler {kind} not supported.")
