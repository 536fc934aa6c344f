"""Optimizers: RAdam, LoRA masking and strict global-norm clipping.

Counterpart of ``neuma_tpu/train/optim.py`` (``radam``, ``masked_radam``,
``global_norm``, ``clip_by_global_norm_strict``), written as plain tensor
code over lists of leaves that reproduces ``optax.radam`` step for step:
the moments ``mu = b1 mu + (1 - b1) g`` and ``nu = b2 nu + (1 - b2) g^2``,
the bias corrections, the length of the approximated SMA
``ro = ro_inf - 2 t b2^t / (1 - b2^t)`` and its threshold 5 (below it the
update is the bias-corrected momentum), in float32, and the learning
rate (a float or a schedule of the step count, starting at 0) applied
last with a minus sign. ``torch.optim.RAdam`` is not assumed to match.

``masked_radam`` updates only the leaves whose mask is True and gives the
others a zero update: the reference's ``mark_only_lora_as_trainable``.
(``optax.masked`` instead passes the masked-out leaves' gradients
through unchanged.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

Schedule = Union[float, Callable]
_THRESHOLD = 5.0  # optax.scale_by_radam's: below it, the unrectified update


@dataclasses.dataclass
class RAdamState:
    count: int  # steps taken
    mu: List[Optional[torch.Tensor]]  # None for a masked-out leaf
    nu: List[Optional[torch.Tensor]]


class RAdam:
    """``optax.radam`` (with ``add_decayed_weights`` first when
    ``weight_decay``) over a list of leaves; ``mask`` marks the leaves it
    updates (all when None)."""

    def __init__(
        self,
        learning_rate: Schedule,
        weight_decay: float = 0.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        mask: Optional[Sequence[bool]] = None,
    ):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mask = None if mask is None else list(mask)

    def _on(self, i: int) -> bool:
        return self.mask is None or self.mask[i]

    def lr(self, count: int) -> torch.Tensor:
        lr = self.learning_rate
        value = lr(count) if callable(lr) else lr
        return torch.as_tensor(value, dtype=torch.float32)

    def init(self, params: Sequence[torch.Tensor]) -> RAdamState:
        zeros = [torch.zeros_like(p) if self._on(i) else None for i, p in enumerate(params)]
        return RAdamState(0, zeros, [None if z is None else z.clone() for z in zeros])

    def update(
        self, grads: Sequence[torch.Tensor], state: RAdamState, params: Sequence[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], RAdamState]:
        b1, b2 = self.b1, self.b2
        t = state.count + 1
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        b1t, b2t = f32(b1) ** t, f32(b2) ** t
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = f32(ro_inf) - 2.0 * f32(t) * b2t / (1.0 - b2t)
        rect = float(ro) >= _THRESHOLD
        if rect:
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        lr = self.lr(state.count)
        updates, mus, nus = [], [], []
        for i, (g, p) in enumerate(zip(grads, params)):
            if not self._on(i):
                updates.append(torch.zeros_like(p))
                mus.append(None)
                nus.append(None)
                continue
            if self.weight_decay:
                g = g + self.weight_decay * p
            mu = (1.0 - b1) * g + b1 * state.mu[i]
            nu = (1.0 - b2) * (g * g) + b2 * state.nu[i]
            mu_hat = mu / (1.0 - b1t).to(mu.device)
            if rect:
                nu_hat = nu / (1.0 - b2t).to(nu.device)
                u = r.to(mu.device) * mu_hat / (torch.sqrt(nu_hat) + self.eps)
            else:
                u = mu_hat
            updates.append(-lr.to(u.device) * u)
            mus.append(mu)
            nus.append(nu)
        return updates, RAdamState(t, mus, nus)


def radam(learning_rate: Schedule, weight_decay: float = 0.0, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8) -> RAdam:
    return RAdam(learning_rate, weight_decay, b1, b2, eps)


def masked_radam(learning_rate: Schedule, mask: Sequence[bool], weight_decay: float = 0.0) -> RAdam:
    """RAdam on the leaves where ``mask`` is True; zero updates elsewhere."""
    return RAdam(learning_rate, weight_decay, mask=mask)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm_strict(
    grads: Sequence[torch.Tensor], max_norm: float
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Clip to ``max_norm``; also return the norm and whether it is
    non-finite, so the caller can raise as the reference's
    ``error_if_nonfinite`` does."""
    norm = global_norm(grads)
    nonfinite = ~torch.isfinite(norm)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads], norm, nonfinite


def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> None:
    """``p += u`` in place, outside autograd."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)

