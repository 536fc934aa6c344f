"""Ascending sort of packed non-negative int32 keys (counterpart of
``neuma_tpu/ops/bitonic.py``).

The JAX package builds a bitonic compare-exchange network for the TPU's
(R, 128) lane layout, because ``lax.sort`` is slow there. The function
it computes is an ascending sort, which ``torch.sort`` gives on every
device; the length check and the dtypes are that module's.
"""
from __future__ import annotations

import torch

LANES = 128


def sortable(n: int) -> bool:
    """True when :func:`sort_i32` handles length ``n``: a power of two
    with at least one full (LANES, LANES) tile."""
    return n >= LANES * LANES and (n & (n - 1)) == 0


def sort_i32(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of (P,) non-negative int32 keys, P = 2^m >= 2^14."""
    P = keys.shape[0]
    if not sortable(P):
        raise ValueError(f"sort_i32 needs pow2 length >= {LANES*LANES}: {P}")
    return torch.sort(keys, stable=True).values


def sort_pairs_u32(key: torch.Tensor) -> torch.Tensor:
    """Sort (P,) uint32 keys with values < 2^31 (the rasterizer's packed
    ``tile << bits_p | pair`` keys). Returns sorted uint32."""
    return sort_i32(key.to(torch.int32)).to(torch.uint32)
