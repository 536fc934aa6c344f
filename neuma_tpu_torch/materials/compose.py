"""Static section routing of per-object materials.

Counterpart of ``neuma_tpu/materials/compose.py``: the particles of N
objects lie in contiguous sections whose lengths are known before the
rollout, so routing is static slices and one concatenation (a
zero-length section is skipped). The materials carry their own weights,
so ``forward(F)`` takes the place of the JAX package's
``apply(params_list, F)``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class ComposeMaterial(nn.Module):
    def __init__(self, materials: Sequence[nn.Module], sections: Sequence[int]):
        super().__init__()
        self.materials = nn.ModuleList(materials)
        self.sections = [int(n) for n in sections]

    def update_sections(self, sections: Sequence[int]) -> None:
        self.sections = [int(n) for n in sections]

    def forward(self, F: torch.Tensor) -> torch.Tensor:
        outs, offset = [], 0
        for mat, n in zip(self.materials, self.sections):
            if n == 0:
                continue
            outs.append(mat(F[offset : offset + n]))
            offset += n
        return torch.cat(outs, dim=0)
