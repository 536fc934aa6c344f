"""Multi-process entry: the process group, the mesh and its collectives.

Counterpart of ``neuma_tpu/parallel/distributed.py`` (``initialize``,
``global_mesh``, ``process_index``, ``is_primary``) on
``torch.distributed``. The port's counterpart of a JAX ``Mesh`` is a
``torch.distributed`` world with one rank per shard: ``Mesh`` lays the
world out on named axes (earlier axes change slowest, as in the JAX
package) and holds one process group per axis line. A single process (no
group started) is a world of one, in which every collective is the
identity.

``initialize`` picks the backend from the device the caller runs on:
NCCL for ``cuda``, gloo for ``cpu``; ``backend=`` overrides it (several
ranks on one card cannot share NCCL, so such a run asks for gloo). A
card that is asked for and absent raises.

gloo carries host tensors only, so the collectives here stage a CUDA
tensor through a pinned host buffer on a gloo group and hand it to NCCL
as it is. Sums over ranks gather every rank's tensor and add them in
rank order, so they repeat bit for bit on any backend.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

# a rank that waits this long on a peer fails instead of hanging
_TIMEOUT = datetime.timedelta(seconds=600)


def initialize(
    device=None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> bool:
    """Start the process group when run multi-process; True if it did.

    ``world_size`` and ``rank`` default to the environment's
    ``WORLD_SIZE`` / ``RANK`` (as ``torchrun`` sets them, with
    ``MASTER_ADDR`` / ``MASTER_PORT`` for the default ``env://``). A
    world of one starts no group unless ``init_method`` is given. The
    backend follows ``device`` (``cuda`` unless the caller asks for the
    CPU): NCCL on a card, gloo on the CPU; ``backend`` overrides it."""
    if dist.is_initialized():
        return False
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return False
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=_TIMEOUT)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return process_index() == 0


class Mesh:
    """The world on named axes, one rank per shard.

    ``shape[axis]`` is the axis size, ``coord(axis)`` this rank's index
    on it, ``ranks(axis)`` the global ranks of this rank's line along it
    (in axis order). ``axis=None`` in the collectives means the whole
    world."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int]):
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.axis_sizes))
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = process_index()
        if int(np.prod(self.axis_sizes)) != self.world:
            raise ValueError(f"mesh {self.axis_sizes} != {self.world} ranks")
        self.backend = dist.get_backend() if dist.is_initialized() else None
        grid = np.arange(self.world).reshape(self.axis_sizes)
        where = np.unravel_index(self.rank, self.axis_sizes)
        self._coords = {a: int(c) for a, c in zip(self.axis_names, where)}
        self._lines: Dict[Optional[str], Tuple[List[int], object]] = {
            None: (list(range(self.world)), None)}
        for i, name in enumerate(self.axis_names):
            # every rank creates every line's group, in the same order
            for line in np.moveaxis(grid, i, -1).reshape(-1, self.axis_sizes[i]):
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks) if self.world > 1 else None
                if self.rank in ranks:
                    self._lines[name] = (ranks, group)

    def coord(self, axis: str) -> int:
        return self._coords[axis]

    def ranks(self, axis: Optional[str] = None) -> List[int]:
        return self._lines[axis][0]

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend takes it: a pinned host copy on gloo."""
        if t.is_cuda and self.backend == "gloo":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host
        return t.contiguous()

    def all_gather(self, t: torch.Tensor, axis: Optional[str] = None) -> List[torch.Tensor]:
        """Every rank's ``t`` along ``axis`` (same shape on each), in axis
        order, on ``t``'s device."""
        ranks, group = self._lines[axis]
        if len(ranks) == 1:
            return [t]
        buf = self._staged(t)
        outs = [torch.empty_like(buf) for _ in ranks]
        dist.all_gather(outs, buf, group=group)
        return [o.to(t.device, non_blocking=True) for o in outs]

    def all_sum(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """The sum of every rank's ``t`` along ``axis``, added in rank
        order (the same bits on every rank and every run)."""
        parts = self.all_gather(t, axis)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def any(self, flag: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """OR of a bool over the ranks along ``axis``."""
        return torch.stack(self.all_gather(flag.reshape(1).to(torch.int32), axis)).any()

    def exchange(self, axis: str, to_left: Optional[torch.Tensor],
                 to_right: Optional[torch.Tensor]):
        """One ring step along ``axis`` in each direction: send
        ``to_left`` to the left neighbour and ``to_right`` to the right
        one (cyclic). Returns ``(from_right, from_left)``: what the right
        neighbour sent left and the left neighbour sent right (same shapes
        as ours; None where ours is None). A neighbour that is this rank
        is a local copy. The two directions carry their own tags, so they
        match also when both neighbours are one rank."""
        ranks, group = self._lines[axis]
        n = len(ranks)
        if n == 1:
            return tuple(None if t is None else t.clone() for t in (to_left, to_right))
        i = ranks.index(self.rank)
        left, right = ranks[(i - 1) % n], ranks[(i + 1) % n]
        ops, recv = [], []
        for tag, (t, dst, src) in enumerate(((to_left, left, right), (to_right, right, left))):
            if t is None:
                recv.append(None)
                continue
            buf = self._staged(t)
            out = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.isend, buf, dst, group, tag))
            ops.append(dist.P2POp(dist.irecv, out, src, group, tag))
            recv.append(out)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        ref = to_left if to_left is not None else to_right
        from_right, from_left = (None if r is None else r.to(ref.device, non_blocking=True)
                                 for r in recv)
        return from_right, from_left


def global_mesh(axis_names: Sequence[str] = ("dp",), axis_sizes: Optional[Tuple[int, ...]] = None
                ) -> Mesh:
    """A mesh over every rank of the world (a world of one without a
    process group). With ``axis_sizes=None``, one axis over the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if axis_sizes is None:
        axis_sizes = (world,)
    return Mesh(axis_names, axis_sizes)
