"""Multi-process entry: the two calls the apps make.

Counterpart of ``neuma_tpu/parallel/distributed.py`` (``initialize``,
``is_primary``) on ``torch.distributed``. A single process (no
``WORLD_SIZE`` above 1 in the environment) needs no runtime and is the
primary. Where ``WORLD_SIZE`` > 1, ``initialize`` starts the process
group from the environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, as ``torchrun`` sets them): NCCL on a card, gloo
otherwise. Only the primary process writes logs and checkpoints.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize() -> bool:
    """Start the process group when run multi-process; True if it did."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, init_method="env://")
    return True


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0
