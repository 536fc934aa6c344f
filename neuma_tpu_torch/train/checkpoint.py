"""The full train-state file and the per-epoch metrics log.

Counterpart of ``neuma_tpu/train/checkpoint.py`` (``save_train_state``,
``load_train_state``, ``MetricsLogger``) for the stage-2 trainer's state:
the LoRA-adapted parameter trees of both materials, their RAdam moments
and the step. The file is the JAX package's: one npz of ``leaf_{i}``
arrays in the order ``jax.tree_util.tree_flatten`` gives for

    {"step": int64, "params": {"e": tree, "p": tree},
     "opt_state": (e_state, p_state)}

Dict keys flatten sorted (so ``opt_state``, then ``params``, then
``step``), lists and tuples in order. Each optimizer state is the JAX
trainer's ``optax.masked(radam(schedule))`` state: ``MaskedState`` over a
chain of ``ScaleByAdamState(count, mu, nu)`` and
``ScaleByScheduleState(count)``. Masked-out (frozen) leaves are
``MaskedNode``s and add no leaf, and with weight decay the chain's first
state (``add_decayed_weights``) is empty, so either way one state
flattens to ``[count, mu..., nu..., count]`` with int32 counts and the
moments of the LoRA leaves alone, in the tree's sorted order
(``final`` before ``layers``, ``lora_a`` before ``lora_b``). The port
keeps the moments as a list in module order (``interop.lora_leaves``);
``_jax_lora_order`` maps one order onto the other. A file written by
either package resumes in the other.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..interop import radam_state_from_numpy, radam_state_to_numpy, to_numpy
from ..nn.mlp import LORA_LEAVES
from .optim import RAdamState


def _jax_lora_order(tree: Dict) -> List[int]:
    """Positions of the port's LoRA-leaf list, in JAX's flatten order."""
    keys = [("layers", i, k) for i, layer in enumerate(tree["layers"])
            for k in LORA_LEAVES if k in layer]
    keys += [("final", 0, k) for k in LORA_LEAVES if k in tree["final"]]
    return sorted(range(len(keys)), key=keys.__getitem__)


def _flatten(tree) -> list:
    """``jax.tree_util.tree_flatten``'s leaf order for dicts and lists."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s structure with the next leaves of the iterator."""
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _state_leaves(state: RAdamState, tree: Dict) -> list:
    s = radam_state_to_numpy(state)
    order = _jax_lora_order(tree)
    if len(order) != len(s["mu"]):
        raise ValueError(f"{len(s['mu'])} moments for {len(order)} LoRA leaves")
    count = np.int32(s["count"])
    return [count] + [s["mu"][j] for j in order] + [s["nu"][j] for j in order] + [count]


def save_train_state(path, step: int, params: Dict, opt_state: Sequence[RAdamState]) -> None:
    """``params`` = {"e": tree, "p": tree} (the material modules'
    ``params()``); ``opt_state`` = (e_state, p_state) over each
    material's LoRA leaves in module order."""
    trees = [params[k] for k in ("e", "p")]
    leaves = [leaf for state, tree in zip(opt_state, trees) for leaf in _state_leaves(state, tree)]
    leaves += _flatten(to_numpy(params))
    leaves.append(np.int64(step))
    np.savez(path, **{f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)})


def load_train_state(path, params: Dict, device="cpu") -> Tuple[int, Dict, Tuple[RAdamState, ...]]:
    """(step, {"e": tree, "p": tree} of numpy leaves, (e_state, p_state))
    from a file of either package; ``params`` is the template (the
    trainer's current trees: the same layers and leaves)."""
    with np.load(path, allow_pickle=False) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    template = to_numpy(params)
    expected = sum(2 + 2 * len(_jax_lora_order(params[k])) for k in ("e", "p"))
    expected += len(_flatten(template)) + 1
    if len(arrays) != expected:
        raise ValueError(f"{path} holds {len(arrays)} leaves; this train state has {expected}")
    leaves = iter(arrays)
    states = []
    for key in ("e", "p"):
        order = _jax_lora_order(params[key])
        count = int(next(leaves))
        mu, nu = [None] * len(order), [None] * len(order)
        for moments in (mu, nu):
            for j in order:
                moments[j] = next(leaves)
        if int(next(leaves)) != count:
            raise ValueError(f"{path}: the RAdam and schedule step counts differ")
        states.append(radam_state_from_numpy(count, mu, nu, device))
    restored = _unflatten(template, leaves)
    for got, want in zip(_flatten(restored), _flatten(template)):
        if got.shape != want.shape:
            raise ValueError(f"{path}: a leaf of shape {got.shape} for one of {want.shape}")
    return int(next(leaves)), restored, tuple(states)


def load_into(module: torch.nn.Module, tree: Dict) -> None:
    """Copy a parameter tree's leaves into a material module in place."""
    with torch.no_grad():
        for dst, src in zip(_flatten(module.params()), _flatten(tree)):
            dst.copy_(torch.as_tensor(src))


class MetricsLogger:
    """Append-only JSONL scalar log, one row per step with arbitrary
    scalar keys (the reference's tensorboardX writer as a tailable file)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def log(self, step: int, **scalars) -> None:
        row = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            row[k] = float(v)
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
