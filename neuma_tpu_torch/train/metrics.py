"""Particle-accuracy metrics: chamfer distance and trajectory MSE.

Counterpart of ``neuma_tpu/train/metrics.py`` (``chamfer_distance``,
``trajectory_mse``), the same numpy code: the reference's
``modules/tune/metrics.py`` (naive and cKDTree chamfer) and
``modules/nclaw/utils.py:86-107`` (diff_mse over saved frames).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def chamfer_distance(a: np.ndarray, b: np.ndarray, chunk: int = 4096) -> float:
    """Symmetric chamfer (mean of squared NN distances both ways).
    KD-tree when scipy imports, chunked brute force otherwise."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        return float(np.mean(_nn_d2(a, b, chunk)) + np.mean(_nn_d2(b, a, chunk)))
    d_ab = cKDTree(b).query(a)[0]
    d_ba = cKDTree(a).query(b)[0]
    return float(np.mean(d_ab ** 2) + np.mean(d_ba ** 2))


def _nn_d2(x: np.ndarray, y: np.ndarray, chunk: int) -> np.ndarray:
    """Squared distance from each row of x to its nearest row of y, by
    brute force over chunks of x."""
    out = []
    for i in range(0, len(x), chunk):
        d2 = ((x[i : i + chunk, None, :] - y[None]) ** 2).sum(-1)
        out.append(d2.min(1))
    return np.concatenate(out)


def trajectory_mse(pred_frames: Sequence[np.ndarray], gt_frames: Sequence[np.ndarray],
                   skip: int = 5) -> float:
    """MSE over every ``skip``-th frame of particle trajectories
    (reference diff_mse, nclaw/utils.py:86-107)."""
    total, count = 0.0, 0
    for i in range(0, min(len(pred_frames), len(gt_frames)), skip):
        total += float(np.mean((np.asarray(pred_frames[i]) - np.asarray(gt_frames[i])) ** 2))
        count += 1
    return total / max(count, 1)
