"""Camera-path editor core: keyframed spline trajectories.

Counterpart of ``neuma_tpu/vis/campath.py``, a copy of its numpy code
(``_catmull_rom``, ``_spline_points``, ``spline_path``): the port imports
nothing of the JAX package, so it keeps its own. A list of keyframes with
per-keyframe transition and hold durations is resampled into a smooth
camera trajectory: centripetal Catmull-Rom splines through the eye and
target points (no cusps or self-intersections on tight turns), linear
fov blending, optional closed loop. The viewer's ``/render_path``
endpoint renders the rollout along the returned cameras.

Keyframe dict fields (all but ``eye``/``target`` optional):
    eye:            [3] world-space camera position
    target:         [3] look-at point
    fov:            vertical fov radians (default: path-wide fov)
    transition_sec: seconds of travel from the PREVIOUS keyframe
                    (default ``default_transition_sec``)
    hold_sec:       seconds to dwell at this keyframe (default 0)
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _catmull_rom(
    p0: np.ndarray, p1: np.ndarray, p2: np.ndarray, p3: np.ndarray,
    t: np.ndarray, alpha: float = 0.5,
) -> np.ndarray:
    """Centripetal Catmull-Rom segment between p1 and p2 sampled at
    ``t`` in [0, 1); degenerates gracefully when control points
    coincide."""

    def tj(ti, a, b):
        return ti + max(np.linalg.norm(b - a) ** alpha, 1e-8)

    t0 = 0.0
    t1 = tj(t0, p0, p1)
    t2 = tj(t1, p1, p2)
    t3 = tj(t2, p2, p3)
    ts = t1 + (t2 - t1) * t[:, None]  # (S, 1)

    def lerp(a, b, ta, tb):
        w = (ts - ta) / max(tb - ta, 1e-8)
        return (1 - w) * a[None] + w * b[None]

    a1 = lerp(p0, p1, t0, t1)
    a2 = lerp(p1, p2, t1, t2)
    a3 = lerp(p2, p3, t2, t3)
    w12 = (ts - t0) / max(t2 - t0, 1e-8)
    b1 = (1 - w12) * a1 + w12 * a2
    w23 = (ts - t1) / max(t3 - t1, 1e-8)
    b2 = (1 - w23) * a2 + w23 * a3
    w = (ts - t1) / max(t2 - t1, 1e-8)
    return (1 - w) * b1 + w * b2


def _spline_points(
    pts: np.ndarray, counts: Sequence[int], loop: bool
) -> np.ndarray:
    """Sample a Catmull-Rom spline through ``pts`` ((K, 3)); segment i
    (pts[i] -> pts[i+1]) gets ``counts[i]`` samples (excluding its end
    point). End tangents: wrap when looping, clamped (endpoint
    duplication) otherwise."""
    k = len(pts)
    out = []
    n_seg = k if loop else k - 1
    for i in range(n_seg):
        p1 = pts[i]
        p2 = pts[(i + 1) % k]
        if loop:
            p0 = pts[(i - 1) % k]
            p3 = pts[(i + 2) % k]
        else:
            p0 = pts[max(i - 1, 0)]
            p3 = pts[min(i + 2, k - 1)]
        t = np.arange(counts[i], dtype=np.float64) / max(counts[i], 1)
        out.append(_catmull_rom(p0, p1, p2, p3, t))
    if not loop:
        out.append(pts[-1:][:])  # include the final keyframe pose
    return np.concatenate(out, axis=0)


def spline_path(
    keyframes: Sequence[dict],
    fps: int = 30,
    default_transition_sec: float = 2.0,
    loop: bool = False,
    default_fov: Optional[float] = None,
) -> List[Tuple[np.ndarray, np.ndarray, Optional[float]]]:
    """Resample keyframes into per-frame (eye, target, fov) camera
    poses. Transition/hold durations are honored per keyframe; the
    trajectory passes exactly through every keyframe."""
    assert len(keyframes) >= 2, "need at least two keyframes"
    eyes = np.asarray([k["eye"] for k in keyframes], np.float64)
    tgts = np.asarray([k["target"] for k in keyframes], np.float64)
    fovs = np.asarray(
        [k.get("fov") or default_fov or 0.8 for k in keyframes],
        np.float64,
    )

    k = len(keyframes)
    n_seg = k if loop else k - 1
    counts = [
        max(
            1,
            int(
                round(
                    float(
                        keyframes[(i + 1) % k].get(
                            "transition_sec", default_transition_sec
                        )
                    )
                    * fps
                )
            ),
        )
        for i in range(n_seg)
    ]

    eye_s = _spline_points(eyes, counts, loop)
    tgt_s = _spline_points(tgts, counts, loop)

    # fov: linear within each segment.
    fov_s = []
    for i in range(n_seg):
        f1, f2 = fovs[i], fovs[(i + 1) % k]
        t = np.arange(counts[i], dtype=np.float64) / counts[i]
        fov_s.append((1 - t) * f1 + t * f2)
    if not loop:
        fov_s.append(fovs[-1:])
    fov_s = np.concatenate(fov_s)

    # Expand holds: dwell at each keyframe's pose before departing.
    frames = []
    starts = np.cumsum([0] + counts)  # sample index of keyframe i
    hold_at = {
        int(starts[i]): int(
            round(float(keyframes[i].get("hold_sec", 0.0)) * fps)
        )
        for i in range(n_seg)
    }
    if not loop:
        hold_at[len(eye_s) - 1] = int(
            round(float(keyframes[-1].get("hold_sec", 0.0)) * fps)
        )
    for j in range(len(eye_s)):
        reps = 1 + hold_at.get(j, 0)
        for _ in range(reps):
            frames.append((eye_s[j], tgt_s[j], float(fov_s[j])))
    return frames
