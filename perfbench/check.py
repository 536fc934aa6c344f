"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference.py``), each number beside its
limit (``limits/<cell>.json``, with the readings it was set from).

Training (``train``): the reference runs the first ``checked_steps``
epochs of stage 2 from the same raw inputs. Compared are

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient as the optimizer got it (the
  clipped gradient, worked out from the optimizer's momentum after one
  step), by the worst leaf: the gap between the program's norm of
  the leaf and the reference's, over the larger of the reference's norm
  of that leaf and of the median leaf;
* ``change_gap``: the change of the leaves after the last checked step,
  by the worst leaf in the same way, leaving out leaves whose reference
  gradient is under a thousandth of the median leaf's.

Serving (``serve``): for each checked frame (a sample drawn from the seed,
and the window's last frame) the reference steps the sim from the
program's state before the frame and renders every view from the
program's state after it. Compared are

* ``state_gap``: the largest gap of the stepped particle state, per
  field (x, v, C, F) the norm of the difference over the norm of the
  reference's change of that field in the step;
* ``image_rmse``: the root mean square difference of the images over
  every checked frame, view and pixel (intensities in [0, 1]).

A non-finite number fails its limit.
"""
from __future__ import annotations

import math
import statistics

import torch

from . import reference


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.norm(t.double()))


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of | |p| - |r| | / max(|r|, median |r|)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: _norm(ref[k]) for k in names}
    med = statistics.median(rn.values())
    return max(abs(_norm(prog[k]) - rn[k]) / max(rn[k], med) for k in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``: losses, the leaves before the first and after the last
    checked step, and the first step's gradients; ``ref``: ``reference.train``."""
    steps = len(ref["losses"])
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"][:steps], ref["losses"]))
    s0, sn = prog["snaps"][0], prog["snaps"][steps]
    g_prog = prog["first_grads"]
    g_ref = ref["first_grads"]
    gmed = statistics.median(_norm(g) for g in g_ref.values())
    moving = {k for k, g in g_ref.items() if _norm(g) >= 1e-3 * gmed}
    d_prog = {k: sn[k] - s0[k] for k in s0}
    d_ref = {k: ref["leaves"][k] - ref["leaves0"][k] for k in s0}
    return {"loss_gap": loss, "grad_gap": leaf_gap(g_prog, g_ref),
            "change_gap": leaf_gap(d_prog, d_ref, keep=moving)}


def serve_numbers(frames: dict, host: torch.Tensor, raw: dict, cfg: dict, stand_in=None) -> dict:
    """``frames``: checked frame -> the program's state before it (with
    the previous frame's references), ``post`` after it, and the host
    slot of its images. ``stand_in`` replaces the program's outputs by
    another reckoning (the control)."""
    ref = reference.build(raw, cfg)
    state_gap, sq, count = 0.0, 0.0, 0
    for pre in frames.values():
        r_state, r_imgs, _ = reference.frame_step(raw, cfg, pre, ref=ref)
        if stand_in is None:
            p_state, p_imgs = pre["post"], host[pre["images"]].to(r_imgs.device)
        else:
            p_state, p_imgs, _ = stand_in(pre, ref)
        for f in ("x", "v", "C", "F"):
            step = _norm(r_state[f] - pre[f])
            state_gap = max(state_gap, _norm(p_state[f] - r_state[f]) / max(step, 1e-30))
        d = (p_imgs - r_imgs).double()
        sq += float((d * d).sum())
        count += d.numel()
    return {"state_gap": state_gap, "image_rmse": math.sqrt(sq / max(count, 1))}


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) with every limited number."""
    rows, ok = [], True
    for name, lim in limits.items():
        value = numbers.get(name, float("nan"))
        passed = math.isfinite(value) and value <= lim["limit"]
        ok = ok and passed
        rows.append((name, value, lim["limit"]))
    return ok, rows
