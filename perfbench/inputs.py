"""The benchmark's inputs, made from ``--seed`` on the device.

One configuration file (``configs/<name>.json``) gives the sizes; this
module draws everything else from the seed with one ``torch.Generator``
on the run's device, in a few large calls: for each object, the particles
and the Gaussians filling its ellipsoid, the Gaussians' raw parameters,
both materials' base MLP weights and LoRA leaves and its initial
velocity; then, for training, the ground-truth frames. The same seed
gives the same inputs on the same kind of device. The cameras are fixed
by the configuration. Both the port (``program.py``) and the plain
reference (``reference.py``) are handed these tensors and derive the rest
themselves.

A configuration holds one object in its top-level keys (``scene``'s
ellipsoid, particles, Gaussians and their looks, ``rho``,
``clip_bound``, ``materials``), or several in ``objects``, one particle
system in the one box of ``scene`` (``sim_scale``, ``sim_offset``, the
cameras' ``target``). Each object of ``objects`` gives ``particles``,
``gaussians``, ``object_center``, ``object_radii``, ``gaussian_scale``,
``opacity_range``, ``sh_rest_std``, ``init_v_range``, ``rho``,
``clip_bound`` and its material section, ``materials``: ``mu``,
``lambda``, ``lora_r``, ``lora_alpha``, ``plasticity_alpha`` and
``lora_b_std``, which replaces the traffic's adaptor scale for it; the
widths and the nonlinearity stay in the top-level ``materials``. The
objects are drawn in order, and their particles and Gaussians lie in
contiguous sections in that order. A configuration of one object draws
the same tensors, in the same order, as it did before ``objects`` existed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def look_at(eye, target, up):
    """World-to-camera rotation (rows right, up, forward) and translation
    of a camera at ``eye`` looking at ``target``."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    r = np.stack([right, np.cross(fwd, right), fwd])
    return r, -r @ eye


def cameras(cfg: dict) -> list:
    """The configuration's views: each ``R_w2c``, ``t``, fields of view and size."""
    sc = cfg["scene"]
    target = np.asarray(sc["target"] if "target" in sc else sc["object_center"], np.float64)
    out = []
    for view in cfg["views"]:
        r, t = look_at(target + np.asarray(view["eye_offset"]), target, view["up"])
        out.append({"name": view["name"], "R_w2c": r.tolist(), "t": t.tolist(),
                    "fov_x": float(view["fov_x"]), "fov_y": float(view["fov_y"]),
                    "width": int(view["width"]), "height": int(view["height"])})
    return out


def _ellipsoid(gen, m: int, center, radii, device) -> torch.Tensor:
    d = torch.randn((m, 3), generator=gen, device=device)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    r = torch.rand((m, 1), generator=gen, device=device) ** (1.0 / 3.0)
    c = torch.as_tensor(center, dtype=torch.float32, device=device)
    return c + d * r * torch.as_tensor(radii, dtype=torch.float32, device=device)


def _linear_law(mu: float, lam: float) -> torch.Tensor:
    """(13, 9): Y = mu (F^T F - I) + lam (det F - 1) I from the features
    [sigma - 1, flat(F^T F - I), det F - 1]: with P = R sym(Y) a
    corotated linear elastic law (small strain: 2 mu eps + lam tr(eps) I)."""
    w = torch.zeros((13, 9))
    for k in range(9):
        w[3 + k, k] = mu
    for k in (0, 4, 8):
        w[12, k] = lam
    return w


def _mlp_layers(gen, dims, m: dict, b_std: float, elastic: bool, device) -> list:
    """Base kernels Xavier-uniform; for the elasticity, the first 13
    hidden pairs of both layers carry each feature z as (GELU(z),
    GELU(-z)), whose difference is z exactly, and the final layer maps
    them through the linear law: the base model is a stable elastic law,
    and the other hidden units add a small nonlinear part. LoRA A is
    uniform over +-1/sqrt(fan_in) (the published initialization); LoRA B
    normal with std ``b_std`` (the elastic final layer's times mu): 0, as
    stage 2 starts, or a trained adaptor's scale for serving."""
    r, alpha = int(m["lora_r"]), float(m["lora_alpha"])
    mu, lam = float(m["mu"]), float(m["lambda"])
    layers = []
    for li, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((fan_in * fan_out + fan_in * r,), generator=gen, device=device)
        kernel = (2.0 * u[:fan_in * fan_out] - 1.0).reshape(fan_in, fan_out) * bound
        std = b_std * (mu if elastic and li == len(dims) - 2 else 1.0)
        if elastic:
            f = dims[0]
            if li == 0:
                kernel[:, :2 * f] = 0.0
                i = torch.arange(f, device=device)
                kernel[i, i], kernel[i, f + i] = 1.0, -1.0
            elif li < len(dims) - 2:
                i = torch.arange(f, device=device)
                kernel[:, :2 * f] = 0.0
                kernel[i, i], kernel[i, f + i] = 1.0, -1.0
                kernel[f + i, i], kernel[f + i, f + i] = -1.0, 1.0
            else:
                law = _linear_law(mu, lam).to(device)
                kernel[:f] = law
                kernel[f:2 * f] = -law
        layers.append({
            "kernel": kernel,
            "lora_a": (2.0 * u[fan_in * fan_out:] - 1.0).reshape(fan_in, r) / math.sqrt(fan_in),
            "lora_b": std * torch.randn((r, fan_out), generator=gen, device=device),
            "lora_scale": torch.tensor(alpha / r, dtype=torch.float32, device=device),
        })
    return layers


def objects(cfg: dict) -> list:
    """Each object's settings, in order: ``objects``, or the one object of
    the top-level keys."""
    if "objects" in cfg:
        shared = cfg["materials"]
        return [dict(o, materials={**shared, **o["materials"]}) for o in cfg["objects"]]
    sc = cfg["scene"]
    keys = ("particles", "gaussians", "object_center", "object_radii", "gaussian_scale",
            "opacity_range", "sh_rest_std", "init_v_range")
    return [dict({k: sc[k] for k in keys}, rho=cfg["rho"], clip_bound=cfg["clip_bound"],
                 materials=cfg["materials"])]


def _join(parts: list) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def make(cfg: dict, seed: int, device, with_gt: bool, lora_b_std: float = 0.0) -> dict:
    """Every input of one run from ``seed``; ``lora_b_std`` is the traffic's
    adaptor (0: stage 2's start). ``objects`` holds each object's counts,
    materials, plasticity ``alpha``, ``clip_bound`` and ``init_v``; the
    particles' and Gaussians' tensors are joined over the objects, and
    ``materials`` and ``init_v`` are the first object's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sc = cfg["scene"]
    size, center = float(sc["sim_scale"]), np.asarray(sc["sim_offset"], np.float32)
    deg = int(cfg["sh_degree"])
    several = "objects" in cfg
    parts = {key: [] for key in ("x0", "vol", "rho", "xyz", "scaling", "rotation", "opacity",
                                 "features_dc", "features_rest")}
    objs = []
    for spec in objects(cfg):
        m = spec["materials"]
        std = float(m["lora_b_std"]) if several else lora_b_std
        obj = _object(gen, spec, size, center, deg, std, device)
        for key in parts:
            parts[key].append(obj.pop(key))
        obj.update(alpha=float(m["plasticity_alpha"]), clip_bound=float(spec["clip_bound"]))
        objs.append(obj)

    raw = {
        "x0": _join(parts["x0"]), "vol": _join(parts["vol"]), "rho": _join(parts["rho"]),
        "size": np.full(3, size, np.float32), "center": center,
        "gaussians": {k: _join(parts[k]) for k in ("xyz", "scaling", "rotation", "opacity",
                                                    "features_dc", "features_rest")},
        "materials": objs[0]["materials"], "init_v": objs[0]["init_v"],
        "cameras": cameras(cfg), "objects": objs,
    }
    if with_gt:
        views = raw["cameras"]
        h, w = views[0]["height"], views[0]["width"]
        raw["gt"] = torch.rand((int(cfg["train"]["num_frames"]), len(views), 3, h, w), generator=gen,
                               device=device)
    return raw


def _object(gen, spec: dict, size: float, center, deg: int, lora_b_std: float, device) -> dict:
    """One object's draws, in the order of the generator."""
    n, k = int(spec["particles"]), int(spec["gaussians"])
    radii = np.asarray(spec["object_radii"], np.float64)
    volume = 4.0 / 3.0 * math.pi * float(np.prod(radii))  # world units
    pts = _ellipsoid(gen, n + k, spec["object_center"], radii, device)
    x0 = (pts[:n] * size + torch.as_tensor(center, device=device)).contiguous()

    spacing = (volume / k) ** (1.0 / 3.0)
    u = torch.rand((k, 9), generator=gen, device=device)
    lo, hi = spec["opacity_range"]
    opacity = lo + (hi - lo) * u[:, 6:7]
    n_rest = (deg + 1) ** 2 - 1
    out = {
        "particles": n, "gaussians": k, "x0": x0,
        "xyz": pts[n:].contiguous(),
        "scaling": torch.log(spacing * float(spec["gaussian_scale"]) * (0.7 + 0.6 * u[:, :3])),
        "rotation": torch.randn((k, 4), generator=gen, device=device),
        "opacity": torch.log(opacity / (1.0 - opacity)),
        "features_dc": ((u[:, 3:6] - 0.5) / SH_C0)[:, None, :].contiguous(),
        "features_rest": float(spec["sh_rest_std"]) * torch.randn((k, n_rest, 3), generator=gen,
                                                                   device=device),
    }

    m = spec["materials"]
    dims = [13, *m["layer_widths"], 9]
    out["materials"] = {name: _mlp_layers(gen, dims, m, lora_b_std, name == "elasticity", device)
                        for name in ("elasticity", "plasticity")}

    v_lo, v_hi = (torch.as_tensor(b, dtype=torch.float32, device=device) for b in spec["init_v_range"])
    out["init_v"] = v_lo + (v_hi - v_lo) * torch.rand((3,), generator=gen, device=device)

    sim_vol = volume * size ** 3 / n
    out["vol"] = torch.full((n,), sim_vol, dtype=torch.float32, device=device)
    out["rho"] = torch.full((n,), float(spec["rho"]), dtype=torch.float32, device=device)
    return out


def per_particle(raw: dict, key: str, device) -> torch.Tensor:
    """An object setting (``clip_bound``) over every particle."""
    return _join([torch.full((o["particles"],), o[key], device=device) for o in raw["objects"]])
