"""Plain PyTorch reference of the NeuMA grounding frame, for the benchmark's
check of ``correct``.

It imports torch and numpy only: nothing of the port, of the JAX package
or of JAX. Every table the port derives from the benchmark's inputs (the
camera matrices, the binding table, the tile pair lists, the block sort)
is worked out again here, from the same raw inputs (``inputs.py``).

What it computes, in float32 with TF32 off (``exact``), on whatever
device its inputs live on:

* the InvariantFull elasticity and plasticity MLPs with LoRA (exact GELU,
  no bias), fed [sigma - 1, flat(F^T F - I), det F - 1] from a signed 3x3
  SVD (singular values sorted descending, det U = det V = +1, the sign
  folded into sigma[2]) whose backward is the closed-form adjoint with
  the ``sign(d) / max(|d|, 1e-10)`` clamp on near-equal squared singular
  values: NeuMA's published material and its conventions; with several
  objects each object's pair on its own contiguous section of the
  particles;
* one MLS-MPM step on the dense grid (quadratic B-splines, APIC, taps off
  the grid folded onto its edge, ``noslip`` / ``freeslip`` box, the
  advection clamp), scattered with ``index_add_``;
* the particle -> Gaussian binding (chi-square 0.95 Mahalanobis field,
  the 10 nearest particles, uniform weights; each object's Gaussians to
  its own particles), the incremental centre update and F Sigma F^T with
  the stop-gradients of the published method;
* 3DGS rasterization: EWA projection (the 1.3 tan-fov clamp, the +0.3
  low-pass), SH colours, 16x16 tiles, front-to-back compositing per
  pixel with the CUDA rasterizer's guards (alpha >= 1/255, alpha capped
  at 0.99 and the cap left out of the gradient, stop before T < 1e-4);
* the rollout loss (each view's mean L1 / L2 summed over the views, weighted
  per frame) and RAdam with
  per-material global-norm clipping for the first steps of stage 2.

Gradients come from autograd through these forwards, except the SVD's
adjoint and the alpha cap above, which the published method defines.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
CHI2_95_3 = 7.814727903251179  # chi2.ppf(0.95, 3)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Matmuls and convolutions in full float32 (``tf32=False``) or in TF32,
    the control's precision; the global flags are restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# --- 3x3 SVD -----------------------------------------------------------------


def _jacobi_svd(a: torch.Tensor, sweeps: int = 6):
    """One-sided Jacobi on (N, 3, 3): returns U, sigma (N, 3), V."""
    b = a.clone()
    n = a.shape[0]
    v = torch.eye(3, dtype=a.dtype, device=a.device).expand(n, 3, 3).clone()
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            bp, bq = b[:, :, p], b[:, :, q]
            alpha = (bp * bp).sum(1)
            beta = (bq * bq).sum(1)
            gamma = (bp * bq).sum(1)
            ok = gamma * gamma > (1e-14 * alpha * beta + 1e-38)
            zeta = (beta - alpha) / (2.0 * torch.where(ok, gamma, torch.ones_like(gamma)))
            t = torch.sign(zeta) / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(ok, t, torch.zeros_like(t))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = c * t
            for m in (b, v):
                mp, mq = m[:, :, p].clone(), m[:, :, q].clone()
                m[:, :, p] = c[:, None] * mp - s[:, None] * mq
                m[:, :, q] = s[:, None] * mp + c[:, None] * mq
    sig = torch.sqrt((b * b).sum(1))
    order = torch.argsort(-sig, dim=1, stable=True)
    sig = torch.gather(sig, 1, order)
    idx = order[:, None, :].expand(n, 3, 3)
    b, v = torch.gather(b, 2, idx), torch.gather(v, 2, idx)
    u = b / torch.clamp(sig, min=1e-30)[:, None, :]
    cross = torch.linalg.cross(u[:, :, 0], u[:, :, 1], dim=1)
    cross = cross / torch.clamp(torch.linalg.norm(cross, dim=1, keepdim=True), min=1e-30)
    u = torch.cat([u[:, :, :2], torch.where((sig[:, 2] < 1e-8)[:, None], cross, u[:, :, 2])[:, :, None]],
                  2)
    for m in (u, v):
        flip = torch.where(torch.linalg.det(m) < 0.0, -1.0, 1.0)
        m[:, :, 2] = m[:, :, 2] * flip[:, None]
        sig = torch.cat([sig[:, :2], (sig[:, 2] * flip)[:, None]], 1)
    return u, sig, v


class _SVD(torch.autograd.Function):
    """A = U diag(sigma) V^T with the closed-form adjoint."""

    @staticmethod
    def forward(ctx, a):
        u, s, v = _jacobi_svd(a)
        ctx.save_for_backward(u, s, v)
        return u, s, v

    @staticmethod
    def backward(ctx, du, ds, dv):
        u, s, v = ctx.saved_tensors
        du = torch.zeros_like(u) if du is None else du
        dv = torch.zeros_like(v) if dv is None else dv
        ds = torch.zeros_like(s) if ds is None else ds
        s2 = s * s
        diff = s2[:, None, :] - s2[:, :, None]  # [i, j] = s_j^2 - s_i^2
        f = torch.sign(diff) / torch.clamp(torch.abs(diff), min=1e-10)
        utdu = u.transpose(1, 2) @ du
        vtdv = v.transpose(1, 2) @ dv
        j = f * (utdu - utdu.transpose(1, 2))
        k = f * (vtdv - vtdv.transpose(1, 2))
        inner = j * s[:, None, :] + s[:, :, None] * k
        inner = inner + torch.diag_embed(ds) - torch.diag_embed(torch.diagonal(inner, 0, 1, 2))
        return u @ inner @ v.transpose(1, 2)


def svd3(a: torch.Tensor):
    return _SVD.apply(a)


# --- materials -----------------------------------------------------------------


def mlp(layers: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """Hidden layers with exact GELU, a linear final layer; each linear is
    x K + (x A) B scale, without bias."""
    for i, p in enumerate(layers):
        x = x @ p["kernel"] + (x @ p["lora_a"]) @ p["lora_b"] * p["lora_scale"]
        if i + 1 < len(layers):
            x = F.gelu(x, approximate="none")
    return x


def _features(f: torch.Tensor):
    u, s, v = svd3(f)
    r = u @ v.transpose(1, 2)
    eye = torch.eye(3, dtype=f.dtype, device=f.device)
    ftf = f.transpose(1, 2) @ f - eye
    det = torch.linalg.det(f)
    x = torch.cat([s - 1.0, ftf.reshape(-1, 9), (det - 1.0)[:, None]], 1)
    return x, r


def _sym(y: torch.Tensor) -> torch.Tensor:
    y = y.reshape(-1, 3, 3)
    return 0.5 * (y + y.transpose(1, 2))


def elasticity(layers, f: torch.Tensor) -> torch.Tensor:
    """Cauchy stress (R sym(MLP)) F^T."""
    x, r = _features(f)
    return (r @ _sym(mlp(layers, x))) @ f.transpose(1, 2)


def plasticity(layers, f: torch.Tensor, alpha: float) -> torch.Tensor:
    """F + alpha R sym(MLP)."""
    x, r = _features(f)
    return f + alpha * (r @ _sym(mlp(layers, x)))


# --- MPM --------------------------------------------------------------------------

_OFFSETS = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(3), indexing="ij"),
                    axis=-1).reshape(27, 3)


def _scrub(t: torch.Tensor) -> torch.Tensor:
    if t.requires_grad:
        t.register_hook(lambda g: torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0))
    return t


def mpm_step(sim: dict, state, stress):
    """One MLS-MPM step on the dense grid; ``state`` is (x, v, C, F)."""
    x, v, c, f = state
    g = int(sim["num_grids"])
    inv_dx, dx = float(g), 1.0 / g
    dt, eps = float(sim["dt"]), float(sim["eps"])
    dev, dt_ = x.device, x.dtype
    px = x * inv_dx
    base = torch.floor(px - 0.5).detach()
    fx = px - base
    w = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2], -1)
    off = torch.as_tensor(_OFFSETS, device=dev)
    wt = w[:, 0, off[:, 0]] * w[:, 1, off[:, 1]] * w[:, 2, off[:, 2]]  # (N, 27)
    dpos = (off.to(dt_)[None] - fx[:, None, :]) * dx  # (N, 27, 3)
    cells = torch.clamp(base.long()[:, None, :] + off[None], 0, g - 1)
    flat = (cells[..., 0] * g + cells[..., 1]) * g + cells[..., 2]

    vol, rho = sim["vol"], sim["rho"]
    mass = vol * rho
    affine = (-dt * 4.0 * inv_dx * inv_dx * vol)[:, None, None] * stress + mass[:, None, None] * c
    mv = wt[..., None] * (mass[:, None, None] * v[:, None, :] + torch.einsum("nij,noj->noi", affine,
                                                                          dpos))
    m = wt * mass[:, None]
    vals = torch.cat([mv, m[..., None]], -1).reshape(-1, 4)
    grid = torch.zeros((g ** 3, 4), dtype=dt_, device=dev).index_add(0, flat.reshape(-1), vals)

    gm, gmv = grid[:, 3], grid[:, :3]
    gv = torch.as_tensor(sim["gravity"], dtype=dt_, device=dev) * dt
    has = gm > 0.0
    denom = torch.where(has, gm + eps, torch.ones_like(gm))[:, None]
    vel = torch.where(has[:, None], gmv / denom + gv, gv.expand_as(gmv))
    idx = torch.arange(g ** 3, device=dev)
    coords = torch.stack([idx // (g * g), (idx // g) % g, idx % g], -1)
    bound = int(sim["bound"])
    viol = ((coords < bound) & (vel < 0.0)) | ((coords >= g - bound) & (vel > 0.0))
    if sim["bc"] == "noslip":
        vel = torch.where(viol.any(-1, keepdim=True), torch.zeros_like(vel), vel)
    elif sim["bc"] == "freeslip":
        vel = torch.where(viol, torch.zeros_like(vel), vel)
    else:
        raise ValueError(f"unknown boundary condition {sim['bc']!r}")

    taps = vel[flat]  # (N, 27, 3)
    new_v = torch.einsum("no,noi->ni", wt, taps)
    new_c = 4.0 * inv_dx * inv_dx * torch.einsum("no,noi,noj->nij", wt, taps, dpos)
    eye = torch.eye(3, dtype=dt_, device=dev)
    new_f = (eye + dt * new_c) @ f
    clip = (sim["clip_bound"] * dx)[:, None]
    new_x = torch.minimum(torch.maximum(x + dt * new_v, clip), 1.0 - clip)
    return new_x, new_v, new_c, new_f


def by_section(mats: list, f: torch.Tensor, fn) -> torch.Tensor:
    """``fn(section, F)`` on each material section's contiguous slice of
    particles, joined."""
    if len(mats) == 1:
        return fn(mats[0], f)
    return torch.cat([fn(m, f[m["span"][0]:m["span"][1]]) for m in mats])


def substep(sim: dict, mats: list, state):
    """elasticity -> MPM step -> plasticity, each material on its own
    section, with the published method's NaN/Inf scrub of every cotangent
    the step passes back."""
    state = tuple(_scrub(t) for t in state)
    stress = _scrub(by_section(mats, state[3], lambda m, f: elasticity(m["elasticity"], f)))
    x, v, c, f = mpm_step(sim, state, stress)
    return x, v, c, by_section(mats, f, lambda m, f: plasticity(m["plasticity"], f, m["alpha"]))


# --- Gaussians, binding, cameras ------------------------------------------------------


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1).reshape(-1, 3, 3)


def covariance(log_scale: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """Sigma = (R S)(R S)^T, (K, 3, 3)."""
    l = quat_to_rotmat(rotation) * torch.exp(log_scale)[:, None, :]
    return l @ l.transpose(1, 2)


def binding_table(means, cov, particles, max_particles: int = 10, chunk: int = 1024):
    """The nearest ``max_particles`` particles with a Mahalanobis
    statistic within chi2(0.95, 3), uniform weights: (K, M) indices and
    weights."""
    inv = torch.linalg.inv(cov)
    top = min(max_particles, particles.shape[0])
    idx_out, w_out = [], []
    for s in range(0, means.shape[0], chunk):
        d = particles[None, :, :] - means[s:s + chunk, None, :]
        stat = torch.einsum("kpi,kij,kpj->kp", d, inv[s:s + chunk], d)
        stat = torch.where(stat <= CHI2_95_3, stat, torch.full_like(stat, float("inf")))
        vals, idx = torch.topk(stat, top, dim=1, largest=False, sorted=True)
        inside = torch.isfinite(vals)
        count = torch.clamp(inside.sum(1, keepdim=True), min=1).to(vals.dtype)
        w = torch.where(inside, 1.0 / count, torch.zeros_like(vals))
        if top < max_particles:
            idx = F.pad(idx, (0, max_particles - top))
            w = F.pad(w, (0, max_particles - top))
        idx_out.append(idx)
        w_out.append(w)
    return torch.cat(idx_out), torch.cat(w_out)


def camera(spec: dict, device) -> dict:
    """World-to-view and full projection (row-vector convention, float64
    then float32), the centre and the focal lengths of a camera given by
    its world-to-camera rotation, translation, fields of view and size."""
    r = np.asarray(spec["R_w2c"], np.float64)
    t = np.asarray(spec["t"], np.float64)
    w2v = np.eye(4)
    w2v[:3, :3], w2v[:3, 3] = r, t
    w2v = w2v.astype(np.float32).T
    zn, zf = 0.01, 100.0
    fx, fy = float(spec["fov_x"]), float(spec["fov_y"])
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = zn / (math.tan(fx / 2) * zn)
    proj[1, 1] = zn / (math.tan(fy / 2) * zn)
    proj[3, 2] = 1.0
    proj[2, 2] = zf / (zf - zn)
    proj[2, 3] = -(zf * zn) / (zf - zn)
    full = w2v @ proj.T
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    w, h = int(spec["width"]), int(spec["height"])
    return {
        "world_view": f32(w2v), "full_proj": f32(full),
        "center": f32(np.linalg.inv(w2v)[3, :3]),
        "width": w, "height": h, "tan_x": math.tan(fx / 2), "tan_y": math.tan(fy / 2),
        "focal_x": w / (2 * math.tan(fx / 2)), "focal_y": h / (2 * math.tan(fy / 2)),
    }


# --- rasterizer ---------------------------------------------------------------------------


def sh_basis(deg: int, d: torch.Tensor) -> torch.Tensor:
    x, y, z = d.unbind(-1)
    out = [torch.full_like(x, SH_C0)]
    if deg > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
                SH_C2[4] * (xx - yy)]
    if deg > 2:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
                SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def project(means, cov, cam):
    """(depth, mean2d, conic (K, 3), radius); radius 0 where not drawn."""
    n = means.shape[0]
    hom = torch.cat([means, torch.ones((n, 1), dtype=means.dtype, device=means.device)], 1)
    pv = hom @ cam["world_view"]
    depth = pv[:, 2]
    ph = hom @ cam["full_proj"]
    pw = 1.0 / (ph[:, 3] + 1e-7)
    pp = ph[:, :3] * pw[:, None]
    w, h = cam["width"], cam["height"]
    mean2d = torch.stack([((pp[:, 0] + 1.0) * w - 1.0) * 0.5, ((pp[:, 1] + 1.0) * h - 1.0) * 0.5], 1)
    tz = torch.where(torch.abs(pv[:, 2]) < 1e-6, torch.full_like(depth, 1e-6), pv[:, 2])
    tx = torch.clamp(pv[:, 0] / tz, -1.3 * cam["tan_x"], 1.3 * cam["tan_x"]) * tz
    ty = torch.clamp(pv[:, 1] / tz, -1.3 * cam["tan_y"], 1.3 * cam["tan_y"]) * tz
    fx, fy = cam["focal_x"], cam["focal_y"]
    zero = torch.zeros_like(tz)
    jac = torch.stack([torch.stack([fx / tz, zero, -(fx * tx) / (tz * tz)], 1),
                       torch.stack([zero, fy / tz, -(fy * ty) / (tz * tz)], 1)], 1)  # (K, 2, 3)
    t = jac @ cam["world_view"][:3, :3].T  # J W
    cov2 = t @ cov @ t.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = det != 0.0
    det_inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], 1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    drawn = (depth > 0.2) & ok
    radius = torch.where(drawn, radius, torch.zeros_like(radius))
    return depth, mean2d, conic, radius


def tile_pairs(depth, mean2d, radius, width: int, height: int):
    """Each drawn Gaussian's (gaussian, tile) pairs, sorted by tile and,
    within a tile, by depth: (gid, tile) int64 and the tile counts."""
    tx, ty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    md, rad = mean2d.detach(), radius

    def tdiv(val, hi):
        return torch.clamp((val / TILE).to(torch.int32).to(torch.int64), 0, hi)

    x0, y0 = tdiv(md[:, 0] - rad, tx), tdiv(md[:, 1] - rad, ty)
    x1, y1 = tdiv(md[:, 0] + rad + TILE - 1, tx), tdiv(md[:, 1] + rad + TILE - 1, ty)
    drawn = rad > 0
    area = torch.where(drawn, (x1 - x0) * (y1 - y0), torch.zeros_like(x0))
    order = torch.argsort(torch.where(drawn, depth.detach(), torch.full_like(depth, float("inf"))),
                          stable=True)
    area_s = area[order]
    gid = torch.repeat_interleave(order, area_s)
    start = torch.cumsum(area_s, 0) - area_s
    k = torch.arange(gid.shape[0], device=gid.device) - torch.repeat_interleave(start, area_s)
    wdt = (x1 - x0)[gid]
    ky = torch.div(k, torch.clamp(wdt, min=1), rounding_mode="floor")
    tile = (y0[gid] + ky) * tx + x0[gid] + (k - ky * wdt)
    perm = torch.argsort(tile, stable=True)
    tile, gid = tile[perm], gid[perm]
    counts = torch.bincount(tile, minlength=tx * ty)
    return gid, tile, counts, tx, ty


class _CapAlpha(torch.autograd.Function):
    """min(a, 0.99) whose gradient passes as if uncapped (the CUDA
    rasterizer's backward ignores the cap)."""

    @staticmethod
    def forward(ctx, a):
        return torch.clamp(a, max=0.99)

    @staticmethod
    def backward(ctx, g):
        return g


def _composite_block(feats, pix, valid_slot):
    """Front-to-back over (B, K) depth-ordered slots of B tiles, for the
    tiles' 256 pixels: returns T (B, 256) and C (B, 3, 256)."""
    mx, my = feats[..., 0:1], feats[..., 1:2]
    ca, cb, cc = feats[..., 2:3], feats[..., 3:4], feats[..., 4:5]
    op, rgb = feats[..., 5:6], feats[..., 6:9]
    dx = mx - pix[:, None, 0, :]
    dy = my - pix[:, None, 1, :]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy  # (B, K, 256)
    # exp of a positive power is never used (power <= 0 below) and could overflow
    alpha = _CapAlpha.apply(op * torch.exp(torch.clamp(power, max=0.0)))
    valid = valid_slot[..., None] & (power <= 0.0) & (alpha >= 1.0 / 255.0)
    q = torch.where(valid, 1.0 - alpha, torch.ones_like(alpha))
    t_incl = torch.cumprod(q, 1)
    contrib = valid & (t_incl.detach() >= 1e-4)
    q = torch.where(contrib, q, torch.ones_like(q))
    t_incl = torch.cumprod(q, 1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    wgt = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
    color = torch.einsum("bkp,bkc->bcp", wgt, rgb)
    return t_incl[:, -1], color


def rasterize(means, cov, opacity, colors, cam, background, budget: int = 1 << 26):
    """(3, H, W) image; also the number of (gaussian, tile) pairs drawn."""
    depth, mean2d, conic, radius = project(means, cov, cam)
    w, h = cam["width"], cam["height"]
    gid, tile, counts, tx, ty = tile_pairs(depth, mean2d, radius, w, h)
    feats = torch.cat([mean2d, conic, opacity[:, None], colors], 1)
    n_tiles = tx * ty
    dev = means.device
    lane = torch.arange(TILE * TILE, device=dev)
    starts = torch.cumsum(counts, 0) - counts
    T_img = torch.ones((n_tiles, TILE * TILE), dtype=means.dtype, device=dev)
    C_img = torch.zeros((n_tiles, 3, TILE * TILE), dtype=means.dtype, device=dev)
    live = torch.nonzero(counts > 0).reshape(-1)
    live = live[torch.argsort(counts[live], descending=True, stable=True)]  # blocks of like depth
    cnt_host = counts[live].tolist()
    live_host = live.tolist()
    i = 0
    Ts, Cs, tiles_done = [], [], []
    while i < len(live_host):  # blocks of tiles padded to their longest list
        j, kmax = i, 0
        while j < len(live_host):
            k2 = max(kmax, cnt_host[j])
            if (j - i + 1) * k2 * TILE * TILE > budget and j > i:
                break
            kmax, j = k2, j + 1
        blk = live[i:j]
        slot = torch.arange(kmax, device=dev)
        valid_slot = slot[None, :] < counts[blk][:, None]
        pidx = torch.clamp(starts[blk][:, None] + slot[None, :], max=max(gid.shape[0] - 1, 0))
        f = feats[gid[pidx]]  # (B, K, 9)
        px = ((blk % tx) * TILE)[:, None] + (lane % TILE)[None, :]
        py = ((blk // tx) * TILE)[:, None] + (lane // TILE)[None, :]
        pix = torch.stack([px, py], 1).to(means.dtype)  # (B, 2, 256)
        t_blk, c_blk = _composite_block(f, pix, valid_slot)
        Ts.append(t_blk)
        Cs.append(c_blk)
        tiles_done.append(blk)
        i = j
    if tiles_done:
        done = torch.cat(tiles_done)
        T_img = T_img.index_put((done,), torch.cat(Ts))
        C_img = C_img.index_put((done,), torch.cat(Cs))
    img = C_img + T_img[:, None, :] * background[None, :, None]  # (tiles, 3, 256)
    img = img.reshape(ty, tx, 3, TILE, TILE).permute(2, 0, 3, 1, 4).reshape(3, ty * TILE, tx * TILE)
    return img[:, :h, :w], int(gid.shape[0])


def colors_for(scene: dict, means, cam) -> torch.Tensor:
    deg = scene["sh_degree"]
    d = means - cam["center"][None, :]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    k = (deg + 1) ** 2
    rgb = torch.einsum("nkc,nk->nc", scene["shs"][:, :k, :], sh_basis(deg, d))
    return torch.clamp(rgb + 0.5, min=0.0)


# --- the scene, the rollout and the trainer ----------------------------------------------


def build(raw: dict, cfg: dict) -> dict:
    """The reference's scene from the benchmark's raw inputs: every table
    the port derives is derived here again. Each object is bound to its
    own particles; its material section is its slice of them."""
    dev = raw["x0"].device
    sim = dict(cfg["sim"])
    clip = [torch.full((o["particles"],), float(o["clip_bound"]), device=dev) for o in raw["objects"]]
    sim.update(vol=raw["vol"], rho=raw["rho"], clip_bound=torch.cat(clip))
    g = raw["gaussians"]
    cov0 = covariance(g["scaling"], g["rotation"])
    size = torch.as_tensor(np.asarray(raw["size"], np.float32), device=dev)
    center = torch.as_tensor(np.asarray(raw["center"], np.float32), device=dev)
    de_x0 = (raw["x0"] - center) / size
    idx, w, sections, p0, g0 = [], [], [], 0, 0
    for o in raw["objects"]:
        p1, g1 = p0 + o["particles"], g0 + o["gaussians"]
        i, wt = binding_table(g["xyz"][g0:g1], cov0[g0:g1], de_x0[p0:p1])
        idx.append(i + p0)
        w.append(wt)
        sections.append({"span": (p0, p1), "alpha": o["alpha"]})
        p0, g0 = p1, g1
    return {
        "sim": sim, "size": size, "center": center, "cov0": cov0, "bind_idx": torch.cat(idx),
        "bind_w": torch.cat(w), "sections": sections,
        "xyz0": g["xyz"], "opacity": torch.sigmoid(g["opacity"]).reshape(-1),
        "shs": torch.cat([g["features_dc"], g["features_rest"]], 1), "sh_degree": int(cfg["sh_degree"]),
        "cams": [camera(c, dev) for c in raw["cameras"]],
        "background": torch.as_tensor(cfg["background"], dtype=torch.float32, device=dev),
    }


def materials(ref: dict, layers: list) -> list:
    """The material sections: ``layers`` holds each object's
    ``{"elasticity": ..., "plasticity": ...}`` MLP layers."""
    return [dict(sec, **lay) for sec, lay in zip(ref["sections"], layers)]


def bind(ref: dict, x, f, de_x_prev, g_prev):
    """Gaussian centres and deformed covariances for particles (x, F)."""
    de_x = (x - ref["center"]) / ref["size"]
    d = de_x - de_x_prev.detach()
    means = g_prev.detach() + torch.einsum("km,kmc->kc", ref["bind_w"], d[ref["bind_idx"]])
    fk = torch.einsum("km,kmc->kc", ref["bind_w"], f.detach().reshape(-1, 9)[ref["bind_idx"]])
    fk = fk.reshape(-1, 3, 3)
    cov = fk @ ref["cov0"] @ fk.transpose(1, 2)
    return de_x, means, (0.5 * (cov + cov.transpose(1, 2))).detach()


def render_views(ref: dict, means, cov):
    """Each view's image (views, 3, H, W) and pair count."""
    imgs, pairs = [], []
    for cam in ref["cams"]:
        img, p = rasterize(means, cov, ref["opacity"], colors_for(ref, means, cam), cam,
                           ref["background"])
        imgs.append(img)
        pairs.append(p)
    return torch.stack(imgs), pairs


def _render_ckpt(ref, means, cov):
    out = {}

    def fn(m):
        imgs, pairs = render_views(ref, m, cov)
        out["pairs"] = pairs
        return imgs

    imgs = torch.utils.checkpoint.checkpoint(fn, means, use_reentrant=False)
    return imgs, out["pairs"]


def rollout_loss(ref: dict, mats: dict, init_v, gt, weights, substeps: int, pixel_loss: str):
    """Sum over frames of weight * the views' summed mean pixel losses;
    the pair counts of every (frame, view) too."""
    x = ref["x0"]
    n = x.shape[0]
    state = (x, init_v.reshape(-1, 3).expand(n, 3).contiguous(),
             torch.zeros((n, 3, 3), dtype=x.dtype, device=x.device),
             torch.eye(3, dtype=x.dtype, device=x.device).expand(n, 3, 3).contiguous())
    de_prev, g_prev = (x - ref["center"]) / ref["size"], ref["xyz0"]
    total, pairs = 0.0, []
    for fr in range(gt.shape[0]):
        for _ in range(substeps):
            state = substep(ref["sim"], mats, state)
        de_x, means, cov = bind(ref, state[0], state[3], de_prev, g_prev)
        imgs, p = _render_ckpt(ref, means, cov)
        pairs.append(p)
        err = imgs - gt[fr]  # each view's mean pixel loss, summed over the views
        loss = err.shape[0] * (torch.mean(torch.abs(err)) if pixel_loss == "l1"
                               else torch.mean(err * err))
        total = total + weights[fr] * loss
        de_prev, g_prev = de_x.detach(), means.detach()
    return total, pairs


def decay_weights(cfg: dict, epoch: int, frames: int) -> torch.Tensor:
    lam = float(cfg.get("lambda_max_decay", 0.0))
    ratio = min((1.0 / lam) * epoch / int(cfg["num_epochs"]), 1.0) if lam > 0 else 1.0
    d0, d1 = float(cfg["decay_init"]), float(cfg["decay_final"])
    rate = torch.tensor(d0 + (d1 - d0) * ratio, dtype=torch.float32)
    exps = torch.as_tensor(np.arange(frames) // max(int(cfg.get("decay_steps", 80)), 1),
                           dtype=torch.float32)
    return torch.pow(rate, exps)


def cosine_lr(sched: dict, lr0: float, step: int) -> float:
    """The cosine schedule of the published configs, evaluated in float32."""
    max_steps = int(sched.get("max_steps", 1e5))
    alpha = float(sched.get("learning_rate_alpha", 0.05))
    if sched["type"] != "cos" or int(sched.get("warm_up_end", 0)):
        raise ValueError("the reference implements the configs' cosine schedule without warm-up")
    progress = torch.tensor(step, dtype=torch.float32) / max(max_steps, 1)
    factor = (torch.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha
    return float(lr0 * factor)


def radam_step(grads, params, mu, nu, t: int, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """One RAdam step (the unrectified momentum while rho_t < 5)."""
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = b2 ** t
    ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
    out = []
    for i, (g, p) in enumerate(zip(grads, params)):
        mu[i] = (1.0 - b1) * g + b1 * mu[i]
        nu[i] = (1.0 - b2) * g * g + b2 * nu[i]
        mu_hat = mu[i] / (1.0 - b1 ** t)
        if ro >= 5.0:
            r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            u = r * mu_hat / (torch.sqrt(nu[i] / (1.0 - b2t)) + eps)
        else:
            u = mu_hat
        out.append(p - lr * u)
    return out


def lora_leaves(mats: dict) -> Dict[str, torch.Tensor]:
    """The trained leaves by name: ``<material>.<layer>.<lora_a|lora_b>``."""
    out = {}
    for name in ("elasticity", "plasticity"):
        for i, layer in enumerate(mats[name]):
            for k in ("lora_a", "lora_b"):
                out[f"{name}.{i}.{k}"] = layer[k]
    return out


def train(raw: dict, cfg: dict, steps: int, tf32: bool = False) -> dict:
    """The first ``steps`` epochs of stage 2 from the raw inputs: each
    step's loss, the first step's clipped gradient and the leaves after
    the last step."""
    with precision(tf32):
        ref = build(raw, cfg)
        ref["x0"] = raw["x0"]
        tcfg = cfg["train"]
        base = {k: [dict(layer) for layer in raw["materials"][k]] for k in ("elasticity", "plasticity")}
        names = list(lora_leaves(base))
        values = [lora_leaves(base)[k].detach().clone() for k in names]
        mu = [torch.zeros_like(v) for v in values]
        nu = [torch.zeros_like(v) for v in values]
        gt = raw["gt"]
        losses, first_grads = [], None
        for epoch in range(1, steps + 1):
            leaves = [v.detach().requires_grad_(True) for v in values]
            mats = {k: [dict(layer) for layer in base[k]] for k in base}
            for name, leaf in zip(names, leaves):
                mat, layer, key = name.split(".")
                mats[mat][int(layer)][key] = leaf
            weights = decay_weights(tcfg, epoch, gt.shape[0]).to(gt.device)
            loss, _ = rollout_loss(ref, materials(ref, [mats]), raw["init_v"], gt, weights,
                                   int(cfg["sim"]["substeps"]), cfg["pixel_loss"])
            grads = list(torch.autograd.grad(loss, leaves))
            losses.append(float(loss.detach()))
            clipped = []
            for mat in ("elasticity", "plasticity"):
                sel = [i for i, nm in enumerate(names) if nm.startswith(mat)]
                norm = torch.sqrt(sum(torch.sum(grads[i] * grads[i]) for i in sel))
                scale = torch.clamp(float(tcfg[f"{mat}_grad_max_norm"]) / (norm + 1e-6), max=1.0)
                for i in sel:
                    grads[i] = grads[i] * scale
            if first_grads is None:
                first_grads = {nm: g.detach().clone() for nm, g in zip(names, grads)}
            lrs = [cosine_lr(tcfg[f"{nm.split('.')[0]}_scheduler"], float(tcfg[f"{nm.split('.')[0]}_lr"]),
                             epoch - 1) for nm in names]
            new = []
            for i, (g, p) in enumerate(zip(grads, values)):
                m, v_ = [mu[i]], [nu[i]]
                new.append(radam_step([g], [p], m, v_, epoch, lrs[i])[0])
                mu[i], nu[i] = m[0], v_[0]
            values = [p.detach() for p in new]
        return {"losses": losses, "first_grads": first_grads,
                "leaves0": {nm: v.detach().clone() for nm, v in lora_leaves(base).items()},
                "leaves": dict(zip(names, values))}


def frame_step(raw: dict, cfg: dict, pre: dict, tf32: bool = False, ref: Optional[dict] = None):
    """One served frame from the program's state before it: the sim step
    from ``pre`` (x, v, C, F) and every view rendered from the program's
    state after it (``post``, with the previous frame's references in
    ``pre``). Returns the stepped state and the images."""
    with precision(tf32), torch.no_grad():
        ref = ref or build(raw, cfg)
        mats = materials(ref, [o["materials"] for o in raw["objects"]])
        state = substep(ref["sim"], mats, (pre["x"], pre["v"], pre["C"], pre["F"]))
        post = pre["post"]
        _, means, cov = bind(ref, post["x"], post["F"], pre["de_x_prev"], pre["g_prev"])
        imgs, pairs = render_views(ref, means, cov)
        return {"x": state[0], "v": state[1], "C": state[2], "F": state[3]}, imgs, pairs


def serve_pairs(raw: dict, cfg: dict, start: dict, frames: int) -> List[List[int]]:
    """Pair counts of each view for ``frames`` served frames from the
    program's state ``start``."""
    with precision(False), torch.no_grad():
        ref = build(raw, cfg)
        mats = materials(ref, [o["materials"] for o in raw["objects"]])
        state = (start["x"], start["v"], start["C"], start["F"])
        de_prev, g_prev = start["de_x_prev"], start["g_prev"]
        out = []
        for _ in range(frames):
            state = substep(ref["sim"], mats, state)
            de_x, means, cov = bind(ref, state[0], state[3], de_prev, g_prev)
            out.append([tile_pairs(*_drawn(means, cov, cam))[0].shape[0] for cam in ref["cams"]])
            de_prev, g_prev = de_x, means
        return out


def _drawn(means, cov, cam):
    depth, mean2d, _, radius = project(means, cov, cam)
    return depth, mean2d, radius, cam["width"], cam["height"]


def train_pairs(raw: dict, cfg: dict, leaves: Dict[str, torch.Tensor]) -> List[List[int]]:
    """Pair counts of each (frame, view) of one training rollout with the
    LoRA leaves ``leaves``."""
    with precision(False), torch.no_grad():
        ref = build(raw, cfg)
        mats = {k: [dict(layer) for layer in raw["materials"][k]] for k in ("elasticity", "plasticity")}
        for name, leaf in leaves.items():
            mat, layer, key = name.split(".")
            mats[mat][int(layer)][key] = leaf
        mats = materials(ref, [mats])
        x = raw["x0"]
        n = x.shape[0]
        state = (x, raw["init_v"].reshape(-1, 3).expand(n, 3).contiguous(),
                 torch.zeros((n, 3, 3), device=x.device),
                 torch.eye(3, device=x.device).expand(n, 3, 3).contiguous())
        de_prev, g_prev = (x - ref["center"]) / ref["size"], ref["xyz0"]
        out = []
        for _ in range(raw["gt"].shape[0]):
            for _ in range(int(cfg["sim"]["substeps"])):
                state = substep(ref["sim"], mats, state)
            de_x, means, cov = bind(ref, state[0], state[3], de_prev, g_prev)
            out.append([tile_pairs(*_drawn(means, cov, cam))[0].shape[0] for cam in ref["cams"]])
            de_prev, g_prev = de_x, means
        return out
