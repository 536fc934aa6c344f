"""Port parity of the render backward, ``neuma_tpu_torch`` on the CPU
against ``neuma_tpu`` (same numpy inputs): the K5 plain version (tile
composite backward) against ``jax.vjp`` of ``composite_pairs_tpu`` in
interpret mode, in the smooth and the capped-alpha regime; the
pair-feature gather's transpose; and ``rasterize_with_aux``'s gradients
with respect to means3d, cov3d, opacity and the SH coefficients against
the JAX rasterizer's ``pallas_interpret`` backend.

The TPU kernel recovers the exclusive transmittance from chunked suffix
products, the port divides pair by pair (``T / (1 - alpha)``, with
``1 - alpha >= 0.01``), so the two round differently along each pixel's
chain; the tolerances below state what that costs.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.render import gaussians as jgs
from neuma_tpu.render import pallas_raster as jpr
from neuma_tpu.render.camera import Camera as JaxCamera
from neuma_tpu_torch import interop
from neuma_tpu_torch.render import raster_kernel as trk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Both packages' render re-export a `rasterize` function under the submodule's name.
jras = importlib.import_module("neuma_tpu.render.rasterize")
tras = importlib.import_module("neuma_tpu_torch.render.rasterize")

SIZE = 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def scaled_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _gaussians(rng, n=120, sh_degree=1, opacity=None):
    k = (sh_degree + 1) ** 2
    op = rng.uniform(-1.0, 3.0, (n, 1)) if opacity is None else np.full((n, 1), opacity)
    return jgs.GaussianPack(
        xyz=jnp.asarray(0.4 * rng.standard_normal((n, 3)).astype(np.float32)),
        features_dc=jnp.asarray(0.5 * rng.standard_normal((n, 1, 3)).astype(np.float32)),
        features_rest=jnp.asarray(0.2 * rng.standard_normal((n, k - 1, 3)).astype(np.float32)),
        scaling=jnp.asarray(np.log(0.04 + 0.05 * rng.random((n, 3))).astype(np.float32)),
        rotation=jnp.asarray(rng.standard_normal((n, 4)).astype(np.float32)),
        opacity=jnp.asarray(op.astype(np.float32)),
        sh_degree=sh_degree,
    )


def _camera():
    return JaxCamera.look_at(eye=np.array([0.3, 0.2, -3.0]), target=np.zeros(3), fov=0.9,
                             width=SIZE, height=SIZE)


def _pairs(g, cam):
    """JAX's pair layout and features for the composite."""
    cov = g.get_covariance()
    depth, visible, mean2d, conic, radius = jras._project(g.xyz, cov, cam)
    gid, counts, start, tx, _, _, _ = jras._build_aligned_pairs(
        depth, visible, mean2d, radius, SIZE, SIZE, jras.RasterConfig(max_pairs=4096))
    colors = jras._sh_colors(g.get_features, g.xyz, cam.camera_center, g.sh_degree)
    feats = jnp.concatenate([mean2d, conic, g.get_opacity.reshape(-1, 1), colors], axis=1)
    return feats[gid], start, counts, tx


@pytest.mark.parametrize("regime", ["smooth", "capped"])
def test_composite_bwd_plain_matches_interpret(regime):
    """K5's plain version on the port's forward T and ``last`` against the
    interpreted TPU backward on its own, on rows below tile_start[-1] (the
    TPU kernel leaves the rows past it unwritten). Scaled max error 1e-5
    per column (measured 4.7e-7): the exclusive T is a division chain here
    and a chunked suffix product there. In the capped regime (opacity 0.9995, so
    opacity * exp(power) > 0.99 near the centres) the chain ignores the
    cap on both sides, and the opacity gradient is live through it."""
    rng = np.random.default_rng(1 if regime == "smooth" else 2)
    g = _gaussians(rng, opacity=None if regime == "smooth" else 7.6)  # sigmoid(7.6) = 0.9995
    pf, start, counts, tx = _pairs(g, _camera())
    nt = counts.shape[0]
    dT = (0.3 * rng.standard_normal((nt, 256))).astype(np.float32)
    dC = (0.3 * rng.standard_normal((nt, 768))).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jpr.composite_pairs_tpu(p, start, counts, tx, True), pf)
    (ref,) = vjp((jnp.asarray(dT), jnp.asarray(dC)))
    end = int(start[-1])
    ref = np.asarray(ref)[:end]
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    args = (t(pf), t(start).to(torch.int32), t(counts).to(torch.int32))
    T, _, last = trk.composite_fwd(*args, tx)
    out = trk.composite_bwd(*args, T, last, t(dT), t(dC), tx).numpy()
    assert out.shape == (pf.shape[0], 9)
    assert (out[end:] == 0).all()
    if regime == "capped":
        assert float(jnp.max(pf[:, 5])) > 0.999 and np.abs(ref[:, 5]).max() > 0
    for j in range(9):
        assert np.abs(ref[:, j]).max() > 0, j
        assert scaled_err(out[:end, j], ref[:, j]) <= 1e-5, (j, scaled_err(out[:end, j], ref[:, j]))


def test_composite_pairs_backward_is_k5():
    """``composite_pairs`` returns K4's (T, C), and its backward is K5 on
    the saved T and ``last``."""
    rng = np.random.default_rng(3)
    pf, start, counts, tx = _pairs(_gaussians(rng), _camera())
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    args = (t(start).to(torch.int32), t(counts).to(torch.int32))
    pft = t(pf).requires_grad_(True)
    T, C = trk.composite_pairs(pft, *args, tx)
    dT, dC = torch.randn_like(T), torch.randn_like(C)
    (g,) = torch.autograd.grad((T, C), pft, (dT, dC))
    T0, C0, last = trk.composite_fwd(t(pf), *args, tx)
    np.testing.assert_array_equal(T.detach().numpy(), T0.numpy())
    np.testing.assert_array_equal(C.detach().numpy(), C0.numpy())
    np.testing.assert_array_equal(
        g.numpy(), trk.composite_bwd(t(pf), *args, T0, last, dT, dC, tx).numpy())


def test_pair_gather_transpose_sums_live_rows_only():
    """The segmented-sum transpose of ``feats[pair_gid]`` equals autograd's
    index backward over the live slots and ignores whatever the rows at or
    past tile_start[-1] hold."""
    rng = np.random.default_rng(4)
    g = _gaussians(rng)
    tg = interop.gaussians_from_numpy(_np(g))
    tcam = interop.camera_from_numpy(_np(_camera()))
    with torch.no_grad():
        depth, visible, mean2d, conic, radius = tras._project(tg.xyz, tg.get_covariance(), tcam)
    gid, counts, start, _, _, _, glue = tras._build_aligned_pairs(
        depth, visible, mean2d, radius, SIZE, SIZE, tras.RasterConfig(max_pairs=4096), with_glue=True)
    feats = torch.randn((tg.xyz.shape[0], 9), generator=torch.Generator().manual_seed(0))
    feats.requires_grad_(True)
    d_pf = torch.randn((gid.shape[0], 9), generator=torch.Generator().manual_seed(1))
    end = int(start[-1])
    slot = torch.arange(gid.shape[0])
    tile_of = torch.bucketize(slot, start[1:], right=True).clamp(max=counts.shape[0] - 1)
    live = (slot < end) & (slot - start[tile_of] < counts[tile_of])
    d_live = torch.where(live[:, None], d_pf, 0.0)
    garbage = torch.where(slot[:, None] >= end, 1e30, d_live)
    (out,) = torch.autograd.grad(tras._gather_pair_feats(feats, gid, glue), feats, garbage)
    (ref,) = torch.autograd.grad(feats[gid], feats, d_live)
    assert (ref != 0).any()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_rasterize_with_aux_gradients_match_jax():
    """d/d(means3d, cov3d, opacity, shs) of a weighted image sum against
    the JAX rasterizer (interpreted TPU kernels). Scaled max error 1e-5 per
    input (measured 1.4e-6): K5's division chain against the TPU's suffix
    products (the test above), carried through the projection's Jacobians."""
    rng = np.random.default_rng(5)
    g = _gaussians(rng)
    cam = _camera()
    bg = np.array([0.2, 0.5, 1.0], np.float32)
    w = rng.standard_normal((3, SIZE, SIZE)).astype(np.float32)
    cfg = jras.RasterConfig(max_pairs=4096, backend="pallas_interpret")

    def jloss(m, c, o, s):
        img, _ = jras.rasterize_with_aux(m, c, o, cam, jnp.asarray(bg), shs=s, sh_degree=1, cfg=cfg)
        return jnp.sum(jnp.asarray(w) * img)

    inputs = (g.xyz, g.get_covariance(), g.get_opacity, g.get_features)
    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(*inputs)
    tcam = interop.camera_from_numpy(_np(cam))
    leaves = [torch.from_numpy(np.asarray(a).copy()).requires_grad_(True) for a in inputs]
    img, _ = tras.rasterize_with_aux(leaves[0], leaves[1], leaves[2], tcam, torch.from_numpy(bg),
                                     shs=leaves[3], sh_degree=1, cfg=tras.RasterConfig(max_pairs=4096))
    grads = torch.autograd.grad((torch.from_numpy(w) * img).sum(), leaves)
    for name, a, r in zip(("means3d", "cov3d", "opacity", "shs"), grads, ref):
        assert np.abs(np.asarray(r)).max() > 0, name
        assert scaled_err(a.numpy(), r) <= 1e-5, (name, scaled_err(a.numpy(), r))
