"""Port parity: camera, SH, covariances, projection, binding, the pair
layout, the tile-composite (K4) plain version and the rasterizer
(``neuma_tpu_torch`` against ``neuma_tpu`` on the CPU, same numpy inputs).

The JAX composite runs its Pallas kernel in interpret mode
(``_composite_fwd_impl(interpret=True)``, ``backend="pallas_interpret"``).
The TPU kernel resolves the front-to-back chain with chunked prefix
products, the port walks it pair by pair, so T and C agree to rounding
(atol 2e-5) and ``last`` agrees except where a pixel's freeze test sits
within rounding of 1e-4.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.ops import sh as jsh
from neuma_tpu.render import binding as jbind
from neuma_tpu.render import gaussians as jgs
from neuma_tpu.render import pallas_raster as jpr
from neuma_tpu.render.camera import Camera as JaxCamera
from neuma_tpu_torch import interop
from neuma_tpu_torch.ops import sh as tsh
from neuma_tpu_torch.render import binding as tbind
from neuma_tpu_torch.render import gaussians as tgs
from neuma_tpu_torch.render import raster_kernel as trk
from neuma_tpu_torch.render import rasterize as tras
from neuma_tpu_torch.render.camera import Camera
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# neuma_tpu.render re-exports a `rasterize` function under the submodule's name.
jras = importlib.import_module("neuma_tpu.render.rasterize")

SIZE = 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gaussians(rng, n=120, sh_degree=1):
    k = (sh_degree + 1) ** 2
    return jgs.GaussianPack(
        xyz=jnp.asarray(0.4 * rng.standard_normal((n, 3)).astype(np.float32)),
        features_dc=jnp.asarray(0.5 * rng.standard_normal((n, 1, 3)).astype(np.float32)),
        features_rest=jnp.asarray(0.2 * rng.standard_normal((n, k - 1, 3)).astype(np.float32)),
        scaling=jnp.asarray(np.log(0.04 + 0.05 * rng.random((n, 3))).astype(np.float32)),
        rotation=jnp.asarray(rng.standard_normal((n, 4)).astype(np.float32)),
        opacity=jnp.asarray(rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32)),
        sh_degree=sh_degree,
    )


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    g = _gaussians(rng)
    cam = JaxCamera.look_at(eye=np.array([0.3, 0.2, -3.0]), target=np.zeros(3), fov=0.9,
                            width=SIZE, height=SIZE)
    tg = interop.gaussians_from_numpy(_np(g))
    tcam = interop.camera_from_numpy(_np(cam))
    cov = g.get_covariance()
    proj = jras._project(g.xyz, cov, cam)
    return dict(g=g, cam=cam, tg=tg, tcam=tcam, cov=cov, proj=proj)


def test_camera_look_at_matches_jax():
    kw = dict(eye=np.array([0.5, 0.55, -1.1]), target=np.array([0.5, 0.5, 0.5]), fov=0.8,
              width=96, height=64)
    ref = JaxCamera.look_at(**kw)
    out = Camera.look_at(**kw)
    for name in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-5, err_msg=name)
    assert (out.focal_x, out.focal_y) == (ref.focal_x, ref.focal_y)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_basis_matches_jax(deg):
    d = np.random.default_rng(deg).standard_normal((50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(tsh.sh_basis(deg, torch.from_numpy(d)).numpy(),
                               np.asarray(jsh.sh_basis(deg, jnp.asarray(d))), atol=1e-5)


def test_sh_colors_matches_jax(scene):
    g, cam, tg, tcam = scene["g"], scene["cam"], scene["tg"], scene["tcam"]
    ref = jras._sh_colors(g.get_features, g.xyz, cam.camera_center, 1)
    out = tras._sh_colors(tg.get_features, tg.xyz, tcam.camera_center, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_covariance_matches_jax(scene):
    np.testing.assert_allclose(scene["tg"].get_covariance(0.9).numpy(),
                               np.asarray(scene["g"].get_covariance(0.9)), atol=1e-5)


def test_project_matches_jax(scene):
    depth, visible, mean2d, conic, radius = scene["proj"]
    out = tras._project(scene["tg"].xyz, torch.from_numpy(np.array(scene["cov"])), scene["tcam"])
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(visible))
    for name, a, r in zip(("depth", "mean2d", "conic", "radius"),
                          (out[0], out[2], out[3], out[4]), (depth, mean2d, conic, radius)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, err_msg=name)


def test_create_from_points_matches_jax():
    rng = np.random.default_rng(3)
    pts = (0.4 + 0.2 * rng.random((300, 3))).astype(np.float32)
    colors = rng.random((300, 3)).astype(np.float32)
    ref = _np(jgs.create_from_points(pts, colors, sh_degree=2))
    out = interop.to_numpy(tgs.create_from_points(pts, colors, sh_degree=2))
    for name in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_allclose(out[name], getattr(ref, name), atol=1e-5, err_msg=name)


def test_binding_table_matches_jax():
    rng = np.random.default_rng(4)
    pts = (0.4 + 0.2 * rng.random((400, 3))).astype(np.float32)
    g = jgs.create_from_points(pts, rng.random((400, 3)).astype(np.float32), sh_degree=0)
    ref = jbind.compute_binding_table(g, jnp.asarray(pts), max_particles=10, chunk=128)
    tg = interop.gaussians_from_numpy(_np(g))
    out = tbind.compute_binding_table(tg, torch.from_numpy(pts), max_particles=10, chunk=128)
    ri, rw = np.asarray(ref.indices), np.asarray(ref.weights)
    oi, ow = out.indices.numpy(), out.weights.numpy()
    # Rows whose Mahalanobis stat sits within float rounding of the chi2
    # threshold may keep a different count; count them and allow none here.
    borderline = int(np.sum(np.any(ow != rw, axis=1)))
    assert borderline == 0, f"{borderline} rows differ at the chi2 threshold"
    live = rw > 0
    np.testing.assert_array_equal(oi[live], ri[live])


def test_binding_apply_matches_jax():
    rng = np.random.default_rng(5)
    K, M, N = 50, 10, 300
    idx = rng.integers(0, N, (K, M)).astype(np.int32)
    w = rng.random((K, M)).astype(np.float32)
    table = jbind.BindingTable(indices=jnp.asarray(idx), weights=jnp.asarray(w))
    ttable = interop.binding_from_numpy(_np(table))
    p0, p1 = (rng.standard_normal((N, 3)).astype(np.float32) for _ in range(2))
    k0 = rng.standard_normal((K, 3)).astype(np.float32)
    F = (np.eye(3) + 0.1 * rng.standard_normal((N, 3, 3))).astype(np.float32)
    cov = np.asarray(jgs.build_covariance(jnp.exp(jnp.asarray(0.3 * rng.standard_normal((K, 3)).astype(np.float32))),
                                          jnp.asarray(rng.standard_normal((K, 4)).astype(np.float32))))
    T = lambda a: torch.from_numpy(np.array(a))
    np.testing.assert_allclose(
        tbind.apply_binding_xyz(ttable, T(p1), T(p0), T(k0)).numpy(),
        np.asarray(jbind.apply_binding_xyz(table, jnp.asarray(p1), jnp.asarray(p0), jnp.asarray(k0))),
        atol=1e-5)
    Fk = tbind.apply_binding_F(ttable, T(F))
    np.testing.assert_allclose(Fk.numpy(), np.asarray(jbind.apply_binding_F(table, jnp.asarray(F))), atol=1e-5)
    np.testing.assert_allclose(
        tbind.deform_cov_by_F(T(cov), Fk).numpy(),
        np.asarray(jbind.deform_cov_by_F(jnp.asarray(cov), jnp.asarray(Fk.numpy()))), atol=1e-5)


@pytest.fixture(scope="module")
def pairs(scene):
    depth, visible, mean2d, conic, radius = scene["proj"]
    cfg = jras.RasterConfig(max_pairs=4096, pair_binning="sort")
    ref = jras._build_aligned_pairs(depth, visible, mean2d, radius, SIZE, SIZE, cfg)
    T = lambda a: torch.from_numpy(np.asarray(a).copy())
    out = tras._build_aligned_pairs(T(depth), T(visible), T(mean2d), T(radius), SIZE, SIZE,
                                    tras.RasterConfig(max_pairs=4096))
    return ref, out


@pytest.mark.parametrize("binning", ["sort", "counting"])
def test_build_aligned_pairs_matches_jax(scene, pairs, binning):
    depth, visible, mean2d, _, radius = scene["proj"]
    cfg = jras.RasterConfig(max_pairs=4096, pair_binning=binning)
    r_gid, r_counts, r_start, r_tx, r_ty, r_ovf, _ = jras._build_aligned_pairs(
        depth, visible, mean2d, radius, SIZE, SIZE, cfg)
    o_gid, o_counts, o_start, o_tx, o_ty, o_ovf = pairs[1]
    assert (o_tx, o_ty) == (r_tx, r_ty) and bool(o_ovf) == bool(r_ovf)
    np.testing.assert_array_equal(o_counts.numpy(), np.asarray(r_counts))
    np.testing.assert_array_equal(o_start.numpy(), np.asarray(r_start))
    assert o_gid.shape == r_gid.shape
    r_gid = np.asarray(r_gid)
    for t in range(o_tx * o_ty):
        s, c = int(r_start[t]), int(r_counts[t])
        np.testing.assert_array_equal(o_gid.numpy()[s : s + c], r_gid[s : s + c], err_msg=f"tile {t}")
    assert int(r_counts.sum()) > 100  # the scene exercises many pairs


def test_composite_plain_matches_interpret(scene, pairs):
    g = scene["g"]
    depth, visible, mean2d, conic, radius = scene["proj"]
    r_gid, r_counts, r_start, r_tx, _, _, _ = pairs[0]
    colors = jras._sh_colors(g.get_features, g.xyz, scene["cam"].camera_center, 1)
    feats = jnp.concatenate([mean2d, conic, g.get_opacity.reshape(-1, 1), colors], axis=1)
    pf = feats[r_gid]
    T_r, C_r, last_r = jax.jit(
        lambda p, s, c: jpr._composite_fwd_impl(p, s, c, r_tx, True))(pf, r_start, r_counts)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    T, C, last = trk.composite_fwd(t(pf), t(r_start).to(torch.int32), t(r_counts).to(torch.int32), r_tx)
    np.testing.assert_allclose(T.numpy(), np.asarray(T_r), atol=2e-5)
    np.testing.assert_allclose(C.numpy(), np.asarray(C_r), atol=2e-5)
    mismatched = int(np.sum(last.numpy() != np.asarray(last_r)))
    assert mismatched == 0, f"{mismatched} pixels differ in `last`"
    assert (last.numpy() >= 0).sum() > 100


def test_padded_starts_matches_jax():
    start = np.array([0, 32, 32, 96, 128], np.int32)
    counts = np.array([5, 0, 40, 1], np.int32)
    ref = jpr._padded_starts(jnp.asarray(start), jnp.asarray(counts), 4)
    out = trk._padded_starts(torch.from_numpy(start), torch.from_numpy(counts), 4)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    assert out[2] == ref[2] == 8
    # Padded tiles composite as empty.
    pf = torch.rand((128 + 32 * 8, 9), generator=torch.Generator().manual_seed(0))
    T, C, last = trk.composite_fwd(pf, out[0], out[1], 2)
    assert (T[4:] == 1).all() and (C[4:] == 0).all() and (last[4:] == -1).all()


def test_rasterize_with_aux_matches_jax(scene):
    g, cam, tg, tcam = scene["g"], scene["cam"], scene["tg"], scene["tcam"]
    bg = np.array([0.2, 0.5, 1.0], np.float32)
    cfg = jras.RasterConfig(max_pairs=4096, backend="pallas_interpret")
    ref, aux = jax.jit(lambda m, c: jras.rasterize_with_aux(
        m, c, g.get_opacity, cam, jnp.asarray(bg), shs=g.get_features, sh_degree=1, cfg=cfg))(
        g.xyz, scene["cov"])
    img, taux = tras.rasterize_with_aux(
        tg.xyz, tg.get_covariance(), tg.get_opacity, tcam, torch.from_numpy(bg),
        shs=tg.get_features, sh_degree=1, cfg=tras.RasterConfig(max_pairs=4096))
    assert img.shape == (3, SIZE, SIZE)
    assert bool(taux["overflow"]) == bool(aux["overflow"])
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), atol=2e-5)


def test_raster_config_guards():
    with pytest.raises(ValueError, match="2\\^24"):
        tras.RasterConfig(max_pairs=1 << 24)
    with pytest.raises(ValueError, match="CHUNK"):
        z = torch.zeros(4)
        tras._build_aligned_pairs(z, z > 0, torch.zeros((4, 2)), z, 32, 32,
                                  tras.RasterConfig(max_pairs=100))
