"""Image-tile sharding (``RasterConfig.tile_sharding``) on the port's kernel
path, on the CPU: K4 and K5 over a range of a frame's tiles (their plain
versions with a tile base), the tile-sharded ``rasterize`` and its
gradients over gloo axes of 2 and 4 against one process, its image
against the JAX package's tile-sharded jnp render, and the grounding
rollout with tiles over a mesh axis against the port's one-process
rollout.

One 4-rank gloo world is spawned for the module (``parallel.dryrun.spawn``;
one torch thread per rank); its rank function builds a ``("tp",)`` mesh of
4 and a ``("dp", "vp")`` mesh of 2 x 2 and returns numpy through files.
The ranks import this module by name to find that function, so JAX is
imported only inside the test that runs the JAX package.

Bounds: the sharded render's image and gradients equal one process's bit
for bit (tiles composite independently and each gradient row is computed
by one rank); the image within atol 2e-5 of JAX's jnp render (the
port-vs-JAX image bound of ``tests/test_torch_backends.py``); the rollout
loss within rtol 1e-5 of one process and its LoRA and ``init_v``
gradients within a scaled 5e-4, the scale floored at 1e-8
(``tests/test_torch_parallel.py``'s halo and replicated-mode bounds:
each rank of a view's group adds half of the view's loss, the trainers'
sum adds the shares back, and the world's sum runs in another order than
one process's autograd; the LoRA leaves of this scene are ~1e-16).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from neuma_tpu_torch.parallel.distributed import Mesh
from neuma_tpu_torch.parallel.dryrun import spawn
from neuma_tpu_torch.parallel.sharding import tile_sharding
from neuma_tpu_torch.render import raster_kernel as rk
from neuma_tpu_torch.render.camera import Camera
from neuma_tpu_torch.render.gaussians import create_from_points
from neuma_tpu_torch.render.rasterize import RasterConfig, rasterize
from neuma_tpu_torch.train.grounding import make_rollout_loss, rank_views
from neuma_tpu_torch.utils import profiling
from test_torch_parallel import _hold_rollout, rollout_scene, rollout_value_and_grad
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


# --- inputs (numpy seeds; the same in every process) ---------------------------


def plain_frame(tiles_x=9, tiles_y=7, seed=3):
    """Pair rows of a 144x112 frame (63 tiles), tiles 16-31 without pairs,
    with seeded cotangents."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 200, tiles_x * tiles_y)
    counts[16:32] = 0
    aligned = (counts + rk.CHUNK - 1) // rk.CHUNK * rk.CHUNK
    start = np.concatenate([[0], np.cumsum(aligned)])
    pf = rng.random((int(start[-1]) + 2 * rk.CHUNK, 9)).astype(np.float32)
    pf[:, 0] *= 16 * tiles_x
    pf[:, 1] *= 16 * tiles_y
    pf[:, 2:5] = np.array([0.05, 0.01, 0.05], np.float32) * (0.5 + pf[:, 2:5])
    dT = rng.standard_normal((counts.size, rk.PIX)).astype(np.float32)
    dC = rng.standard_normal((counts.size, 3 * rk.PIX)).astype(np.float32)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)
    return torch.from_numpy(pf), i32(start), i32(counts), tiles_x, torch.from_numpy(dT), \
        torch.from_numpy(dC)


def render_scene(width=128, height=128, n=500, seed=3):
    """``tests/test_parallel.py``'s tile-sharding scene (500 SH-0 Gaussians
    in [0.4, 0.6]^3 seen from z = -1.6) at ``width`` x ``height``, and a
    seeded weight image for the gradient."""
    rng = np.random.default_rng(seed)
    pts = (0.4 + 0.2 * rng.random((n, 3))).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    w = np.random.default_rng(7).standard_normal((3, height, width)).astype(np.float32)
    return dict(pts=pts, colors=colors, w=w, width=width, height=height)


RENDER_CFG = dict(max_pairs=1 << 14)


def render_value_and_grad(sc, cfg):
    """The image and the gradients of sum(w * image) with respect to the
    means, covariances, opacity and SH, as numpy."""
    pack = create_from_points(sc["pts"], sc["colors"], sh_degree=0)
    cam = Camera.look_at(eye=np.array([0.5, 0.55, -1.6]), target=np.array([0.5, 0.5, 0.5]),
                         fov=0.8, width=sc["width"], height=sc["height"])
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        pack.xyz, pack.get_covariance(), pack.get_opacity, pack.get_features)]
    img = rasterize(leaves[0], leaves[1], leaves[2], cam, torch.zeros(3), shs=leaves[3],
                    sh_degree=0, cfg=cfg)
    grads = torch.autograd.grad((torch.from_numpy(sc["w"]) * img).sum(), leaves)
    return img.detach().numpy(), [g.numpy() for g in grads]


# (mesh, tile axis, width, height): 64 tiles over 4 and 2; 63 over 4 and 2
# (ranges 16, 16, 16, 15 and 32, 31); 9 over 4 (ranges 3, 3, 3 and none)
RENDER_CASES = [("tp", "tp", 128, 128), ("tp", "tp", 144, 112), ("tp", "tp", 48, 48),
                ("dpvp", "dp", 128, 128), ("dpvp", "dp", 144, 112), ("dpvp", "vp", 48, 48)]
ROLLOUT_CASES = ("replicated", "halo", "tiles_over_vp")


def tile_rollout_scene(mesh, case):
    """``rollout_scene`` (32x32 views: 4 tiles) on the 2 x 2 mesh: tiles
    over dp (the particle axis) and views over vp, as the JAX package's
    dry-run mesh runs it, in both grid modes; or tiles over vp with no
    view axis."""
    scene, gt = rollout_scene()
    tile_axis, view_axis = ("vp", None) if case == "tiles_over_vp" else ("dp", "vp")
    halo = case == "halo"
    return dataclasses.replace(
        scene, mesh=mesh, particle_axis="dp", view_axis=view_axis,
        grid_mode="halo" if halo else "replicated", halo_capacity=96 if halo else None,
        raster_cfg=dataclasses.replace(scene.raster_cfg,
                                       tile_sharding=tile_sharding(mesh, tile_axis))), gt


# --- what each rank runs --------------------------------------------------------


def rank_checks():
    meshes = {"tp": Mesh(("tp",), (4,)), "dpvp": Mesh(("dp", "vp"), (2, 2))}
    res = {"rank": dist.get_rank(), "render": {}, "stats": {}}
    for case in RENDER_CASES:
        name, axis, width, height = case
        cfg = RasterConfig(**RENDER_CFG, tile_sharding=tile_sharding(meshes[name], axis))
        profiling.reset_counters()
        res["render"][case] = render_value_and_grad(render_scene(width, height), cfg)
        res["stats"][case] = {"calls": profiling.counters["tile_gather.calls"]}
    mesh = meshes["dpvp"]
    res["rollout"], res["views"] = {}, {}
    for case in ROLLOUT_CASES:
        scene, gt = tile_rollout_scene(mesh, case)
        res["rollout"][case] = rollout_value_and_grad(scene, gt)
        res["views"][case] = rank_views(len(scene.cameras), mesh, scene.view_axis,
                                        scene.raster_cfg.tile_sharding.axis)
    res["rerun"] = rollout_value_and_grad(*tile_rollout_scene(mesh, "replicated"))
    return res


# --- the tests ------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn(rank_checks, 4, device="cpu", workdir=tmp_path_factory.mktemp("tiles"))


@pytest.mark.parametrize("t0,t1", [(0, 16), (16, 32), (20, 45), (48, 63), (63, 63)])
def test_plain_composite_over_a_tile_range_matches_the_whole_frame(t0, t1):
    """The plain K4 and K5 over tiles [t0, t1) of a 63-tile frame (with a
    tile base; 16-31 hold no pair; [63, 63) is empty) give the whole
    frame's T, C, ``last`` and pair rows of those tiles bit for bit, and
    zero rows outside the range's slots."""
    pf, start, counts, tiles_x, dT, dC = plain_frame()
    T, C, last = rk.composite_fwd(pf, start, counts, tiles_x)
    rows = rk.composite_bwd(pf, start, counts, T, last, dT, dC, tiles_x)
    assert (last >= 0).any() and (rows != 0).any()
    ts, cn = start[t0:t1 + 1], counts[t0:t1]
    Tr, Cr, lr = rk.composite_fwd(pf, ts, cn, tiles_x, t0)
    for a, b in ((Tr, T[t0:t1]), (Cr, C[t0:t1]), (lr, last[t0:t1])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    rr = rk.composite_bwd(pf, ts, cn, Tr, lr, dT[t0:t1], dC[t0:t1], tiles_x, t0)
    lo, hi = int(start[t0]), int(start[t1])
    np.testing.assert_array_equal(rr[lo:hi].numpy(), rows[lo:hi].numpy())
    assert not rr[:lo].any() and not rr[hi:].any()


def test_tile_range_splits_as_jax_partitions_the_tile_dimension():
    """k = ceil(T / size) contiguous tiles per coordinate; the last ones
    may own fewer or none."""
    assert [rk.tile_range(63, 4, c) for c in range(4)] == [
        (0, 16, 16), (16, 32, 16), (32, 48, 16), (48, 63, 16)]
    assert [rk.tile_range(9, 4, c)[:2] for c in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 9)]
    assert rk.tile_range(64, 1, 0) == (0, 64, 64)


@pytest.mark.parametrize("case", RENDER_CASES, ids=lambda c: f"{c[1]}{'4' if c[0] == 'tp' else '2'}"
                         f"-{c[2]}x{c[3]}")
def test_tile_sharded_render_is_one_process_bitwise(world, case):
    """Every rank's image and gradients of means, covariances, opacity
    and SH equal the one-process render's bit for bit; the forward and the
    backward each run one gather over the tile axis."""
    img, grads = render_value_and_grad(render_scene(*case[2:]), RasterConfig(**RENDER_CFG))
    for r in world:
        r_img, r_grads = r["render"][case]
        np.testing.assert_array_equal(r_img, img)
        for name, a, b in zip(("means3d", "cov3d", "opacity", "shs"), r_grads, grads):
            assert np.abs(b).max() > 0, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert r["stats"][case]["calls"] == 2


def test_tile_sharded_render_matches_jax(world):
    """The port's tile-sharded image (4 ranks) against the JAX package's
    tile-sharded jnp render on the conftest's 8-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from neuma_tpu.parallel.sharding import tile_sharding as jax_tile_sharding
    from neuma_tpu.render.camera import Camera as JaxCamera
    from neuma_tpu.render.gaussians import create_from_points as jax_points
    from neuma_tpu.render.rasterize import RasterConfig as JaxRasterConfig
    from neuma_tpu.render.rasterize import rasterize as jax_rasterize

    sc = render_scene()
    pack = jax_points(sc["pts"], sc["colors"], sh_degree=0)
    cam = JaxCamera.look_at(eye=np.array([0.5, 0.55, -1.6]), target=np.array([0.5, 0.5, 0.5]),
                            fov=0.8, width=128, height=128)
    mesh = JaxMesh(np.array(jax.devices()[:8]), ("tp",))
    cfg = JaxRasterConfig(max_pairs=1 << 14, backend="jnp",
                          tile_sharding=jax_tile_sharding(mesh, "tp"))
    with mesh:
        ref = jax.jit(lambda m: jax_rasterize(m, pack.get_covariance(), pack.get_opacity, cam,
                                              jnp.zeros(3), shs=pack.get_features, sh_degree=0,
                                              cfg=cfg))(jnp.asarray(sc["pts"]))
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(world[0]["render"][("tp", "tp", 128, 128)][0], ref, atol=2e-5)


@pytest.mark.parametrize("case", ROLLOUT_CASES)
def test_tile_sharded_rollout_matches_one_process(world, case):
    """The rollout over the 2 x 2 mesh with each view's tiles over an axis
    (dp with views over vp, in both grid modes; vp without a view axis)
    against the port's one-process rollout: loss within rtol 1e-5, every
    gradient leaf within a scaled 5e-4, every rank equal, no overflow; the
    two ranks along the tile axis render the same views, and every view is
    rendered by one such pair."""
    ref = rollout_value_and_grad(*rollout_scene())
    for r in world:
        _hold_rollout(r["rollout"][case], ref)
    for r in world[1:]:
        assert r["rollout"][case][0] == world[0]["rollout"][case][0]
        for a, b in zip(r["rollout"][case][1], world[0]["rollout"][case][1]):
            np.testing.assert_array_equal(a, b)
    views = [r["views"][case] for r in world]  # rank = 2 dp + vp
    pairs = [(0, 1), (2, 3)] if case == "tiles_over_vp" else [(0, 2), (1, 3)]
    assert sorted(v for a, _ in pairs for v in views[a]) == [0, 1]
    for a, b in pairs:
        assert views[a] == views[b]


def test_tile_sharded_rollout_reruns_bitwise(world):
    for r in world:
        a, b = r["rollout"]["replicated"], r["rerun"]
        assert a[0] == b[0]
        for x, y in zip(a[1], b[1]):
            np.testing.assert_array_equal(x, y)


def test_tile_axis_must_be_a_mesh_axis_and_not_the_view_axis():
    """The tile axis may not be the view axis (a view's tiles split over
    the ranks that render it), must be an axis of the scene's mesh, and
    needs a mesh."""
    mesh = Mesh(("dp", "vp"), (1, 1))
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        tile_sharding(mesh, "tp")
    scene, _ = rollout_scene()
    cfg = dataclasses.replace(scene.raster_cfg, tile_sharding=tile_sharding(mesh, "vp"))
    with pytest.raises(ValueError, match="is the view axis"):
        make_rollout_loss(dataclasses.replace(scene, mesh=mesh, view_axis="vp", raster_cfg=cfg),
                          device="cpu")
    with pytest.raises(ValueError, match="must split an axis of scene.mesh"):
        make_rollout_loss(dataclasses.replace(scene, raster_cfg=cfg), device="cpu")
    other = dataclasses.replace(scene, mesh=Mesh(("dp", "vp"), (1, 1)), raster_cfg=cfg)
    with pytest.raises(ValueError, match="must split an axis of scene.mesh"):
        make_rollout_loss(other, device="cpu")
