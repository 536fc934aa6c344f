"""The port's jnp raster backend (``RasterConfig(backend="jnp")``: each
tile's depth list cut after ``max_per_tile`` pairs, composited by the
plain K4/K5 on the CPU) against the JAX package's jnp backend, and
``ops/bitonic.py`` against the JAX package's.

The same numpy inputs go through both packages: the image within 2e-5,
the gradients of a weighted sum of the image with respect to the means,
covariances, opacities and SH (or colours) within a scaled 1e-5 (max
error over the reference's largest value), ``overflow`` equal. Cases: a
cap above every tile's count, a cap that cuts five tiles, that cap under
a ``max_pairs`` that also cuts, a ``max_pairs`` that is not a multiple of
CHUNK, and the JAX package's own per-tile overflow case. Within the port:
the high cap is bitwise ``"auto"``, a Gaussian whose every pair is cut
gets exactly zero gradient, tile sharding over a mesh of one is bitwise
no sharding, the knobs ``segment``, ``scale_modifier``, ``pair_grad``
and ``pair_binning`` change no bit, and a cut raises
``PairBudgetOverflowError`` in a trainer's rollout.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.ops import bitonic as jbitonic
from neuma_tpu_torch import interop
from neuma_tpu_torch.ops import bitonic as tbitonic
from test_rasterize import make_scene
from test_torch_backends import (  # noqa: F401 (raster_scene: a fixture)
    SIZE, _check_raster, _np, _port_value_and_grad, raster_scene)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

jras = importlib.import_module("neuma_tpu.render.rasterize")
tras = importlib.import_module("neuma_tpu_torch.render.rasterize")

# ``raster_scene``'s 3 x 3 tiles hold 10, 24, 7, 28, 75, 25, 4, 17 and 4
# of its 194 pairs: a cap of 16 cuts five of them.
CUT = 16


def _check(sc, **kw):
    """The port's jnp backend against the JAX package's; returns overflow."""
    return _check_raster(sc, jras.RasterConfig(backend="jnp", **kw),
                         tras.RasterConfig(backend="jnp", **kw))


def _equal(a, b):
    """Two ``_port_value_and_grad`` results bitwise equal."""
    return a[1] == b[1] and all(np.array_equal(x, y) for x, y in zip([a[0]] + a[2],
                                                                    [b[0]] + b[2]))


def _layout(sc, cap=None):
    """The port's pair layout of the scene at ``max_pairs`` 4096, each
    tile cut at ``cap`` when it is given."""
    m, c = (torch.from_numpy(a.copy()) for a in sc["inputs"][:2])
    depth, visible, mean2d, _, radius = tras._project(m, c, sc["tcam"])
    return tras._build_aligned_pairs(depth, visible, mean2d, radius, SIZE, SIZE,
                                     tras.RasterConfig(max_pairs=4096), max_per_tile=cap)


@pytest.mark.parametrize("max_pairs,cap", [(4096, 1024), (4096, CUT), (128, CUT), (100, 1024)],
                         ids=["cap_above_every_tile", "cap_cuts", "cap_and_budget_cut",
                              "budget_not_a_chunk_multiple"])
def test_jnp_backend_matches_jax(raster_scene, max_pairs, cap):
    counts = _layout(raster_scene)[1]
    assert int(counts.sum()) == 194
    cut_tiles = int((counts > cap).sum())
    assert cut_tiles == (5 if cap == CUT else 0)
    ovf = _check(raster_scene, max_pairs=max_pairs, max_per_tile=cap)
    assert ovf == (cut_tiles > 0 or max_pairs < 194)


def test_per_tile_depth_overflow_signal_matches_jax():
    """The JAX package's ``test_per_tile_depth_overflow_signal`` scene
    (60 Gaussians, 64 x 64, precomputed colours, ``max_per_tile`` 2)."""
    m, c, o, colors, cam = make_scene(np.random.default_rng(0), n=60)
    w = np.random.default_rng(1).standard_normal((3, cam.height, cam.width)).astype(np.float32)
    sc = dict(cam=cam, tcam=interop.camera_from_numpy(_np(cam)), colors=True,
              bg=np.array([0.2, 0.5, 1.0], np.float32), w=w,
              inputs=tuple(np.asarray(a) for a in (m, c, o, colors)))
    assert _check(sc, max_pairs=65536, max_per_tile=2)


def test_jnp_with_a_high_cap_is_auto_bitwise(raster_scene):
    auto = _port_value_and_grad(raster_scene, tras.RasterConfig(max_pairs=4096))
    high = _port_value_and_grad(raster_scene, tras.RasterConfig(max_pairs=4096,
                                                                max_per_tile=1024, backend="jnp"))
    assert auto[1] is False and _equal(auto, high)


def test_fully_cut_gaussian_gets_exactly_zero_gradient(raster_scene):
    """A Gaussian with pairs, every one past its tile's cap, gets 0 in every
    leaf (it has a gradient when nothing is cut)."""
    def composited(out):
        pair_gid, counts, tile_start = out[:3]
        return {int(g) for t in range(counts.shape[0])
                for g in pair_gid[tile_start[t]:tile_start[t] + counts[t]]}

    cut = sorted(composited(_layout(raster_scene)) - composited(_layout(raster_scene, cap=CUT)))
    assert len(cut) >= 5
    full = _port_value_and_grad(raster_scene, tras.RasterConfig(max_pairs=4096))[2]
    grads = _port_value_and_grad(raster_scene, tras.RasterConfig(
        max_pairs=4096, max_per_tile=CUT, backend="jnp"))[2]
    assert any(g[cut].any() for g in full)
    for g in grads:
        assert not g[cut].any()


@pytest.fixture(scope="module")
def cut_default(raster_scene):
    return _port_value_and_grad(raster_scene, tras.RasterConfig(max_pairs=4096, max_per_tile=CUT,
                                                                backend="jnp"))


def test_tile_sharding_over_a_mesh_of_one_is_bitwise(raster_scene, cut_default):
    from neuma_tpu_torch.parallel.distributed import Mesh
    from neuma_tpu_torch.parallel.sharding import tile_sharding

    tiles = _port_value_and_grad(raster_scene, tras.RasterConfig(
        max_pairs=4096, max_per_tile=CUT, backend="jnp",
        tile_sharding=tile_sharding(Mesh(("dp",), (1,)))))
    assert tiles[1] is True and _equal(tiles, cut_default)


@pytest.mark.parametrize("knob,value", [
    ("segment", 1), ("segment", 8), ("segment", 32), ("segment", 4096),
    ("scale_modifier", 0.5), ("scale_modifier", 1.0), ("scale_modifier", 2.0),
    ("pair_grad", "scatter"), ("pair_grad", "segsum"),
    ("pair_binning", "auto"), ("pair_binning", "counting"), ("pair_binning", "sort"),
])
def test_knob_changes_no_bit(raster_scene, cut_default, knob, value):
    got = _port_value_and_grad(raster_scene, tras.RasterConfig(
        max_pairs=4096, max_per_tile=CUT, backend="jnp", **{knob: value}))
    assert _equal(got, cut_default)


def test_cut_raises_in_the_rollout():
    """A trainer's rollout raises on the jnp backend's cut, as the JAX
    package's trainer raises on the same flag; with a cap above every tile
    it runs."""
    from neuma_tpu_torch.train import grounding as tground
    from neuma_tpu_torch.train.schedulers import cosine_decay_schedule

    gt = np.full((2, 1, 3, 32, 32), 0.3, np.float32)

    def run(cap):
        scene = tground.build_scene(n_particles=300, grid=16, substeps=1, width=32, height=32,
                                    n_views=1, force_mask=False, max_pairs=1 << 12,
                                    max_per_tile=cap, layer_widths=(16, 16), lora_r=4,
                                    device="cpu")
        scene = dataclasses.replace(scene, raster_cfg=dataclasses.replace(scene.raster_cfg,
                                                                          backend="jnp"))
        return tground.optimize_init_velocity(scene, gt, 1, 0.01, cosine_decay_schedule(0.01, 1),
                                              device="cpu")

    assert np.isfinite(run(1 << 12).losses).all()
    with pytest.raises(tground.PairBudgetOverflowError,
                       match="velocity epoch 1: raise raster.max_pairs/max_per_tile"):
        run(2)


@pytest.mark.parametrize("n", [1 << 14, 1 << 15])
def test_bitonic_matches_jax(n):
    keys = np.random.default_rng(n).integers(0, 1 << 31, n, dtype=np.int64).astype(np.int32)
    keys[:64] = keys[64:128]  # repeated keys
    want_i32 = np.asarray(jax.jit(jbitonic.sort_i32)(jnp.asarray(keys)))
    want_u32 = np.asarray(jax.jit(jbitonic.sort_pairs_u32)(jnp.asarray(keys.astype(np.uint32))))
    got_i32 = tbitonic.sort_i32(torch.from_numpy(keys))
    got_u32 = tbitonic.sort_pairs_u32(torch.from_numpy(keys).to(torch.uint32))
    assert got_i32.dtype == torch.int32 and got_u32.dtype == torch.uint32
    assert want_i32.dtype == np.int32 and want_u32.dtype == np.uint32
    np.testing.assert_array_equal(got_i32.numpy(), want_i32)
    np.testing.assert_array_equal(got_u32.to(torch.int64).numpy(), want_u32.astype(np.int64))


def test_bitonic_lengths_match_jax():
    for n in (0, 1, 128, 1 << 13, 1 << 14, 3 << 13, 20000, 1 << 15, 1 << 18):
        assert tbitonic.sortable(n) == jbitonic.sortable(n), n
    for n in (1 << 13, 3 << 13, 20000):
        with pytest.raises(AssertionError) as want:
            jbitonic.sort_i32(jnp.zeros((n,), jnp.int32))
        with pytest.raises(ValueError) as got:
            tbitonic.sort_i32(torch.zeros((n,), dtype=torch.int32))
        assert str(got.value) == str(want.value)
