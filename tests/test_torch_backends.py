"""Port parity of the alternative ``p2g`` backends and of the
rasterizer's backend choice (``neuma_tpu_torch`` against ``neuma_tpu`` on
the CPU, the same numpy inputs):

* ``sim/mpm.py``'s ``p2g_scatter`` and ``p2g_matmul`` (with more
  particles than a chunk, and on a ``region`` slab view), values and
  gradients, a scaled 1e-5 (max error over the reference's largest
  value, per output);
* the rasterizer's kernel path against the JAX package's interpreted
  kernels: image and the gradients with respect to means, covariances,
  opacities and SH, with and without ``overflow``;
* ``RasterConfig.backend`` on CPU tensors, and ``RasterConfig``'s fields,
  defaults and validation messages against the JAX package's.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.core.types import MPMConstants, ParticleState, Statics
from neuma_tpu.render import gaussians as jgs
from neuma_tpu.render.camera import Camera as JaxCamera
from neuma_tpu.sim import mpm as jmpm
from neuma_tpu_torch import interop
from neuma_tpu_torch.core.types import ParticleState as TState
from neuma_tpu_torch.sim import mpm as tmpm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Both packages' render re-export a `rasterize` function under the submodule's name.
jras = importlib.import_module("neuma_tpu.render.rasterize")
tras = importlib.import_module("neuma_tpu_torch.render.rasterize")

TOL = 1e-5
SIZE = 48


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / (scale if scale > 0 else 1.0)


# ---------------------------------------------------------------- p2g


def _sim_scene(g, n, lo=0.25, hi=0.75, seed=0):
    rng = np.random.default_rng(seed)
    constants = MPMConstants(
        num_grids=g, bound=2, bc="noslip", dt=jnp.float32(8e-4),
        gravity=jnp.asarray([0.0, -9.8, 0.0], jnp.float32), eps=jnp.float32(6e-7),
    )
    en = np.ones((n,), np.int32)
    en[: n // 10] = 0
    statics = Statics(
        vol=jnp.full((n,), 2e-8, jnp.float32), rho=jnp.full((n,), 1000.0, jnp.float32),
        clip_bound=jnp.full((n,), 0.1, jnp.float32), enabled=jnp.asarray(en),
    )
    f32 = lambda a: a.astype(np.float32)
    x = 0.25 + 0.5 * rng.random((n, 3))
    x[:, 0] = lo + (hi - lo) * rng.random(n)
    state = ParticleState(
        x=jnp.asarray(f32(x)),
        v=jnp.asarray(f32(0.3 * rng.standard_normal((n, 3)))),
        C=jnp.asarray(f32(0.5 * rng.standard_normal((n, 3, 3)))),
        F=jnp.asarray(f32(np.eye(3)[None] + 0.02 * rng.standard_normal((n, 3, 3)))),
    )
    stress = jnp.asarray(f32(1e-3 * rng.standard_normal((n, 3, 3))))
    port = (interop.constants_from_numpy(_np(constants)), interop.statics_from_numpy(_np(statics)),
            interop.state_from_numpy(_np(state)), torch.from_numpy(np.array(stress)))
    return (constants, statics, state, stress), port, rng


def _check_p2g(jfn, tfn, scene, cells):
    (c, st, s, stress), (tc, tst, ts, tstress), rng = scene
    du = rng.standard_normal(cells).astype(np.float32)
    df = rng.standard_normal((cells, 3)).astype(np.float32)

    def both(x, v, C, sr):
        outs, vjp = jax.vjp(lambda *a: jfn(c, st, ParticleState(a[0], a[1], a[2], s.F), a[3]),
                            x, v, C, sr)
        return outs, vjp((jnp.asarray(du), jnp.asarray(df)))

    outs, jgrads = jax.jit(both)(s.x, s.v, s.C, stress)
    tin = [t.clone().requires_grad_(True) for t in (ts.x, ts.v, ts.C, tstress)]
    touts = tfn(tc, tst, TState(tin[0], tin[1], tin[2], ts.F), tin[3])
    loss = (touts[0] * torch.from_numpy(du)).sum() + (touts[1] * torch.from_numpy(df)).sum()
    tgrads = torch.autograd.grad(loss, tin)
    for name, got, want in zip(("grid_m", "grid_mv", "dx", "dv", "dC", "dstress"),
                               list(touts) + list(tgrads), list(outs) + list(jgrads)):
        assert np.abs(np.asarray(want)).max() > 0, name
        assert _err(got, want) <= TOL, (name, _err(got, want))


@pytest.mark.parametrize("g", [16, 32])
def test_p2g_scatter_matches_jax(g):
    _check_p2g(jmpm.p2g_scatter, tmpm.p2g_scatter, _sim_scene(g, 900), g ** 3)


def test_p2g_matmul_chunked_matches_jax():
    """1,000 particles in chunks of 256 (the last one short)."""
    g = 16
    _check_p2g(lambda *a: jmpm.p2g_matmul(*a, chunk=256),
               lambda *a: tmpm.p2g_matmul(*a, chunk=256), _sim_scene(g, 1000), g ** 3)


def test_p2g_matmul_region_matches_jax():
    """The slab view: x lines [3, 10) of a 16-cell grid, which cover every
    tap of particles with x in [0.3, 0.45]."""
    g, region = 16, ((3, 7), (0, 16), (0, 16))
    _check_p2g(lambda *a: jmpm.p2g_matmul(*a, chunk=512, region=region),
               lambda *a: tmpm.p2g_matmul(*a, chunk=512, region=region),
               _sim_scene(g, 600, lo=0.3, hi=0.45), 7 * 16 * 16)


def test_p2g_methods_repeat_bitwise():
    (_, (tc, tst, ts, tstress), _) = _sim_scene(32, 800)
    for method in ("scatter", "matmul"):
        a = tmpm.p2g(tc, tst, ts, tstress, method=method)
        b = tmpm.p2g(tc, tst, ts, tstress, method=method)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), method


# ------------------------------------------------------------ rasterizer


def _gaussians(rng, n=90, sh_degree=1):
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
def raster_scene():
    rng = np.random.default_rng(0)
    g = _gaussians(rng)
    cam = JaxCamera.look_at(eye=np.array([0.3, 0.2, -3.0]), target=np.zeros(3), fov=0.9,
                            width=SIZE, height=SIZE)
    bg = np.array([0.2, 0.5, 1.0], np.float32)
    w = rng.standard_normal((3, SIZE, SIZE)).astype(np.float32)
    inputs = tuple(np.asarray(a) for a in (g.xyz, g.get_covariance(), g.get_opacity,
                                           g.get_features))
    return dict(cam=cam, tcam=interop.camera_from_numpy(_np(cam)), bg=bg, w=w, inputs=inputs)


def _colour_kw(sc, last):
    """The last input as SH (degree 1), or as precomputed colours where the
    scene says ``colors``."""
    return dict(colors_precomp=last) if sc.get("colors") else dict(shs=last, sh_degree=1)


def _jax_value_and_grad(sc, cfg):
    def loss(m, c, o, s):
        img, aux = jras.rasterize_with_aux(m, c, o, sc["cam"], jnp.asarray(sc["bg"]), cfg=cfg,
                                           **_colour_kw(sc, s))
        return jnp.sum(jnp.asarray(sc["w"]) * img), (img, aux["overflow"])

    (_, (img, ovf)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                        has_aux=True))(*sc["inputs"])
    return np.asarray(img), bool(ovf), [np.asarray(a) for a in grads]


def _port_value_and_grad(sc, cfg):
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in sc["inputs"]]
    img, aux = tras.rasterize_with_aux(leaves[0], leaves[1], leaves[2], sc["tcam"],
                                       torch.from_numpy(sc["bg"]), cfg=cfg,
                                       **_colour_kw(sc, leaves[3]))
    grads = torch.autograd.grad((torch.from_numpy(sc["w"]) * img).sum(), leaves)
    return img.detach().numpy(), bool(aux["overflow"]), [a.numpy() for a in grads]


def _check_raster(sc, jcfg, tcfg, img_atol=2e-5):
    ref_img, ref_ovf, ref_grads = _jax_value_and_grad(sc, jcfg)
    img, ovf, grads = _port_value_and_grad(sc, tcfg)
    assert ovf == ref_ovf
    np.testing.assert_allclose(img, ref_img, atol=img_atol)
    for name, a, r in zip(("means3d", "cov3d", "opacity", "shs"), grads, ref_grads):
        assert np.abs(r).max() > 0, name
        assert _err(a, r) <= TOL, (name, _err(a, r))
    return ovf


@pytest.mark.parametrize("max_pairs", [4096, 128])
def test_kernel_path_matches_jax(raster_scene, max_pairs):
    """The kernel path (plain K4/K5 on the CPU) against the JAX package's
    interpreted kernels: image, gradients and ``overflow``. The scene
    needs 194 pairs, so 128 drops the same pairs on both sides."""
    kw = dict(max_pairs=max_pairs, backend="pallas_interpret")
    ovf = _check_raster(raster_scene, jras.RasterConfig(**kw), tras.RasterConfig(**kw))
    assert ovf == (max_pairs < 194)


def test_backend_choice_on_the_cpu(raster_scene):
    """'auto' and 'pallas_interpret' give the same bits on CPU tensors (the
    plain versions); 'pallas' asks for the kernels and raises."""
    sc = raster_scene
    args = [torch.from_numpy(a.copy()) for a in sc["inputs"]]
    run = lambda cfg: tras.rasterize(args[0], args[1], args[2], sc["tcam"],
                                     torch.from_numpy(sc["bg"]), shs=args[3], sh_degree=1,
                                     cfg=cfg)
    with torch.no_grad():
        assert torch.equal(run(tras.RasterConfig(max_pairs=4096)),
                           run(tras.RasterConfig(max_pairs=4096, backend="pallas_interpret")))
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            run(tras.RasterConfig(max_pairs=4096, backend="pallas"))


def test_raster_config_validation_matches_jax():
    """The port's ``RasterConfig`` has the JAX package's fields, in its
    order and with its defaults; every bad ``backend``, ``pair_binning``
    and ``pair_grad`` fails with its message; ``"jnp"`` and every value of
    ``segment``, ``scale_modifier``, ``pair_grad`` and ``pair_binning``
    that it accepts are accepted. ``tile_sharding`` takes the port's
    ``parallel.sharding.tile_sharding``."""
    from neuma_tpu_torch.parallel.distributed import Mesh
    from neuma_tpu_torch.parallel.sharding import TileSharding, tile_sharding

    names = [f.name for f in dataclasses.fields(tras.RasterConfig)]
    assert names == [f.name for f in dataclasses.fields(jras.RasterConfig)]
    assert names == ["max_pairs", "max_per_tile", "segment", "scale_modifier", "backend",
                     "pair_grad", "pair_binning", "tile_sharding"]
    for name in names:
        assert getattr(tras.RasterConfig(), name) == getattr(jras.RasterConfig(), name), name
    mesh = Mesh(("dp",), (1,))
    cfg = tras.RasterConfig(tile_sharding=tile_sharding(mesh))
    assert cfg.tile_sharding == TileSharding(mesh, "dp")
    for field, bad in (("backend", "cuda"), ("backend", "JNP"), ("backend", ""),
                       ("pair_binning", "radix"), ("pair_binning", "Sort"),
                       ("pair_grad", "atomic"), ("pair_grad", "segment")):
        with pytest.raises(ValueError) as want:
            jras.RasterConfig(**{field: bad})
        with pytest.raises(ValueError) as got:
            tras.RasterConfig(**{field: bad})
        assert str(got.value) == str(want.value), (field, bad)
    for field, good in (("backend", "jnp"), ("segment", 16), ("scale_modifier", 0.5),
                        ("pair_grad", "segsum"), ("pair_grad", "scatter"),
                        ("pair_binning", "sort"), ("pair_binning", "counting"),
                        ("pair_binning", "auto")):
        assert getattr(tras.RasterConfig(**{field: good}), field) == good
        assert getattr(jras.RasterConfig(**{field: good}), field) == good
