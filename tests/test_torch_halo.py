"""Port parity of the halo-exchange pieces against the JAX package on the
CPU, on the same numpy inputs: ``partition_particles`` / ``unpartition``,
the block layouts in a ``GridGeom`` view, the blocked scatter (K1 and the
fold) and the tap gathers (the unfold, K2 and K3) in slab views of a
32^3 grid cut 4 ways, ``grid_op`` in a view, the halo step of 2 and 4
gloo ranks against ``make_halo_mpm_step`` on a 4-device JAX mesh (the
conftest's virtual CPU devices), and the particle-sharded step of 4 gloo
ranks, forward and vjp, against ``jax.vjp`` of
``neuma_tpu.parallel.sharding.make_sharded_sim_step`` on that mesh.

The JAX kernels run in interpret mode with the package's
``NEUMA_KERNEL_PREC=highest`` knob (``p2g_kernel._PREC_MODE``), so both
sides contract in full FP32: kernel-level bounds are a scaled 1e-5. The
halo step and the sharded step: atol 2e-5, rtol 1e-4 (JAX
``tests/test_halo.py``'s); the sharded step's cotangents a scaled 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from neuma_tpu.core.types import GridGeom as JaxGeom
from neuma_tpu.core.types import MPMConstants as JaxConstants
from neuma_tpu.core.types import ParticleState as JaxState
from neuma_tpu.core.types import Statics as JaxStatics
from neuma_tpu.parallel import halo as jhalo
from neuma_tpu.parallel import sharding as jsharding
from neuma_tpu.sim import mpm as jmpm
from neuma_tpu.sim import p2g_kernel as jpk
from neuma_tpu_torch.core.types import GridGeom
from neuma_tpu_torch.parallel import halo as thalo
from neuma_tpu_torch.parallel.dryrun import spawn
from neuma_tpu_torch.sim import mpm as tmpm
from neuma_tpu_torch.sim import p2g_kernel as tpk
from test_torch_parallel import (
    SHARDED_GRIDS,
    halo_step_rank,
    scene_arrays,
    sharded_step_rank,
    step_cotangents,
    torch_scene,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

G, SHARDS = 32, 4


def jax_scene(a, bc="noslip"):
    n = a["x"].shape[0]
    constants = JaxConstants(num_grids=a["g"], bound=1, bc=bc, dt=jnp.float32(1e-3),
                             gravity=jnp.asarray([0, -9.8, 0], jnp.float32), eps=jnp.float32(6e-7))
    statics = JaxStatics(vol=jnp.full((n,), 2e-6, jnp.float32),
                         rho=jnp.full((n,), 1000.0, jnp.float32),
                         clip_bound=jnp.full((n,), 0.1, jnp.float32),
                         enabled=jnp.ones((n,), jnp.int32))
    state = JaxState(*(jnp.asarray(a[k]) for k in ("x", "v", "C", "F")))
    return constants, statics, state, jnp.asarray(a["stress"])


def views(tol):
    """Each shard's slab view of the 32^3 grid cut 4 ways (width 8)."""
    w = thalo.slab_width(G, SHARDS)
    lo = thalo.HALO + tol
    dims = (w + 2 * lo, G, G)
    return [(JaxGeom(dims=dims, origin=jnp.asarray([s * w - lo, 0, 0], jnp.int32)),
             GridGeom(dims=dims, origin=torch.tensor([s * w - lo, 0, 0])), s) for s in range(SHARDS)]


def scaled_close(a, r, atol=1e-5, name=""):
    a, r = np.asarray(a), np.asarray(r)
    scale = max(np.abs(r).max(), 1e-8)
    np.testing.assert_allclose(a / scale, r / scale, rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def binned():
    """The scene (JAX and port) and its shard bins, width 8."""
    a = scene_arrays(n=768, g=G)
    jc, jst, js, jstress = jax_scene(a)
    tc, tst, ts, tstress = torch_scene(a)
    jp = jhalo.partition_particles(jc, js, jst, SHARDS, 768)
    tp = thalo.partition_particles(tc, ts, tst, SHARDS, 768)
    return (jc, jst, js, jstress, jp), (tc, tst, ts, tstress, tp)


def test_partition_matches_jax_and_roundtrips(binned):
    (jc, jst, js, _, jp), (tc, tst, ts, _, tp) = binned
    np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(jp.perm))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert bool(tp.overflow) == bool(jp.overflow) is False
    for k in ("x", "v", "C", "F"):
        np.testing.assert_array_equal(getattr(tp.state, k).numpy(), np.asarray(getattr(jp.state, k)))
    np.testing.assert_array_equal(tp.statics.enabled.numpy(), np.asarray(jp.statics.enabled))
    back = thalo.unpartition(tp, 768, ts)
    for k in ("x", "v", "C", "F"):
        assert torch.equal(getattr(back, k), getattr(ts, k))
    # order: by owner, ties by index
    owner = thalo.owner_of(tc, ts.x, thalo.slab_width(G, SHARDS), SHARDS).numpy()
    live = tp.perm.numpy()[tp.valid.numpy()]
    assert np.array_equal(live, np.lexsort((np.arange(768), owner)))
    tiny_j = jhalo.partition_particles(jc, js, jst, SHARDS, 100)
    tiny_t = thalo.partition_particles(tc, ts, tst, SHARDS, 100)
    assert bool(tiny_t.overflow) and bool(tiny_j.overflow)
    np.testing.assert_array_equal(tiny_t.perm.numpy(), np.asarray(tiny_j.perm))
    # dropped particles keep their template state
    back = thalo.unpartition(tiny_t, 768, ts)
    assert torch.equal(back.x, ts.x)


def _view_particles(binned, s, own):
    """A shard's own bin, or every particle (most taps outside the view)."""
    (_, _, js, _, jp), (_, _, ts, _, tp) = binned
    return (jp.state.x[s], tp.state.x[s]) if own else (js.x, ts.x)


@pytest.mark.parametrize("own", [True, False], ids=["own-bin", "all-particles"])
@pytest.mark.parametrize("tol", [0, 2])
def test_view_layouts_match_jax(binned, tol, own):
    jc, tc = binned[0][0], binned[1][0]
    for jg, tg, s in views(tol):
        jx, tx = _view_particles(binned, s, own)
        ref, out = jpk.block_sort(jc, jx, geom=jg), tpk.block_sort(tc, tx, geom=tg)
        for name in ("perm", "inv_perm", "bstart", "counts", "bid", "base", "loc"):
            np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                          err_msg=f"{name} (shard {s}, tol {tol})")
        np.testing.assert_array_equal(out.fx.numpy(), np.asarray(ref.fx))
        if not own:
            assert (out.loc.numpy() == -1).any(), "taps outside the view get line -1"
        jl, _, _, _ = jpk.build_chunk_layout(jc, jx, chunk=tpk.CHUNK, sort=ref, geom=jg)
        tl, _, _, _ = tpk.build_chunk_layout(tc, tx, tpk.CHUNK, out, tg)
        for name in ("src", "valid", "c2b", "dest"):
            np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)))


@pytest.fixture
def full_fp32_kernels(monkeypatch):
    monkeypatch.setattr(jpk, "_PREC_MODE", "highest")


def _channels(n, seed):
    rng = np.random.default_rng(seed)
    gm = (1e-3 * rng.random(n)).astype(np.float32)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    A = (3.0 * rng.standard_normal((n, 3, 3))).astype(np.float32)
    return gm, b, A


@pytest.mark.parametrize("own", [True, False], ids=["own-bin", "all-particles"])
def test_view_scatter_and_gathers_match_interpret(binned, full_fp32_kernels, own):
    """K1 + fold (``p2g_blocked``) and the unfold + K2 / K3
    (``apic_gather``) per view (tol 2), against ``p2g_blocked_pallas`` and
    ``apic_gather_tpu`` interpreted, with the same view; with every
    particle in every view, taps outside it add and read nothing. The
    two edge views (origin -4, and past the grid) for the own bins, an
    inner one for every particle (the interpreter is slow)."""
    jc, tc = binned[0][0], binned[1][0]
    for jg, tg, s in views(2):
        if s not in ((0, SHARDS - 1) if own else (1,)):
            continue
        jx, tx = _view_particles(binned, s, own)
        n = tx.shape[0]
        gm, b, A = _channels(n, s)
        jm, jf = jpk.p2g_blocked_pallas(jc, jx, jnp.asarray(gm), jnp.asarray(b), jnp.asarray(A),
                                        interpret=True, geom=jg)
        tm, tf = tpk.p2g_blocked(tc, tx, torch.from_numpy(gm), torch.from_numpy(b),
                                 torch.from_numpy(A), geom=tg)
        scaled_close(tm, jm, name=f"grid_m (shard {s})")
        scaled_close(tf, jf, name=f"grid_f (shard {s})")
        cells = tg.num_cells
        rng = np.random.default_rng(10 + s)
        df = rng.standard_normal((cells, 3)).astype(np.float32)
        du = rng.standard_normal(cells).astype(np.float32)
        for derivs in (False, True):
            ref = jpk.apic_gather_tpu(jc, jx, jnp.asarray(gm), jnp.asarray(b), jnp.asarray(A),
                                      jnp.asarray(df), jnp.asarray(du), derivs=derivs,
                                      interpret=True, geom=jg)
            out = tpk.apic_gather(tc, tx, torch.from_numpy(gm), torch.from_numpy(b),
                                  torch.from_numpy(A), torch.from_numpy(df), torch.from_numpy(du),
                                  derivs=derivs, geom=tg)
            for name, o, r in zip(("dx", "dgm", "db", "dA"), out, ref):
                if name == "dx" and not derivs:
                    continue
                scaled_close(o, r, name=f"{name} (shard {s}, derivs {derivs})")


@pytest.mark.parametrize("bc", ["noslip", "freeslip"])
def test_grid_op_in_a_view_matches_jax(bc):
    a = scene_arrays(g=G)
    jc, tc = jax_scene(a, bc)[0], torch_scene(a, bc)[0]
    rng = np.random.default_rng(4)
    for jg, tg, s in views(0):
        m = np.where(rng.random(tg.num_cells) < 0.5, rng.random(tg.num_cells), 0.0).astype(np.float32)
        mv = rng.standard_normal((tg.num_cells, 3)).astype(np.float32)
        ref = jmpm.grid_op(jc, jnp.asarray(m), jnp.asarray(mv), jg)
        out = tmpm.grid_op(tc, torch.from_numpy(m), torch.from_numpy(mv), tg)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref), err_msg=f"shard {s}")


HALO_CASE = (scene_arrays(n=512, g=32), "noslip")


@pytest.fixture(scope="module")
def jax_halo_step():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs the conftest's virtual CPU devices")
    a, bc = HALO_CASE
    c, statics, state, stress = jax_scene(a, bc)
    mesh = JaxMesh(np.array(devs[:4]), ("dp",))
    new, ovf = jax.jit(jhalo.make_halo_mpm_step(c, statics, mesh))(state, stress)
    return {k: np.asarray(getattr(new, k)) for k in ("x", "v", "C", "F")}, bool(ovf)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_step_matches_jax(jax_halo_step, tmp_path, world):
    ref, ref_ovf = jax_halo_step
    outs = spawn(halo_step_rank, world, args=([HALO_CASE],), device="cpu", workdir=tmp_path)
    assert not ref_ovf
    for (out, ovf), in outs:
        assert not ovf
        for k in ref:
            np.testing.assert_allclose(out[k], ref[k], atol=2e-5, rtol=1e-4,
                                       err_msg=f"{k} ({world} ranks)")


@pytest.fixture(scope="module")
def jax_sharded_steps():
    """``jax.vjp`` of the JAX package's sharded step on a 4-device mesh,
    per grid of ``SHARDED_GRIDS``: the new state and the cotangents of
    (x, v, C, F, stress) for ``step_cotangents``."""
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs the conftest's virtual CPU devices")
    mesh = JaxMesh(np.array(devs[:4]), ("dp",))
    out = {}
    for g in SHARDED_GRIDS:
        c, statics, state, stress = jax_scene(scene_arrays(n=512, g=g))
        step = jsharding.make_sharded_sim_step(c, mesh)
        cts = JaxState(*(jnp.asarray(t) for t in step_cotangents(512)))

        def value_and_vjp(s, sr, ct):
            new, pull = jax.vjp(lambda a, b: step(statics, a, b), s, sr)
            return new, pull(ct)

        new, (d_s, d_stress) = jax.jit(value_and_vjp)(state, stress, cts)
        out[g] = ([np.asarray(getattr(new, k)) for k in ("x", "v", "C", "F")],
                  [np.asarray(t) for t in (d_s.x, d_s.v, d_s.C, d_s.F, d_stress)])
    return out


def test_sharded_step_matches_jax(jax_sharded_steps, tmp_path):
    """Four gloo ranks' ``make_sharded_sim_step`` (the dense grid at 16,
    K1-K3's slab chain at 32), forward and vjp, gathered over the ranks
    (measured: values within 1.2e-5, cotangents a scaled 1.3e-6)."""
    ranks = spawn(sharded_step_rank, 4, args=([scene_arrays(n=512, g=g) for g in SHARDED_GRIDS],),
                  device="cpu", workdir=tmp_path)
    for (new, grads), g in ((out, g) for r in ranks for out, g in zip(r, SHARDED_GRIDS)):
        ref_new, ref_grads = jax_sharded_steps[g]
        for k, a, b in zip("xvCF", new, ref_new):
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4, err_msg=f"{k} (g={g})")
        for k, a, b in zip(("x", "v", "C", "F", "stress"), grads, ref_grads):
            assert np.abs(b).max() > 0
            scaled_close(a, b, atol=1e-4, name=f"d {k} (g={g})")


def test_cube_view_equals_full_cube():
    """``geom=GridGeom.cube(G)`` (K1's per-block sums folded onto the view,
    the view unfolded for K2 / K3) gives the full-cube path's results
    (the slab chain), forward and backward, at G 32."""
    from neuma_tpu_torch.sim.blocked import apic_scatter

    a = scene_arrays(n=512, g=G)
    tc, tst, ts, tstress = torch_scene(a)
    cube = GridGeom.cube(G)
    assert cube.dims == (G, G, G) and cube.num_cells == G ** 3
    mass, b, affine = tmpm._p2g_terms(tc, tst, ts, tstress)
    outs = []
    for geom in (None, cube):
        x = ts.x.clone().requires_grad_(True)
        grid_m, grid_f = apic_scatter(tc, x, mass, b, affine, geom=geom)
        new_v, new_C = tmpm.g2p_core(tc, x, tmpm.grid_op(tc, grid_m, grid_f, geom), geom=geom)
        loss = (new_v ** 2).sum() + new_C.sum() + (grid_m * grid_f[:, 0]).sum()
        outs.append([t.detach() for t in (grid_m, grid_f, new_v, new_C)]
                    + list(torch.autograd.grad(loss, [x])))
    for name, u, c in zip(("grid_m", "grid_f", "new_v", "new_C", "dx"), *outs):
        scaled_close(c, u, name=name)
