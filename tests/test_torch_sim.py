"""Port parity: block layouts, payload, halo add, the P2G (K1) and G2P
(K2) plain versions, and the slab MPM step (``neuma_tpu_torch`` against
``neuma_tpu`` on the CPU, same numpy inputs).

The JAX side runs its Pallas kernels in interpret mode
(``interpret=True`` / ``NEUMA_SLAB_GRID=interpret``); that mode runs the
TPU kernels' bf16 "high3" splits, so kernel-level parity is held at the
scaled 3e-5 bound of ``tests/test_slab_grid.py``. Against JAX's dense
full-FP32 path (``NEUMA_SLAB_GRID=off``) the bound is 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.core.types import MPMConstants, ParticleState, Statics
from neuma_tpu.sim import mpm as jmpm
from neuma_tpu.sim import p2g_kernel as jpk
from neuma_tpu_torch import interop
from neuma_tpu_torch.sim import mpm as tmpm
from neuma_tpu_torch.sim import p2g_kernel as tpk


def _scene(n=1500, g=32, bc="noslip", seed=0):
    rng = np.random.default_rng(seed)
    constants = MPMConstants(
        num_grids=g, bound=2, bc=bc, dt=jnp.float32(8e-4),
        gravity=jnp.asarray([0.0, -9.8, 0.0], jnp.float32), eps=jnp.float32(6e-7),
    )
    statics = Statics(
        vol=jnp.full((n,), 2e-8, jnp.float32), rho=jnp.full((n,), 1000.0, jnp.float32),
        clip_bound=jnp.full((n,), 0.1, jnp.float32), enabled=jnp.ones((n,), jnp.int32),
    )
    x = (0.25 + 0.5 * rng.random((n, 3))).astype(np.float32)
    v = (0.3 * rng.standard_normal((n, 3))).astype(np.float32)
    C = (0.5 * rng.standard_normal((n, 3, 3))).astype(np.float32)
    F = (np.eye(3, dtype=np.float32)[None]
         + 0.02 * rng.standard_normal((n, 3, 3)).astype(np.float32))
    stress = (1e-3 * rng.standard_normal((n, 3, 3))).astype(np.float32)
    state = ParticleState(x=jnp.asarray(x), v=jnp.asarray(v), C=jnp.asarray(C), F=jnp.asarray(F))
    return constants, statics, state, jnp.asarray(stress)


def _to_torch(constants, statics, state, stress):
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return (
        interop.constants_from_numpy(np_(constants)),
        interop.statics_from_numpy(np_(statics)),
        interop.state_from_numpy(np_(state)),
        torch.from_numpy(np.asarray(stress).copy()),
    )


def _scaled_close(a, r, atol, name=""):
    a, r = np.asarray(a), np.asarray(r)
    scale = max(np.abs(r).max(), 1e-8)
    np.testing.assert_allclose(a / scale, r / scale, rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def scene():
    jax_side = _scene()
    return jax_side, _to_torch(*jax_side)


@pytest.fixture(scope="module")
def payload_inputs(scene):
    (c, st, s, stress), (tc, tst, ts, tstress) = scene
    jl = jpk.build_step_layouts(c, s.x)
    tl = tpk.build_step_layouts(tc, ts.x)
    jm, jb, ja = jmpm._p2g_terms(c, st, s, stress)
    tm, tb, ta = tmpm._p2g_terms(tc, tst, ts, tstress)
    jpay = jpk.pack_payload(c, jl.scatter, jl.sort.fx, jl.sort.loc, jm, jb, ja)
    tpay = tpk.pack_payload(tc, tl.scatter, tl.sort.fx, tl.sort.loc, tm, tb, ta)
    return jl, tl, jpay, tpay


def test_block_sort_matches_jax(scene):
    (c, _, s, _), (tc, _, ts, _) = scene
    ref = jpk.block_sort(c, s.x)
    out = tpk.block_sort(tc, ts.x)
    for name in ref._fields:
        np.testing.assert_array_equal(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )


def test_chunk_layout_matches_jax(payload_inputs):
    jl, tl, _, _ = payload_inputs
    for name in jl.scatter._fields:
        np.testing.assert_array_equal(
            getattr(tl.scatter, name).numpy(), np.asarray(getattr(jl.scatter, name)),
            err_msg=name,
        )


@pytest.mark.parametrize("shift,reused", [(1e-6, True), (0.05, False)])
def test_refresh_step_layouts_matches_jax(scene, shift, reused):
    (c, _, s, _), (tc, _, ts, _) = scene
    x1 = np.asarray(s.x) + np.float32(shift)
    ref, ref_reused = jpk.refresh_step_layouts(c, jnp.asarray(x1), jpk.build_step_layouts(c, s.x))
    out, out_reused = tpk.refresh_step_layouts(
        tc, torch.from_numpy(x1), tpk.build_step_layouts(tc, ts.x)
    )
    assert bool(ref_reused) == out_reused == reused
    for part in ("sort", "scatter", "gather"):
        r, o = getattr(ref, part), getattr(out, part)
        for name in r._fields:
            np.testing.assert_array_equal(
                getattr(o, name).numpy(), np.asarray(getattr(r, name)), err_msg=f"{part}.{name}"
            )


def test_pack_payload_matches_jax(payload_inputs):
    _, _, jpay, tpay = payload_inputs
    np.testing.assert_allclose(tpay.numpy(), np.asarray(jpay), rtol=0, atol=1e-6)


@pytest.mark.parametrize("g", [32, 70])
def test_halo_add_slabs_exact(g):
    nb = -(-g // jpk.BLOCK)
    pb = np.random.default_rng(g).standard_normal((nb ** 3, 4, 16, 256)).astype(np.float32)
    ref = np.asarray(jpk.halo_add_slabs(jnp.asarray(pb), (nb, nb, nb)))
    out = tpk.halo_add_slabs(torch.from_numpy(pb), (nb, nb, nb)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_p2g_plain_matches_interpret(payload_inputs):
    jl, tl, jpay, tpay = payload_inputs
    M = jl.scatter.c2b.shape[0]
    NB = 27
    partials = jax.jit(lambda p: jpk.run_p2g_fwd(p, M, interpret=True))(jpay)
    ref = jnp.zeros((NB, 4, 16, 256), jnp.float32).at[jl.scatter.c2b].add(partials)
    out = tpk.run_p2g_fwd(tpay, tl.scatter.c2b, NB)  # CPU tensors: plain version
    _scaled_close(out.numpy(), ref, 3e-5)


@pytest.mark.parametrize("clip", [False, True])
def test_g2p_plain_matches_interpret(payload_inputs, clip):
    """With ``clip`` some rows carry tap lines outside 0..15 (-1, 16),
    which read zero in both."""
    jl, tl, jpay, tpay = payload_inputs
    if clip:
        pay = np.asarray(jpay).copy()
        for k, (col, line) in enumerate([(tpk._L0, -1.0), (tpk._L0 + 5, 16.0), (tpk._L0 + 7, -1.0)]):
            pay[k::5, col] = line
        jpay, tpay = jnp.asarray(pay), torch.from_numpy(pay)
    M = jl.gather.c2b.shape[0]
    slabs = np.random.default_rng(2).standard_normal((27, 4, 16, 16, 16)).astype(np.float32)
    ref = jax.jit(
        lambda p, sl: jpk.run_apic_gather(p, sl, jl.gather.c2b, M, 32.0, False, interpret=True)
    )(jpay, jnp.asarray(slabs))
    out = tpk.run_apic_gather(tpay, torch.from_numpy(slabs), tl.gather.c2b, 32.0)
    _scaled_close(out.numpy(), ref, 3e-5)


@pytest.fixture(scope="module")
def step_refs():
    """JAX mpm_step per boundary condition: interpreted slab kernels and
    the dense FP32 path."""
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        for bc in ("noslip", "freeslip"):
            c, st, s, stress = _scene(bc=bc)
            step = lambda s_, sr_: jmpm.mpm_step(c, st, s_, sr_)
            mp.setenv("NEUMA_SLAB_GRID", "interpret")
            slab = jax.jit(step)(s, stress)
            mp.setenv("NEUMA_SLAB_GRID", "off")
            dense = jax.jit(step)(s, stress)
            refs[bc] = (slab, dense)
    return refs


@pytest.mark.parametrize("bc", ["noslip", "freeslip"])
def test_mpm_step_matches_jax(step_refs, bc):
    slab, dense = step_refs[bc]
    tc, tst, ts, tstress = _to_torch(*_scene(bc=bc))
    out = tmpm.mpm_step(tc, tst, ts, tstress)
    for name in ("x", "v", "C", "F"):
        a = getattr(out, name).numpy()
        _scaled_close(a, getattr(slab, name), 3e-5, f"{name} vs interpret slab")
        _scaled_close(a, getattr(dense, name), 1e-5, f"{name} vs dense f32")


def test_packed_substep_applies_both_materials(scene):
    (_, _, _, _), (tc, tst, ts, tstress) = scene
    calls = []

    def elasticity(F):
        calls.append("e")
        return torch.zeros_like(F)

    def plasticity(F):
        calls.append("p")
        return 2.0 * F

    sub = tmpm.make_packed_substep(tc, tst, elasticity, plasticity)
    out = sub(ts, tpk.build_step_layouts(tc, ts.x))
    ref = tmpm.mpm_step(tc, tst, ts, torch.zeros_like(tstress))
    assert calls == ["e", "p"]
    np.testing.assert_array_equal(out.F.numpy(), 2.0 * ref.F.numpy())
    np.testing.assert_array_equal(out.x.numpy(), ref.x.numpy())
