"""Port parity of the dense-grid MPM step (``num_grids <= 24``):
``neuma_tpu_torch`` on the CPU against ``neuma_tpu``'s dense path, which
the JAX package takes on every backend at these grid sizes (same numpy
inputs).

The scene is a 20^3 grid with 400 particles, 80 of them within a cell
of a wall so that their taps clamp onto the edge lines and the boundary
condition acts. Every comparison is a scaled max error of 1e-5 (the
error over the reference's largest value), the bound of
``test_torch_sim.py::test_mpm_step_matches_jax`` against the dense f32
path: both sides run full float32, the port's scatter adds each cell's
taps as a pairwise tree where the JAX CPU scatter adds them in index
order, and the einsums contract in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.core.types import MPMConstants, ParticleState, Statics
from neuma_tpu.materials.meta import (
    InvariantFullMetaElasticity as JaxElasticity,
    InvariantFullMetaPlasticity as JaxPlasticity,
    MetaMaterialConfig as JaxMaterialConfig,
)
from neuma_tpu.nn import mlp as jmlp
from neuma_tpu.sim import blocked as jblocked
from neuma_tpu.sim import mpm as jmpm
from neuma_tpu_torch import interop
from neuma_tpu_torch.materials.meta import (
    InvariantFullMetaElasticity,
    InvariantFullMetaPlasticity,
    MetaMaterialConfig,
)
from neuma_tpu_torch.sim import blocked as tblocked
from neuma_tpu_torch.sim import mpm as tmpm
from neuma_tpu_torch.sim import p2g_kernel as tpk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

G, N, TOL = 20, 400, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def scaled_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _scene(bc="noslip", seed=0):
    """(JAX side, port side) of one step's inputs."""
    rng = np.random.default_rng(seed)
    x = 0.25 + 0.5 * rng.random((N, 3))
    walls = rng.integers(0, 3, 80)  # an axis per wall particle
    near = (0.1 + 0.9 * rng.random(80)) / G  # within a cell of the wall, inside the clip
    x[np.arange(80), walls] = np.where(rng.random(80) < 0.5, near, 1.0 - near)
    constants = MPMConstants(
        num_grids=G, bound=2, bc=bc, dt=jnp.float32(8e-4),
        gravity=jnp.asarray([0.0, -9.8, 0.0], jnp.float32), eps=jnp.float32(6e-7),
    )
    statics = Statics(
        vol=jnp.full((N,), 2e-8, jnp.float32), rho=jnp.full((N,), 1000.0, jnp.float32),
        clip_bound=jnp.full((N,), 0.1, jnp.float32), enabled=jnp.ones((N,), jnp.int32),
    )
    f32 = lambda a: np.asarray(a, np.float32)
    state = ParticleState(
        x=jnp.asarray(f32(x)), v=jnp.asarray(f32(0.3 * rng.standard_normal((N, 3)))),
        C=jnp.asarray(f32(0.5 * rng.standard_normal((N, 3, 3)))),
        F=jnp.asarray(f32(np.eye(3)[None] + 0.02 * rng.standard_normal((N, 3, 3)))),
    )
    stress = f32(1e-3 * rng.standard_normal((N, 3, 3)))
    torch_side = (interop.constants_from_numpy(_np(constants)), interop.statics_from_numpy(_np(statics)),
                  interop.state_from_numpy(_np(state)), torch.from_numpy(stress))
    return (constants, statics, state, jnp.asarray(stress)), torch_side


@pytest.fixture(scope="module")
def scene():
    return _scene()


def test_tap_geometry_matches_jax(scene):
    (c, _, s, _), (tc, _, ts, _) = scene
    ref = jblocked._tap_geometry(c, s.x)
    out = tblocked._tap_geometry(tc, ts.x)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    clamped = (np.asarray(ref[0]) % G == 0) | (np.asarray(ref[0]) % G == G - 1)
    assert clamped.any()  # wall particles' taps sit on the edge lines
    for a, r in zip(out[1:], ref[1:]):
        assert scaled_err(a.numpy(), r) <= TOL


def _grid_cotangents(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(G ** 3).astype(np.float32),
            rng.standard_normal((G ** 3, 3)).astype(np.float32))


@pytest.mark.parametrize("with_mass", [True, False])
def test_dense_forward_matches_jax(scene, with_mass):
    (c, st, s, stress), (tc, tst, ts, tstress) = scene
    jm, jb, ja = jmpm._p2g_terms(c, st, s, stress)
    tm, tb, ta = tmpm._p2g_terms(tc, tst, ts, tstress)
    ref = jblocked._dense_forward(c, s.x, jm if with_mass else None, jb, ja)
    out = tblocked._dense_forward(tc, ts.x, tm if with_mass else None, tb, ta)
    assert scaled_err(out[1].numpy(), ref[1]) <= TOL
    if with_mass:
        assert scaled_err(out[0].numpy(), ref[0]) <= TOL
    else:
        assert out[0] is None and ref[0] is None


def test_ordered_scatter_is_the_indexed_sum():
    """Runs of 1 to 300 rows (the tree's odd tails included) against a
    float64 ``index_add_``, to float32 rounding."""
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(np.repeat(rng.permutation(50), rng.integers(1, 300, 50)))
    idx = idx[torch.from_numpy(rng.permutation(idx.numel()))]
    vals = torch.from_numpy(rng.standard_normal((idx.numel(), 4)).astype(np.float32))
    out = tblocked._ordered_scatter(idx, vals, 60)
    ref = torch.zeros((60, 4), dtype=torch.float64).index_add_(0, idx, vals.double())
    assert (out[50:] == 0).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=2e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("role", ["p2g_adjoint", "g2p_position_adjoint"])
def test_apic_bwd_matches_jax(scene, role):
    """The two tap-space adjoints of the step backward: the forward (mass,
    b, affine) against a grid cotangent (du, df), and (d new_v, kappa d
    new_C) against a grid velocity."""
    (c, st, s, stress), (tc, tst, ts, tstress) = scene
    du, df = _grid_cotangents(4)
    if role == "p2g_adjoint":
        jargs = (*jmpm._p2g_terms(c, st, s, stress), jnp.asarray(du), jnp.asarray(df))
        targs = (*tmpm._p2g_terms(tc, tst, ts, tstress), torch.from_numpy(du), torch.from_numpy(df))
    else:
        rng = np.random.default_rng(5)
        b2 = rng.standard_normal((N, 3)).astype(np.float32)
        A2 = (40.0 * rng.standard_normal((N, 3, 3))).astype(np.float32)
        jargs = (None, jnp.asarray(b2), jnp.asarray(A2), None, jnp.asarray(df))
        targs = (None, torch.from_numpy(b2), torch.from_numpy(A2), None, torch.from_numpy(df))
    ref = jblocked._apic_bwd_jnp(c, s.x, *jargs)
    out = tblocked._apic_bwd_jnp(tc, ts.x, *targs)
    for a, r in zip(out, ref):
        if r is None:
            assert a is None
            continue
        assert np.abs(np.asarray(r)).max() > 0
        assert scaled_err(a.numpy(), r) <= TOL


@pytest.mark.parametrize("bc", ["noslip", "freeslip"])
def test_grid_op_matches_jax(bc):
    """Random momenta of both signs on a grid with empty cells, so that
    the walls' boundary test zeroes some velocities."""
    (c, _, _, _), (tc, _, _, _) = _scene(bc=bc)
    rng = np.random.default_rng(6)
    m = np.where(rng.random(G ** 3) < 0.3, 0.0, rng.random(G ** 3)).astype(np.float32)
    mv = rng.standard_normal((G ** 3, 3)).astype(np.float32)
    ref = np.asarray(jmpm.grid_op(c, jnp.asarray(m), jnp.asarray(mv)))
    out = tmpm.grid_op(tc, torch.from_numpy(m), torch.from_numpy(mv)).numpy()
    assert (ref == 0).any()
    np.testing.assert_array_equal(out == 0, ref == 0)
    assert scaled_err(out, ref) <= TOL


@pytest.mark.parametrize("bc", ["noslip", "freeslip"])
def test_mpm_step_matches_jax(bc):
    (c, st, s, stress), (tc, tst, ts, tstress) = _scene(bc=bc)
    ref = jmpm.mpm_step(c, st, s, stress)
    out = tmpm.mpm_step(tc, tst, ts, tstress)
    for name in ("x", "v", "C", "F"):
        assert scaled_err(getattr(out, name).numpy(), getattr(ref, name)) <= TOL, name


def _cotangents(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in ((N, 3), (N, 3), (N, 3, 3), (N, 3, 3))]


@pytest.fixture(scope="module")
def step_vjps(scene):
    (c, st, s, stress), (tc, tst, ts, tstress) = scene
    g_np = _cotangents(13)
    _, vjp = jax.vjp(lambda a, b: jmpm.mpm_step_diff(c, st, a, b), s, stress)
    d_s, d_stress = vjp(ParticleState(*(jnp.asarray(a) for a in g_np)))
    leaves = [t.clone().requires_grad_(True) for t in (ts.x, ts.v, ts.C, ts.F, tstress)]
    out = tmpm.mpm_step_diff(tc, tst, tmpm.ParticleState(*leaves[:4]), leaves[4])
    grads = torch.autograd.grad([out.x, out.v, out.C, out.F], leaves,
                                [torch.from_numpy(a) for a in g_np])
    return [g.numpy() for g in grads], [np.asarray(r) for r in (d_s.x, d_s.v, d_s.C, d_s.F, d_stress)]


@pytest.mark.parametrize("leaf", ["x", "v", "C", "F", "stress"])
def test_mpm_step_diff_vjp_matches_jax(step_vjps, leaf):
    """The direct piece adjoint (tail vjp, the dense scatter as the
    gather's transpose, the grid_op vjp, both tap-space adjoints, the
    _p2g_terms vjp, the scrub) for every state leaf and the stress."""
    out, ref = step_vjps
    k = ["x", "v", "C", "F", "stress"].index(leaf)
    assert np.abs(ref[k]).max() > 0
    assert scaled_err(out[k], ref[k]) <= TOL, scaled_err(out[k], ref[k])


def test_g2p_core_vjp_matches_jax(scene):
    """The dense ``g2p_core`` Function against JAX's custom VJP: the
    position cotangent and the grid cotangent (the dense scatter)."""
    (c, _, s, _), (tc, _, ts, _) = scene
    rng = np.random.default_rng(8)
    grid_v = rng.standard_normal((G ** 3, 3)).astype(np.float32)
    dv, dC = rng.standard_normal((N, 3)).astype(np.float32), rng.standard_normal((N, 3, 3)).astype(np.float32)
    outs, vjp = jax.vjp(lambda x, gv: jmpm.g2p_core(c, x, gv), s.x, jnp.asarray(grid_v))
    ref = vjp((jnp.asarray(dv), jnp.asarray(dC)))
    x = ts.x.clone().requires_grad_(True)
    gv = torch.from_numpy(grid_v).requires_grad_(True)
    new_v, new_C = tmpm.g2p_core(tc, x, gv)
    for a, r in zip((new_v, new_C), outs):
        assert scaled_err(a.detach().numpy(), r) <= TOL
    grads = torch.autograd.grad([new_v, new_C], [x, gv], [torch.from_numpy(dv), torch.from_numpy(dC)])
    for a, r in zip(grads, ref):
        assert scaled_err(a.numpy(), r) <= TOL


def _with_lora(params, seed, r=4, alpha=8.0):
    params = jmlp.add_lora_to_mlp(params, jax.random.PRNGKey(seed + 1), r, alpha)
    rng = np.random.default_rng(seed)

    def fill(p):
        p = dict(p)
        p["lora_b"] = jnp.asarray(0.2 * rng.standard_normal(p["lora_b"].shape).astype(np.float32))
        return p

    return {"layers": [fill(p) for p in params["layers"]], "final": fill(params["final"])}


@pytest.fixture(scope="module")
def substep(scene):
    """The packed substep with ``layouts=None`` on both sides: its
    forward and its vjp into the state and both materials' LoRA leaves."""
    (c, st, s, _), (tc, tst, ts, _) = scene
    jcfg, tcfg = JaxMaterialConfig(layer_widths=(16, 16)), MetaMaterialConfig(layer_widths=(16, 16))
    mats = []
    for jcls, tcls, seed in ((JaxElasticity, InvariantFullMetaElasticity, 10),
                             (JaxPlasticity, InvariantFullMetaPlasticity, 20)):
        jm = jcls(jcfg)
        params = _with_lora(jax.tree_util.tree_map(lambda a: 0.5 * a, jm.init(jax.random.PRNGKey(seed))),
                            seed + 1)
        mats.append((jm, params, tcls(tcfg, interop.mlp_params_from_numpy(_np(params)))))
    (je, pe, te), (jp, pp, tp) = mats
    g_np = _cotangents(11)
    sub = jmpm.make_packed_substep(c, st, lambda p, F: je.apply(p, F), lambda p, F: jp.apply(p, F))
    out_j, vjp = jax.vjp(lambda a, b, st_: sub(a, b, st_, None), pe, pp, s)
    d_pe, d_pp, d_s = vjp(ParticleState(*(jnp.asarray(a) for a in g_np)))
    ref = [np.asarray(d_s.x), np.asarray(d_s.v), np.asarray(d_s.C), np.asarray(d_s.F)]
    ref += interop.lora_leaves(_np(d_pe)) + interop.lora_leaves(_np(d_pp))

    leaves = [t.clone().requires_grad_(True) for t in (ts.x, ts.v, ts.C, ts.F)]
    out = tmpm.make_packed_substep(tc, tst, te, tp)(tmpm.ParticleState(*leaves), None)
    params = tmpm.trainable_params(te) + tmpm.trainable_params(tp)
    grads = torch.autograd.grad([out.x, out.v, out.C, out.F], leaves + params,
                                [torch.from_numpy(a) for a in g_np])
    return out, out_j, [g.numpy() for g in grads], ref


def test_packed_substep_forward_matches_jax(substep):
    out, ref, _, _ = substep
    for name in ("x", "v", "C", "F"):
        assert scaled_err(getattr(out, name).detach().numpy(), getattr(ref, name)) <= TOL, name


@pytest.mark.parametrize("leaf", range(4 + 12))
def test_packed_substep_vjp_matches_jax(substep, leaf):
    """d(x, v, C, F) and the 12 LoRA leaves of both materials."""
    _, _, out, ref = substep
    assert np.abs(ref[leaf]).max() > 0
    assert scaled_err(out[leaf], ref[leaf]) <= TOL, scaled_err(out[leaf], ref[leaf])


def test_rollout_on_a_dense_grid_builds_no_layouts(monkeypatch):
    """The port's rollout at num_grids = 24 (the largest dense grid) on the
    CPU: a finite loss, finite gradients, nonzero into init_v and into each
    material's LoRA leaves, and no block layout built or refreshed. Runs
    no JAX."""
    from neuma_tpu_torch.train import grounding

    def refuse(*args, **kwargs):
        raise AssertionError("a block layout was built on a dense grid")

    monkeypatch.setattr(tmpm, "build_step_layouts", refuse)
    monkeypatch.setattr(tpk, "build_step_layouts", refuse)
    monkeypatch.setattr(grounding, "refresh_step_layouts", refuse)
    scene = grounding.build_scene(n_particles=300, grid=24, substeps=2, width=32, height=32, n_views=1,
                                  force_mask=False, max_pairs=1 << 12, max_per_tile=64,
                                  layer_widths=(8,), lora_r=2, device="cpu")
    loss_fn = grounding.make_rollout_loss(scene, device="cpu")
    p_e, p_p = tmpm.trainable_params(scene.elasticity), tmpm.trainable_params(scene.plasticity)
    init_v = torch.tensor([0.3, 0.0, 0.0], requires_grad=True)
    gt = torch.rand((2, 1, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    loss, _ = loss_fn(init_v, torch.ones(2), gt)
    grads = torch.autograd.grad(loss, [init_v] + p_e + p_p)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    norm = lambda gs: float(sum((g.double() ** 2).sum() for g in gs))
    assert norm(grads[:1]) > 0
    assert norm(grads[1 : 1 + len(p_e)]) > 0 and norm(grads[1 + len(p_e):]) > 0
