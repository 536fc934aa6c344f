"""Port parity of the training slice's pieces, ``neuma_tpu_torch`` on the
CPU against ``neuma_tpu`` (same numpy inputs): the closed-form ``svd3c``
backward, the materials' gradients with respect to F and the LoRA
leaves, the K3 plain version (G2P gather with spline derivatives)
against the interpreted TPU kernel, the packed substep's vjp (the slab
step adjoint with K1 as the gather's transpose and K3 twice, the
materials recomputed) and its NaN/Inf scrub, and the binding's
stop-gradients.

The JAX kernels run in interpret mode (``interpret=True`` /
``NEUMA_SLAB_GRID=interpret``), which runs the TPU's bf16 "high3"
splits; each tolerance below says what it covers.
"""
import importlib

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
from neuma_tpu.render import binding as jbind
from neuma_tpu.sim import mpm as jmpm
from neuma_tpu.sim import p2g_kernel as jpk
from neuma_tpu_torch import interop
from neuma_tpu_torch.materials.meta import (
    InvariantFullMetaElasticity,
    InvariantFullMetaPlasticity,
    MetaMaterialConfig,
)
from neuma_tpu_torch.nn import mlp as tmlp
from neuma_tpu_torch.render import binding as tbind
from neuma_tpu_torch.sim import mpm as tmpm
from neuma_tpu_torch.sim import p2g_kernel as tpk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Both packages' ops re-export an `svd3` function under the submodule's name.
jsvd = importlib.import_module("neuma_tpu.ops.svd3")
tsvd = importlib.import_module("neuma_tpu_torch.ops.svd3")

N = 800


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def scaled_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _with_lora(params, seed, r=4, alpha=8.0):
    params = jmlp.add_lora_to_mlp(params, jax.random.PRNGKey(seed + 1), r, alpha)
    rng = np.random.default_rng(seed)

    def fill(p):
        p = dict(p)
        p["lora_b"] = jnp.asarray(0.2 * rng.standard_normal(p["lora_b"].shape).astype(np.float32))
        return p

    return {"layers": [fill(p) for p in params["layers"]], "final": fill(params["final"])}


@pytest.fixture(scope="module")
def materials():
    """(JAX material, its params, port module) for each material."""
    jcfg, tcfg = JaxMaterialConfig(layer_widths=(16, 16)), MetaMaterialConfig(layer_widths=(16, 16))
    out = {}
    for name, jcls, tcls, seed in (("elasticity", JaxElasticity, InvariantFullMetaElasticity, 10),
                                   ("plasticity", JaxPlasticity, InvariantFullMetaPlasticity, 20)):
        jm = jcls(jcfg)
        params = _with_lora(jax.tree_util.tree_map(lambda a: 0.5 * a, jm.init(jax.random.PRNGKey(seed))),
                            seed + 1)
        out[name] = (jm, params, tcls(tcfg, interop.mlp_params_from_numpy(_np(params))))
    return out


# --- (a) svd3c backward -------------------------------------------------------


def _svd_inputs(kind, n=256, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "spread":
        F = np.eye(3, dtype=np.float32)[None] + 0.3 * rng.standard_normal((n, 3, 3)).astype(np.float32)
    else:  # rotations times near-equal (and exactly equal) singular values
        q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
        s = np.ones((n, 3)) + np.where(rng.random((n, 1)) < 0.5, 0.0, 1e-6) * rng.standard_normal((n, 3))
        s[::4] = [1.0, 1.0, 0.5]  # an exactly repeated pair: the clamp decides
        F = (q * s[:, None, :] @ np.transpose(q, (0, 2, 1))).astype(np.float32)
    cots = [rng.standard_normal((n,)).astype(np.float32) for _ in range(21)]
    return F, cots


def test_svd3c_function_matches_jax():
    """The autograd Function against JAX's custom VJP where the factors
    are unique (well separated singular values), cotangents on all 21
    outputs: factors to atol 1e-5, gradients to a scaled max error of 1e-5
    (one float32 chain of sums in either package)."""
    F, cots = _svd_inputs("spread")
    F9 = [F[:, r, c] for r in range(3) for c in range(3)]
    out_j, vjp = jax.vjp(jsvd.svd3c, tuple(jnp.asarray(f) for f in F9))
    c_j = (tuple(map(jnp.asarray, cots[:9])), tuple(map(jnp.asarray, cots[9:12])),
           tuple(map(jnp.asarray, cots[12:])))
    (ref,) = vjp(c_j)
    leaves = [torch.from_numpy(f.copy()).requires_grad_(True) for f in F9]
    u9, s3, vh9 = tsvd.svd3c(leaves)
    outs = list(u9) + list(s3) + list(vh9)
    grads = torch.autograd.grad(outs, leaves, [torch.from_numpy(c) for c in cots])
    for a, r in zip(outs, jax.tree_util.tree_leaves(out_j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), atol=1e-5)
    assert max(scaled_err(g.numpy(), r) for g, r in zip(grads, ref)) <= 1e-5


@pytest.mark.parametrize("kind", ["spread", "near_equal"])
def test_svd3c_adjoint_matches_jax(kind):
    """The closed-form adjoint on the same factors (JAX's forward) and
    cotangents. Near-equal and exactly repeated singular values go through
    the ``sign(diff) / max(|diff|, 1e-10)`` clamp: finite, and equal to
    JAX's to a scaled 1e-5 (the factors of a repeated value are not unique,
    so the two forwards are not compared there)."""
    F, cots = _svd_inputs(kind)
    F9 = [jnp.asarray(F[:, r, c]) for r in range(3) for c in range(3)]
    u9, s3, vh9 = jsvd._svd3c_fwd_impl(tuple(F9))
    c_j = (tuple(map(jnp.asarray, cots[:9])), tuple(map(jnp.asarray, cots[9:12])),
           tuple(map(jnp.asarray, cots[12:])))
    (ref,) = jsvd._svd3c_bwd((u9, s3, vh9), c_j)
    t = lambda xs: tuple(torch.from_numpy(np.asarray(x).copy()) for x in xs)
    out = tsvd._svd3c_bwd(t(u9), t(s3), t(vh9), t(cots[:9]), t(cots[9:12]), t(cots[12:]))
    assert all(bool(torch.isfinite(g).all()) for g in out)
    assert max(scaled_err(g.numpy(), r) for g, r in zip(out, ref)) <= 1e-5


def test_svd3c_unused_outputs_take_zero_cotangents():
    """A loss on the singular values alone: the U and Vh cotangents are
    zero, and the result is JAX's with zeros in their place."""
    F, cots = _svd_inputs("spread", n=64, seed=3)
    F9 = [F[:, r, c] for r in range(3) for c in range(3)]
    z = tuple(jnp.zeros(64, jnp.float32) for _ in range(9))
    _, vjp = jax.vjp(jsvd.svd3c, tuple(jnp.asarray(f) for f in F9))
    (ref,) = vjp((z, tuple(map(jnp.asarray, cots[9:12])), z))
    leaves = [torch.from_numpy(f.copy()).requires_grad_(True) for f in F9]
    _, s3, _ = tsvd.svd3c(leaves)
    grads = torch.autograd.grad(list(s3), leaves, [torch.from_numpy(c) for c in cots[9:12]])
    assert max(scaled_err(g.numpy(), r) for g, r in zip(grads, ref)) <= 1e-5


# --- (b) materials ------------------------------------------------------------


def test_lora_mask_matches_jax(materials):
    _, params, tm = materials["elasticity"]
    assert tmlp.lora_mask(tm.params()) == jmlp.lora_mask(_np(params))
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    assert names and all(n.endswith(("lora_a", "lora_b")) for n in names)
    assert all(not b.requires_grad for b in tm.buffers())


@pytest.mark.parametrize("name", ["elasticity", "plasticity"])
def test_material_gradients_match_jax(materials, name):
    """d/dF and d/d(LoRA A, B) of <cot, material(F)>: scaled max error
    1e-5 per leaf (measured 5e-7). Both run float32 MLPs whose matmuls sum
    in other orders, and the SVD adjoint divides by s_j^2 - s_i^2, which
    amplifies that rounding for F near the identity."""
    jm, params, tm = materials[name]
    rng = np.random.default_rng(5)
    F = (np.eye(3, dtype=np.float32)[None] + 0.2 * rng.standard_normal((300, 3, 3))).astype(np.float32)
    cot = rng.standard_normal((300, 3, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, f: jm.apply(p, f), params, jnp.asarray(F))
    d_params, d_F = vjp(jnp.asarray(cot))
    Ft = torch.from_numpy(F.copy()).requires_grad_(True)
    grads = torch.autograd.grad(tm(Ft), [Ft] + tmpm.trainable_params(tm), torch.from_numpy(cot))
    refs = [np.asarray(d_F)] + interop.lora_leaves(_np(d_params))
    assert len(grads) == len(refs) == 1 + 2 * 3
    for i, (g, r) in enumerate(zip(grads, refs)):
        assert np.abs(r).max() > 0
        assert scaled_err(g.numpy(), r) <= 1e-5, (i, scaled_err(g.numpy(), r))


# --- (c) K3 plain version -----------------------------------------------------


def _sim_scene(n=N, g=32, seed=0):
    rng = np.random.default_rng(seed)
    constants = MPMConstants(
        num_grids=g, bound=2, bc="noslip", dt=jnp.float32(8e-4),
        gravity=jnp.asarray([0.0, -9.8, 0.0], jnp.float32), eps=jnp.float32(6e-7),
    )
    statics = Statics(
        vol=jnp.full((n,), 2e-8, jnp.float32), rho=jnp.full((n,), 1000.0, jnp.float32),
        clip_bound=jnp.full((n,), 0.1, jnp.float32), enabled=jnp.ones((n,), jnp.int32),
    )
    x = (0.25 + 0.5 * rng.random((n, 3))).astype(np.float32)
    v = (0.3 * rng.standard_normal((n, 3))).astype(np.float32)
    C = (0.5 * rng.standard_normal((n, 3, 3))).astype(np.float32)
    F = (np.eye(3, dtype=np.float32)[None] + 0.02 * rng.standard_normal((n, 3, 3))).astype(np.float32)
    stress = (1e-3 * rng.standard_normal((n, 3, 3))).astype(np.float32)
    state = ParticleState(x=jnp.asarray(x), v=jnp.asarray(v), C=jnp.asarray(C), F=jnp.asarray(F))
    torch_side = (interop.constants_from_numpy(_np(constants)), interop.statics_from_numpy(_np(statics)),
                  interop.state_from_numpy(_np(state)), torch.from_numpy(stress))
    return (constants, statics, state, jnp.asarray(stress)), torch_side


@pytest.fixture(scope="module")
def sim():
    return _sim_scene()


@pytest.mark.parametrize("role", ["p2g_adjoint", "g2p_position_adjoint"])
def test_k3_plain_matches_interpret(sim, role):
    """The step backward's two K3 calls: the forward (mass, b, affine)
    against a slab cotangent, and (d new_v, kappa d new_C) against grid
    velocities. Scaled max error 3e-5 per output group (dgm, db, dA, dx),
    the bound of the K1/K2 parity tests: interpret mode runs the TPU's
    bf16 "high3" splits."""
    (c, st, s, stress), (tc, tst, ts, tstress) = sim
    rng = np.random.default_rng(7)
    jl, tl = jpk.build_step_layouts(c, s.x), tpk.build_step_layouts(tc, ts.x)
    if role == "p2g_adjoint":
        jterms = jmpm._p2g_terms(c, st, s, stress)
        tterms = tmpm._p2g_terms(tc, tst, ts, tstress)
    else:
        dv = rng.standard_normal((N, 3)).astype(np.float32)
        A2 = (40.0 * rng.standard_normal((N, 3, 3))).astype(np.float32)
        jterms = (None, jnp.asarray(dv), jnp.asarray(A2))
        tterms = (None, torch.from_numpy(dv), torch.from_numpy(A2))
    jpay = jpk.pack_payload(c, jl.gather, jl.sort.fx, jl.sort.loc, *jterms)
    tpay = tpk.pack_payload(tc, tl.gather, tl.sort.fx, tl.sort.loc, *tterms)
    slabs = rng.standard_normal((27, 4, 16, 16, 16)).astype(np.float32)
    if role == "g2p_position_adjoint":
        slabs[:, 3] = 0.0
    M = jl.gather.c2b.shape[0]
    ref = np.asarray(jax.jit(
        lambda p, sl: jpk.run_apic_gather(p, sl, jl.gather.c2b, M, 32.0, True, interpret=True)
    )(jpay, jnp.asarray(slabs)))
    out = tpk.run_apic_gather(tpay, torch.from_numpy(slabs), tl.gather.c2b, 32.0, derivs=True).numpy()
    assert np.abs(ref[:, 13:16]).max() > 0, "the derivative columns are live"
    for cols in (slice(0, 1), slice(1, 4), slice(4, 13), slice(13, 16)):
        if np.abs(ref[:, cols]).max() > 0:
            assert scaled_err(out[:, cols], ref[:, cols]) <= 3e-5, cols


def test_k3_without_derivs_is_k2(sim):
    (_, _, _, _), (tc, tst, ts, tstress) = sim
    tl = tpk.build_step_layouts(tc, ts.x)
    tpay = tpk.pack_payload(tc, tl.gather, tl.sort.fx, tl.sort.loc, *tmpm._p2g_terms(tc, tst, ts, tstress))
    slabs = torch.randn((27, 4, 16, 16, 16), generator=torch.Generator().manual_seed(0))
    k2 = tpk.run_apic_gather(tpay, slabs, tl.gather.c2b, 32.0)
    k3 = tpk.run_apic_gather(tpay, slabs, tl.gather.c2b, 32.0, derivs=True)
    np.testing.assert_array_equal(k3[:, :13].numpy(), k2[:, :13].numpy())
    assert (k2[:, 13:] == 0).all() and (k3[:, 13:] != 0).any()


# --- (e) packed substep vjp ---------------------------------------------------


def _substep_vjps(sim, materials, g_np):
    (c, st, s, stress), (tc, tst, ts, _) = sim
    je, pe, te = materials["elasticity"]
    jp, pp, tp = materials["plasticity"]
    layouts = jpk.build_step_layouts(c, s.x)
    sub = jmpm.make_packed_substep(c, st, lambda p, F: je.apply(p, F), lambda p, F: jp.apply(p, F))
    g_j = ParticleState(*(jnp.asarray(a) for a in g_np))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEUMA_SLAB_GRID", "interpret")
        d_pe, d_pp, d_s = jax.jit(
            lambda a, b, st_, g_: jax.vjp(lambda x, y, z: sub(x, y, z, layouts), a, b, st_)[1](g_)
        )(pe, pp, s, g_j)
    ref = [np.asarray(d_s.x), np.asarray(d_s.v), np.asarray(d_s.C), np.asarray(d_s.F)]
    ref += interop.lora_leaves(_np(d_pe)) + interop.lora_leaves(_np(d_pp))

    leaves = [t.clone().requires_grad_(True) for t in (ts.x, ts.v, ts.C, ts.F)]
    state = tmpm.ParticleState(*leaves)
    out = tmpm.make_packed_substep(tc, tst, te, tp)(state, tpk.build_step_layouts(tc, ts.x))
    grads = torch.autograd.grad([out.x, out.v, out.C, out.F], leaves + tmpm.trainable_params(te) + tmpm.trainable_params(tp),
                                [torch.from_numpy(a) for a in g_np])
    return [g.numpy() for g in grads], ref


def _cotangents(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in ((N, 3), (N, 3), (N, 3, 3), (N, 3, 3))]


@pytest.fixture(scope="module")
def substep_vjps(sim, materials):
    return _substep_vjps(sim, materials, _cotangents(11))


@pytest.mark.parametrize("leaf", range(4 + 12))
def test_packed_substep_vjp_matches_jax(substep_vjps, leaf):
    """d(x, v, C, F) and the 12 LoRA leaves of both materials. Scaled max
    error 1e-4 per leaf: the slab kernels run interpreted with the TPU's
    bf16 "high3" splits on the JAX side (3e-5 per kernel), and the
    material vjps add the float32 MLP/SVD rounding of the test above."""
    out, ref = substep_vjps
    assert np.abs(ref[leaf]).max() > 0
    assert scaled_err(out[leaf], ref[leaf]) <= 1e-4, scaled_err(out[leaf], ref[leaf])


def test_mpm_step_diff_vjp_matches_jax(sim):
    """The step alone: d(x, v, C, F) and d stress against JAX's
    ``mpm_step_diff`` (interpreted kernels), scaled max error 1e-4 per
    leaf as above."""
    (c, st, s, stress), (tc, tst, ts, tstress) = sim
    layouts = jpk.build_step_layouts(c, s.x)
    g_np = _cotangents(13)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEUMA_SLAB_GRID", "interpret")
        d_s, d_stress = jax.jit(lambda s_, sr, g_: jax.vjp(
            lambda a, b: jmpm.mpm_step_diff(c, st, a, b, layouts), s_, sr)[1](g_))(
            s, stress, ParticleState(*(jnp.asarray(a) for a in g_np)))
    leaves = [t.clone().requires_grad_(True) for t in (ts.x, ts.v, ts.C, ts.F, tstress)]
    out = tmpm.mpm_step_diff(tc, tst, tmpm.ParticleState(*leaves[:4]), leaves[4])
    grads = torch.autograd.grad([out.x, out.v, out.C, out.F], leaves,
                                [torch.from_numpy(a) for a in g_np])
    refs = [d_s.x, d_s.v, d_s.C, d_s.F, d_stress]
    for g, r in zip(grads, refs):
        assert np.abs(np.asarray(r)).max() > 0
        assert scaled_err(g.numpy(), r) <= 1e-4, scaled_err(g.numpy(), r)


def test_packed_substep_scrubs_nan_cotangents(sim, materials):
    """A NaN in one particle's v cotangent spreads through the grid; the
    step's scrub maps it to 0 in every outgoing cotangent, so every
    gradient is finite and that particle's x cotangent and the y component
    of its v cotangent are 0, in the port as in JAX. (How far the NaN spreads before the scrub depends
    on how each scatter sums, so the zero patterns elsewhere may differ.)"""
    g_np = _cotangents(12)
    g_np[1][5, 1] = np.nan
    out, ref = _substep_vjps(sim, materials, g_np)
    for a, r in zip(out, ref):
        assert np.all(np.isfinite(a)) and np.all(np.isfinite(r))
    # x mixes the grid's channels, v keeps them apart: the NaN rode on
    # channel 1 (y momentum).
    assert (out[0][5] == 0).all() and (ref[0][5] == 0).all()
    assert out[1][5, 1] == 0 and ref[1][5, 1] == 0


def test_scrub_cotangents_is_identity_with_a_scrubbing_backward():
    x = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    y = tmpm.scrub_cotangents(x)
    np.testing.assert_array_equal(y.detach().numpy(), x.detach().numpy())
    (g,) = torch.autograd.grad(y, x, torch.tensor([float("nan"), float("inf"), 4.0]))
    np.testing.assert_array_equal(g.numpy(), [0.0, 0.0, 4.0])


# --- (k) binding stop-gradients -----------------------------------------------


def _binding_case(seed=5, K=50, M=10, n=300):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (K, M)).astype(np.int32)
    w = rng.random((K, M)).astype(np.float32)
    w[:, 7:] = 0.0  # unbound slots, as the table's rejected candidates
    table = jbind.BindingTable(indices=jnp.asarray(idx), weights=jnp.asarray(w))
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in ((n, 3), (n, 3), (K, 3), (K, 3))]
    return table, interop.binding_from_numpy(_np(table)), arrays


def test_binding_xyz_gradient_flows_only_through_p_curr():
    """JAX stops the gradient of p_prev and k_prev; the port detaches
    them, and the p_curr gradient (the inverse-table transpose) matches
    ``jax.grad`` to float32 rounding (atol 1e-5)."""
    table, ttable, (p1, p0, k0, w_out) = _binding_case()
    ref = jax.grad(
        lambda a, b, c: jnp.sum(jnp.asarray(w_out) * jbind.apply_binding_xyz(table, a, b, c)),
        argnums=(0, 1, 2),
    )(jnp.asarray(p1), jnp.asarray(p0), jnp.asarray(k0))
    assert np.abs(np.asarray(ref[1])).max() == 0 and np.abs(np.asarray(ref[2])).max() == 0
    ins = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (p1, p0, k0)]
    out = tbind.apply_binding_xyz(ttable, *ins)
    g = torch.autograd.grad((torch.from_numpy(w_out) * out).sum(), ins, allow_unused=True)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    assert g[1] is None and g[2] is None


def test_binding_transpose_equals_plain_index_backward():
    """The inverse-table sum equals autograd's index backward."""
    _, ttable, (p1, _, _, w_out) = _binding_case(seed=8)
    d = torch.from_numpy(p1).requires_grad_(True)
    table = ttable.with_inverse(d.shape[0])
    out = tbind._BindingGather.apply(d, table.indices, table.weights, table.inverse)
    plain = torch.einsum("km,kmc->kc", table.weights, d[table.indices])
    w = torch.from_numpy(w_out)
    (a,) = torch.autograd.grad((w * out).sum(), d)
    (b,) = torch.autograd.grad((w * plain).sum(), d)
    np.testing.assert_array_equal(out.detach().numpy(), plain.detach().numpy())
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_deform_cov_by_F_stops_the_gradient():
    """The reference's default: no gradient reaches F or the covariance
    (zero in JAX; no graph in the port), unless ``stop_gradient=False``."""
    rng = np.random.default_rng(9)
    cov = np.abs(rng.standard_normal((20, 6))).astype(np.float32)
    F = (np.eye(3) + 0.1 * rng.standard_normal((20, 3, 3))).astype(np.float32)
    ref = jax.grad(lambda f: jnp.sum(jbind.deform_cov_by_F(jnp.asarray(cov), f) ** 2))(jnp.asarray(F))
    assert np.abs(np.asarray(ref)).max() == 0
    Ft = torch.from_numpy(F).requires_grad_(True)
    assert not tbind.deform_cov_by_F(torch.from_numpy(cov), Ft).requires_grad
    live = tbind.deform_cov_by_F(torch.from_numpy(cov), Ft, stop_gradient=False)
    (g,) = torch.autograd.grad((live ** 2).sum(), Ft)
    ref_live = jax.grad(lambda f: jnp.sum(jbind.deform_cov_by_F(jnp.asarray(cov), f, False) ** 2))(
        jnp.asarray(F))
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_live), rtol=1e-5, atol=1e-6)
