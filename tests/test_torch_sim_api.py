"""Port parity: the sim's public surface, ``p2g`` (``method="auto"``),
``g2p``, ``advect_extra``, ``apic_scatter`` and ``apic_scatter_f``
(values and VJPs), and ``sim/rollout.py``'s ``make_step_fn`` +
``rollout`` over 3 frames x 2 substeps (``neuma_tpu_torch`` against
``neuma_tpu``, the same numpy inputs, CPU).

Each runs on the dense grid (16 cells) and on a slab grid (32 cells).
On the slab grid the port's forward is K1 and its backward K3 (their
plain versions on the CPU) and ``g2p`` gathers by K2, while the JAX
package runs its full-FP32 jnp paths there off the TPU (the blocked
``_blocked_forward`` scatter, the dense gathers, ``_apic_bwd_jnp``), so
no interpret mode is needed. Bound: a scaled 1e-5 (max error over the
reference's largest value, per output).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.core.types import MPMConstants, ParticleState, Statics
from neuma_tpu.materials import meta as jmeta
from neuma_tpu.materials import preset as jpreset
from neuma_tpu.sim import blocked as jblocked
from neuma_tpu.sim import mpm as jmpm
from neuma_tpu.sim import rollout as jrollout
from neuma_tpu_torch import interop, sim as tsim
from neuma_tpu_torch.core.types import ParticleState as TState
from neuma_tpu_torch.sim import blocked as tblocked
from neuma_tpu_torch.sim import rollout as trollout
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
GRIDS = [16, 32]


@pytest.fixture(autouse=True)
def _jax_full_fp32(monkeypatch):
    """The JAX package's non-TPU paths (no interpreted slab kernels)."""
    monkeypatch.delenv("NEUMA_SLAB_GRID", raising=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / (scale if scale > 0 else 1.0)


def _scene(g, n=1200, seed=0):
    rng = np.random.default_rng(seed + g)
    constants = MPMConstants(
        num_grids=g, bound=2, bc="noslip", dt=jnp.float32(8e-4),
        gravity=jnp.asarray([0.0, -9.8, 0.0], jnp.float32), eps=jnp.float32(6e-7),
    )
    en = np.ones((n,), np.int32)
    en[: n // 10] = 0  # some particles frozen
    statics = Statics(
        vol=jnp.full((n,), 2e-8, jnp.float32), rho=jnp.full((n,), 1000.0, jnp.float32),
        clip_bound=jnp.full((n,), 0.1, jnp.float32), enabled=jnp.asarray(en),
    )
    f32 = lambda a: a.astype(np.float32)
    state = ParticleState(
        x=jnp.asarray(f32(0.25 + 0.5 * rng.random((n, 3)))),
        v=jnp.asarray(f32(0.3 * rng.standard_normal((n, 3)))),
        C=jnp.asarray(f32(0.5 * rng.standard_normal((n, 3, 3)))),
        F=jnp.asarray(f32(np.eye(3)[None] + 0.02 * rng.standard_normal((n, 3, 3)))),
    )
    stress = jnp.asarray(f32(1e-3 * rng.standard_normal((n, 3, 3))))
    port = (interop.constants_from_numpy(_np(constants)), interop.statics_from_numpy(_np(statics)),
            interop.state_from_numpy(_np(state)), torch.from_numpy(np.array(stress)))
    return (constants, statics, state, stress), port, rng


def _jax_vjp(fn, primals, cots):
    """(outputs, input cotangents) of ``fn`` in one jitted call."""

    def both(primals, cots):
        outs, vjp = jax.vjp(fn, *primals)
        return outs, vjp(cots)

    return jax.jit(both)(tuple(jnp.asarray(p) for p in primals),
                         jax.tree_util.tree_map(jnp.asarray, cots))


def _leaves(state):
    return (state.x, state.v, state.C, state.F)


def _grads_torch(outs, cots, inputs):
    loss = sum((o * torch.as_tensor(c)).sum() for o, c in zip(outs, cots) if o is not None)
    return torch.autograd.grad(loss, inputs, allow_unused=True)


@pytest.mark.parametrize("g", GRIDS)
def test_apic_scatter_matches_jax(g):
    (c, _, s, _), (tc, _, ts, _), rng = _scene(g)
    n = s.x.shape[0]
    gm = rng.random(n).astype(np.float32) * 1e-5
    b = rng.standard_normal((n, 3)).astype(np.float32) * 1e-5
    A = rng.standard_normal((n, 3, 3)).astype(np.float32) * 1e-4
    du = rng.standard_normal(g ** 3).astype(np.float32)
    df = rng.standard_normal((g ** 3, 3)).astype(np.float32)
    x = np.asarray(s.x)

    outs, jgrads = _jax_vjp(lambda *a: jblocked.apic_scatter(c, *a), (x, gm, b, A), (du, df))
    tin = [torch.tensor(a, requires_grad=True) for a in (x, gm, b, A)]
    touts = tblocked.apic_scatter(tc, *tin)
    tgrads = _grads_torch(touts, (du, df), tin)
    for name, got, want in zip(("grid_m", "grid_f", "dx", "dgm", "db", "dA"),
                               list(touts) + list(tgrads), list(outs) + list(jgrads)):
        assert _err(got, want) <= TOL, name

    out_f, jg = _jax_vjp(lambda *a: jblocked.apic_scatter_f(c, *a), (x, b, A), df)
    tin = [torch.tensor(a, requires_grad=True) for a in (x, b, A)]
    tout = tblocked.apic_scatter_f(tc, *tin)
    tg = _grads_torch([tout], [df], tin)
    for name, got, want in zip(("grid_f", "dx", "db", "dA"), [tout, *tg], [out_f, *jg]):
        assert _err(got, want) <= TOL, f"scatter_f {name}"


@pytest.mark.parametrize("g", GRIDS)
def test_p2g_matches_jax(g):
    (c, st, s, stress), (tc, tst, ts, tstress), rng = _scene(g)
    du = rng.standard_normal(g ** 3).astype(np.float32)
    df = rng.standard_normal((g ** 3, 3)).astype(np.float32)

    def jfn(x, v, C, sr):
        return jmpm.p2g(c, st, ParticleState(x=x, v=v, C=C, F=s.F), sr)

    outs, jgrads = _jax_vjp(jfn, (s.x, s.v, s.C, stress), (du, df))
    tin = [t.clone().requires_grad_(True) for t in (ts.x, ts.v, ts.C, tstress)]
    touts = tsim.p2g(tc, tst, TState(tin[0], tin[1], tin[2], ts.F), tin[3])
    tgrads = _grads_torch(touts, (du, df), tin)
    for name, got, want in zip(("grid_m", "grid_mv", "dx", "dv", "dC", "dstress"),
                               list(touts) + list(tgrads), list(outs) + list(jgrads)):
        assert _err(got, want) <= TOL, name
    for method in ("matmul", "scatter"):
        with pytest.raises(NotImplementedError, match="queue 1, item 5"):
            tsim.p2g(tc, tst, ts, tstress, method=method)


@pytest.mark.parametrize("g", GRIDS)
def test_g2p_matches_jax(g):
    (c, st, s, _), (tc, tst, ts, _), rng = _scene(g)
    grid_v = rng.standard_normal((g ** 3, 3)).astype(np.float32)
    cots = [rng.standard_normal(np.shape(a)).astype(np.float32) for a in _leaves(s)]

    def jfn(x, v, C, F, gv):
        return _leaves(jmpm.g2p(c, st, ParticleState(x=x, v=v, C=C, F=F), gv))

    outs, jgrads = _jax_vjp(jfn, (*_leaves(s), grid_v), tuple(cots))
    tin = [t.clone().requires_grad_(True) for t in _leaves(ts)] + [
        torch.tensor(grid_v, requires_grad=True)]
    touts = _leaves(tsim.g2p(tc, tst, TState(*tin[:4]), tin[4]))
    tgrads = _grads_torch(touts, cots, tin)
    names = ("x", "v", "C", "F", "dx", "dv", "dC", "dF", "dgrid_v")
    for name, got, want in zip(names, list(touts) + list(tgrads), list(outs) + list(jgrads)):
        assert _err(got, want) <= TOL, name


@pytest.mark.parametrize("g", GRIDS)
def test_advect_extra_matches_jax(g):
    (c, st, s, stress), (tc, tst, ts, tstress), rng = _scene(g)
    (_, st2, s2, _), (_, tst2, ts2, _), _ = _scene(g, n=300, seed=5)
    out = jax.jit(lambda *a: jmpm.advect_extra(c, st, *a))(s, stress, st2, s2)
    got = tsim.advect_extra(tc, tst, ts, tstress, tst2, ts2)
    for name, a, b in zip("xvCF", _leaves(got), _leaves(out)):
        assert _err(a, b) <= TOL, name


@pytest.fixture(scope="module", params=GRIDS)
def rollouts(request):
    """3 frames x 2 substeps through JAX's ``make_step_fn`` + ``rollout``
    (jitted once) and the port's; the port's also as a loop of its steps.
    The materials are a volume elasticity and a Plain meta plasticity
    (8, 8) with LoRA (nonzero B): no SVD, so the JAX compile stays short
    (the SVD families are held in ``test_torch_materials_presets.py``)."""
    g = request.param
    (c, st, s, _), (tc, tst, ts, _), rng = _scene(g, n=800)
    e_cfg = {"E": 2e4, "nu": 0.3}
    jel = jpreset.VolumeElasticity(e_cfg)
    pe = jel.init(None)
    cfg = jmeta.MetaMaterialConfig(layer_widths=(8, 8), alpha=1e-2)
    jpl = jmeta.PlainMetaPlasticity(cfg)
    pp = jpl.init_lora(jpl.init(jax.random.PRNGKey(1)), jax.random.PRNGKey(11), r=2, alpha=4.0)
    for layer in pp["layers"] + [pp["final"]]:
        layer["lora_b"] = jnp.asarray(
            0.3 * rng.standard_normal(layer["lora_b"].shape).astype(np.float32))
    tel = interop.material_from_numpy("VolumeElasticity", e_cfg, _np(pe))
    tpl = interop.material_from_numpy("PlainMetaPlasticity", cfg, _np(pp))
    jstep = jrollout.make_step_fn(c, st, jel.apply, jpl.apply)
    final, traj = jax.jit(lambda s0: jrollout.rollout(
        jstep, pe, pp, s0, 3, substeps=2, remat=True, constants=c))(s)
    tstep = trollout.make_step_fn(tc, tst, tel, tpl)
    tfinal, ttraj = trollout.rollout(tstep, ts, 3, substeps=2, remat=True, constants=tc)
    with torch.no_grad():
        loop = ts
        for _ in range(6):
            loop = tstep(loop)
    return (final, traj), (tfinal, ttraj), loop


def test_rollout_matches_jax(rollouts):
    (final, traj), (tfinal, ttraj), _ = rollouts
    for name, a, b in zip("xvCF", _leaves(tfinal), _leaves(final)):
        assert _err(a, b) <= TOL, f"final {name}"
    for name, a, b in zip("xvCF", _leaves(ttraj), _leaves(traj)):
        assert a.shape[0] == 3 and _err(a, b) <= TOL, f"trajectory {name}"


def test_rollout_equals_a_loop_of_steps(rollouts):
    """The carried, refreshed block sort gives the same layouts as one
    built per step: the rollout equals the step loop bit for bit."""
    _, (tfinal, ttraj), loop = rollouts
    for a, b in zip(_leaves(tfinal), _leaves(loop)):
        assert torch.equal(a.detach(), b)
    assert torch.equal(ttraj.x[-1].detach(), loop.x)


def test_rollout_gradient_flows_through_remat():
    """With autograd recording, the per-frame checkpoint still carries the
    gradient to the initial velocity and the materials' LoRA leaves."""
    _, (tc, tst, ts, _), _ = _scene(16, n=200)
    cfg = interop.materials.MetaMaterialConfig(layer_widths=(8, 8))
    gen = torch.Generator().manual_seed(0)
    e = interop.materials.PlainMetaElasticity.init(cfg, gen)
    p = interop.materials.PlainMetaPlasticity.init(cfg, gen)
    for m in (e, p):
        m.init_lora(gen, r=2, alpha=4.0)
    v0 = ts.v.clone().requires_grad_(True)
    step = trollout.make_step_fn(tc, tst, e, p)
    final, _ = trollout.rollout(step, dataclasses.replace(ts, v=v0), 2, substeps=1, constants=tc)
    grads = torch.autograd.grad(final.x.square().sum(), [v0] + [q for q in e.parameters()
                                                                 if q.requires_grad])
    assert all(torch.isfinite(g).all() for g in grads) and grads[0].abs().max() > 0
