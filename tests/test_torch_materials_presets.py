"""Port parity: the preset materials, every meta family and
``ComposeMaterial`` (``neuma_tpu_torch.materials`` against
``neuma_tpu.materials``, the same numpy weights and F, CPU).

Each material's value and its F-gradient (``jax.vjp`` of a random
cotangent W against the port's autograd) on random F near the identity
(I + 0.05 N) and away from it (I + 0.3 N, det > 0.2), within
rtol 1e-5 with an absolute floor of 1e-5 of the largest reference value
(a scaled 1e-5). The weights cross through ``interop.material_from_numpy``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu import materials as jm
from neuma_tpu_torch import interop
from neuma_tpu_torch import materials as tm

TOL = 1e-5
PRESETS = [
    ("CorotatedElasticity", {"E": 2e5, "nu": 0.3}),
    ("StVKElasticity", {"E": 1e5, "nu": 0.25, "random": True}),
    ("VolumeElasticity", {"E": 1e5, "nu": 0.3, "mode": "taichi"}),
    ("VolumeElasticity", {"E": 1e5, "nu": 0.3, "mode": "ziran"}),
    ("SigmaElasticity", {"E": 1e5, "nu": 0.3}),
    ("IdentityPlasticity", {}),
    ("SigmaPlasticity", {}),
    ("VonMisesPlasticity", {"E": 1e5, "nu": 0.3, "sigma_y": 1e3}),
    ("VonMisesPlasticity", {"E": 1e5, "nu": 0.3, "sigma_y": 1e3, "random": True}),
    ("DruckerPragerPlasticity", {"E": 1e5, "nu": 0.3, "friction_angle": 30.0}),
    ("DruckerPragerPlasticity", {"E": 1e5, "nu": 0.3, "friction_angle": 25.0, "cohesion": 0.01,
                                 "random": True}),
]
META = ["PlainMetaElasticity", "PlainMetaPlasticity", "PolarMetaElasticity",
        "PolarMetaPlasticity", "InvariantMetaElasticity", "SVDMetaElasticity",
        "SVDMetaPlasticity", "InvariantFullMetaElasticity", "InvariantFullMetaPlasticity"]
SPLINE_CFG = {"num_side_points": 4, "xk_max": 2.0, "yk_max": 0.5, "alpha": 1e-2}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _F(kind, n=64, seed=0):
    rng = np.random.default_rng(seed)
    scale = 0.05 if kind == "near" else 0.3
    F = np.eye(3, dtype=np.float32) + scale * rng.standard_normal((4 * n, 3, 3)).astype(np.float32)
    return F[np.linalg.det(F) > 0.2][:n]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(float(np.abs(want).max()), 1e-30))


def _check(jax_apply, port, F, seed=1):
    W = np.random.default_rng(seed).standard_normal(F.shape).astype(np.float32)
    want, vjp = jax.vjp(jax_apply, jnp.asarray(F))
    (want_g,) = vjp(jnp.asarray(W))
    Ft = torch.tensor(F, requires_grad=True)
    out = port(Ft)
    (got_g,) = torch.autograd.grad((out * torch.as_tensor(W)).sum(), Ft)
    _close(out.detach().numpy(), want)
    _close(got_g.numpy(), want_g)


@pytest.mark.parametrize("kind", ["near", "away"])
@pytest.mark.parametrize("name,cfg", PRESETS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(PRESETS)])
def test_preset_matches_jax(name, cfg, kind):
    jmat = getattr(jm, name)(cfg)
    params = jmat.init(None)
    port = interop.material_from_numpy(name, cfg, _np(params))
    default = getattr(tm, name)(cfg)  # the port's own init, from the config alone
    for k, v in _np(params).items():
        np.testing.assert_array_equal(getattr(default, k).detach().numpy(), v)
    _check(lambda f: jmat.apply(params, f), port, _F(kind))


def _meta_params(jmat, seed):
    """The JAX package's init with LoRA on every linear and a nonzero
    ``lora_b`` drawn from numpy (so the LoRA term counts)."""
    params = jmat.init_lora(jmat.init(jax.random.PRNGKey(seed)), jax.random.PRNGKey(seed + 7),
                            r=4, alpha=8.0)
    rng = np.random.default_rng(seed)

    def fill(p):
        p = dict(p)
        p["lora_b"] = jnp.asarray(0.2 * rng.standard_normal(p["lora_b"].shape).astype(np.float32))
        return p

    return {"layers": [fill(p) for p in params["layers"]], "final": fill(params["final"])}


@pytest.mark.parametrize("kind", ["near", "away"])
@pytest.mark.parametrize("name", META)
def test_meta_family_matches_jax(name, kind):
    cfg = jm.MetaMaterialConfig(layer_widths=(16, 16), alpha=1e-2)
    jmat = getattr(jm, name)(cfg)
    params = _meta_params(jmat, seed=META.index(name))
    port = interop.material_from_numpy(name, cfg, _np(params))
    assert all(m == (k in ("lora_a", "lora_b"))
               for layer in port.lora_mask()["layers"] for k, m in layer.items())
    _check(lambda f: jmat.apply(params, f), port, _F(kind))


@pytest.mark.parametrize("kind", ["near", "away"])
@pytest.mark.parametrize("name", ["SplineMetaElasticity", "SplineMetaPlasticity"])
def test_spline_matches_jax(name, kind):
    jmat = getattr(jm, name)(SPLINE_CFG)
    init = jmat.init(None)
    default = getattr(tm, name).init(SPLINE_CFG)  # no draw: the JAX package's init
    for k, v in _np(init).items():
        np.testing.assert_array_equal(getattr(default, k).detach().numpy(), v)
    np.testing.assert_array_equal(default.xk.numpy(), np.asarray(jmat.xk))
    rng = np.random.default_rng(5)
    params = {k: jnp.asarray(rng.uniform(-0.5, 0.5, np.shape(v)).astype(np.float32))
              for k, v in init.items()}  # knots off their init so every term counts
    port = interop.material_from_numpy(name, SPLINE_CFG, _np(params))
    assert port.lora_params() == {} and not any(port.lora_mask().values())
    _check(lambda f: jmat.apply(params, f), port, _F(kind))


def test_compose_material_matches_jax_with_an_empty_section():
    """Three materials over sections (64, 0, 64), then (0, 64, 64): the
    empty one is skipped and the others see their own rows."""
    specs = [("CorotatedElasticity", {"E": 1e5, "nu": 0.3}),
             ("StVKElasticity", {"E": 3e5, "nu": 0.2}),
             ("VolumeElasticity", {"E": 2e5, "nu": 0.3})]
    jmats = [getattr(jm, n)(c) for n, c in specs]
    params = [m.init(None) for m in jmats]
    jcomp = jm.ComposeMaterial(jmats, [64, 0, 64])
    port = interop.compose_from_numpy(specs, [_np(p) for p in params], [64, 0, 64])
    assert isinstance(port, tm.ComposeMaterial) and len(list(port.parameters())) == 3
    F = np.concatenate([_F("away", seed=3), _F("near", seed=4)])
    _check(lambda f: jcomp.apply(params, f), port, F)
    port.update_sections([0, 64, 64])
    jcomp.update_sections([0, 64, 64])
    _check(lambda f: jcomp.apply(params, f), port, F)
