"""Port parity: MLP with LoRA, 3x3 SVD and the InvariantFull materials
(``neuma_tpu_torch`` against ``neuma_tpu``, same numpy inputs, CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.materials.meta import (
    InvariantFullMetaElasticity as JaxElasticity,
    InvariantFullMetaPlasticity as JaxPlasticity,
    MetaMaterialConfig as JaxMaterialConfig,
)
from neuma_tpu.nn import mlp as jmlp
from neuma_tpu.ops.svd3 import svd3 as jax_svd3
from neuma_tpu_torch import interop
from neuma_tpu_torch.materials.meta import (
    InvariantFullMetaElasticity,
    InvariantFullMetaPlasticity,
    MetaMaterialConfig,
)
from neuma_tpu_torch.nn import mlp as tmlp
from neuma_tpu_torch.ops.svd3 import svd3
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_lora(params, seed, r=4, alpha=8.0):
    """LoRA on every linear with a NON-zero lora_b drawn from numpy, so
    the LoRA term matters."""
    params = jmlp.add_lora_to_mlp(params, jax.random.PRNGKey(seed + 1), r, alpha)
    rng = np.random.default_rng(seed)

    def fill(p):
        p = dict(p)
        p["lora_b"] = jnp.asarray(
            0.1 * rng.standard_normal(p["lora_b"].shape).astype(np.float32)
        )
        return p

    return {"layers": [fill(p) for p in params["layers"]], "final": fill(params["final"])}


def _near_identity_F(n, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return (np.eye(3, dtype=np.float32)[None]
            + scale * rng.standard_normal((n, 3, 3)).astype(np.float32))


@pytest.mark.parametrize("norm,no_bias", [(None, True), (None, False), ("wn", False), ("ln", True)])
def test_mlp_with_lora_matches_jax(norm, no_bias):
    cfg = jmlp.MLPConfig(in_dim=13, out_dim=9, layer_widths=(16, 16), norm=norm, no_bias=no_bias)
    params = jmlp.init_mlp(jax.random.PRNGKey(0), cfg)
    if not no_bias:  # non-zero biases so they matter
        params = jax.tree_util.tree_map(lambda a: a + 0.01, params)
    params = _with_lora(params, seed=3)
    x = np.random.default_rng(1).standard_normal((64, 13)).astype(np.float32)
    ref = np.asarray(jmlp.apply_mlp(params, cfg, jnp.asarray(x)))
    tcfg = tmlp.MLPConfig(in_dim=13, out_dim=9, layer_widths=(16, 16), norm=norm, no_bias=no_bias)
    out = tmlp.apply_mlp(interop.mlp_params_from_numpy(_np(params)), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_merge_lora_matches_jax():
    cfg = jmlp.MLPConfig(in_dim=13, out_dim=9, layer_widths=(16,), norm="wn", no_bias=False)
    params = _with_lora(jmlp.init_mlp(jax.random.PRNGKey(2), cfg), seed=5)
    ref = _np(jmlp.merge_lora(params["final"]))
    out = interop.to_numpy(tmlp.merge_lora(interop.mlp_params_from_numpy(_np(params))["final"]))
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_init_mlp_and_lora_tree_structure():
    """Same leaves and shapes as the JAX package's init (the draws differ)."""
    cfg = jmlp.MLPConfig(in_dim=13, out_dim=9, layer_widths=(16, 16), norm="wn", no_bias=False)
    ref = _np(jmlp.add_lora_to_mlp(jmlp.init_mlp(jax.random.PRNGKey(0), cfg),
                                   jax.random.PRNGKey(1), 4, 8.0))
    gen = torch.Generator().manual_seed(0)
    tcfg = tmlp.MLPConfig(in_dim=13, out_dim=9, layer_widths=(16, 16), norm="wn", no_bias=False)
    out = interop.to_numpy(tmlp.add_lora_to_mlp(tmlp.init_mlp(tcfg, gen), gen, 4, 8.0))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: np.shape(a), t)
    assert shapes(out) == shapes(ref)
    np.testing.assert_array_equal(out["final"]["lora_b"], 0.0)
    assert out["final"]["lora_scale"] == np.float32(2.0)


def test_svd3_matches_jax_near_identity():
    F = _near_identity_F(256, seed=4, scale=0.2)
    U, s, Vh = jax_svd3(jnp.asarray(F))
    R_ref = np.asarray(U @ Vh)
    tU, ts, tVh = svd3(torch.from_numpy(F))
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), atol=1e-5)
    np.testing.assert_allclose((tU @ tVh).numpy(), R_ref, atol=1e-5)
    # The port's own conventions: det(U), det(V) > 0 and A = U diag(s) Vh.
    assert (torch.linalg.det(tU) > 0).all() and (torch.linalg.det(tVh) > 0).all()
    recon = tU @ torch.diag_embed(ts) @ tVh
    np.testing.assert_allclose(recon.numpy(), F, atol=1e-5)


def test_svd3_reflection_sign_on_last_sigma():
    F = _near_identity_F(32, seed=6)
    F[:, :, 2] *= -1.0  # det < 0: the reflection goes into sigma[2]
    _, s_ref, _ = jax_svd3(jnp.asarray(F))
    _, s, _ = svd3(torch.from_numpy(F))
    assert (s[:, 2] < 0).all()
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-5)


@pytest.fixture(scope="module")
def materials():
    jcfg = JaxMaterialConfig(layer_widths=(16, 16))
    tcfg = MetaMaterialConfig(layer_widths=(16, 16))
    out = {}
    for name, jcls, tcls, seed in (
        ("elasticity", JaxElasticity, InvariantFullMetaElasticity, 10),
        ("plasticity", JaxPlasticity, InvariantFullMetaPlasticity, 20),
    ):
        jm = jcls(jcfg)
        params = _with_lora(jm.init(jax.random.PRNGKey(seed)), seed=seed + 1)
        tm = tcls(tcfg, interop.mlp_params_from_numpy(_np(params)))
        out[name] = (jm, params, tm)
    return out


@pytest.mark.parametrize("name", ["elasticity", "plasticity"])
def test_material_matches_jax(materials, name):
    jm, params, tm = materials[name]
    F = _near_identity_F(200, seed=7)
    ref = np.asarray(jm.apply(params, jnp.asarray(F)))
    with torch.no_grad():
        out = tm(torch.from_numpy(F)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_param_roundtrip_bit_exact(materials):
    _, params, tm = materials["elasticity"]
    ref = _np(params)
    back = interop.to_numpy(tm.params())
    flat_ref, tree_ref = jax.tree_util.tree_flatten(ref)
    flat_out, tree_out = jax.tree_util.tree_flatten(back)
    assert tree_ref == tree_out
    for a, b in zip(flat_out, flat_ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
