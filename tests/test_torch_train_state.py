"""The port's train-state file (``neuma_tpu_torch/train/checkpoint.py``)
against the JAX package's (``neuma_tpu/train/checkpoint.py``): a file the
port writes loads in JAX's ``load_train_state`` against a template from a
freshly initialized JAX trainer (``masked_radam`` over LoRA-adapted
trees), with every leaf bitwise equal; JAX's own file of those trees has
the same leaves in the same order and dtypes; and ``MetricsLogger`` rows
carry the same keys and values. Resuming the port from a JAX trainer's
file is ``test_torch_train.py::test_finetune_constitutive_resumes_a_jax_train_state``.
No rollout runs here.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.materials import InvariantFullMetaElasticity as JaxElasticity
from neuma_tpu.materials import MetaMaterialConfig as JaxConfig
from neuma_tpu.train import checkpoint as jckpt
from neuma_tpu.train import optim as joptim
from neuma_tpu_torch import interop
from neuma_tpu_torch.materials.meta import (
    InvariantFullMetaElasticity,
    InvariantFullMetaPlasticity,
    MetaMaterialConfig,
)
from neuma_tpu_torch.sim.mpm import trainable_params
from neuma_tpu_torch.train import checkpoint as tckpt
from neuma_tpu_torch.train import optim as toptim


def _materials(widths, weight_norm=False):
    gen = torch.Generator().manual_seed(0)
    cfg = MetaMaterialConfig(layer_widths=widths, norm="wn" if weight_norm else None)
    mats = []
    for cls in (InvariantFullMetaElasticity, InvariantFullMetaPlasticity):
        mat = cls.init(cfg, gen)
        mat.init_lora(gen, r=2, alpha=4.0)
        mats.append(mat)
    return mats


def _trained_states(mats, wd, steps=3):
    """Each material's RAdam state after ``steps`` updates with random
    gradients (and weight decay ``wd``), the leaves updated in place."""
    rng = np.random.default_rng(1)
    states = []
    for mat in mats:
        leaves = trainable_params(mat)
        opt = toptim.radam(lambda c: 0.01 / (c + 1), wd)
        state = opt.init(leaves)
        for _ in range(steps):
            grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                     for p in leaves]
            updates, state = opt.update(grads, state, leaves)
            toptim.apply_updates(leaves, updates)
        states.append(state)
    return states


def _jax_template(mats, wd):
    """A freshly initialized JAX trainer's state for trees of these shapes
    (``finetune_constitutive``'s template)."""
    params = {k: jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(m.params()))
              for k, m in zip("ep", mats)}
    jmat = JaxElasticity(JaxConfig())
    opt_state = tuple(
        joptim.masked_radam(lambda c: 0.0, jmat.lora_mask(params[k]), wd).init(params[k])
        for k in "ep")
    return {"step": 0, "params": {"e": jax.tree_util.tree_map(jnp.zeros_like, params["e"]),
                                  "p": jax.tree_util.tree_map(jnp.zeros_like, params["p"])},
            "opt_state": opt_state}


def _adam_state(state):
    for leaf in jax.tree_util.tree_leaves(state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(leaf, "nu"):
            return leaf.mu, leaf.nu
    raise AssertionError("no RAdam state")


@pytest.mark.parametrize("widths,wd,weight_norm", [
    ((16, 16), 0.0, False),   # optax.masked(radam): no chain
    ((8, 4, 6), 0.01, False),  # with weight decay: chain(add_decayed_weights, radam)
    ((5,), 0.0, True),         # weight-norm kernels (kernel_g, kernel_v)
])
def test_port_file_loads_in_jax(tmp_path, widths, wd, weight_norm):
    """Port -> JAX: the restored step, every parameter leaf and both
    materials' RAdam count, mu and nu equal the port's bitwise."""
    mats = _materials(widths, weight_norm)
    states = _trained_states(mats, wd)
    path = tmp_path / "train_state.npz"
    tckpt.save_train_state(path, 7, {"e": mats[0].params(), "p": mats[1].params()}, states)

    restored = jckpt.load_train_state(path, _jax_template(mats, wd))
    assert int(restored["step"]) == 7
    for key, mat in zip("ep", mats):
        want = interop.to_numpy(mat.params())
        got = jax.tree_util.tree_map(np.asarray, restored["params"][key])
        for layer_t, layer_j in zip(want["layers"] + [want["final"]],
                                    list(got["layers"]) + [got["final"]]):
            assert sorted(layer_t) == sorted(layer_j)
            for k in layer_t:
                np.testing.assert_array_equal(layer_j[k], layer_t[k])
    for state, j_state in zip(states, restored["opt_state"]):
        mu, nu = _adam_state(j_state)
        counts = [np.asarray(c) for c in jax.tree_util.tree_leaves(j_state) if np.ndim(c) == 0]
        assert [int(c) for c in counts] == [3, 3] and all(c.dtype == np.int32 for c in counts)
        port = interop.radam_state_to_numpy(state)
        for a, r in zip(port["mu"] + port["nu"], interop.lora_leaves(mu) + interop.lora_leaves(nu)):
            np.testing.assert_array_equal(np.asarray(r), a)


def test_jax_file_of_the_same_state_is_the_same_file(tmp_path):
    """JAX -> port: JAX's ``save_train_state`` of the restored trees writes
    the same leaves (order, dtype, values) as the port did, and the port's
    ``load_train_state`` reads it back to its own state bitwise."""
    mats = _materials((16, 16))
    states = _trained_states(mats, 0.01)
    port_path, jax_path = tmp_path / "port.npz", tmp_path / "jax.npz"
    params = {"e": mats[0].params(), "p": mats[1].params()}
    tckpt.save_train_state(port_path, 4, params, states)
    restored = jckpt.load_train_state(port_path, _jax_template(mats, 0.01))
    jckpt.save_train_state(jax_path, 4, restored["params"], opt_state=restored["opt_state"])
    a, b = np.load(port_path), np.load(jax_path)
    assert a.files == b.files
    for name in a.files:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name])

    step, got, got_states = tckpt.load_train_state(jax_path, params)
    assert step == 4
    for key in "ep":
        for x, y in zip(jax.tree_util.tree_leaves(got[key]),
                        jax.tree_util.tree_leaves(interop.to_numpy(params[key]))):
            np.testing.assert_array_equal(x, y)
    for s, want in zip(got_states, states):
        x, y = interop.radam_state_to_numpy(s), interop.radam_state_to_numpy(want)
        assert x["count"] == y["count"] == 3
        for u, v in zip(x["mu"] + x["nu"], y["mu"] + y["nu"]):
            np.testing.assert_array_equal(u, v)


def test_load_into_writes_every_leaf(tmp_path):
    """Restoring into fresh materials reproduces the saved trees bitwise."""
    mats = _materials((8, 8))
    states = _trained_states(mats, 0.0)
    path = tmp_path / "s.npz"
    tckpt.save_train_state(path, 2, {"e": mats[0].params(), "p": mats[1].params()}, states)
    fresh = _materials((8, 8))
    with torch.no_grad():
        for p in fresh[0].parameters():
            p.zero_()
    _, restored, _ = tckpt.load_train_state(path, {"e": fresh[0].params(), "p": fresh[1].params()})
    tckpt.load_into(fresh[0], restored["e"])
    for a, b in zip(fresh[0].parameters(), mats[0].parameters()):
        assert torch.equal(a, b)


def test_a_file_of_other_shapes_is_refused(tmp_path):
    mats = _materials((8, 8))
    path = tmp_path / "s.npz"
    tckpt.save_train_state(path, 2, {"e": mats[0].params(), "p": mats[1].params()},
                           _trained_states(mats, 0.0, steps=1))
    other = _materials((8, 9))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_train_state(path, {"e": other[0].params(), "p": other[1].params()})
    deeper = _materials((8, 8, 8))
    with pytest.raises(ValueError):
        tckpt.load_train_state(path, {"e": deeper[0].params(), "p": deeper[1].params()})


def test_metrics_logger_rows_match_jax(tmp_path):
    """The same calls write rows with the same keys and values (``time``
    is the wall clock of each call)."""
    rows = {}
    for name, cls in (("port", tckpt.MetricsLogger), ("jax", jckpt.MetricsLogger)):
        logger = cls(tmp_path / name / "metrics.jsonl")
        logger.log(1, stage=1.0, loss=np.float32(0.25), lr=torch.tensor(0.5))
        logger.log(2, stage=2.0, loss_rgb=0.125, grad_norm_elasticity=np.float64(3e-21))
        logger.close()
        rows[name] = [json.loads(line) for line in (tmp_path / name / "metrics.jsonl").open()]
    assert len(rows["port"]) == len(rows["jax"]) == 2
    for a, b in zip(rows["port"], rows["jax"]):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k != "time"} == {k: v for k, v in b.items() if k != "time"}
