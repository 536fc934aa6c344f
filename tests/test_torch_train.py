"""Port parity of the trainers and what they are built from,
``neuma_tpu_torch`` on the CPU against ``neuma_tpu`` and ``optax``: RAdam
(plain, with weight decay, masked), strict global-norm clipping, the
learning-rate schedules and the rollout-decay weights; the two training
stages (``optimize_init_velocity`` and ``finetune_constitutive``) for two
epochs each, and the port resuming the JAX trainer's train-state file
after its first epoch; the ``on_nonfinite`` policy on a poisoned
parameter; and the overflow guard.

The JAX trainer's masked optimizer (``optax.masked``) passes the frozen
leaves' gradients through as updates, and its clipping norm counts them,
where the reference (and the port) train the LoRA leaves alone. The
parity test therefore runs the JAX materials with their non-LoRA leaves
behind ``stop_gradient``: their gradients are then exactly zero, and the
JAX trainer computes what the reference does.
"""
import copy
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuma_tpu.train import grounding as jground
from neuma_tpu.train import optim as joptim
from neuma_tpu.train import schedulers as jsched
from neuma_tpu_torch import interop
from neuma_tpu_torch.train import grounding as tground
from neuma_tpu_torch.train import optim as toptim
from neuma_tpu_torch.train import schedulers as tsched

from test_torch_rollout_grad import make_scenes, scaled_err
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _leaves(seed, shapes=((4, 3), (3,), (2, 5))):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _adam_state(state):
    """The (mu, nu) of optax's RAdam inside a (possibly chained or masked) state."""
    for leaf in jax.tree_util.tree_leaves(state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(leaf, "nu"):
            return leaf.mu, leaf.nu
    raise AssertionError("no RAdam state")


SCHED = {"type": "cos", "max_steps": 6, "learning_rate_alpha": 0.1, "warm_up_end": 2}


@pytest.mark.parametrize("lr,wd", [(0.01, 0.0), ("schedule", 0.0), (0.02, 0.1)])
def test_radam_matches_optax_for_3_steps(lr, wd):
    """Updates and moments of three steps (a constant rate, a schedule of
    the step count, and weight decay): rtol 1e-6, the same float32
    formulas in another order of operations."""
    j_lr = jsched.fetch_schedule(SCHED, 0.05) if lr == "schedule" else lr
    t_lr = tsched.fetch_schedule(SCHED, 0.05) if lr == "schedule" else lr
    params = _leaves(0)
    j_opt, t_opt = joptim.radam(j_lr, wd), toptim.radam(t_lr, wd)
    j_state = j_opt.init(params)
    tp = [torch.from_numpy(p.copy()) for p in params]
    t_state = t_opt.init(tp)
    for step in range(3):
        grads = _leaves(10 + step)
        j_up, j_state = j_opt.update(grads, j_state, params)
        t_up, t_state = t_opt.update([torch.from_numpy(g) for g in grads], t_state, tp)
        for a, r in zip(t_up, j_up):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6, atol=1e-9)
        params = optax.apply_updates(params, j_up)
        toptim.apply_updates(tp, t_up)
    mu, nu = _adam_state(j_state)
    got = interop.radam_state_to_numpy(t_state)
    assert got["count"] == 3
    for a, r in zip(got["mu"] + got["nu"], list(mu) + list(nu)):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-6, atol=1e-12)


def test_radam_state_roundtrip():
    state = toptim.radam(0.1).init([torch.ones(3), torch.zeros(2)])
    back = interop.radam_state_from_numpy(**interop.radam_state_to_numpy(state))
    assert back.count == 0 and all(torch.equal(a, b) for a, b in zip(back.mu + back.nu,
                                                                         state.mu + state.nu))


def test_masked_radam_updates_only_the_mask():
    """Masked leaves: optax's RAdam update. Unmasked leaves: a zero update
    in the port (the reference's frozen parameters), where ``optax.masked``
    would pass the raw gradient through."""
    params, grads = _leaves(1), _leaves(2)
    mask = [True, False, True]
    j_up, _ = optax.masked(optax.radam(0.01), mask).update(grads, optax.masked(
        optax.radam(0.01), mask).init(params), params)
    t_opt = toptim.masked_radam(0.01, mask)
    tp = [torch.from_numpy(p.copy()) for p in params]
    t_up, t_state = t_opt.update([torch.from_numpy(g) for g in grads], t_opt.init(tp), tp)
    for a, r, m in zip(t_up, j_up, mask):
        if m:
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6)
        else:
            assert (a == 0).all() and np.array_equal(np.asarray(r), grads[1])
    assert t_state.mu[1] is None


@pytest.mark.parametrize("scale", [1e-3, 10.0, float("nan")])
def test_clip_by_global_norm_strict_matches_jax(scale):
    grads = [g * np.float32(scale) for g in _leaves(3)]
    r_clip, r_norm, r_bad = joptim.clip_by_global_norm_strict(grads, 1.0)
    t_clip, t_norm, t_bad = toptim.clip_by_global_norm_strict([torch.from_numpy(g) for g in grads], 1.0)
    assert bool(t_bad) == bool(r_bad) == (scale != scale)
    np.testing.assert_allclose(float(t_norm), float(r_norm), rtol=1e-6)
    for a, r in zip(t_clip, r_clip):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6)


@pytest.mark.parametrize("cfg", [
    {"type": "cos", "max_steps": 8, "learning_rate_alpha": 0.025},
    {"type": "cos", "max_steps": 8, "warm_up_end": 3},
    {"type": "exp", "max_steps": 8, "lr_final": 1e-4},
    {"type": "exp", "max_steps": 8, "lr_final": 1e-4, "warmup_steps": 3, "ramp": "cosine"},
    {"type": "exp", "max_steps": 8, "warmup_steps": 2},
])
def test_schedules_match_jax(cfg):
    j, t = jsched.fetch_schedule(cfg, 0.02), tsched.fetch_schedule(cfg, 0.02)
    for step in range(10):
        np.testing.assert_allclose(float(t(step)), float(j(step)), rtol=1e-6)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="not supported"):
        tsched.fetch_schedule({"type": "step"}, 0.1)


def test_decay_weights_match_jax():
    cfg = {"decay_init": 0.5, "decay_final": 1.0, "lambda_max_decay": 0.33}
    for epoch in (1, 3, 9):
        rate = tground.decay_rate_for_epoch(cfg, epoch, 10)
        assert rate == jground.decay_rate_for_epoch(cfg, epoch, 10)
        np.testing.assert_array_equal(tground.rollout_decay_weights(7, rate, 2).numpy(),
                                      np.asarray(jground.rollout_decay_weights(7, rate, 2)))


# --- the trainers against JAX -----------------------------------------------------


class _FrozenBase:
    """A JAX material whose non-LoRA leaves sit behind ``stop_gradient``."""

    def __init__(self, material):
        self.material = material

    def apply(self, params, F):
        mask = self.material.lora_mask(params)
        params = jax.tree_util.tree_map(
            lambda p, m: p if m else jax.lax.stop_gradient(p), params, mask)
        return self.material.apply(params, F)

    def lora_mask(self, params):
        return self.material.lora_mask(params)


def _trainer_scenes():
    jscene, tscene, gt = make_scenes(frames=2, substeps=1, exclude=(), n=300, size=32)
    jscene = dataclasses.replace(jscene, elasticity=_FrozenBase(jscene.elasticity),
                                 plasticity=_FrozenBase(jscene.plasticity))
    return jscene, tscene, gt


CFG = {
    "num_epochs": 2, "elasticity_lr": 0.02, "plasticity_lr": 0.01, "warmup_step": 1,
    "elasticity_wd": 0.01, "plasticity_wd": 0.01,
    # the scene's elasticity gradient norm is ~2e-13: this bound clips it
    "elasticity_grad_max_norm": 1e-14, "plasticity_grad_max_norm": 1.0,
    "elasticity_scheduler": {"type": "cos", "max_steps": 2},
    "plasticity_scheduler": {"type": "exp", "max_steps": 2, "lr_final": 1e-3},
    "decay_init": 0.5, "decay_final": 1.0, "decay_steps": 1, "lambda_max_decay": 0.33,
}
INIT_V = np.array([0.4, -0.2, 0.1], np.float32)


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    """Two JAX epochs of stage 2 that keep the train-state file. The
    checkpoint hook copies the file at epoch 2, before the trainer writes
    that epoch's state: the copy holds the state after epoch 1."""
    jscene, tscene, gt = _trainer_scenes()
    fresh = copy.deepcopy(tscene)
    folder = tmp_path_factory.mktemp("train_state")
    path, epoch1 = folder / "train_state.npz", folder / "epoch1.npz"

    def keep_epoch1(epoch, *_):
        if epoch == 2:
            shutil.copy(path, epoch1)

    pe, pp = jscene.elasticity_params, jscene.plasticity_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEUMA_SLAB_GRID", "interpret")
        ref = jground.finetune_constitutive(
            dataclasses.replace(jscene, gt_images=jnp.asarray(gt)), INIT_V, CFG, pe, pp,
            checkpoint_fn=keep_epoch1, train_state_path=path)
    return dict(jscene=jscene, tscene=tscene, fresh=fresh, gt=gt, ref=ref, epoch1=epoch1)


def _assert_lora_leaves_trained(t_params, j_params, j_start, tol):
    t_np, j_np = interop.to_numpy(t_params), jax.tree_util.tree_map(np.asarray, j_params)
    for a, r, r0 in zip(interop.lora_leaves(t_np), interop.lora_leaves(j_np),
                        interop.lora_leaves(jax.tree_util.tree_map(np.asarray, j_start))):
        assert not np.array_equal(r, r0), "the leaf trained"
        assert scaled_err(a, r) <= tol
    for layer_t, layer_j, layer_0 in zip(t_np["layers"] + [t_np["final"]],
                                         j_np["layers"] + [j_np["final"]],
                                         list(j_start["layers"]) + [j_start["final"]]):
        for k in ("kernel", "bias", "lora_scale"):
            if k in layer_0:
                np.testing.assert_array_equal(layer_j[k], np.asarray(layer_0[k]))
                np.testing.assert_array_equal(layer_t[k], np.asarray(layer_0[k]))


def test_finetune_constitutive_matches_jax(stage2):
    """Two epochs of stage 2: losses to a relative 1e-5, the clipping
    norms to 1e-4 and the final LoRA leaves to a scaled 1e-5 (the
    gradients agree to a scaled ~6e-5, see test_torch_rollout_grad.py, and
    enter the leaves scaled by the learning rate); every other leaf
    bitwise unchanged on both sides. The scene's material gradients are
    small (the stress enters the grid scaled by vol dt 4 inv_dx^2), so
    weight decay moves the leaves most."""
    jscene, ref = stage2["jscene"], stage2["ref"]
    ckpts = []
    out = tground.finetune_constitutive(
        stage2["tscene"], stage2["gt"], INIT_V, CFG, device="cpu",
        checkpoint_fn=lambda e, a, b, loss: ckpts.append(e))
    assert ckpts == [1, 2]
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-5)
    np.testing.assert_allclose(out.grad_norms_e, ref.grad_norms_e, rtol=1e-4)
    np.testing.assert_allclose(out.grad_norms_p, ref.grad_norms_p, rtol=1e-4)
    assert ref.grad_norms_e[0] > CFG["elasticity_grad_max_norm"], "the clip is active"
    for t_params, j_params, j_start in ((out.params_e, ref.params_e, jscene.elasticity_params),
                                        (out.params_p, ref.params_p, jscene.plasticity_params)):
        _assert_lora_leaves_trained(t_params, j_params, j_start, 1e-5)


def test_finetune_constitutive_resumes_a_jax_train_state(stage2, tmp_path):
    """The port resumes from the JAX trainer's file after epoch 1: the
    step, every parameter leaf and the RAdam moments it restores equal
    what the JAX package's ``load_train_state`` reads (bitwise), and its
    epoch 2 matches the JAX run's loss to a relative 1e-5 and its final
    LoRA leaves to the scaled 6.1e-5 of the rollout gradients."""
    from neuma_tpu.train.checkpoint import load_train_state as jax_load
    from neuma_tpu_torch.train.checkpoint import load_train_state

    jscene, ref, scene = stage2["jscene"], stage2["ref"], stage2["fresh"]
    pe, pp = jscene.elasticity_params, jscene.plasticity_params
    j_opt = lambda p, m: joptim.masked_radam(lambda c: 0.0, m.lora_mask(p), 0.01).init(p)
    template = {"step": 0, "params": {"e": pe, "p": pp},
                "opt_state": (j_opt(pe, jscene.elasticity), j_opt(pp, jscene.plasticity))}
    j_state = jax_load(stage2["epoch1"], template)
    step, params, states = load_train_state(
        stage2["epoch1"], {"e": scene.elasticity.params(), "p": scene.plasticity.params()})
    assert step == int(j_state["step"]) == 1
    for key in ("e", "p"):
        for a, r in zip(jax.tree_util.tree_leaves(params[key]),
                        jax.tree_util.tree_leaves(j_state["params"][key])):
            np.testing.assert_array_equal(a, np.asarray(r))
    for state, j_opt_state in zip(states, j_state["opt_state"]):
        mu, nu = _adam_state(j_opt_state)
        got = interop.radam_state_to_numpy(state)
        assert got["count"] == 1
        for a, r in zip(got["mu"] + got["nu"], interop.lora_leaves(mu) + interop.lora_leaves(nu)):
            np.testing.assert_array_equal(a, np.asarray(r))

    path = tmp_path / "train_state.npz"
    shutil.copy(stage2["epoch1"], path)
    out = tground.finetune_constitutive(scene, stage2["gt"], INIT_V, CFG, device="cpu",
                                        train_state_path=path, resume_state=True)
    np.testing.assert_allclose(out.losses, ref.losses[1:], rtol=1e-5)
    for t_params, j_params, j_start in ((out.params_e, ref.params_e, pe),
                                        (out.params_p, ref.params_p, pp)):
        _assert_lora_leaves_trained(t_params, j_params, j_start, 6.1e-5)


def test_optimize_init_velocity_matches_jax(monkeypatch):
    """Two epochs of stage 1 (the regularizer on from epoch 1, as
    ``int(0.1 * 2) = 0``): losses to a relative 1e-5 and the final
    velocity to 1e-6 absolute (steps of ~lr = 0.05)."""
    jscene, tscene, gt = _trainer_scenes()
    monkeypatch.setenv("NEUMA_SLAB_GRID", "interpret")
    j_sched, t_sched = (m.cosine_decay_schedule(0.05, 2) for m in (jsched, tsched))
    ref = jground.optimize_init_velocity(dataclasses.replace(jscene, gt_images=jnp.asarray(gt)),
                                         2, 0.05, j_sched, init_v0=INIT_V)
    out = tground.optimize_init_velocity(tscene, gt, 2, 0.05, t_sched, init_v0=INIT_V, device="cpu")
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-5)
    assert not np.allclose(out.init_v, INIT_V)
    np.testing.assert_allclose(out.init_v, ref.init_v, rtol=0, atol=1e-6)


# --- guards -------------------------------------------------------------------------


@pytest.fixture
def small_scene():
    kw = dict(n_particles=300, grid=32, substeps=1, width=32, height=32, n_views=1,
              force_mask=False, max_pairs=1 << 12, max_per_tile=64, layer_widths=(16, 16), lora_r=4)
    return lambda **over: tground.build_scene(**{**kw, **over}, device="cpu")


def _poison(scene):
    with torch.no_grad():
        scene.elasticity.mlp.layers[0].lora_b[0, 0] = float("nan")


def _cfg(epochs, **over):
    return {**CFG, "num_epochs": epochs, "elasticity_grad_max_norm": 1.0,
            "elasticity_wd": 0.0, "plasticity_wd": 0.0, **over}


GT = np.full((2, 1, 3, 32, 32), 0.3, np.float32)


def test_nonfinite_gradient_raises_by_default(small_scene):
    scene = small_scene()
    _poison(scene)
    with pytest.raises(tground.NonFiniteGradientError, match="epoch 1"):
        tground.finetune_constitutive(scene, GT, INIT_V, _cfg(2), device="cpu")


def test_nonfinite_gradient_skip_keeps_the_parameters(small_scene, capsys):
    """'skip' zeroes both nets' gradients on a bad epoch: the optimizer
    state advances, the parameters do not move, and a line goes to
    stderr; below the cap nothing raises."""
    scene = small_scene()
    _poison(scene)
    before = [p.detach().clone() for p in scene.plasticity.parameters()]
    res = tground.finetune_constitutive(
        scene, GT, INIT_V, _cfg(2, on_nonfinite="skip", max_nonfinite_skips=2), device="cpu")
    assert len(res.losses) == 2 and not np.isfinite(res.grad_norms_e).any()
    assert "update skipped (2/2)" in capsys.readouterr().err
    for a, b in zip(before, scene.plasticity.parameters()):
        assert torch.equal(a, b)


def test_nonfinite_gradient_skip_cap_raises(small_scene):
    scene = small_scene()
    _poison(scene)
    with pytest.raises(tground.NonFiniteGradientError, match="max_nonfinite_skips=1"):
        tground.finetune_constitutive(
            scene, GT, INIT_V, _cfg(3, on_nonfinite="skip", max_nonfinite_skips=1), device="cpu")


def test_unknown_nonfinite_policy_raises(small_scene):
    with pytest.raises(ValueError, match="on_nonfinite"):
        tground.finetune_constitutive(small_scene(), GT, INIT_V, _cfg(1, on_nonfinite="ignore"),
                                      device="cpu")


def test_pair_budget_overflow_raises(small_scene):
    scene = small_scene(max_pairs=64)
    with pytest.raises(tground.PairBudgetOverflowError, match="velocity epoch 1"):
        tground.optimize_init_velocity(scene, GT, 1, 0.01, tsched.cosine_decay_schedule(0.01, 1),
                                       device="cpu")
