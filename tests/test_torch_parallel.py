"""The port's scale-out on CPU gloo ranks: the halo-exchange grid,
the particle-sharded step and its adjoint, the rollout loss in halo mode
and in the particle-sharded replicated-grid mode, and the dry run.

Each world size is spawned once per module (``parallel.dryrun.spawn``,
a ``file://`` rendezvous under ``tmp_path``; each rank runs torch on one
thread) and runs every rank-side check in one go; the ranks return numpy
arrays through files, and the tests hold them to the same code in one
process. This module imports no JAX: the spawned ranks import it by name
to find their function. The JAX package's halo step is held against the
port's in ``tests/test_torch_halo.py``.

Bounds: the halo step against ``mpm_step`` at atol 2e-5 and rtol 1e-4
(JAX ``tests/test_halo.py``'s: the slab views add the grid in another
order), scaled 3e-5 per field for bins carried across steps; gradients
through a 3-step halo rollout within a scaled 2e-4 of the single-process
step's; the halo-mode rollout loss within rtol 1e-5 of the replicated
path and its LoRA and ``init_v`` gradients within a scaled 5e-4 (JAX
``test_halo_grid_mode_loss_and_grads_match_replicated``'s); the
particle-sharded step at atol 2e-5, rtol 1e-4, its input cotangents for
a seeded output cotangent within a scaled 5e-4 of ``mpm_step_diff``'s;
the replicated-grid rollout over a mesh within the halo mode's bounds of
one process.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from neuma_tpu_torch.core.types import MPMConstants, ParticleState, Statics
from neuma_tpu_torch.parallel import distributed, halo
from neuma_tpu_torch.parallel.distributed import Mesh
from neuma_tpu_torch.parallel.dryrun import build_tiny_scene, dryrun_multichip, spawn
from neuma_tpu_torch.parallel.sharding import (
    make_sharded_sim_step,
    pad_scene_particles,
    pad_to_multiple,
    shard_particles,
)
from neuma_tpu_torch.sim.mpm import mpm_step, mpm_step_diff, trainable_params
from neuma_tpu_torch.train.grounding import _sum_over_ranks, make_rollout_loss, rank_views
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


# --- scenes (numpy inputs; the same in every process) --------------------------


def scene_arrays(n=512, g=16, seed=0):
    """``tests/test_halo.py::make_scene``'s recipe: positions over the box,
    random v, C, F near I and stress, noslip."""
    rng = np.random.default_rng(seed)
    return dict(
        g=g, x=(0.02 + 0.96 * rng.random((n, 3))).astype(np.float32),
        v=(0.5 * rng.standard_normal((n, 3))).astype(np.float32),
        C=(0.1 * rng.standard_normal((n, 3, 3))).astype(np.float32),
        F=(np.eye(3)[None] + 0.02 * rng.standard_normal((n, 3, 3))).astype(np.float32),
        stress=(1e-3 * rng.standard_normal((n, 3, 3))).astype(np.float32),
    )


def torch_scene(a, bc="noslip"):
    n = a["x"].shape[0]
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32))
    constants = MPMConstants(num_grids=a["g"], bound=1, bc=bc, dt=f(1e-3), gravity=f([0, -9.8, 0]),
                             eps=f(6e-7))
    statics = Statics(vol=f(np.full(n, 2e-6)), rho=f(np.full(n, 1000.0)),
                      clip_bound=f(np.full(n, 0.1)), enabled=torch.ones(n, dtype=torch.int32))
    state = ParticleState(f(a["x"]), f(a["v"]), f(a["C"]), f(a["F"]))
    return constants, statics, state, f(a["stress"])


def _np(state):
    return {k: getattr(state, k).detach().numpy() for k in ("x", "v", "C", "F")}


STEP_CASES = [(16, "noslip"), (16, "freeslip"), (32, "noslip"), (32, "freeslip")]
SHARDED_GRIDS = (16, 32)  # the dense branch, the slab branch (K1-K3)


def grad_loss(st):
    return (st.x ** 2).sum() + (st.v * st.C[:, 0, 0:1]).sum()


def rollout_scene(grid=32, n_views=2, n_particles=96):
    """The rollout scene of the mesh tests: ``build_tiny_scene`` at
    ``grid`` with 96 particles spread over the box, LoRA r 4 with a
    non-zero ``lora_b``, 2 frames x 2 substeps, non-zero ground truth."""
    scene, gt = build_tiny_scene(n_particles=n_particles, grid=grid, frames=2, substeps=2,
                                 img=32, n_views=n_views, spread=0.7)
    gen = torch.Generator().manual_seed(2)
    for mat in (scene.elasticity, scene.plasticity):
        mat.init_lora(gen, r=4, alpha=8.0)
        with torch.no_grad():
            for name, p in mat.named_parameters():
                if "lora_b" in name:
                    p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    gt = torch.as_tensor(np.random.default_rng(3).random(gt.shape).astype(np.float32))
    return scene, gt


ROLLOUT_ARGS = (torch.tensor([0.4, -0.2, 0.1]), torch.tensor([1.0, 0.7]))
# chip_smoke.py phase 17's scene cut to CPU size (its widths shrunk too)
CHIP_SMALL = dict(n_particles=300, grid=32, substeps=1, width=32, height=32, max_pairs=1 << 14,
                  layer_widths=(8, 8), lora_r=2)


def rollout_value_and_grad(scene, gt):
    params = trainable_params(scene.elasticity) + trainable_params(scene.plasticity)
    init_v = ROLLOUT_ARGS[0].clone().requires_grad_(True)
    loss, aux = make_rollout_loss(scene, device="cpu")(init_v, ROLLOUT_ARGS[1], gt)
    grads = _sum_over_ranks(scene, torch.autograd.grad(loss, params + [init_v]))
    return float(loss.detach()), [g.numpy() for g in grads], {k: bool(v) for k, v in aux.items()}


TRAIN_CFG = {"num_epochs": 1, "elasticity_lr": 0.01, "plasticity_lr": 0.01,
             "elasticity_scheduler": {"type": "cos"}, "plasticity_scheduler": {"type": "cos"},
             "decay_init": 1.0, "decay_final": 1.0}


def run_trainers(scene, gt):
    """One epoch of each trainer (the velocity stage with its sparsity
    regularizer on): the stage-1 velocity and the LoRA leaves after."""
    from neuma_tpu_torch.train.grounding import finetune_constitutive, optimize_init_velocity
    from neuma_tpu_torch.train.schedulers import cosine_decay_schedule

    vel = optimize_init_velocity(scene, gt, 2, 0.05, cosine_decay_schedule(0.05, 2),
                                 lambda_reg=0.5, init_v0=ROLLOUT_ARGS[0].numpy(), device="cpu")
    out = finetune_constitutive(scene, gt, vel.init_v, TRAIN_CFG, device="cpu")
    return vel.init_v, vel.losses, out.losses, [p.detach().numpy().copy() for p in (
        trainable_params(scene.elasticity) + trainable_params(scene.plasticity))]


def step_cotangents(n, seed=21):
    """A seeded output cotangent on (x, v, C, F) of ``n`` particles."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((n, 3), (n, 3), (n, 3, 3), (n, 3, 3))]


def step_vjp(step, statics, state, stress, cotangents):
    """``step``'s new state and the cotangents of (x, v, C, F, stress)
    for ``cotangents``, as tensors."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (*_state(state), stress)]
    new = step(statics, ParticleState(*leaves[:4]), leaves[4])
    grads = torch.autograd.grad(list(_state(new)), leaves, cotangents)
    return [t.detach() for t in _state(new)], list(grads)


def _state(s):
    return (s.x, s.v, s.C, s.F)


# --- what each rank runs --------------------------------------------------------


def sharded_step_outputs(arrays_list, mesh):
    """``make_sharded_sim_step`` on each scene, on this rank's shard: the
    new state and the input cotangents for ``step_cotangents``, each
    gathered over the ranks, as numpy."""
    out = []
    for a in arrays_list:
        c, statics, state, stress = torch_scene(a)
        cts = [shard_particles(torch.from_numpy(t), mesh) for t in step_cotangents(len(a["x"]))]
        new, grads = step_vjp(make_sharded_sim_step(c, mesh), shard_particles(statics, mesh),
                              shard_particles(state, mesh), shard_particles(stress, mesh), cts)
        whole = lambda t: torch.cat(mesh.all_gather(t.contiguous())).numpy()
        out.append(([whole(t) for t in new], [whole(g) for g in grads]))
    return out


def sharded_step_rank(arrays_list):
    """A world's sharded steps on the given scenes (``tests/test_torch_halo.py``)."""
    return sharded_step_outputs(arrays_list, Mesh(("dp",), (dist.get_world_size(),)))



def halo_step_outputs(arrays_list, mesh, tol=0, capacity=None):
    """One ``make_halo_mpm_step`` per scene: (state, overflow) as numpy."""
    out = []
    for a, bc in arrays_list:
        c, statics, state, stress = torch_scene(a, bc)
        new, ovf = halo.make_halo_mpm_step(c, statics, mesh, capacity=capacity, tol=tol)(
            state, stress)
        out.append((_np(new), bool(ovf)))
    return out


def halo_step_rank(arrays_list):
    """A world's halo steps on the given scenes (``tests/test_torch_halo.py``)."""
    return halo_step_outputs(arrays_list, Mesh(("dp",), (dist.get_world_size(),)))


def rank_checks():
    """Every rank-side check of one world (see the tests below)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = Mesh(("dp",), (world,))
    res = {"backend": dist.get_backend(), "rank": rank}

    # the halo step, one repartition per step, against mpm_step
    cases = [(scene_arrays(g=g), bc) for g, bc in STEP_CASES]
    cases.append((scene_arrays(n=1024, g=70, seed=1), "noslip"))
    res["steps"] = halo_step_outputs(cases, mesh)

    # gradients through 3 halo steps: rank 0's loss counts, the others'
    # backward runs the collectives; the ranks' gradients are added
    res["grads"] = {}
    for g in (16, 32):
        c, statics, state, stress = torch_scene(scene_arrays(n=256, g=g))
        step = halo.make_halo_mpm_step(c, statics, mesh)
        v0 = state.v.clone().requires_grad_(True)
        s_in = stress.clone().requires_grad_(True)
        st, ovf = dataclasses.replace(state, v=v0), False
        for _ in range(3):
            st, o = step(st, s_in)
            ovf |= bool(o)
        loss = grad_loss(st) * (1.0 if rank == 0 else 0.0)
        gv, gs = (mesh.all_sum(t) for t in torch.autograd.grad(loss, [v0, s_in]))
        res["grads"][g] = (float(loss.detach()), gv.numpy(), gs.numpy(), ovf)

    # the margin flag: a foreign bin, and drift past the tolerance
    c, statics, state, stress = torch_scene(scene_arrays(n=256, g=32))
    part = halo.partition_particles(c, state, statics, world, capacity=256)
    foreign = (mesh.coord("dp") - 1) % world
    bst, bstat, valid = halo.shard_of(part, foreign)
    stress_b = torch.where(valid[:, None, None], stress[part.perm[foreign]], 0.0)
    _, bad = halo.make_halo_sim_step(c, mesh)(bstat, bst, stress_b)
    res["margin_foreign"] = bool(mesh.any(bad))
    bst, bstat, valid = halo.shard_of(part, mesh.coord("dp"))
    stress_b = torch.where(valid[:, None, None], stress[part.perm[mesh.coord("dp")]], 0.0)
    moved = dataclasses.replace(bst, x=bst.x + torch.tensor([3.0 / c.inv_dx, 0.0, 0.0]))
    _, bad = halo.make_halo_bins_step(c, mesh, tol=2)(bstat, moved, stress_b)
    res["margin_drift"] = bool(mesh.any(bad))
    _, bad = halo.make_halo_bins_step(c, mesh, tol=2)(bstat, bst, stress_b)
    res["margin_own"] = bool(mesh.any(bad))

    # bins carried over 4 drifting steps (tol 2) against per-step repartitioning
    drift = 0.25 / (float(c.dt) * c.inv_dx)
    state = dataclasses.replace(state, v=torch.tensor([drift, 0.0, 0.0]).expand(256, 3).clone())
    part = halo.partition_particles(c, state, statics, world, capacity=256)
    shard = mesh.coord("dp")
    bins, bstat, valid = halo.shard_of(part, shard)
    stress_b = torch.where(valid[:, None, None], stress[part.perm[shard]], 0.0)
    bins_step = halo.make_halo_bins_step(c, mesh, tol=2)
    margins = []
    for _ in range(4):
        bins, bad = bins_step(bstat, bins, stress_b)
        margins.append(bool(mesh.any(bad)))
    carried = halo.unpartition(dataclasses.replace(part, state=halo.gather_bins(mesh, "dp", bins)),
                               256, state)
    per_step, step = state, halo.make_halo_mpm_step(c, statics, mesh)
    for _ in range(4):
        per_step, _ = step(per_step, stress)
    res["carried"] = (_np(carried), _np(per_step), margins)

    # the particle-sharded step (replicated grid) and its vjp, dense and slab grids
    res["sharded"] = dict(zip(SHARDED_GRIDS, sharded_step_outputs(
        [scene_arrays(n=512, g=g) for g in SHARDED_GRIDS], mesh)))

    # the halo-mode rollout loss and its gradients, 2 x 1 or 2 x 2 (there
    # with the view axis first: views 0 and 1 land on ranks 0 and 2)
    scene, gt = rollout_scene()
    rmesh = Mesh(("dp", "vp"), (2, 1)) if world == 2 else Mesh(("vp", "dp"), (2, 2))
    scene = dataclasses.replace(scene, mesh=rmesh, particle_axis="dp", view_axis="vp",
                                grid_mode="halo", halo_capacity=96)
    res["rollout"] = rollout_value_and_grad(scene, gt)
    res["rollout_rerun"] = rollout_value_and_grad(scene, gt)
    res["views"] = rank_views(2, rmesh, "vp")

    # the replicated-grid rollout over particle shards: the same meshes
    # (with a vp axis the sim is replicated along it), then one axis
    # without a view axis on a scene whose 93 particles are padded
    scene = dataclasses.replace(scene, grid_mode="replicated", halo_capacity=None)
    res["replicated"] = rollout_value_and_grad(scene, gt)
    res["replicated_rerun"] = rollout_value_and_grad(scene, gt)
    res["replicated_remat"] = rollout_value_and_grad(dataclasses.replace(scene, remat="frame"), gt)
    scene, gt = rollout_scene(n_particles=93)
    res["replicated_padded"] = rollout_value_and_grad(dataclasses.replace(
        scene, mesh=mesh, particle_axis="dp"), gt)

    res["dryrun"] = dryrun_multichip(world, device="cpu")
    if world == 2:
        # the card script's phase 17 rank, at a small shape on the CPU
        import chip_smoke

        res["chip_rank"] = chip_smoke.mesh_rank("cpu", CHIP_SMALL)
        res["chip_rank_replicated"] = chip_smoke.mesh_rank("cpu", CHIP_SMALL,
                                                           grid_mode="replicated")
        res["trainers"] = {}
        for mode in ("halo", "replicated"):  # a fresh scene each: the trainers update its LoRA
            scene, gt = rollout_scene()
            res["trainers"][mode] = run_trainers(dataclasses.replace(
                scene, mesh=Mesh(("dp",), (2,)), particle_axis="dp", grid_mode=mode), gt)
    return res


# --- the tests ------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, spawned at once (each rank runs one torch thread)."""
    base = tmp_path_factory.mktemp("worlds")
    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(spawn, rank_checks, n, device="cpu", workdir=base)
                   for n in (2, 4)}
        return {n: f.result() for n, f in futures.items()}


def test_initialize_follows_the_device(worlds):
    """gloo for CPU ranks, and no group (and no refusal) in one process;
    a card asked for and absent raises instead of falling back to gloo."""
    assert {r["backend"] for rs in worlds.values() for r in rs} == {"gloo"}
    assert not distributed.initialize(device="cpu") and not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.initialize(device="cuda", world_size=2, rank=0,
                                   init_method="file:///nonexistent/rendezvous")
    assert not dist.is_initialized()


def test_mesh_of_one_process():
    """Without a group the world is one rank: every collective is the
    identity, and a neighbour that is this rank is a local copy."""
    mesh = Mesh(("dp", "vp"), (1, 1))
    t = torch.arange(6.0).reshape(2, 3)
    assert mesh.coord("dp") == 0 and mesh.ranks("vp") == [0]
    assert torch.equal(mesh.all_sum(t), t) and torch.equal(mesh.all_gather(t)[0], t)
    fr, fl = mesh.exchange("dp", t, t + 1)
    assert torch.equal(fr, t) and torch.equal(fl, t + 1) and fr is not t
    with pytest.raises(ValueError, match="ranks"):
        Mesh(("dp",), (2,))


@pytest.mark.parametrize("world", [2, 4])
def test_halo_step_matches_single_process(worlds, world):
    """Every rank ends with the same global state, equal to ``mpm_step``'s
    (g 16: the dense view, g 32: K1/K2's views, g 70 over 4: the partial
    last slab, 16 of 18 rows)."""
    cases = [(scene_arrays(g=g), bc) for g, bc in STEP_CASES]
    cases.append((scene_arrays(n=1024, g=70, seed=1), "noslip"))
    ranks = worlds[world]
    for i, (a, bc) in enumerate(cases):
        c, statics, state, stress = torch_scene(a, bc)
        ref = _np(mpm_step(c, statics, state, stress))
        outs = [r["steps"][i] for r in ranks]
        for out, ovf in outs:
            assert not ovf
            for k in ref:
                np.testing.assert_array_equal(out[k], outs[0][0][k])
                np.testing.assert_allclose(out[k], ref[k], atol=2e-5, rtol=1e-4,
                                           err_msg=f"{k} (g={a['g']}, {bc}, {world} ranks)")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("g", [16, 32])
def test_halo_rollout_gradients_match_single_process(worlds, world, g):
    c, statics, state, stress = torch_scene(scene_arrays(n=256, g=g))
    v0 = state.v.clone().requires_grad_(True)
    s_in = stress.clone().requires_grad_(True)
    st = dataclasses.replace(state, v=v0)
    for _ in range(3):
        st = mpm_step_diff(c, statics, st, s_in)
    loss = grad_loss(st)
    gv, gs = torch.autograd.grad(loss, [v0, s_in])
    for r in worlds[world]:
        l_h, gv_h, gs_h, ovf = r["grads"][g]
        assert not ovf
        if r["rank"] == 0:
            np.testing.assert_allclose(l_h, float(loss.detach()), rtol=1e-5)
        for a, b, name in ((gv_h, gv.numpy(), "init v"), (gs_h, gs.numpy(), "stress")):
            scale = max(np.abs(b).max(), 1e-8)
            np.testing.assert_allclose(a / scale, b / scale, atol=2e-4, err_msg=f"{name} (g={g})")


@pytest.mark.parametrize("world", [2, 4])
def test_margin_flag(worlds, world):
    """A bin stepped on the wrong rank, or pushed 3 cells (> tol 2) past
    its slab, trips the flag; the own bin does not."""
    for r in worlds[world]:
        assert r["margin_foreign"] and r["margin_drift"] and not r["margin_own"]


@pytest.mark.parametrize("world", [2, 4])
def test_bins_carried_match_per_step_repartition(worlds, world):
    c, statics, state, stress = torch_scene(scene_arrays(n=256, g=32))
    drift = 0.25 / (float(c.dt) * c.inv_dx)
    state = dataclasses.replace(state, v=torch.tensor([drift, 0.0, 0.0]).expand(256, 3).clone())
    ref = state
    for _ in range(4):
        ref = mpm_step(c, statics, ref, stress)
    ref = _np(ref)
    for r in worlds[world]:
        carried, per_step, margins = r["carried"]
        assert not any(margins)
        for k in ref:
            scale = max(np.abs(ref[k]).max(), 1e-8)
            for got in (carried[k], per_step[k]):
                np.testing.assert_allclose(got / scale, ref[k] / scale, atol=3e-5, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_sim_step_matches_single_step(worlds, world):
    """The new state, gathered, is ``mpm_step``'s on every rank."""
    for g in SHARDED_GRIDS:
        c, statics, state, stress = torch_scene(scene_arrays(n=512, g=g))
        ref = _np(mpm_step(c, statics, state, stress))
        for r in worlds[world]:
            for k, out in zip(ref, r["sharded"][g][0]):
                np.testing.assert_allclose(out, ref[k], atol=2e-5, rtol=1e-4,
                                           err_msg=f"{k} (g={g})")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("g", SHARDED_GRIDS)
def test_sharded_sim_step_vjp_matches_single_step(worlds, world, g):
    """The sharded step's adjoint (the ranks' grid cotangents added once,
    K3 in both roles on each shard): the cotangents of (x, v, C, F,
    stress) for a seeded output cotangent, gathered, within a scaled 5e-4
    of the single-process ``mpm_step_diff``'s (measured: at most 8.6e-7;
    the new state within 3.9e-6)."""
    c, statics, state, stress = torch_scene(scene_arrays(n=512, g=g))
    cts = [torch.from_numpy(t) for t in step_cotangents(512)]
    _, ref = step_vjp(lambda st, s, sr: mpm_step_diff(c, st, s, sr), statics, state, stress, cts)
    for r in worlds[world]:
        for name, out, b in zip(("x", "v", "C", "F", "stress"), r["sharded"][g][1], ref):
            b = b.numpy()
            assert np.abs(b).max() > 0
            scale = np.abs(b).max()
            np.testing.assert_allclose(out / scale, b / scale, atol=5e-4, err_msg=f"d {name}")


@pytest.fixture(scope="module")
def replicated_rollout():
    scene, gt = rollout_scene()
    return rollout_value_and_grad(scene, gt)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_rollout_loss_and_grads_match_replicated(worlds, replicated_rollout, world):
    """2 x 1 and 2 x 2 meshes (two views: on 4 ranks two ranks render
    none): the loss, every LoRA leaf's and ``init_v``'s gradient summed
    over the world, no overflow, and a bitwise rerun."""
    ref_loss, ref_grads, ref_aux = replicated_rollout
    assert ref_aux == {"overflow": False, "halo_overflow": False}
    for r in worlds[world]:
        loss, grads, aux = r["rollout"]
        assert aux == ref_aux
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        for a, b in zip(grads, ref_grads):
            scale = max(np.abs(b).max(), 1e-8)
            np.testing.assert_allclose(a / scale, b / scale, atol=5e-4)
        rerun = r["rollout_rerun"]
        assert rerun[0] == loss and all(np.array_equal(a, b) for a, b in zip(rerun[1], grads))
    assert [r["views"] for r in worlds[world]] == ([[0], [1]] if world == 2
                                                   else [[0], [], [1], []])


@pytest.fixture(scope="module")
def replicated_rollout_padded():
    return rollout_value_and_grad(*rollout_scene(n_particles=93))


def _hold_rollout(out, ref):
    loss, grads, aux = out
    ref_loss, ref_grads, ref_aux = ref
    assert aux == ref_aux == {"overflow": False, "halo_overflow": False}
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    for a, b in zip(grads, ref_grads):
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_replicated_rollout_over_a_mesh_matches_one_process(worlds, replicated_rollout, world):
    """``grid_mode="replicated"`` over the halo test's 2 x 1 and 2 x 2
    meshes (particles split on dp, views on vp): the loss, every LoRA
    leaf's and ``init_v``'s gradient summed over the world, no overflow,
    every rank's loss equal, and a bitwise rerun (measured: loss 9.6e-8
    relative, gradients 7.9e-8 scaled); likewise with the per-frame remat
    (the sim's collectives rerun in the backward)."""
    outs = [r["replicated"] for r in worlds[world]]
    for r in worlds[world]:
        _hold_rollout(r["replicated"], replicated_rollout)
        _hold_rollout(r["replicated_remat"], replicated_rollout)
        rerun = r["replicated_rerun"]
        assert rerun[0] == r["replicated"][0]
        assert all(np.array_equal(a, b) for a, b in zip(rerun[1], r["replicated"][1]))
    assert len({o[0] for o in outs}) == 1


@pytest.mark.parametrize("world", [2, 4])
def test_replicated_rollout_pads_the_particles(worlds, replicated_rollout_padded, world):
    """One particle axis over the world, no view axis (views round-robin,
    on 4 ranks two render none), 93 particles padded to 94 or 96 with
    disabled ones: the same loss and summed gradients as one process
    (measured: 1.0e-7 relative, 7.6e-8 scaled)."""
    for r in worlds[world]:
        _hold_rollout(r["replicated_padded"], replicated_rollout_padded)


@pytest.mark.parametrize("world,mesh", [(2, (2, 1)), (4, (2, 2))])
def test_dryrun_multichip_on_the_cpu(worlds, world, mesh):
    """``dryrun_multichip`` in a running world of 2 (mesh 2 x 1) and of 4
    (mesh 2 x 2); ``python -m neuma_tpu_torch.parallel.dryrun`` spawns
    its own (``chip_smoke.py`` phase 17d on the card)."""
    outs = [r["dryrun"] for r in worlds[world]]
    assert (outs[0]["dp"], outs[0]["vp"]) == mesh
    assert f"dryrun_multichip({world}): one sharded train step OK" in outs[0]["line"]
    assert all(np.isfinite(o["loss"]) and o["loss"] == outs[0]["loss"] for o in outs)
    # at rest (init_v 0, F = I) the LoRA gradient is zero up to rounding, as
    # in the JAX package's dry run, which checks the loss alone
    assert all(not o["overflow"] and not o["halo_overflow"] and np.isfinite(o["grad_norm"])
               for o in outs)


@pytest.fixture(scope="module")
def chip_small_single():
    """``chip_smoke.halo_value_and_grad`` on the small scene in one process."""
    import chip_smoke

    scene, v0, gt = chip_smoke.halo_scene("cpu", CHIP_SMALL)
    return chip_smoke.halo_value_and_grad(scene, "cpu")[0](v0, gt)


def _hold_chip_rank(ranks, single):
    loss, aux, grads = single
    assert [r["views"] for r in ranks] == [[0, 2], [1]]
    for r in ranks:
        assert r["bitwise"] and not r["overflow"] and not r["halo_overflow"]
        np.testing.assert_allclose(float(r["loss"]), float(loss), rtol=1e-5)
        for a, b in zip(r["grads"], grads):
            scale = max(float(b.abs().max()), 1e-8)
            np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, atol=5e-4)


def test_chip_smoke_halo_rank_on_the_cpu(worlds, chip_small_single):
    """``chip_smoke.mesh_rank`` (phase 17b's rank side) at a small shape on
    2 CPU ranks: the ranks agree, reruns are bitwise, nothing overflows,
    and the loss and gradients match the single process's
    (``chip_smoke.halo_value_and_grad`` on the replicated scene)."""
    ranks = [r["chip_rank"] for r in worlds[2]]
    _hold_chip_rank(ranks, chip_small_single)
    for r in ranks:
        assert r["capacity"] >= 1.25 * max(r["slab_counts"]) and sum(r["slab_counts"]) == 300


def test_chip_smoke_replicated_rank_on_the_cpu(worlds, chip_small_single):
    """Phase 18's rank side (``mesh_rank(grid_mode="replicated")``) as
    above, with shards of 150 particles and one grid sum per substep
    forward (K1's per-block sums: 27 blocks x 4 x 16^3 f32) and one more
    in the backward."""
    ranks = [r["chip_rank_replicated"] for r in worlds[2]]
    _hold_chip_rank(ranks, chip_small_single)
    for r in ranks:
        assert r["slab_counts"] == [150, 150] and r["capacity"] == 150
        assert r["fwd_exchange_per_substep"]["calls"] == 1
        assert r["fwd_exchange_per_substep"]["bytes"] == 27 * 4 * 16 ** 3 * 4
        assert r["vg_exchange_per_substep"]["calls"] == 2


def test_trainers_over_two_ranks_match_one_process(worlds):
    """``optimize_init_velocity`` (2 epochs, the regularizer on from the
    first) and ``finetune_constitutive`` (1 epoch) in halo mode and in
    the particle-sharded replicated mode on 2 ranks: both ranks end with
    the same velocity and LoRA leaves, those of the single-process
    trainers (the ranks' gradients are added, the regularizer's once)."""
    scene, gt = rollout_scene()
    ref_v, ref_vl, ref_l, ref_p = run_trainers(scene, gt)
    for mode in ("halo", "replicated"):
        outs = [r["trainers"][mode] for r in worlds[2]]
        for v, vl, ll, params in outs:
            np.testing.assert_allclose(v, ref_v, rtol=1e-5, atol=1e-7, err_msg=mode)
            np.testing.assert_allclose(vl, ref_vl, rtol=1e-5, err_msg=mode)
            np.testing.assert_allclose(ll, ref_l, rtol=1e-5, err_msg=mode)
            for a, b in zip(params, ref_p):
                scale = max(np.abs(b).max(), 1e-8)
                np.testing.assert_allclose(a / scale, b / scale, atol=1e-5, err_msg=mode)
        assert all(np.array_equal(a, b) for a, b in zip(outs[0][3], outs[1][3]))


def test_halo_mode_requires_a_mesh(replicated_rollout):
    """Halo mode without a mesh, and a view axis equal to the particle
    axis in either mode, are refused; the replicated mode over a mesh of
    one builds and gives one process's loss and gradients bit for bit,
    with the particle axis set or not."""
    scene, gt = rollout_scene()
    with pytest.raises(ValueError, match="requires scene.mesh"):
        make_rollout_loss(dataclasses.replace(scene, grid_mode="halo"), device="cpu")
    one = Mesh(("dp",), (1,))
    ref = replicated_rollout
    for axis in (None, "dp"):
        out = rollout_value_and_grad(dataclasses.replace(scene, mesh=one, particle_axis=axis), gt)
        assert out[0] == ref[0] and out[2] == ref[2]
        assert all(np.array_equal(a, b) for a, b in zip(out[1], ref[1]))
    for mode in ("halo", "replicated"):
        with pytest.raises(ValueError, match="replicated along the view axis"):
            make_rollout_loss(dataclasses.replace(scene, mesh=one, grid_mode=mode,
                                                  particle_axis="dp", view_axis="dp"),
                              device="cpu")


@pytest.mark.parametrize("names", [("dp", "vp"), ("vp", "dp")])
def test_rank_views_follow_the_view_axis(names):
    """Each view on one rank of a 2 x 3 world: round-robin over the ranks
    without a view axis; with one, view ``v`` on the ranks at ``v % 2`` on
    it, and among those on ``(v // 2) % 3`` along the other axis."""
    sizes = dict(dp=3, vp=2)
    shape = tuple(sizes[a] for a in names)
    n_views = 9
    owners = {}
    for rank in range(6):
        where = dict(zip(names, np.unravel_index(rank, shape)))
        mesh = SimpleNamespace(rank=rank, world=6, axis_names=names, shape=sizes,
                               coord=lambda a, where=where: int(where[a]))
        assert rank_views(n_views, mesh) == [v for v in range(n_views) if v % 6 == rank]
        for v in rank_views(n_views, mesh, "vp"):
            assert v not in owners
            owners[v] = (int(where["vp"]), int(where["dp"]))
    assert owners == {v: (v % 2, (v // 2) % 3) for v in range(n_views)}
    with pytest.raises(ValueError, match="not an axis"):
        rank_views(n_views, mesh, "tp")


def test_padding_helpers():
    a, n = pad_to_multiple(torch.ones(5, 3), 4)
    assert n == 5 and a.shape == (8, 3) and float(a[5:].abs().sum()) == 0.0
    c, statics, state, _ = torch_scene(scene_arrays(n=6))
    st, stat, n = pad_scene_particles(state, statics, 4)
    assert n == 6 and st.x.shape[0] == 8
    assert torch.equal(st.F[6:], torch.eye(3).expand(2, 3, 3)) and int(stat.enabled[6:].sum()) == 0
