"""Port parity of the training slice: value and gradient of the rollout
loss (elasticity MLP -> slab MPM -> plasticity MLP -> binding ->
Particle-GS -> L2, full BPTT) with respect to both materials' LoRA
leaves and ``init_v``, ``neuma_tpu_torch`` on the CPU against
``jax.value_and_grad`` of the ``neuma_tpu`` loss with its Pallas kernels
in interpret mode (``NEUMA_SLAB_GRID=interpret``,
``backend="pallas_interpret"``), so the JAX backward runs K1, K3 and K5
interpreted.

The scene: 600 particles, 32^3 grid, one 48x48 view, SH degree 1, MLP
widths (16, 16) with LoRA r = 4 and non-zero ``lora_b``, 3 frames x 2
substeps with frame 1 excluded and decay weights, non-zero ground truth.
Tolerances: the loss to a relative 1e-5 and each gradient leaf to a
scaled max error of 1e-4 (the interpret-mode kernels run the TPU's bf16
"high3" splits, ~3e-5 scaled per step, and the composite's chunked
suffix products round otherwise than the port's sequential division).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.core.types import MPMConstants, Statics
from neuma_tpu.materials.meta import (
    InvariantFullMetaElasticity as JaxElasticity,
    InvariantFullMetaPlasticity as JaxPlasticity,
    MetaMaterialConfig as JaxMaterialConfig,
)
from neuma_tpu.nn import mlp as jmlp
from neuma_tpu.render.binding import compute_binding_table
from neuma_tpu.render.camera import Camera as JaxCamera
from neuma_tpu.render.gaussians import create_from_points
from neuma_tpu.render.rasterize import RasterConfig as JaxRasterConfig
from neuma_tpu.train import grounding as jground
from neuma_tpu_torch import interop
from neuma_tpu_torch.materials.meta import (
    InvariantFullMetaElasticity,
    InvariantFullMetaPlasticity,
    MetaMaterialConfig,
)
from neuma_tpu_torch.render.rasterize import RasterConfig
from neuma_tpu_torch.sim.mpm import trainable_params
from neuma_tpu_torch.train import grounding as tground
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, G, SIZE, FRAMES, SUBSTEPS = 600, 32, 48, 3, 2
INIT_V = np.array([0.4, -0.2, 0.1], np.float32)
WEIGHTS = np.array([1.0, 0.7, 0.49], np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lora(params, seed):
    params = jmlp.add_lora_to_mlp(params, jax.random.PRNGKey(seed), 4, 8.0)
    rng = np.random.default_rng(seed)

    def fill(p):
        p = dict(p)
        p["lora_b"] = jnp.asarray(0.2 * rng.standard_normal(p["lora_b"].shape).astype(np.float32))
        return p

    return {"layers": [fill(p) for p in params["layers"]], "final": fill(params["final"])}


def make_scenes(frames=FRAMES, substeps=SUBSTEPS, exclude=(1,), n=N, size=SIZE):
    """JAX and port scenes from the same numpy inputs, and the GT."""
    rng = np.random.default_rng(0)
    pts = (0.4 + 0.2 * rng.random((n, 3))).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    constants = MPMConstants(
        num_grids=G, bound=1, bc="noslip", dt=jnp.float32(1e-3 / substeps),
        gravity=jnp.asarray([0.0, -9.8, 0.0], jnp.float32), eps=jnp.float32(6e-7),
    )
    statics = Statics(
        vol=jnp.full((n,), 2e-8, jnp.float32), rho=jnp.full((n,), 1000.0, jnp.float32),
        clip_bound=jnp.full((n,), 0.1, jnp.float32), enabled=jnp.ones((n,), jnp.int32),
    )
    mcfg = JaxMaterialConfig(layer_widths=(16, 16))
    elasticity, plasticity = JaxElasticity(mcfg), JaxPlasticity(mcfg)
    pe = _lora(jax.tree_util.tree_map(lambda a: 0.5 * a, elasticity.init(jax.random.PRNGKey(0))), 1)
    pp = _lora(jax.tree_util.tree_map(lambda a: 0.5 * a, plasticity.init(jax.random.PRNGKey(2))), 3)
    gaussians = create_from_points(pts, colors, sh_degree=1)
    table = compute_binding_table(gaussians, jnp.asarray(pts), max_particles=10)
    cam = JaxCamera.look_at(eye=np.array([0.5, 0.55, -0.6]), target=np.array([0.5, 0.5, 0.5]),
                            fov=0.8, width=size, height=size)
    gt = (0.5 + 0.3 * rng.standard_normal((frames, 1, 3, size, size))).astype(np.float32)
    common = dict(size=np.ones(3), center=np.zeros(3), substeps=substeps, pixel_loss="l2",
                  exclude_frames=exclude)
    jscene = jground.GroundingScene(
        constants=constants, statics=statics, elasticity=elasticity, plasticity=plasticity,
        elasticity_params=pe, plasticity_params=pp, gaussians=gaussians, binding=table,
        cameras=[cam], gt_images=jnp.asarray(gt), init_x=jnp.asarray(pts),
        background=jnp.ones(3), remat="none",
        raster_cfg=JaxRasterConfig(max_pairs=4096, backend="pallas_interpret"), **common,
    )
    tcfg = MetaMaterialConfig(layer_widths=(16, 16))
    tscene = tground.GroundingScene(
        constants=interop.constants_from_numpy(_np(constants)),
        statics=interop.statics_from_numpy(_np(statics)),
        elasticity=InvariantFullMetaElasticity(tcfg, interop.mlp_params_from_numpy(_np(pe))),
        plasticity=InvariantFullMetaPlasticity(tcfg, interop.mlp_params_from_numpy(_np(pp))),
        gaussians=interop.gaussians_from_numpy(_np(gaussians)),
        binding=interop.binding_from_numpy(_np(table)),
        cameras=[interop.camera_from_numpy(_np(cam))],
        init_x=torch.from_numpy(pts.copy()), background=torch.ones(3),
        raster_cfg=RasterConfig(max_pairs=4096), remat="none", **common,
    )
    return jscene, tscene, gt


def scaled_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def scenes():
    return make_scenes()


@pytest.fixture(scope="module")
def jax_value_and_grad(scenes):
    jscene, _, gt = scenes
    loss_fn = jground.make_rollout_loss(jscene)
    pe, pp = jscene.elasticity_params, jscene.plasticity_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEUMA_SLAB_GRID", "interpret")
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda a, b, v, g: loss_fn(a, b, v, jnp.asarray(WEIGHTS), gt_images=g),
            argnums=(0, 1, 2), has_aux=True,
        ))(pe, pp, jnp.asarray(INIT_V), jnp.asarray(gt))
    ge, gp, gv = grads
    return float(loss), interop.lora_leaves(_np(ge)) + interop.lora_leaves(_np(gp)), np.asarray(gv)


def port_value_and_grad(tscene, gt):
    loss_fn = tground.make_rollout_loss(tscene, device="cpu")
    iv = torch.from_numpy(INIT_V.copy()).requires_grad_(True)
    params = trainable_params(tscene.elasticity) + trainable_params(tscene.plasticity)
    weights = torch.from_numpy(WEIGHTS[: gt.shape[0]])
    loss, _ = loss_fn(iv, weights, torch.from_numpy(gt))
    grads = torch.autograd.grad(loss, [iv] + params)
    return float(loss.detach()), [g.numpy() for g in grads[1:]], grads[0].numpy()


@pytest.fixture(scope="module")
def port_grads(scenes):
    _, tscene, gt = scenes
    return port_value_and_grad(tscene, gt)


def test_rollout_loss_matches_jax(port_grads, jax_value_and_grad):
    gap = abs(port_grads[0] - jax_value_and_grad[0]) / abs(jax_value_and_grad[0])
    print(f"loss: port {port_grads[0]:.8f} jax {jax_value_and_grad[0]:.8f} rel {gap:.2e}")
    assert gap <= 1e-5


@pytest.mark.parametrize("leaf", range(12))
def test_lora_gradient_matches_jax(port_grads, jax_value_and_grad, leaf):
    out, ref = port_grads[1][leaf], jax_value_and_grad[1][leaf]
    assert np.abs(ref).max() > 0, "the leaf's gradient is live"
    err = scaled_err(out, ref)
    print(f"leaf {leaf}: scaled err {err:.2e}")
    assert err <= 1e-4


def test_init_v_gradient_matches_jax(port_grads, jax_value_and_grad):
    err = scaled_err(port_grads[2], jax_value_and_grad[2])
    print(f"init_v grad {port_grads[2]} jax {jax_value_and_grad[2]} scaled err {err:.2e}")
    assert np.abs(jax_value_and_grad[2]).max() > 0 and err <= 1e-4


def test_frame_remat_gives_equal_gradients():
    """Per-frame checkpointing recomputes each frame in the backward and
    gives the same loss and gradients, bit for bit (port against port, on
    a smaller scene)."""
    _, tscene, gt = make_scenes(frames=2, substeps=2, exclude=(), n=300, size=32)
    loss, grads, gv = port_value_and_grad(tscene, gt)
    loss_f, grads_f, gv_f = port_value_and_grad(dataclasses.replace(tscene, remat="frame"), gt)
    assert loss_f == loss
    np.testing.assert_array_equal(gv_f, gv)
    for a, b in zip(grads_f, grads):
        np.testing.assert_array_equal(a, b)


def test_remat_policy_resolves_as_jax(scenes):
    jscene, tscene, _ = scenes
    for remat in ("auto", "frame", "none"):
        assert tground._remat_policy(dataclasses.replace(tscene, remat=remat), FRAMES) == \
            jground._remat_policy(dataclasses.replace(jscene, remat=remat))
    with pytest.raises(ValueError, match="remat"):
        tground._remat_policy(dataclasses.replace(tscene, remat="some"), FRAMES)


def test_bench_shapes_resolve_to_no_remat():
    for shape in tground.BENCH_SHAPES.values():
        kw = {k: v for k, v in shape.items() if k != "frames"}
        kw.update(n_particles=64)  # the estimate's particle term at full width below
        scene = tground.build_scene(**kw, device="cpu")
        n = shape["n_particles"]
        scene = dataclasses.replace(scene, init_x=torch.zeros((n, 3)))
        assert tground._remat_policy(scene, shape["frames"]) == "none"
