"""Port parity of the whole slice: the forward grounding rollout loss
(elasticity MLP -> slab MPM -> plasticity MLP -> binding -> Particle-GS
-> L2), ``neuma_tpu_torch.train.grounding.make_rollout_loss`` on the CPU
against the jitted ``neuma_tpu`` one with its Pallas kernels in
interpret mode (``NEUMA_SLAB_GRID=interpret``,
``backend="pallas_interpret"``). The scene: 800 particles, 32^3 grid,
one 64x64 view, SH degree 1, MLP widths (16, 16) with LoRA r = 4 and a
non-zero ``lora_b``, 2 frames x 2 substeps, non-zero ground truth.
"""
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
from neuma_tpu_torch.train import grounding as tground
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, G, SIZE, FRAMES, SUBSTEPS = 800, 32, 64, 2, 2


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


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(0)
    pts = (0.4 + 0.2 * rng.random((N, 3))).astype(np.float32)
    colors = rng.random((N, 3)).astype(np.float32)
    constants = MPMConstants(
        num_grids=G, bound=1, bc="noslip", dt=jnp.float32(1e-3 / SUBSTEPS),
        gravity=jnp.asarray([0.0, -9.8, 0.0], jnp.float32), eps=jnp.float32(6e-7),
    )
    statics = Statics(
        vol=jnp.full((N,), 2e-8, jnp.float32), rho=jnp.full((N,), 1000.0, jnp.float32),
        clip_bound=jnp.full((N,), 0.1, jnp.float32), enabled=jnp.ones((N,), jnp.int32),
    )
    mcfg = JaxMaterialConfig(layer_widths=(16, 16))
    elasticity, plasticity = JaxElasticity(mcfg), JaxPlasticity(mcfg)
    pe = _lora(jax.tree_util.tree_map(lambda a: 0.5 * a, elasticity.init(jax.random.PRNGKey(0))), 1)
    pp = _lora(jax.tree_util.tree_map(lambda a: 0.5 * a, plasticity.init(jax.random.PRNGKey(2))), 3)
    gaussians = create_from_points(pts, colors, sh_degree=1)
    table = compute_binding_table(gaussians, jnp.asarray(pts), max_particles=10)
    cam = JaxCamera.look_at(eye=np.array([0.5, 0.55, -0.6]), target=np.array([0.5, 0.5, 0.5]),
                            fov=0.8, width=SIZE, height=SIZE)
    gt = (0.5 + 0.3 * rng.standard_normal((FRAMES, 1, 3, SIZE, SIZE))).astype(np.float32)
    common = dict(size=np.ones(3), center=np.zeros(3), substeps=SUBSTEPS, pixel_loss="l2")
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
        raster_cfg=RasterConfig(max_pairs=4096), **common,
    )
    return jscene, tscene, gt


@pytest.fixture(scope="module")
def jax_loss(scenes):
    jscene, _, gt = scenes
    init_v = jnp.asarray([0.4, -0.2, 0.1], jnp.float32)
    weights = jnp.asarray([1.0, 0.7], jnp.float32)
    loss_fn = jground.make_rollout_loss(jscene)
    pe, pp = jscene.elasticity_params, jscene.plasticity_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEUMA_SLAB_GRID", "interpret")
        loss, aux = jax.jit(
            lambda a, b, g: loss_fn(a, b, init_v, weights, gt_images=g)
        )(pe, pp, jnp.asarray(gt))
    return float(loss), {k: bool(v) for k, v in aux.items()}


def test_rollout_loss_matches_jax(scenes, jax_loss):
    _, tscene, gt = scenes
    loss_fn = tground.make_rollout_loss(tscene, device="cpu")
    loss, aux = loss_fn(torch.tensor([0.4, -0.2, 0.1]), torch.tensor([1.0, 0.7]), torch.from_numpy(gt))
    ref, ref_aux = jax_loss
    assert {k: bool(v) for k, v in aux.items()} == ref_aux == {
        "overflow": False, "halo_overflow": False}
    gap = abs(float(loss) - ref) / abs(ref)
    print(f"rollout loss: port {float(loss):.8f} jax {ref:.8f} relative gap {gap:.3e}")
    assert gap <= 1e-4, f"relative gap {gap:.3e}"


def test_rollout_is_deterministic(scenes):
    _, tscene, gt = scenes
    loss_fn = tground.make_rollout_loss(tscene, device="cpu")
    args = (torch.tensor([0.4, -0.2, 0.1]), torch.tensor([1.0, 0.7]), torch.from_numpy(gt))
    assert torch.equal(loss_fn(*args)[0], loss_fn(*args)[0])


def test_excluded_frame_adds_no_loss(scenes):
    _, tscene, gt = scenes
    import dataclasses

    args = (torch.tensor([0.4, -0.2, 0.1]), torch.tensor([1.0, 0.0]), torch.from_numpy(gt))
    only_first = tground.make_rollout_loss(tscene, device="cpu")(*args)[0]
    excl = dataclasses.replace(tscene, exclude_frames=(1,))
    args = (args[0], torch.tensor([1.0, 0.7]), args[2])
    assert torch.equal(tground.make_rollout_loss(excl, device="cpu")(*args)[0], only_first)


def test_halo_grid_mode_raises(scenes):
    import dataclasses

    _, tscene, _ = scenes
    with pytest.raises(ValueError, match="later slice"):
        tground.make_rollout_loss(dataclasses.replace(tscene, grid_mode="halo"), device="cpu")
