"""Port parity of the registration slice, ``neuma_tpu_torch`` on the CPU
against ``neuma_tpu`` (same numpy inputs): the Sim(3) helpers,
``register_gaussians`` on ``tests/test_register.py``'s scene with the
D-SSIM term on (so the SSIM gradient and the SH rotation run), a
port-only recovery run with that test's assertions, and both ``regist``
CLIs on a fabricated real capture (``tests/test_realcapture.py``'s
helpers), including reruns and a JAX-written ``registered_params.npz``.

The JAX side registers through its default backend here (the jnp
composite); the port through K4/K5's plain versions. The file compiles
the JAX registration step twice: once in ``test_register_matches_jax``
and once in the JAX CLI run.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from neuma_tpu.render.camera import Camera as JaxCamera
from neuma_tpu.render.gaussians import create_from_points
from neuma_tpu.render.rasterize import RasterConfig as JaxRasterConfig
from neuma_tpu.train import register as jreg
from neuma_tpu_torch import interop
from neuma_tpu_torch.data.ply import load_ply, load_ply_points
from neuma_tpu_torch.render.gaussians import GaussianPack
from neuma_tpu_torch.render.rasterize import RasterConfig, rasterize
from neuma_tpu_torch.train import register as treg
from test_realcapture import deep_update, load_repo_config, make_kernels_and_mesh, make_real_capture
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZE = 48
EYES = ([0, 0.1, -1.5], [-1.5, 0.1, 0.0], [0.9, 1.2, 0.9])
TRUE = dict(init_r_deg=(8.0, -5.0, 4.0), init_t=(0.06, -0.04, 0.05), init_s=1.15)
JAX_RASTER = JaxRasterConfig(max_pairs=8192, max_per_tile=256, segment=16)
PORT_RASTER = RasterConfig(max_pairs=8192, max_per_tile=256)


def scaled_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def scene():
    """``tests/test_register.py``'s scene: 150 SH-1 Gaussians, a known
    Sim(3) and three 48x48 views of the moved cloud on white, rendered by
    the port (both packages then fit the same numpy frames)."""
    rng = np.random.default_rng(0)
    n = 150
    pts = (0.2 * rng.standard_normal((n, 3))).astype(np.float32)
    pack = create_from_points(pts, rng.random((n, 3)).astype(np.float32), sh_degree=1)
    cams = [JaxCamera.look_at(eye=np.array(e), target=np.zeros(3), fov=0.9, width=SIZE,
                              height=SIZE) for e in EYES]
    moved = treg.apply_sim3(treg.init_sim3_params(treg.RegisterConfig(**TRUE)),
                            interop.gaussians_from_numpy(pack))
    with torch.no_grad():
        gt = np.stack([rasterize(moved.xyz, moved.get_covariance(), moved.get_opacity,
                                 interop.camera_from_numpy(c), torch.ones(3),
                                 shs=moved.get_features, sh_degree=1, cfg=PORT_RASTER).numpy()
                       for c in cams])
    return dict(pts=pts, pack=pack, cams=cams, gt=gt,
                true_params={k: np.asarray(v) for k, v in
                             jreg.init_sim3_params(jreg.RegisterConfig(**TRUE)).items()})


def _port(scene):
    pack = interop.gaussians_from_numpy(scene["pack"])
    cams = [interop.camera_from_numpy(c) for c in scene["cams"]]
    return pack, cams


def test_sim3_helpers_match_jax(scene):
    """init_sim3_params, apply_sim3 (every field, SH rotation included)
    and apply_sim3_points: scaled max error 1e-5 each."""
    pack, _ = _port(scene)
    jp = jreg.init_sim3_params(jreg.RegisterConfig(**TRUE))
    tp = treg.init_sim3_params(treg.RegisterConfig(**TRUE))
    for k in ("r", "t", "s"):
        assert scaled_err(tp[k], jp[k]) <= 1e-5, k
    jm, tm = jreg.apply_sim3(jp, scene["pack"]), treg.apply_sim3(tp, pack)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        assert scaled_err(getattr(tm, f), getattr(jm, f)) <= 1e-5, f
    origin = np.mean(scene["pts"], axis=0, keepdims=True)
    probe = scene["pts"][:20]
    want = jreg.apply_sim3_points(jp, jnp.asarray(probe), jnp.asarray(origin))
    got = treg.apply_sim3_points(tp, torch.as_tensor(probe), torch.as_tensor(origin))
    assert scaled_err(got, want) <= 1e-5


def test_register_matches_jax(scene):
    """3 iterations, log_every 1, lambda_dssim 0.2: losses within rtol
    1e-4 and the fitted params within a scaled 1e-4."""
    fit = dict(iterations=3, lr_r=0.02, lr_t=0.02, lr_s=0.02, learning_rate_alpha=0.05,
               lambda_dssim=0.2)
    j = jreg.register_gaussians(scene["pack"], scene["cams"], jnp.asarray(scene["gt"]),
                                jreg.RegisterConfig(**fit), jnp.ones(3), raster_cfg=JAX_RASTER,
                                log_every=1)
    pack, cams = _port(scene)
    logged = []
    t = treg.register_gaussians(pack, cams, torch.as_tensor(scene["gt"]),
                                treg.RegisterConfig(**fit), torch.ones(3), raster_cfg=PORT_RASTER,
                                log_fn=lambda i, l, p: logged.append(i), log_every=1,
                                device="cpu")
    assert logged == [1, 2, 3] and len(j.losses) == 3
    np.testing.assert_allclose(t.losses, j.losses, rtol=1e-4)
    for k in ("r", "t", "s"):
        assert t.params[k].shape == j.params[k].shape and t.params[k].dtype == np.float32
        assert scaled_err(t.params[k], j.params[k]) <= 1e-4, k
    assert t.origin.shape == (1, 3)
    np.testing.assert_allclose(t.origin, j.origin, rtol=1e-6, atol=1e-7)


def test_register_recovers_transform(scene):
    """The port alone, ``tests/test_register.py``'s run and assertions:
    150 iterations halve the loss, and the fitted Sim(3) maps probe
    points closer than half the initial error."""
    pack, cams = _port(scene)
    fit = treg.RegisterConfig(iterations=150, lr_r=0.02, lr_t=0.02, lr_s=0.02,
                              learning_rate_alpha=0.05)
    result = treg.register_gaussians(pack, cams, torch.as_tensor(scene["gt"]), fit, torch.ones(3),
                                     raster_cfg=PORT_RASTER, log_every=10, device="cpu")
    assert result.losses[-1] < 0.5 * result.losses[0]
    probe = torch.as_tensor(scene["pts"][:20])
    origin = torch.mean(pack.xyz, dim=0, keepdim=True)
    got = treg.apply_sim3_points(interop.sim3_params_from_numpy(result.params), probe, origin)
    want = treg.apply_sim3_points(interop.sim3_params_from_numpy(scene["true_params"]), probe,
                                  origin)
    err = torch.linalg.norm(got - want, dim=1).mean()
    base = torch.linalg.norm(probe - want, dim=1).mean()
    assert err < 0.5 * base, f"sim3 error {err} vs initial {base}"


def _regist_config(tmp_path, name):
    """configs/realworld/regist-bun.yaml on a fabricated capture, 4 iterations."""
    rng = np.random.default_rng(0)
    cap = tmp_path / "capture"
    if not cap.is_dir():
        cap.mkdir()
        make_real_capture(cap, rng)
        make_kernels_and_mesh(tmp_path, rng, center=(0.0, 0.0, 0.0), extent=1.0)
    cfg = load_repo_config("realworld/regist-bun.yaml")
    deep_update(cfg, {
        "root": str(tmp_path / "logs"), "name": name,
        "gaussian": {"kernels_path": str(tmp_path / "kernels.ply")},
        "particle_data": {"mesh_path": str(tmp_path / "mesh.obj"), "mesh_sample_resolution": 8},
        "video_data": {"data": {"path": str(cap), "used_views": ["r_0", "r_1"], "width": 96,
                                "height": 64}},
        "raster": {"max_pairs": 16384, "max_per_tile": 256},
        "register": {"iterations": 4, "INIT_R": [10, 0, 0], "INIT_T": [0.4, 0.4, -0.5],
                     "INIT_S": 0.2},
    })
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, tmp_path / "logs" / name


def test_regist_apps_match(tmp_path):
    """Both CLIs on the same capture: params (scaled 1e-4), the kernels PLY
    (every field, scaled 1e-4) and the particles PLY (scaled 1e-4); the
    port's rerun is a no-op (files byte-equal); a JAX-written
    registered_params.npz (with its kernels PLY) makes the port skip
    stage A and write the same particles (scaled 1e-6), and the port's
    file does the same for the JAX app."""
    from neuma_tpu.apps import regist as jax_regist
    from neuma_tpu_torch.apps import regist as port_regist

    jcfg, jout = _regist_config(tmp_path, "jax")
    tcfg, tout = _regist_config(tmp_path, "port")
    jax_regist.main(["-c", str(jcfg)])
    run = port_regist.main(["-c", str(tcfg)], device="cpu")
    assert run.stage_a_s is not None and run.stage_b_s is not None
    files = ("registered_params.npz", "registered_kernels.ply", "registered_particles.ply")
    jp, tp = np.load(jout / files[0]), np.load(tout / files[0])
    assert sorted(tp.files) == sorted(jp.files) == ["origin", "r", "s", "t"]
    for k in jp.files:
        assert scaled_err(tp[k], jp[k]) <= 1e-4, k
    jk, tk = load_ply(jout / files[1]), load_ply(tout / files[1])
    assert sorted(jk) == sorted(tk)
    for k in jk:
        assert scaled_err(tk[k], jk[k]) <= 1e-4, k
    assert scaled_err(load_ply_points(tout / files[2]), load_ply_points(jout / files[2])) <= 1e-4

    before = {f: (tout / f).read_bytes() for f in files}
    rerun = port_regist.main(["-c", str(tcfg)], device="cpu")
    assert rerun.stage_a_s is None and rerun.stage_b_s is None and rerun.losses == []
    assert all((tout / f).read_bytes() == before[f] for f in files)
    assert "Registration already done" in (tout / "log.txt").read_text()

    # The JAX app's params file lets the port skip stage A.
    _, from_jax = _regist_config(tmp_path, "from_jax")
    from_jax.mkdir(parents=True)
    for f in files[:2]:
        shutil.copy(jout / f, from_jax / f)
    run = port_regist.main(["-c", str(tmp_path / "from_jax.yaml")], device="cpu")
    assert run.stage_a_s is None and run.stage_b_s is not None
    assert scaled_err(load_ply_points(from_jax / files[2]),
                      load_ply_points(jout / files[2])) <= 1e-6
    assert GaussianPack.from_ply(from_jax / files[1], 0).num_gaussians == 70

    # ... and the port's lets the JAX app skip it.
    _, to_jax = _regist_config(tmp_path, "to_jax")
    to_jax.mkdir(parents=True)
    for f in files[:2]:
        shutil.copy(tout / f, to_jax / f)
    jax_regist.main(["-c", str(tmp_path / "to_jax.yaml")])
    assert (to_jax / files[1]).read_bytes() == before[files[1]]
    assert scaled_err(load_ply_points(to_jax / files[2]),
                      load_ply_points(tout / files[2])) <= 1e-6


@pytest.mark.parametrize("case", ["identity", "half_turn_x", "half_turn_diag", "generic"])
def test_rotmat_to_quat_gradient_matches_jax(case):
    """``rotmat_to_quat``'s gradient, which registration takes through the
    rotation composed into every Gaussian: at rotations where candidate
    pivots are clamped (1 + tr = 0 at a half turn; three zero pivots at
    the identity) the unselected candidates get a zero cotangent that
    must stay zero (no 0 * inf), and the gradient matches JAX's (scaled
    1e-5)."""
    import jax

    from neuma_tpu.ops import rotation as jrot
    from neuma_tpu_torch.ops import rotation as trot

    axis = {"identity": [0.0, 0.0, 0.0], "half_turn_x": [np.pi, 0.0, 0.0],
            "half_turn_diag": list(np.pi * np.array([1.0, 1.0, 0.0]) / np.sqrt(2.0)),
            "generic": [0.3, -0.7, 0.2]}[case]
    R = trot.axis_angle_to_rotmat(torch.tensor(axis, dtype=torch.float32)).detach()
    w = torch.tensor([0.3, -1.1, 0.7, 0.5])
    Rt = R.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(trot.rotmat_to_quat(Rt) * w), Rt)
    gj = jax.grad(lambda m: jnp.sum(jrot.rotmat_to_quat(m) * jnp.asarray(w.numpy())))(
        jnp.asarray(R.numpy()))
    assert torch.isfinite(g).all()
    assert scaled_err(g, gj) <= 1e-5
