"""Port parity of the config, data and initializer modules,
``neuma_tpu_torch`` against ``neuma_tpu`` on the same files and the same
``default_rng`` draws: configs with overrides, PLY point clouds and
Gaussian PLYs written by either package, the COLMAP readers, both
dataset readers, mesh sampling, data preparation, the initializers and
``MPMConstants.from_cfg``, and the reference-checkpoint loaders.

Tolerances: everything is bitwise equal (the same numpy code, or the
same float32 values copied), except where the two frameworks do float
arithmetic in their own order: the binding weights (1 / count) are equal
and its indices are compared where the weight is above 0 (top-k orders
the rejected +inf ties differently).
"""
import dataclasses
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.core.types import MPMConstants as JaxConstants
from neuma_tpu.data import colmap as jcolmap
from neuma_tpu.data import mesh as jmesh
from neuma_tpu.data import ply as jply
from neuma_tpu.data import prepare as jprepare
from neuma_tpu.data import readers as jreaders
from neuma_tpu.data import sampling as jsampling
from neuma_tpu.data import torch_ckpt as jckpt
from neuma_tpu.render.gaussians import GaussianPack as JaxPack
from neuma_tpu.render.gaussians import create_from_points as jax_create
from neuma_tpu.sim import initializers as jinit
from neuma_tpu.utils import config as jconfig
from neuma_tpu_torch import interop
from neuma_tpu_torch.core.types import MPMConstants
from neuma_tpu_torch.data import colmap as tcolmap
from neuma_tpu_torch.data import mesh as tmesh
from neuma_tpu_torch.data import ply as tply
from neuma_tpu_torch.data import prepare as tprepare
from neuma_tpu_torch.data import readers as treaders
from neuma_tpu_torch.data import sampling as tsampling
from neuma_tpu_torch.data import torch_ckpt as tckpt
from neuma_tpu_torch.render.binding import BindingTable
from neuma_tpu_torch.render.gaussians import GaussianPack
from neuma_tpu_torch.sim import initializers as tinit
from neuma_tpu_torch.utils import config as tconfig

from test_apps import make_assets, make_synthetic_dataset
from test_realcapture import make_real_capture

CONFIG = "configs/synthetic/finetune-bb.yaml"
OVERRIDES = ["seed=7", "sim.num_grids=48", "raster.segment=16", "velocity.views=[d_0, d_1]",
             "particle_data.shape.sort=null", "debug=false", "name=run a", "constitution.lora.alpha=0.5"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_binding_equal(t_idx, t_w, j_idx, j_w):
    """Weights equal; indices equal where the weight is above 0."""
    np.testing.assert_array_equal(t_w, j_w)
    live = j_w > 0
    np.testing.assert_array_equal(t_idx[live], j_idx[live])


# --- config --------------------------------------------------------------------------


def test_config_overrides_and_save_match_jax(tmp_path):
    repo = Path(__file__).resolve().parent.parent
    t = tconfig.load_config(repo / CONFIG, OVERRIDES)
    j = jconfig.load_config(repo / CONFIG, OVERRIDES)
    assert t.to_dict() == j.to_dict()
    assert t.sim.num_grids == 48 and t.velocity.views == ["d_0", "d_1"] and t.name == "run a"
    assert t.get_path("constitution.lora.alpha") == 0.5 and t.get_path("no.such", 3) == 3
    t.save(tmp_path / "t.yaml")
    j.save(tmp_path / "j.yaml")
    assert (tmp_path / "t.yaml").read_bytes() == (tmp_path / "j.yaml").read_bytes()
    assert tconfig.load_config(tmp_path / "t.yaml").to_dict() == t.to_dict()
    copy = t.copy()
    copy.sim.num_grids = 1
    assert t.sim.num_grids == 48
    with pytest.raises(SystemExit, match="not found"):
        tconfig.load_config(tmp_path / "missing.yaml")


# --- PLY -----------------------------------------------------------------------------


def test_ply_points_cross_read(tmp_path, rng):
    pts = rng.random((37, 3)).astype(np.float32)
    tply.save_ply_points(tmp_path / "t.ply", pts)
    jply.save_ply_points(tmp_path / "j.ply", pts)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(tply.load_ply_points(tmp_path / "j.ply"), pts)
    np.testing.assert_array_equal(jply.load_ply_points(tmp_path / "t.ply"), pts)


def test_ply_ascii_and_big_endian(tmp_path):
    """The reader's other formats, on hand-written files."""
    (tmp_path / "a.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\nproperty float y\n"
        "property float z\nproperty uchar red\nend_header\n1 2 3 4\n5 6 7 8\n")
    rows = np.array([(1.5, 2.5, 3.5), (4.0, 5.0, 6.0)], dtype=">f4").tobytes()
    (tmp_path / "b.ply").write_bytes(
        b"ply\nformat binary_big_endian 1.0\nelement vertex 2\nproperty float x\n"
        b"property float y\nproperty float z\nend_header\n" + rows)
    for name in ("a.ply", "b.ply"):
        t, j = tply.load_ply(tmp_path / name), jply.load_ply(tmp_path / name)
        assert list(t) == list(j)
        for k in t:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("sh_degree", [0, 2, 3])
def test_gaussian_ply_cross_read(tmp_path, rng, sh_degree):
    """Each package reads the other's kernels.ply to the same arrays, and
    both write the same bytes for one pack."""
    pts = rng.random((50, 3)).astype(np.float32)
    jpack = jax_create(pts, rng.random((50, 3)).astype(np.float32), sh_degree=sh_degree)
    rest = rng.standard_normal(np.shape(jpack.features_rest)).astype(np.float32)
    jpack = dataclasses.replace(jpack, features_rest=jnp.asarray(rest))
    jpack.to_ply(tmp_path / "j.ply")
    tpack = GaussianPack.from_ply(tmp_path / "j.ply", sh_degree)
    for name in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(getattr(tpack, name).numpy(), np.asarray(getattr(jpack, name)))
    tpack.to_ply(tmp_path / "t.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = JaxPack.from_ply(tmp_path / "t.ply", sh_degree)
    np.testing.assert_array_equal(np.asarray(back.features_rest), tpack.features_rest.numpy())


def test_gaussian_masked_and_concatenate(rng):
    pts = rng.random((20, 3)).astype(np.float32)
    jpack = jax_create(pts, None, sh_degree=1)
    tpack = interop.gaussians_from_numpy(_np(jpack))
    mask = rng.random(20) > 0.4
    jm, tm = jpack.masked(mask), tpack.masked(mask)
    jc, tc = JaxPack.concatenate([jm, jpack]), GaussianPack.concatenate([tm, tpack])
    for name in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
    assert tc.num_gaussians == mask.sum() + 20 and tc.sh_degree == 1


def test_binding_file_cross_read(tmp_path):
    from neuma_tpu.render.binding import BindingTable as JaxTable

    rng = np.random.default_rng(3)
    idx = rng.integers(0, 100, (12, 5)).astype(np.int32)
    w = rng.random((12, 5)).astype(np.float32) * (rng.random((12, 5)) > 0.3)
    jt = JaxTable(indices=jnp.asarray(idx), weights=jnp.asarray(w))
    jt.save(tmp_path / "j.npz")
    tt = BindingTable.load(tmp_path / "j.npz")
    assert tt.indices.dtype == torch.int64
    np.testing.assert_array_equal(tt.counts().numpy(), np.asarray(jt.counts()))
    tt.save(tmp_path / "t.npz")
    a, b = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    for k in ("indices", "weights"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


# --- COLMAP --------------------------------------------------------------------------


def test_colmap_camera_readers_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    with open(tmp_path / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 4752, 2672) + struct.pack("<4d", 3000.0, 3100.0, 2376.0, 1336.0))
        f.write(struct.pack("<iiQQ", 3, 4, 640, 480) + struct.pack("<8d", *rng.random(8)))
    (tmp_path / "cameras.txt").write_text(
        "# Camera list\n1 PINHOLE 4752 2672 3000 3100 2376 1336\n\n2 SIMPLE_PINHOLE 10 20 5 5 10\n")
    for fn in ("read_cameras_binary", "read_cameras_text"):
        path = tmp_path / ("cameras.bin" if fn.endswith("binary") else "cameras.txt")
        t, j = getattr(tcolmap, fn)(path), getattr(jcolmap, fn)(path)
        assert t.keys() == j.keys()
        for k in t:
            assert (t[k].model, t[k].width, t[k].height) == (j[k].model, j[k].width, j[k].height)
            np.testing.assert_array_equal(t[k].params, j[k].params)
    for rvec in (np.zeros(3), np.array([0.3, -1.2, 0.7])):
        np.testing.assert_array_equal(tcolmap.rodrigues(rvec), jcolmap.rodrigues(rvec))


def test_focal2fov_matches_jax():
    from neuma_tpu.render.camera import focal2fov as jax_focal2fov
    from neuma_tpu_torch.render.camera import fov2focal, focal2fov

    for focal, pixels in ((1111.1, 800), (35.5, 64)):
        assert focal2fov(focal, pixels) == jax_focal2fov(focal, pixels)
        assert abs(fov2focal(focal2fov(focal, pixels), pixels) - focal) < 1e-9 * focal


# --- dataset readers -----------------------------------------------------------------


def _camera_equal(t, j):
    for name in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert (t.width, t.height, t.fov_x, t.fov_y, t.znear, t.zfar) == (
        j.width, j.height, j.fov_x, j.fov_y, j.znear, j.zfar)


@pytest.mark.parametrize("resolution", [1, 2])
def test_synthetic_dataset_matches_jax(tmp_path, rng, resolution):
    views = make_synthetic_dataset(tmp_path, rng, size=24, n_views=2, n_steps=4)
    cfg = {"camera_type": "NeuMASynthetic", "camera": {"resolution": resolution},
           "data": {"path": str(tmp_path), "transformsfile": "data_dynamic.json",
                    "white_background": True, "exclude_steps": [2], "used_views": views}}
    t, j = treaders.VideoDataset(cfg), jreaders.VideoDataset(cfg)
    assert (t.views, t.steps, len(t)) == (j.views, j.steps, len(j)) == (views, [0, 1, 3], 6)
    gt = t.stacked_gt(views[::-1], [3, 1])
    assert gt.dtype == torch.float32 and gt.device.type == "cpu"
    np.testing.assert_array_equal(gt.numpy(), j.stacked_gt(views[::-1], [3, 1]))
    for a, b in zip(t.cameras_for(views), j.cameras_for(views)):
        _camera_equal(a, b)
    _camera_equal(t.get(1, 0).camera, j.get(1, 0).camera)


@pytest.mark.parametrize("mask_only", [False, True])
def test_real_capture_dataset_matches_jax(tmp_path, rng, mask_only):
    make_real_capture(tmp_path, rng)
    cfg = {"camera_type": "RealCapture",
           "data": {"path": str(tmp_path), "white_background": True, "width": 96, "height": 64,
                    "read_mask_only": mask_only}}
    t, j = treaders.VideoDataset(cfg), jreaders.VideoDataset(cfg)
    assert (t.views, t.steps) == (j.views, j.steps)
    np.testing.assert_array_equal(t.stacked_gt(t.views, t.steps).numpy(),
                                  j.stacked_gt(j.views, j.steps))
    for a, b in zip(t.cameras_for(t.views), j.cameras_for(j.views)):
        _camera_equal(a, b)


# --- meshes and sampling -------------------------------------------------------------


def _ico():
    m = tmesh.make_icosphere(radius=0.25, subdivisions=2)
    return tmesh.TriMesh(vertices=m.vertices + np.array([0.5, 0.55, 0.5]), faces=m.faces)


def test_mesh_geometry_and_sampling_match_jax(tmp_path):
    tm = _ico()
    jm = jmesh.make_icosphere(radius=0.25, subdivisions=2)
    jm = jmesh.TriMesh(vertices=jm.vertices + np.array([0.5, 0.55, 0.5]), faces=jm.faces)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    pts = np.random.default_rng(5).random((500, 3))
    np.testing.assert_array_equal(tm.contains(pts), jm.contains(pts))
    np.testing.assert_array_equal(tm.sample_surface(64, np.random.default_rng(6)),
                                  jm.sample_surface(64, np.random.default_rng(6)))
    tm.export_obj(tmp_path / "m.obj")
    head = (f"element vertex {len(tm.vertices)}\nproperty float x\nproperty float y\n"
            f"property float z\nelement face {len(tm.faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    (tmp_path / "a.ply").write_text(
        "ply\nformat ascii 1.0\n" + head
        + "".join(f"{x} {y} {z}\n" for x, y, z in tm.vertices.astype(np.float32))
        + "".join(f"3 {a} {b} {c}\n" for a, b, c in tm.faces))
    (tmp_path / "b.ply").write_bytes(
        ("ply\nformat binary_little_endian 1.0\n" + head).encode()
        + tm.vertices.astype("<f4").tobytes()
        + b"".join(struct.pack("<B3i", 3, *f) for f in tm.faces))
    for name in ("m.obj", "a.ply", "b.ply"):
        a, b = tmesh.load_mesh(tmp_path / name), jmesh.load_mesh(tmp_path / name)
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_array_equal(a.faces, tm.faces)
    for mode, res in (("uniform", 10), ("surface", 300), ("volumetric", 12)):
        a = tsampling.sample_particles(tmp_path / "m.obj", mode, res, np.random.default_rng(7))
        b = jsampling.sample_particles(tmp_path / "m.obj", mode, res, np.random.default_rng(7))
        assert len(a) > 10
        np.testing.assert_array_equal(a, b)


def test_volumetric_fallback_matches_jax(tmp_path, monkeypatch):
    """The Python lattice that stands in when the native sampler cannot run,
    and the route each volumetric call records."""
    m = _ico()
    np.testing.assert_array_equal(tsampling._hcp_interior_points(m, 0.05),
                                  jsampling._hcp_interior_points(m, 0.05))
    if tsampling.NATIVE_SAMPLER.is_file():
        tsampling.volumetric_sampling(m, 10)
        assert tsampling.last_volumetric_route == "native"
    monkeypatch.setattr(tsampling, "NATIVE_SAMPLER", tmp_path / "absent")
    monkeypatch.setattr(tsampling, "_native_build_attempted", True)
    p = tsampling.volumetric_sampling(m, 10)
    assert tsampling.last_volumetric_route == "hcp" and len(p) > 10


# --- data preparation ----------------------------------------------------------------


@pytest.mark.parametrize("source", ["mesh", "points"])
def test_prepare_simulation_data_matches_jax(tmp_path, rng, source):
    """The same files from both packages: kernels.ply and particles.ply
    bitwise, bindings.npz and n_particles.npy under the tie rule. The mesh
    case injects kernel centres in pass 1 (the count and positions are
    compared through particles.ply)."""
    kernels, mesh = make_assets(tmp_path, rng)
    kw = dict(kernels_path=kernels, sh_degree=2, max_particles=8, seed=3)
    if source == "mesh":
        kw.update(mesh_path=mesh, mesh_sample_mode="uniform", mesh_sample_resolution=7,
                  particles_downsample_factor=4)
    else:
        pts = tmesh.load_mesh(mesh).sample_surface(400, np.random.default_rng(9)).astype(np.float32)
        tply.save_ply_points(tmp_path / "pcd.ply", pts)
        kw.update(particles_path=tmp_path / "pcd.ply", particles_downsample_factor=3)
    tprepare.prepare_simulation_data(save_dir=tmp_path / "t", device="cpu", **kw)
    jprepare.prepare_simulation_data(save_dir=tmp_path / "j", **kw)
    for name in ("kernels.ply", "particles.ply"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    t, j = np.load(tmp_path / "t" / "bindings.npz"), np.load(tmp_path / "j" / "bindings.npz")
    assert t["indices"].dtype == j["indices"].dtype == np.int32
    assert_binding_equal(t["indices"], t["weights"], j["indices"], j["weights"])
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "n_particles.npy"),
                                  np.load(tmp_path / "j" / "n_particles.npy"))
    if source == "mesh":
        n_kept = -(-len(tsampling.sample_particles(mesh, "uniform", 7)) // 4)
        assert len(tply.load_ply_points(tmp_path / "t" / "particles.ply")) > n_kept, "injected"

    g, p, table = tprepare.load_prepared(tmp_path / "t", 2, device="cpu")
    assert g.num_gaussians == table.num_kernels and p.shape[1] == 3
    before = (tmp_path / "t" / "particles.ply").stat().st_mtime_ns
    tprepare.prepare_simulation_data(save_dir=tmp_path / "t", device="cpu", **kw)  # idempotent skip
    assert (tmp_path / "t" / "particles.ply").stat().st_mtime_ns == before


def test_prepare_needs_a_particle_source(tmp_path, rng):
    kernels, _ = make_assets(tmp_path, rng)
    with pytest.raises(ValueError, match="particles_path"):
        tprepare.prepare_simulation_data(save_dir=tmp_path / "t", kernels_path=kernels, sh_degree=2,
                                         device="cpu")


# --- initializers and constants ------------------------------------------------------


SIM = {"gravity": [0.0, -9.8, 0.0], "bc": "noslip", "num_grids": 32, "dt": 0.001, "bound": 1,
       "eps": 6e-7}


def test_constants_from_cfg_match_jax():
    t, j = MPMConstants.from_cfg(SIM), JaxConstants.from_cfg(SIM)
    assert (t.num_grids, t.bound, t.bc) == (j.num_grids, j.bound, j.bc)
    for name in ("dt", "gravity", "eps"):
        assert getattr(t, name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))


@pytest.mark.parametrize("sort", [None, 1])
def test_init_data_and_statics_match_jax(tmp_path, rng, sort):
    pts = (np.array([-0.2, 0.3, -0.2]) + 0.4 * rng.random((300, 3))).astype(np.float32)
    for name in ("t", "j"):
        (tmp_path / name).mkdir()
        tply.save_ply_points(tmp_path / name / "particles.ply", pts)
    cfg = lambda name: {
        "shape": {"name": "particles", "asset_root": str(tmp_path / name), "sort": sort,
                  "ori_bounds": [[-0.5, 0.0, -0.5], [0.5, 1.0, 0.5]],
                  "sim_bounds": [[0.0, 0.1, 0.0], [1.0, 0.9, 1.0]]},
        "rho": 1000.0, "clip_bound": 0.1, "span": [0, 5]}
    t, j = tinit.MPMInitData.from_cfg(cfg("t")), jinit.MPMInitData.from_cfg(cfg("j"))
    for name in ("pos", "size", "center"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert (t.vol, t.rho, t.clip_bound, t.span, t.num_particles) == (
        j.vol, j.rho, j.clip_bound, j.span, j.num_particles)
    # the cached npz is read on the second call
    assert tinit.MPMInitData.from_cfg(cfg("t")).vol == t.vol
    for step in (0, 5):
        ts, js = tinit.build_statics([t, t], step=step, device="cpu"), jinit.build_statics([j, j], step=step)
        for name in ("vol", "rho", "clip_bound", "enabled"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    for group in (t, j):
        group.set_lin_vel([0.1, 0.0, -0.2])
        group.set_ang_vel([0.0, 1.0, 0.0])
    (ts, sec_t), (js, sec_j) = tinit.build_initial_state([t], device="cpu"), jinit.build_initial_state([j])
    assert sec_t == sec_j
    for name in ("x", "v", "C", "F"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))


def test_points_outside_the_sim_box_are_refused():
    with pytest.raises(ValueError, match="unit sim box"):
        tinit.MPMInitData.from_points(np.full((4, 3), 1.5), 1.0, 1000.0, 0.1, (0, 1))


# --- reference checkpoints -----------------------------------------------------------


def _state_dict(rng, widths, weight_norm, lora_r=0, parametrize=False):
    sd, w_in = {}, 13
    names = [f"layers.{i}.fc" for i in range(len(widths))] + ["final_layer.fc"]
    for name, w_out in zip(names, list(widths) + [9]):
        v = torch.from_numpy(rng.standard_normal((w_out, w_in)).astype(np.float32))
        if weight_norm and name != "final_layer.fc":
            g = torch.from_numpy(rng.random((w_out, 1)).astype(np.float32))
            if parametrize:
                sd[f"{name}.parametrizations.weight.original0"] = g
                sd[f"{name}.parametrizations.weight.original1"] = v
            else:
                sd[f"{name}.weight_g"], sd[f"{name}.weight_v"] = g, v
            sd[f"{name}.bias"] = torch.from_numpy(rng.random(w_out).astype(np.float32))
        else:
            sd[f"{name}.weight"] = v
        if lora_r:
            sd[f"{name}.lora_A"] = torch.from_numpy(rng.random((lora_r, w_in)).astype(np.float32))
            sd[f"{name}.lora_B"] = torch.from_numpy(rng.random((w_out, lora_r)).astype(np.float32))
        w_in = w_out
    return sd


def _tree_equal(t, j):
    t, j = interop.to_numpy(t), _np(j)
    assert jax.tree_util.tree_structure(t) == jax.tree_util.tree_structure(j)
    for a, b in zip(jax.tree_util.tree_leaves(t), jax.tree_util.tree_leaves(j)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weight_norm,parametrize", [(False, False), (True, False), (True, True)])
def test_base_model_and_lora_match_jax(tmp_path, weight_norm, parametrize):
    """A reference-form ``.pt`` written with ``torch.save``: the base pair
    and an overlaid LoRA state dict, against the JAX package's loaders."""
    rng = np.random.default_rng(11)
    path = tmp_path / "base.pt"
    torch.save({"elasticity": _state_dict(rng, (8, 8), weight_norm, parametrize=parametrize),
                "plasticity": _state_dict(rng, (8, 8), weight_norm, parametrize=parametrize)}, path)
    t_e, t_p = tckpt.load_base_model(path, num_layers=2)
    j_e, j_p = jckpt.load_base_model(path, num_layers=2)
    _tree_equal(t_e, j_e)
    _tree_equal(t_p, j_p)
    lora_sd = _state_dict(rng, (8, 8), False, lora_r=3)
    _tree_equal(tckpt.merge_lora_state_dict(t_e, lora_sd, 2, r=3, alpha=6.0),
                jckpt.merge_lora_state_dict(j_e, lora_sd, 2, r=3, alpha=6.0))
    _tree_equal(tckpt.mlp_params_from_state_dict(lora_sd, 2),
                jckpt.mlp_params_from_state_dict(lora_sd, 2))


def test_params_npz_cross_read(tmp_path):
    rng = np.random.default_rng(12)
    tree = {"elasticity": {"layers": [{"lora_a": rng.random((3, 2)).astype(np.float32)}] * 3,
                           "final": {"lora_b": rng.random((2, 9)).astype(np.float32)}},
            "loss": np.float32(0.5)}
    tckpt.save_params_npz(tmp_path / "t.npz", interop.mlp_params_from_numpy(tree))
    jckpt.save_params_npz(tmp_path / "j.npz", tree)
    a, b = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    _tree_equal(tckpt.load_params_npz(tmp_path / "j.npz"), jckpt.load_params_npz(tmp_path / "t.npz"))
