"""The port's public surface against the JAX package's: each subpackage's
``__all__`` name for name (and every name resolving, the re-exported
functions shadowing their modules as in JAX), and the helpers
``GridState``, ``AverageMeter``, ``sh_to_rgb``, ``binding_flags``, the
COLMAP image / point readers with ``qvec_to_rotmat``, ``sim/blocked.py``'s
``BLOCK`` / ``CHUNK`` and ``materials/meta.py``'s ``Params``."""
import importlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuma_tpu.core import types as jtypes
from neuma_tpu.data import colmap as jcolmap
from neuma_tpu.ops import sh as jsh
from neuma_tpu.render import binding as jbind
from neuma_tpu.render import gaussians as jgs
from neuma_tpu.utils import logging as jlogging
from neuma_tpu_torch import interop
from neuma_tpu_torch.core import types as ttypes
from neuma_tpu_torch.data import colmap as tcolmap
from neuma_tpu_torch.ops import sh as tsh
from neuma_tpu_torch.render import binding as tbind
from neuma_tpu_torch.utils import logging as tlogging
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SUBPACKAGES = ("ops", "nn", "render", "train", "data", "core", "utils", "vis",
               "materials", "sim", "parallel")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_equal_jax(sub):
    jax_pkg = importlib.import_module(f"neuma_tpu.{sub}")
    port = importlib.import_module(f"neuma_tpu_torch.{sub}")
    want = list(jax_pkg.__all__)
    if sub == "parallel":  # the port's process mesh, ``jax.sharding.Mesh`` in JAX
        want = ["Mesh"] + want
    assert list(port.__all__) == want
    for name in port.__all__:
        obj = getattr(port, name)
        assert not isinstance(obj, type(importlib)), f"{sub}.{name} is a module"
        assert callable(obj), f"{sub}.{name}"


def test_shadowing_functions_are_the_functions():
    from neuma_tpu_torch.ops import svd3
    from neuma_tpu_torch.render import RasterConfig, rasterize

    ras_mod = importlib.import_module("neuma_tpu_torch.render.rasterize")
    svd_mod = importlib.import_module("neuma_tpu_torch.ops.svd3")
    assert rasterize is ras_mod.rasterize and RasterConfig is ras_mod.RasterConfig
    assert svd3 is svd_mod.svd3
    assert callable(rasterize) and callable(svd3)


def test_top_level_package_exports_nothing():
    import neuma_tpu_torch

    assert not hasattr(neuma_tpu_torch, "__all__")
    assert neuma_tpu_torch.__doc__


def test_grid_state_zeros_and_cube_equal_jax():
    g = 5
    got = ttypes.GridState.zeros(g, device="cpu")
    want = jtypes.GridState.zeros(g)
    for a, b in zip(got.cube(g), want.cube(g)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(0)
    fields = dict(m=rng.random(g ** 3, np.float32), mv=rng.random((g ** 3, 3), np.float32),
                  v=rng.random((g ** 3, 3), np.float32))
    got = ttypes.GridState(**{k: torch.from_numpy(v) for k, v in fields.items()})
    want = jtypes.GridState(**{k: jnp.asarray(v) for k, v in fields.items()})
    for a, b in zip(got.cube(g), want.cube(g)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ttypes.GridState.zeros(2, torch.float64, device="cpu").m.dtype == torch.float64
    if torch.cuda.is_available():
        assert ttypes.GridState.zeros(2).m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttypes.GridState.zeros(2)


def test_average_meter_sequence_equals_jax():
    got, want = tlogging.AverageMeter(), jlogging.AverageMeter()
    for val, n in ((1.5, 1), (2.25, 3), (-0.5, 2), (10.0, 1)):
        got.update(val, n)
        want.update(val, n)
        assert vars(got) == vars(want)
    got.reset()
    want.reset()
    assert vars(got) == vars(want) == dict(val=0.0, avg=0.0, sum=0.0, count=0)


def test_sh_to_rgb_equals_jax():
    sh = np.random.default_rng(1).standard_normal((64, 16, 3)).astype(np.float32)
    got = tsh.sh_to_rgb(torch.from_numpy(sh)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsh.sh_to_rgb(jnp.asarray(sh))), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tsh.rgb_to_sh(tsh.sh_to_rgb(torch.from_numpy(sh))).numpy(), sh,
                               rtol=0, atol=1e-5)


def test_binding_flags_equal_jax():
    """Gaussians over the whole cloud, particles in half of it: some
    kernels bind particles and some none."""
    rng = np.random.default_rng(4)
    pts = (0.4 + 0.2 * rng.random((300, 3))).astype(np.float32)
    particles = pts[pts[:, 0] < 0.5]
    g = jgs.create_from_points(pts, rng.random((300, 3)).astype(np.float32), sh_degree=0)
    want = np.asarray(jbind.binding_flags(g, jnp.asarray(particles), chunk=128))
    tg = interop.gaussians_from_numpy(jax.tree_util.tree_map(np.asarray, g))
    got = tbind.binding_flags(tg, torch.from_numpy(particles), chunk=128)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_qvec_to_rotmat_bitwise():
    rng = np.random.default_rng(2)
    for _ in range(20):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        got, want = tcolmap.qvec_to_rotmat(q), jcolmap.qvec_to_rotmat(q)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_array_equal(tcolmap.qvec_to_rotmat(np.array([1.0, 0, 0, 0])), np.eye(3))


def _write_images_bin(path, rng):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 3))
        for image_id, n_pts in ((1, 0), (7, 4), (2, 9)):
            q = rng.standard_normal(4)
            f.write(struct.pack("<idddddddi", image_id, *(q / np.linalg.norm(q)),
                                *rng.standard_normal(3), 10 + image_id))
            f.write(f"frame_{image_id:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", n_pts))
            for _ in range(n_pts):
                f.write(struct.pack("<ddq", *rng.random(2) * 100, int(rng.integers(-1, 50))))


def _write_points3d_bin(path, rng):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 5))
        for point_id in range(5):
            f.write(struct.pack("<QdddBBBd", point_id + 100, *rng.standard_normal(3),
                                *rng.integers(0, 256, 3).tolist(), float(rng.random())))
            track = point_id % 3 + 1
            f.write(struct.pack("<Q", track))
            f.write(struct.pack(f"<{2 * track}i", *rng.integers(0, 20, 2 * track).tolist()))


def test_colmap_images_and_points_readers_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    _write_images_bin(tmp_path / "images.bin", rng)
    _write_points3d_bin(tmp_path / "points3D.bin", rng)
    got = tcolmap.read_images_binary(tmp_path / "images.bin")
    want = jcolmap.read_images_binary(tmp_path / "images.bin")
    assert list(got) == list(want) == [1, 7, 2]
    for k in want:
        a, b = got[k], want[k]
        assert (a.id, a.camera_id, a.name) == (b.id, b.camera_id, b.name)
        assert np.array_equal(a.qvec, b.qvec) and np.array_equal(a.tvec, b.tvec)
        assert isinstance(a, tcolmap.ColmapImage)
    assert got[7].name == "frame_007.png" and got[2].camera_id == 12
    xyz, rgb = tcolmap.read_points3d_binary(tmp_path / "points3D.bin")
    jxyz, jrgb = jcolmap.read_points3d_binary(tmp_path / "points3D.bin")
    assert xyz.shape == (5, 3) and rgb.dtype == np.uint8
    assert np.array_equal(xyz, jxyz) and np.array_equal(rgb, jrgb) and rgb.dtype == jrgb.dtype


def test_sim_blocked_sizes_and_meta_params_equal_jax():
    jblocked = importlib.import_module("neuma_tpu.sim.blocked")
    tblocked = importlib.import_module("neuma_tpu_torch.sim.blocked")
    tkernel = importlib.import_module("neuma_tpu_torch.sim.p2g_kernel")
    assert (tblocked.BLOCK, tblocked.CHUNK) == (jblocked.BLOCK, jblocked.CHUNK) == (14, 512)
    assert tblocked.BLOCK == tkernel.BLOCK
    jmeta = importlib.import_module("neuma_tpu.materials.meta")
    tmeta = importlib.import_module("neuma_tpu_torch.materials.meta")
    assert tmeta.Params is jmeta.Params
