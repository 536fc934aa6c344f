"""Port parity of densification and camera interpolation,
``neuma_tpu_torch`` on the CPU against ``neuma_tpu``: every function of
``render/densify.py`` on the same pack, gradients and numpy seed (equal
Gaussian counts, every field within a scaled 1e-6), and
``Camera.interpolate`` (the matrices within 1e-6 absolute, both the
slerp and the equal-rotation branch, and the shorter arc).
"""
import jax
import numpy as np
import pytest

from neuma_tpu.render import densify as jd
from neuma_tpu.render.camera import Camera as JaxCamera
from neuma_tpu.render.gaussians import create_from_points
from neuma_tpu_torch import interop
from neuma_tpu_torch.render import densify as td
from neuma_tpu_torch.render.camera import Camera
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def scaled_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def same_pack(t, j, tol=1e-6):
    assert t.num_gaussians == j.num_gaussians and t.sh_degree == j.sh_degree
    for f in FIELDS:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.shape == b.shape, f
        if b.size:
            assert scaled_err(a, b) <= tol, f


@pytest.fixture(scope="module")
def packs():
    """``tests/test_densify.py``'s pack (30 SH-1 Gaussians) with its
    scales spread over two decades and random rotations, in both packages."""
    rng = np.random.default_rng(0)
    pack = create_from_points(rng.random((30, 3)).astype(np.float32),
                              rng.random((30, 3)).astype(np.float32), sh_degree=1)
    pack = pack.__class__(**{**{f: getattr(pack, f) for f in FIELDS},
                            "scaling": np.log(10 ** rng.uniform(-2.5, -0.5, (30, 3))).astype(np.float32),
                            "rotation": rng.standard_normal((30, 4)).astype(np.float32),
                            "opacity": rng.uniform(-6, 2, (30, 1)).astype(np.float32),
                            "sh_degree": 1})
    np_pack = jax.tree_util.tree_map(np.asarray, pack)
    return pack, interop.gaussians_from_numpy(np_pack)


def test_prune_and_reset_opacity_match_jax(packs):
    jp, tp = packs
    mask = np.zeros(30, bool)
    mask[::3] = True
    same_pack(td.prune(tp, mask), jd.prune(jp, mask))
    for ceiling in (0.01, 0.3):
        same_pack(td.reset_opacity(tp, ceiling), jd.reset_opacity(jp, ceiling))


@pytest.mark.parametrize("extent", [1.0, 30.0, 1e-6])
def test_clone_and_split_match_jax(packs, extent):
    """extent 1e-6 selects every high-gradient Gaussian as big (split),
    30 as small (clone), 1 a mix."""
    jp, tp = packs
    grads = np.random.default_rng(1).random(30).astype(np.float32)
    same_pack(td.densify_and_clone(tp, grads, 0.4, extent), jd.densify_and_clone(jp, grads, 0.4, extent))
    for n_split in (2, 3):
        t = td.densify_and_split(tp, grads, 0.4, extent, n_split=n_split,
                                 rng=np.random.default_rng(7))
        j = jd.densify_and_split(jp, grads, 0.4, extent, n_split=n_split,
                                 rng=np.random.default_rng(7))
        same_pack(t, j)


def test_densify_and_prune_matches_jax(packs):
    """DensifyState accumulation over two rounds of stats (with radii),
    then one full round with the screen-size prune on."""
    jp, tp = packs
    rng = np.random.default_rng(2)
    js, ts = jd.DensifyState.zeros(30), td.DensifyState.zeros(30)
    for _ in range(2):
        g = rng.standard_normal((30, 3)).astype(np.float32)
        filt = rng.random(30) < 0.7
        radii = rng.random(30).astype(np.float32) * 9
        js.add_stats(g, filt, radii)
        ts.add_stats(g, filt, radii)
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k))
    for screen in (None, 20.0):
        t, t_state = td.densify_and_prune(tp, ts, 0.8, 0.05, 1.0, max_screen_size=screen,
                                          rng=np.random.default_rng(3))
        j, j_state = jd.densify_and_prune(jp, js, 0.8, 0.05, 1.0, max_screen_size=screen,
                                          rng=np.random.default_rng(3))
        same_pack(t, j)
        assert t_state.denom.shape == j_state.denom.shape == (t.num_gaussians, 1)


@pytest.mark.parametrize("eyes", [([0, 0, -2.0], [2.0, 0.5, 0.3]), ([0, 0, -2.0], [0, 0, -2.0]),
                                  ([0.3, 0.2, -3.0], [-2.0, -1.2, 2.5])])
def test_camera_interpolate_matches_jax(eyes):
    """A slerp, the equal-rotation branch (angle below 1e-6) and a path
    across more than a half turn."""
    kw = dict(target=np.zeros(3), width=64, height=48, fov=0.9)
    jc = JaxCamera.interpolate(JaxCamera.look_at(eye=np.array(eyes[0]), **kw),
                               JaxCamera.look_at(eye=np.array(eyes[1]), **kw), 6)
    tc = Camera.interpolate(Camera.look_at(eye=np.array(eyes[0]), **kw),
                            Camera.look_at(eye=np.array(eyes[1]), **kw), 6)
    assert len(tc) == len(jc) == 6
    for a, b in zip(tc, jc):
        assert (a.width, a.height, a.fov_x, a.fov_y) == (b.width, b.height, b.fov_x, b.fov_y)
        for f in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)), atol=1e-6)
