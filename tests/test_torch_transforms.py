"""Port parity: rotation conversions, SH band rotation, Gaussian-pack
transforms and the video writer (``neuma_tpu_torch.ops.rotation``,
``ops.wigner``, ``render.transforms`` and ``utils.video`` against the
JAX package's, the same numpy inputs, CPU).

Values agree within a scaled 1e-5 (max error over the reference's
largest value; quaternions also up to nothing: the same sign, so the tie
rule and branch order of ``rotmat_to_quat`` match, near-180-degree
rotations included). The video writer is run with ``imageio`` and with
it removed (the GIF is then written by PIL).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neuma_tpu.ops import rotation as jrot
from neuma_tpu.ops import wigner as jwig
from neuma_tpu.render import transforms as jtr
from neuma_tpu.render.gaussians import create_from_points as jcreate
from neuma_tpu.utils import video as jvideo
from neuma_tpu_torch import interop
from neuma_tpu_torch.ops import rotation as trot
from neuma_tpu_torch.ops import wigner as twig
from neuma_tpu_torch.render import transforms as ttr
from neuma_tpu_torch.utils import video as tvideo
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size == 0:
        return 0.0
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _rotations(n=32, seed=0):
    """Random rotations plus the corner cases of ``rotmat_to_quat``: the
    identity, 180 degrees about each axis and about a diagonal, and
    near-180-degree turns."""
    rng = np.random.default_rng(seed)
    aa = rng.standard_normal((n, 3)).astype(np.float32)
    axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 1, 1], [0.3, -1, 0.2]],
                    np.float32)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    special = np.concatenate([np.zeros((1, 3), np.float32), np.pi * axes,
                              (np.pi - 1e-3) * axes]).astype(np.float32)
    return np.array(jrot.axis_angle_to_rotmat(jnp.asarray(np.concatenate([aa, special]))))


def test_axis_angle_and_euler_match_jax():
    rng = np.random.default_rng(1)
    aa = rng.standard_normal((40, 3)).astype(np.float32)
    aa[0] = 0.0  # the zero rotation
    assert _err(trot.axis_angle_to_rotmat(torch.as_tensor(aa)),
                jrot.axis_angle_to_rotmat(jnp.asarray(aa))) <= TOL
    ang = rng.uniform(-np.pi, np.pi, (40, 3)).astype(np.float32)
    for order in ("XYZ", "ZYX", "YXZ"):
        assert _err(trot.euler_to_rotmat(torch.as_tensor(ang), order),
                    jrot.euler_to_rotmat(jnp.asarray(ang), order)) <= TOL


def test_quaternion_conversions_match_jax():
    R = _rotations()
    q_t = trot.rotmat_to_quat(torch.as_tensor(R))
    q_j = np.asarray(jrot.rotmat_to_quat(jnp.asarray(R)))
    assert _err(q_t, q_j) <= TOL  # the same sign on every row
    back = trot.quat_to_rotmat(q_t)
    assert _err(back, R) <= 1e-5
    rng = np.random.default_rng(2)
    q = rng.standard_normal((20, 4)).astype(np.float32)
    assert _err(trot.quat_to_rotmat(torch.as_tensor(q)), jrot.quat_to_rotmat(jnp.asarray(q))) <= TOL


def test_quaternion_ties_pick_the_first_branch():
    """Equal pivots (a 180-degree turn about (1, 1, 0): m00 - m11 - m22
    equals m11 - m00 - m22) take the first candidate, as ``jnp.argmax``."""
    R = np.array(jrot.axis_angle_to_rotmat(
        jnp.asarray([[np.pi / np.sqrt(2), np.pi / np.sqrt(2), 0.0]], jnp.float32)))
    R = 0.5 * (R + R.transpose(0, 2, 1))  # exactly symmetric: the pivots tie
    np.testing.assert_array_equal(trot.rotmat_to_quat(torch.as_tensor(R)).numpy(),
                                  np.asarray(jrot.rotmat_to_quat(jnp.asarray(R))))


def test_rot6d_round_trip_matches_jax():
    R = _rotations(seed=3)
    d6 = np.array(jrot.rotmat_to_rot6d(jnp.asarray(R)))
    np.testing.assert_array_equal(trot.rotmat_to_rot6d(torch.as_tensor(R)).numpy(), d6)
    noisy = d6 + 0.1 * np.random.default_rng(4).standard_normal(d6.shape).astype(np.float32)
    assert _err(trot.rot6d_to_rotmat(torch.as_tensor(noisy)),
                jrot.rot6d_to_rotmat(jnp.asarray(noisy))) <= TOL


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_rotate_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    f_rest = rng.standard_normal((16, (deg + 1) ** 2 - 1, 3)).astype(np.float32)
    for R in _rotations(n=3, seed=deg)[[0, 1, 2, 5, 9]]:
        got = twig.rotate_sh(torch.as_tensor(f_rest), torch.as_tensor(R))
        want = jwig.rotate_sh(jnp.asarray(f_rest), jnp.asarray(R))
        assert _err(got, want) <= TOL
        for Dt, Dj in zip(twig.sh_rotation_matrices(torch.as_tensor(R), deg),
                          jwig.sh_rotation_matrices(jnp.asarray(R), deg)):
            assert _err(Dt, Dj) <= TOL


def test_sh_rotation_is_differentiable():
    R = torch.as_tensor(_rotations(n=1)[0], dtype=torch.float32).requires_grad_(True)
    f = torch.randn((4, 15, 3), generator=torch.Generator().manual_seed(0))
    (g,) = torch.autograd.grad(twig.rotate_sh(f, R).square().sum(), R)
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("deg", [0, 3])
def test_transform_gaussians_matches_jax(deg):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.5, 0.5, (60, 3)).astype(np.float32)
    jpack = jcreate(pts, rng.random((60, 3)).astype(np.float32), sh_degree=deg)
    rest = rng.standard_normal(np.shape(jpack.features_rest)).astype(np.float32)
    rot = rng.standard_normal((60, 4)).astype(np.float32)
    jpack = dataclasses.replace(jpack, features_rest=jnp.asarray(rest), rotation=jnp.asarray(rot))
    tpack = interop.gaussians_from_numpy(jax.tree_util.tree_map(np.asarray, jpack))
    R = _rotations(n=1, seed=8)[0]
    t = np.array([0.1, -0.2, 0.3], np.float32)
    origin = np.array([[0.05, 0.0, -0.05]], np.float32)
    cases = [dict(scale=1.7), dict(scale=0.6, origin=origin), dict(R=R), dict(t=t),
             dict(R=R, t=t, scale=1.3, origin=origin)]
    for kw in cases:
        want = jtr.transform_gaussians(jpack, **{k: jnp.asarray(v) for k, v in kw.items()})
        got = ttr.transform_gaussians(tpack, **{k: torch.as_tensor(v) for k, v in kw.items()})
        for name in ("xyz", "scaling", "rotation", "features_rest", "features_dc", "opacity"):
            assert _err(getattr(got, name), getattr(want, name)) <= TOL, (kw.keys(), name)
    q0, q1 = rng.standard_normal((2, 10, 4)).astype(np.float32)
    assert _err(ttr.quaternion_multiply(torch.as_tensor(q0), torch.as_tensor(q1)),
                jtr.quaternion_multiply(jnp.asarray(q0), jnp.asarray(q1))) <= TOL


def _frames(folder, n=5, size=12):
    rng = np.random.default_rng(0)
    folder.mkdir()
    for i in (0, 1, 2, 10, 3)[:n]:  # natural order: 0 1 2 3 10
        Image.fromarray((rng.random((size, size, 4)) * 255).astype(np.uint8), "RGBA").save(
            folder / f"v_{i:d}.png")
    Image.fromarray(np.zeros((size, size, 3), np.uint8)).save(folder / "w_0.png")


def _gif_frames(path):
    im = Image.open(path)
    out = []
    for i in range(im.n_frames):
        im.seek(i)
        out.append(np.array(im.convert("RGB")))
    return out


def test_frames_load_as_in_jax(tmp_path):
    _frames(tmp_path / "f")
    paths = [p.name for p in tvideo._natsorted((tmp_path / "f").glob("v_*.png"))]
    assert paths == ["v_0.png", "v_1.png", "v_2.png", "v_3.png", "v_10.png"]
    assert paths == [p.name for p in jvideo._natsorted((tmp_path / "f").glob("v_*.png"))]
    for white in (False, True):
        got = tvideo._load_frames(tmp_path / "f", "v_*.png", 2, white, resize=(8, 8))
        want = jvideo._load_frames(tmp_path / "f", "v_*.png", 2, white, resize=(8, 8))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_save_video_with_imageio(tmp_path, capsys):
    """With imageio the writer does what the JAX package's does: an mp4
    where the ffmpeg plugin works, else a GIF beside it."""
    pytest.importorskip("imageio")
    _frames(tmp_path / "f")
    got = tvideo.save_video(tmp_path / "f", "v_*.png", tmp_path / "t.mp4", fps=10)
    jvideo.save_video(tmp_path / "f", "v_*.png", tmp_path / "j.mp4", fps=10)
    want = next(p for p in tmp_path.iterdir() if p.stem == "j")
    assert got.suffix == want.suffix and got.stem == "t"
    if got.suffix == ".gif":
        for a, b in zip(_gif_frames(got), _gif_frames(want)):
            np.testing.assert_array_equal(a, b)
    assert "imageio is not installed" not in capsys.readouterr().out
    tvideo.save_gif(tmp_path / "f", "v_*.png", tmp_path / "g.gif", fps=10)
    assert len(_gif_frames(tmp_path / "g.gif")) == 5


def test_save_video_without_imageio(tmp_path, monkeypatch, capsys):
    """With imageio removed the GIF that the JAX package falls back to is
    written by PIL: every frame, in natural order, and the printed line
    says so."""
    monkeypatch.setitem(sys.modules, "imageio", None)  # import imageio -> ImportError
    _frames(tmp_path / "f")
    got = tvideo.save_video(tmp_path / "f", "v_*.png", tmp_path / "t.mp4", fps=10, white_bg=True)
    assert got == tmp_path / "t.gif" and got.is_file()
    assert "imageio is not installed: GIF written by PIL" in capsys.readouterr().out
    frames = _gif_frames(got)
    want = tvideo._load_frames(tmp_path / "f", "v_*.png", 1, True)
    assert len(frames) == len(want) == 5
    assert frames[0].shape == want[0].shape
    tvideo.save_gif(tmp_path / "f", "v_*.png", tmp_path / "g.gif", skip_frame=2)
    assert len(_gif_frames(tmp_path / "g.gif")) == 3
    assert tvideo.save_video(tmp_path / "f", "none_*.png", tmp_path / "n.mp4") is None
