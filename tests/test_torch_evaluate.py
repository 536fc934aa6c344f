"""Port parity of the evaluation slice, ``neuma_tpu_torch`` on the CPU
against ``neuma_tpu`` (same numpy inputs): the image losses and metrics
with their gradients, both chamfer branches and ``trajectory_mse``,
LPIPS-VGG with the same random weights (and an npz of the documented
layout, and the optional ``lpips`` package through a stand-in module),
and both ``evaluate`` CLIs on fabricated PNGs.

Tolerances: the losses and gradients to rtol 1e-5 with a floor of 1e-5
of the reference's largest magnitude (float32 on both sides; the SSIM
convolutions sum 121 taps in other orders); LPIPS to rtol 1e-5; the
``metrics.txt`` numbers to 1e-5 (they are printed to 5 and 6 decimals).
"""
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neuma_tpu.train import losses as jl
from neuma_tpu.train import lpips as jlp
from neuma_tpu.train import metrics as jm
from neuma_tpu_torch import interop
from neuma_tpu_torch.train import losses as tl
from neuma_tpu_torch.train import lpips as tlp
from neuma_tpu_torch.train import metrics as tm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def close(a, ref, rtol=1e-5):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    floor = rtol * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(a, ref, rtol=rtol, atol=floor)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    a = rng.random((2, 3, 29, 34)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["smooth_l1_loss", "mse", "psnr", "ssim", "l1_loss", "l2_loss"])
def test_loss_values_and_gradients_match_jax(images, name):
    """Value and gradient with respect to the first image (``ssim``'s
    through one ``jax.vjp``; ``mse`` and ``psnr`` are per image, summed
    for the gradient)."""
    a, b = images
    jf, tf = getattr(jl, name), getattr(tl, name)
    value, vjp = jax.vjp(lambda x: jf(x, jnp.asarray(b)), jnp.asarray(a))
    (jgrad,) = vjp(jnp.ones_like(value))
    ta = torch.from_numpy(a.copy()).requires_grad_(True)
    out = tf(ta, torch.from_numpy(b))
    out.sum().backward()
    assert tuple(out.shape) == tuple(value.shape)
    close(out.detach(), value)
    close(ta.grad, jgrad)


def test_gaussian_window_and_psnr_of_identical_images(images):
    close(tl._gaussian_window(11, 1.5), jl._gaussian_window(11, 1.5))
    a = torch.from_numpy(images[0])
    assert torch.isinf(tl.psnr(a, a)).all() and np.isinf(np.asarray(jl.psnr(images[0], images[0]))).all()
    close(tl.ssim(a[0], a[0]), 1.0)


@pytest.mark.parametrize("beta", [0.05, 1.0])
def test_smooth_l1_beta_matches_jax(images, beta):
    a, b = images
    close(tl.smooth_l1_loss(torch.from_numpy(a), torch.from_numpy(b), beta),
          jl.smooth_l1_loss(a, b, beta))


def test_chamfer_both_branches_and_trajectory_mse(monkeypatch):
    rng = np.random.default_rng(1)
    a, b = rng.random((700, 3)), rng.random((500, 3))
    kd = tm.chamfer_distance(a, b)
    np.testing.assert_allclose(kd, jm.chamfer_distance(a, b), rtol=1e-12)
    monkeypatch.setitem(sys.modules, "scipy.spatial", None)  # the import now raises
    with pytest.raises(ImportError):
        from scipy.spatial import cKDTree  # noqa: F401
    brute = tm.chamfer_distance(a, b, chunk=64)
    np.testing.assert_allclose(brute, kd, rtol=1e-12)
    np.testing.assert_allclose(brute, jm.chamfer_distance(a, b, chunk=64), rtol=1e-12)
    frames_a = [rng.random((50, 3)).astype(np.float32) for _ in range(12)]
    frames_b = [rng.random((50, 3)).astype(np.float32) for _ in range(11)]
    for skip in (1, 5):
        assert tm.trajectory_mse(frames_a, frames_b, skip) == jm.trajectory_mse(frames_a, frames_b, skip)
    assert tm.trajectory_mse([], []) == 0.0


def test_lpips_random_weights_match_jax():
    """The random fallback draws the same weights; the distance on a (2,
    3, 32, 32) batch within rtol 1e-5; the JAX weights through interop
    give the same distance."""
    jparams = jlp._init_random()
    tparams = tlp._init_random()
    for (jw, jb), (tw, tb) in zip(jparams.convs, tparams.convs):
        np.testing.assert_array_equal(tw.numpy(), jw)
        np.testing.assert_array_equal(tb.numpy(), jb)
    for jh, th in zip(jparams.heads, tparams.heads):
        np.testing.assert_array_equal(th.numpy(), jh)
    rng = np.random.default_rng(2)
    x0 = rng.random((2, 3, 32, 32)).astype(np.float32)
    x1 = rng.random((2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jlp.lpips(jnp.asarray(x0), jnp.asarray(x1), jparams))
    got = tlp.lpips(torch.from_numpy(x0), torch.from_numpy(x1), tparams)
    close(got, want)
    via = tlp.lpips(torch.from_numpy(x0), torch.from_numpy(x1),
                    interop.lpips_params_from_numpy(jparams))
    np.testing.assert_array_equal(via.numpy(), got.numpy())
    # odd sizes: 45 x 37 pools to 22 x 18, 11 x 9, 5 x 4, 2 x 2
    taps = tlp._vgg_features(tparams, torch.zeros((1, 3, 45, 37)))
    assert [tuple(t.shape[2:]) for t in taps] == [(45, 37), (22, 18), (11, 9), (5, 4), (2, 2)]


def test_lpips_npz_loads_as_pretrained(tmp_path, capsys):
    """An npz in the documented layout (conv{i}_w/b, head{j}_w) is
    pretrained and named ``lpips_vgg``; without one the metric is
    ``lpips_vgg_rand`` with its WARNING."""
    src = jlp._init_random(seed=5)
    arrays = {}
    for i, (w, b) in enumerate(src.convs):
        arrays[f"conv{i}_w"], arrays[f"conv{i}_b"] = w, b + 0.01
    for j, h in enumerate(src.heads):
        arrays[f"head{j}_w"] = 2.0 * h
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **arrays)
    metric = tlp.LPIPSMetric(path, device="cpu")
    assert metric.params.pretrained and metric.name == "lpips_vgg"
    np.testing.assert_array_equal(metric.params.convs[3][1].numpy(), arrays["conv3_b"])
    rng = np.random.default_rng(3)
    a, b = rng.random((3, 24, 24)).astype(np.float32), rng.random((3, 24, 24)).astype(np.float32)
    want = tlp.lpips(torch.from_numpy(a), torch.from_numpy(b), tlp.LPIPSParams.from_numpy(
        [(arrays[f"conv{i}_w"], arrays[f"conv{i}_b"]) for i in range(13)],
        [arrays[f"head{j}_w"] for j in range(5)], pretrained=True))
    assert metric(a, b) == float(want[0])
    assert "WARNING" not in capsys.readouterr().out
    fallback = tlp.LPIPSMetric(tmp_path / "absent.npz", device="cpu")
    assert not fallback.params.pretrained and fallback.name == "lpips_vgg_rand"
    assert "WARNING: no pretrained LPIPS-VGG weights" in capsys.readouterr().out


def test_optional_lpips_package_is_preferred(monkeypatch):
    """With an ``lpips`` module importable, ``_lpips_model`` names the
    metric ``lpips`` and calls the package's model on (1, 3, H, W) inputs
    in [-1, 1]."""
    from neuma_tpu_torch.apps import evaluate

    seen = []

    class StandIn(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            assert net == "vgg"

        def forward(self, a, b):
            seen.append((tuple(a.shape), float(a.min()), float(a.max())))
            return torch.mean(torch.abs(a - b)).reshape(1, 1, 1, 1)

    monkeypatch.setitem(sys.modules, "lpips", types.SimpleNamespace(LPIPS=StandIn))
    name, call = evaluate._lpips_model(device="cpu")
    r = np.zeros((8, 6, 3), np.float32)
    g = np.ones((8, 6, 3), np.float32)
    assert name == "lpips" and call(r, g) == pytest.approx(2.0)
    assert seen == [((1, 3, 8, 6), -1.0, -1.0)]


def _frames(root, name, n, size, seed):
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    base = (rng.random((size[0], size[1], 3)) * 255).astype(np.uint8)
    for i in range(n):
        noise = rng.integers(-30, 30, base.shape)
        img = np.clip(base.astype(int) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / f"{name}_{i}.png")


def _metrics(path):
    """{name: mean} and the per-frame rows of a metrics.txt."""
    text = path.read_text()
    head, rows = text.split("\nper-frame:\n")
    means = {k: float(v) for k, v in (line.split(": ") for line in head.strip().splitlines())}
    per = [{k: float(v) for k, v in re.findall(r"(\w+)=([-\d.inf]+)", line)}
           for line in rows.strip().splitlines()]
    return means, per


@pytest.mark.parametrize("case", ["crop", "small"])
def test_evaluate_apps_match(tmp_path, case, capsys):
    """Both CLIs on the same PNGs. ``crop``: 100x90 frames larger than
    ``--crop 10 55 20 75`` (a 45x55 crop, odd pooling), ``--skip 2
    --start 1 --end 4`` and ``--video`` (side-by-side frames and a GIF or
    video). ``small``: 40x40 frames with the default crop, which does not
    apply. The same metric names, the means and every per-frame number
    within 1e-5."""
    from neuma_tpu.apps import evaluate as jax_eval
    from neuma_tpu_torch.apps import evaluate as port_eval

    size, n = ((100, 90), 9) if case == "crop" else ((40, 40), 3)
    _frames(tmp_path / "render", "r", n, size, 0)
    _frames(tmp_path / "gt", "g", n, size, 1)
    args = ["-r", str(tmp_path / "render"), "-g", str(tmp_path / "gt")]
    if case == "crop":
        args += ["--crop", "10", "55", "20", "75", "--skip", "2", "--start", "1", "--end", "4",
                 "--video"]
    jax_eval.main(args + ["-o", str(tmp_path / "jax.txt")])
    port_eval.main(args + ["-o", str(tmp_path / "port.txt")], device="cpu")
    (jmeans, jrows), (tmeans, trows) = _metrics(tmp_path / "jax.txt"), _metrics(tmp_path / "port.txt")
    assert list(tmeans) == list(jmeans) == ["psnr", "ssim", "lpips_vgg_rand"]
    assert len(trows) == len(jrows) == (3 if case == "crop" else n)
    for k in jmeans:
        assert abs(tmeans[k] - jmeans[k]) <= 1e-5, k
        for a, b in zip(trows, jrows):
            assert abs(a[k] - b[k]) <= 1e-5, k
    if case == "crop":
        sbs = sorted((tmp_path / "render" / "side_by_side").glob("sbs_*.png"))
        assert len(sbs) == 3 and Image.open(sbs[0]).size == (180, 100)
        assert list((tmp_path / "render").glob("side_by_side.*"))
    assert "Metrics written to" in capsys.readouterr().out
