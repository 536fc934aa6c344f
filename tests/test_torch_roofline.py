"""The port's ``utils/roofline.py`` against the JAX package's
``neuma_tpu/utils/roofline.py``: every model's ``(flops, bytes)`` exactly
over a grid of shapes that holds both bench shapes, ``sol_time`` and
``grounding_step_frame`` under the same peaks, and the port's one chip,
``H100_SXM``, whose peaks ``chip_smoke.py``'s kernel bounds read."""
import dataclasses
import functools
import importlib.util
import itertools
from pathlib import Path

import pytest

from neuma_tpu.utils import roofline as jrl
from neuma_tpu_torch.utils import roofline as rl
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent

# (n_particles, grid, width, height, n_pairs, max_pairs, substeps, n_views):
# the headline and realworld bench shapes (pairs at both ends of what the
# first view needs) and small ones.
SHAPES = [
    (10000, 32, 800, 800, 65536, 1 << 16, 1, 1),
    (10000, 32, 800, 800, 67768, 1 << 17, 1, 1),
    (30000, 70, 1920, 1080, 262144, 1 << 18, 20, 3),
    (30000, 70, 1920, 1080, 391000, 1 << 19, 20, 3),
    (800, 16, 64, 64, 2311, 1 << 12, 2, 1),
    (1, 1, 1, 1, 0, 0, 1, 1),
]
NS = sorted({s[0] for s in SHAPES} | {0, 48068})
GRIDS = sorted({s[1] for s in SHAPES} | {24, 42})

MODELS = {
    "p2g": [(n, g) for n, g in itertools.product(NS, GRIDS)],
    "grid_op": [(g,) for g in GRIDS],
    "g2p": [(n, g) for n, g in itertools.product(NS, GRIDS)],
    "sim_step": [(n, g) for n, g in itertools.product(NS, GRIDS)],
    "material_mlp": [(n,) for n in NS] + [(n, (16, 16), 5, 9, 4) for n in NS]
    + [(n, (64, 64, 64), 3, 6, 8) for n in NS],
    "svd3": [(n,) for n in NS],
    "composite": [s[4:5] + s[2:4] for s in SHAPES] + [s[4:5] + s[2:4] + (8,) for s in SHAPES],
    "pair_build": [(s[4], s[5]) for s in SHAPES],
    "projection": [(n,) for n in NS],
    "sh_eval": [(n,) for n in NS] + [(n, d) for n in NS for d in range(4)],
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_counts_equal_jax(name):
    for args in MODELS[name]:
        assert getattr(rl, name)(*args) == getattr(jrl, name)(*args), (name, args)


PEAKS = {
    "h100_sxm": dataclasses.asdict(rl.H100_SXM),
    "jax_default": dataclasses.asdict(jrl.V5E),
}


@pytest.mark.parametrize("peaks", sorted(PEAKS))
def test_sol_time_equals_jax_under_the_same_peaks(peaks):
    chip, jchip = rl.ChipPeaks(**PEAKS[peaks]), jrl.ChipPeaks(**PEAKS[peaks])
    for n, g in itertools.product(NS, GRIDS):
        for f32 in (True, False):
            flops, nbytes = rl.sim_step(n, g)
            assert rl.sol_time(flops, nbytes, f32, chip) == jrl.sol_time(flops, nbytes, f32, jchip)
    assert rl.sol_time(1e12, 1e9) == rl.sol_time(1e12, 1e9, True, rl.H100_SXM)


@pytest.mark.parametrize("peaks", sorted(PEAKS))
@pytest.mark.parametrize("bwd_factor", [1.0, 3.0])
def test_grounding_step_frame_equals_jax(monkeypatch, peaks, bwd_factor):
    """Both packages' ``grounding_step_frame`` read their module's
    ``sol_time``; each is bound to the same peaks here."""
    monkeypatch.setattr(jrl, "sol_time", functools.partial(
        jrl.sol_time, chip=jrl.ChipPeaks(**PEAKS[peaks])))
    monkeypatch.setattr(rl, "sol_time", functools.partial(
        rl.sol_time, chip=rl.ChipPeaks(**PEAKS[peaks])))
    for shape in SHAPES:
        got = rl.grounding_step_frame(*shape, bwd_factor=bwd_factor)
        assert got == jrl.grounding_step_frame(*shape, bwd_factor=bwd_factor), shape
        assert got > 0


def test_default_chip_is_h100_sxm():
    """Unpatched, the port's bound is the JAX formula at ``H100_SXM``."""
    h100 = functools.partial(jrl.sol_time, chip=jrl.ChipPeaks(**PEAKS["h100_sxm"]))
    for shape in SHAPES:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jrl, "sol_time", h100)
            want = jrl.grounding_step_frame(*shape)
        assert rl.grounding_step_frame(*shape) == want


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_h100_peaks_are_the_data_sheet_and_chip_smoke_uses_them():
    assert (rl.H100_SXM.bf16_flops, rl.H100_SXM.f32_flops, rl.H100_SXM.hbm_bps) == (
        989e12, 67e12, 3.35e12)
    chip_smoke = _chip_smoke()
    assert chip_smoke.bound_ms(3.35e9, 1.0) == (1.0, "bytes")
    assert chip_smoke.bound_ms(1.0, 67e9) == (1.0, "operations")
    for nbytes, flops in ((1.23e8, 4.56e9), (7.0e6, 1.0e12), (0.0, 0.0)):
        t_bytes, t_ops = nbytes / rl.H100_SXM.hbm_bps * 1e3, flops / rl.H100_SXM.f32_flops * 1e3
        assert chip_smoke.bound_ms(nbytes, flops)[0] == max(t_bytes, t_ops)
    src = (REPO / "chip_smoke.py").read_text()
    assert "3.35e12" not in src and "67e12" not in src, "chip_smoke.py keeps its own peaks"


def test_the_port_holds_one_chip_and_no_tpu_figure():
    chips = [v for v in vars(rl).values() if isinstance(v, rl.ChipPeaks)]
    assert chips == [rl.H100_SXM]
    figures = [repr(getattr(jrl.V5E, f.name)) for f in dataclasses.fields(jrl.V5E)
               if f.name != "name"] + ["197e12", "819e9", jrl.V5E.name]
    sources = sorted((REPO / "neuma_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in sources:
        text = path.read_text()
        assert not [f for f in figures if f in text], path
