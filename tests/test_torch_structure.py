"""Structure rules of the PyTorch port: no JAX and nothing of the JAX
package in ``neuma_tpu_torch/`` or ``chip_smoke.py``; entry points that
refuse to run without a CUDA device unless asked for the CPU; stable
sorts; no float atomics in the kernels that sum many contributions into
one slot; each module names its JAX counterpart."""
import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (test files import both frameworks)
import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "neuma_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "neuma_tpu")]
    assert not bad, f"{path.name} imports {bad}"


def test_every_sort_is_stable():
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("argsort", "sort")):
                kw = {k.arg: k.value for k in node.keywords}
                assert "stable" in kw and getattr(kw["stable"], "value", None) is True, (
                    f"{path.name}:{node.lineno} sorts without stable=True")


PARALLEL = ["distributed.py", "halo.py", "sharding.py", "dryrun.py"]


def test_parallel_modules_are_checked_and_spawned_ranks_import_no_jax():
    """The scale-out modules are among the sources scanned above, and a
    spawned rank (which imports the port's parallel package and the rank
    functions of ``tests/test_torch_parallel.py``,
    ``tests/test_torch_tile_sharding.py`` or ``chip_smoke.py``)
    loads no JAX at all, nor does the port's example."""
    for name in PARALLEL:
        assert PORT / "parallel" / name in SOURCES, name
    assert PORT / "examples" / "smoke_e2e.py" in SOURCES
    code = ("import sys; sys.path.insert(0, 'tests'); import neuma_tpu_torch.parallel, "
            "neuma_tpu_torch.parallel.dryrun, neuma_tpu_torch.train.grounding, test_torch_parallel, "
            "test_torch_tile_sharding, "
            "chip_smoke, neuma_tpu_torch.examples.smoke_e2e; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'neuma_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_p2g_kernel_has_no_float_atomics():
    src = (PORT / "csrc" / "p2g.cu").read_text()
    assert "atomicAdd" not in src and "atomic" not in src.replace("atomics", "")


@pytest.mark.parametrize("name", ["g2p_bwd.cu", "composite_bwd.cu", "composite.cu"])
def test_backward_kernels_have_no_float_atomics(name):
    """K3 sums its taps, K4 its segments and K5 each pair's pixels in a
    fixed order."""
    src = (PORT / "csrc" / name).read_text()
    assert "atomicAdd" not in src and "atomic" not in src.replace("atomics", "")


def _float_atomics(src):
    """The atomic calls in a CUDA source whose target is a float: a cast to
    float, or a name declared as a float pointer or float array."""
    src = re.sub(r"//[^\n]*", "", src)  # code only
    floats = set(re.findall(r"\bfloat2?\s*\*\s*(?:__restrict__\s+)?(\w+)", src)) | set(
        re.findall(r"\bfloat2?\s+(\w+)\s*\[", src))
    return [call.group(0) for call in re.finditer(r"\batomic\w*\s*\(([^,)]*)", src)
            if "float" in call.group(1) or set(re.findall(r"\w+", call.group(1))) & floats]


@pytest.mark.parametrize("path", sorted((PORT / "csrc").glob("*.cu")) + sorted((PORT / "csrc").glob("*.cuh")),
                         ids=lambda p: p.name)
def test_no_float_atomics_in_any_kernel(path):
    """No atomicAdd / atomicAdd_block / atomicCAS (or any other atomic)
    on a float: every reduction runs in a fixed order."""
    assert _float_atomics(path.read_text()) == [], path.name


def test_float_atomic_detector_catches_one():
    assert _float_atomics(
        "__global__ void k(float* __restrict__ out, int* n) { atomicAdd(&out[0], 1.f); }")
    assert _float_atomics("__global__ void k(float2* s) { atomicAdd_block((float*)s, 1.f); }")
    assert not _float_atomics("__global__ void k(int* n) { atomicAdd(n, 1); }")


KERNEL_SOURCES = sorted((PORT / "csrc").glob("*.cu"))


def _entry_points(src):
    """The names and parameter counts of a CUDA source's ``extern "C"``
    functions."""
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in re.finditer(r'extern "C"\s+\w+\s+(\w+)\s*\(([^)]*)\)', src)}


@pytest.mark.parametrize("path", KERNEL_SOURCES, ids=lambda p: p.name)
def test_kernel_entry_points_have_signatures(path):
    """Each C entry point is in ``kernels._SIGNATURES`` with as many
    argument types as it has parameters (ctypes would otherwise pass a
    pointer as a 32-bit int)."""
    from neuma_tpu_torch import kernels

    found = _entry_points(path.read_text())
    assert found, path.name
    assert {k: len(kernels._SIGNATURES.get(k, ())) for k in found} == found, path.name


def test_every_signature_names_an_entry_point():
    from neuma_tpu_torch import kernels

    defined = {}
    for path in KERNEL_SOURCES:
        defined.update(_entry_points(path.read_text()))
    assert set(kernels._SIGNATURES) == set(defined)


def test_kernels_build_without_fast_math():
    """No fast math and no flush-to-zero: K6 and K7 agree bit for bit with
    eager PyTorch, whose float arithmetic keeps denormals (the Jacobi's
    1e-38 is one), and they call only correctly rounded operations."""
    from neuma_tpu_torch import kernels

    flags = " ".join(kernels._ARCH + kernels._FLAGS)
    assert "fast_math" not in flags and "ftz" not in flags and "fmad" not in flags
    src = (PORT / "csrc" / "svd3.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert not re.search(r"__f\w*_r[zud]\b|__fdividef|__expf|rsqrtf|__frsqrt|\bsqrtf\b", code)
    for op in ("__fmul_rn", "__fadd_rn", "__fsub_rn", "__fdiv_rn", "__fsqrt_rn"):
        assert op in code, op


def test_modules_name_their_jax_counterpart():
    checked = set()
    for path in PORT.rglob("*.py"):
        if path.name in ("__init__.py", "kernels.py", "device.py", "interop.py"):
            continue
        doc = ast.get_docstring(ast.parse(path.read_text())) or ""
        assert "neuma_tpu/" in doc, f"{path.relative_to(REPO)} docstring names no JAX counterpart"
        checked.add(str(path.relative_to(PORT)))
    new = {"vis/instance.py", "vis/campath.py", "vis/viewer.py", "apps/visualize.py",
           "utils/profiling.py"}
    assert new <= checked
    for rel in new:
        assert f"neuma_tpu/{rel}" in ast.get_docstring(ast.parse((PORT / rel).read_text())), rel


def test_importing_the_port_builds_nothing():
    import neuma_tpu_torch.train.grounding  # noqa: F401  (imports every layer)
    from neuma_tpu_torch import kernels

    assert kernels._lib is None


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: these check the no-device refusal")


def test_entry_points_raise_without_cuda():
    _no_cuda()
    from neuma_tpu_torch.core.device import resolve_device
    from neuma_tpu_torch.train.grounding import build_scene, make_rollout_loss

    small = dict(n_particles=300, grid=32, substeps=1, width=32, height=32, n_views=1,
                 force_mask=True, max_pairs=1024, max_per_tile=64, layer_widths=(8,), lora_r=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_scene(**small)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    scene = build_scene(**small, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_rollout_loss(scene)
    loss, aux = make_rollout_loss(scene, device="cpu")(
        torch.zeros(3), torch.ones(1), torch.zeros((1, 1, 3, 32, 32)))
    assert torch.isfinite(loss) and set(aux) == {"overflow", "halo_overflow"}
    from neuma_tpu_torch.apps.finetune import main as finetune_main

    with pytest.raises(RuntimeError, match="CUDA"):
        finetune_main(["-c", "any-config.yaml"])
    from neuma_tpu_torch.apps.common import assemble_scene, run_data_preparation
    from neuma_tpu_torch.data.prepare import load_prepared, prepare_simulation_data
    from neuma_tpu_torch.sim.initializers import build_initial_state, build_statics

    # the device is resolved before any argument is read
    for call in (lambda: run_data_preparation(None, "any-dir"),
                 lambda: assemble_scene(None, "any-dir", None, None, None, 1, 1, [], "l2",
                                        torch.zeros(3), False),
                 lambda: prepare_simulation_data("any-dir", "any.ply"),
                 lambda: load_prepared("any-dir"),
                 lambda: build_statics([]), lambda: build_initial_state([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    from neuma_tpu_torch.apps import evaluate, regist
    from neuma_tpu_torch.train.lpips import LPIPSMetric
    from neuma_tpu_torch.train.register import RegisterConfig, register_gaussians

    for call in (lambda: regist.main(["-c", "any-config.yaml"]),
                 lambda: evaluate.main(["-r", "any-dir", "-g", "any-dir"]),
                 lambda: register_gaussians(None, [], None, RegisterConfig(), None),
                 lambda: LPIPSMetric()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    from neuma_tpu_torch.apps import visualize
    from neuma_tpu_torch.core.types import MPMConstants
    from neuma_tpu_torch.parallel.dryrun import dryrun_multichip, spawn
    from neuma_tpu_torch.render.camera import Camera
    from neuma_tpu_torch.render.gaussians import create_from_points
    from neuma_tpu_torch.render.rasterize import RasterConfig, rasterize
    from neuma_tpu_torch.vis.instance import NeuMAInstance
    from neuma_tpu_torch.vis.viewer import DynamicViewer

    pack = create_from_points(np.full((4, 3), 0.5, np.float32), sh_degree=0)
    cam = Camera.look_at(eye=np.array([0.5, 0.5, -1.0]), target=np.full(3, 0.5), width=16,
                         height=16)
    for call in (lambda: visualize.main(["-c", "any-config.yaml"]),
                 lambda: NeuMAInstance(MPMConstants(), []).simulate(),
                 lambda: DynamicViewer(NeuMAInstance(MPMConstants(), [])),
                 lambda: spawn(print, 2), lambda: dryrun_multichip(2),
                 lambda: rasterize(pack.xyz, pack.get_covariance(), pack.get_opacity, cam,
                                   torch.ones(3), shs=pack.get_features, sh_degree=0,
                                   cfg=RasterConfig(max_pairs=1024, backend="pallas"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_trainers_raise_without_cuda():
    _no_cuda()
    from neuma_tpu_torch.train.grounding import (
        build_scene, finetune_constitutive, optimize_init_velocity)
    from neuma_tpu_torch.train.schedulers import cosine_decay_schedule

    scene = build_scene(n_particles=300, grid=32, substeps=1, width=32, height=32, n_views=1,
                        force_mask=True, max_pairs=1024, max_per_tile=64, layer_widths=(8,),
                        lora_r=2, device="cpu")
    gt = np.zeros((1, 1, 3, 32, 32), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        optimize_init_velocity(scene, gt, 1, 0.01, cosine_decay_schedule(0.01, 1))
    cfg = {"num_epochs": 1, "elasticity_lr": 0.01, "plasticity_lr": 0.01,
           "elasticity_scheduler": {"type": "cos"}, "plasticity_scheduler": {"type": "cos"},
           "decay_init": 1.0, "decay_final": 1.0}
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune_constitutive(scene, gt, np.zeros(3), cfg)


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    _no_cuda()
    run = lambda script: subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True, timeout=120)
    res = run(REPO / "chip_smoke.py")
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = run(tmp_path / "chip_smoke.py")
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_cpu_wrappers_take_the_plain_versions():
    from neuma_tpu_torch.render import raster_kernel as rk
    from neuma_tpu_torch.sim import p2g_kernel as pk

    gen = torch.Generator().manual_seed(0)
    pf = torch.rand((64, 9), generator=gen)
    start = torch.tensor([0, 32, 64], dtype=torch.int32)
    counts = torch.tensor([5, 20], dtype=torch.int32)
    for a, b in zip(rk.composite_fwd(pf, start, counts, 2), rk.composite_fwd_plain(pf, start, counts, 2)):
        assert torch.equal(a, b)
    T, _, last = rk.composite_fwd_plain(pf, start, counts, 2)
    dT, dC = torch.rand((2, 256), generator=gen), torch.rand((2, 768), generator=gen)
    assert torch.equal(rk.composite_bwd(pf, start, counts, T, last, dT, dC, 2),
                       rk.composite_bwd_plain(pf, start, counts, T, last, dT, dC, 2))
    payload = torch.zeros((2 * pk.CHUNK, 48))
    c2b = torch.zeros(2, dtype=torch.int32)
    assert torch.equal(pk.run_p2g_fwd(payload, c2b, 1), pk.run_p2g_fwd_plain(payload, c2b, 1))
    np.testing.assert_array_equal(pk.run_apic_gather(payload, torch.zeros((1, 4, 16, 16, 16)), c2b, 32.0).numpy(), 0.0)
    payload = torch.rand((2 * pk.CHUNK, 48), generator=gen)
    slabs = torch.rand((1, 4, 16, 16, 16), generator=gen)
    assert torch.equal(pk.run_apic_gather(payload, slabs, c2b, 32.0, derivs=True),
                       pk.run_apic_gather_plain(payload, slabs, c2b, 32.0, derivs=True))
