"""The port's spans and counters on the CPU (``utils/profiling.py``):
``span`` does nothing without a profiler; with one, the MPM substep, the
binding, the rasterizer and the stage-2 trainer open their spans with the
nesting the benchmark's span charging reads (``perfbench/spantrace.py``),
and the trainer's spans close before ``log_fn``; ``refresh_step_layouts``
counts its refreshes and rebuilds."""
import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neuma_tpu_torch.core.types import ParticleState
from neuma_tpu_torch.render.binding import apply_binding_F, apply_binding_xyz, deform_cov_by_F
from neuma_tpu_torch.render.rasterize import rasterize_with_aux
from neuma_tpu_torch.sim.mpm import make_packed_substep
from neuma_tpu_torch.sim.rollout import make_step_fn, rollout
from neuma_tpu_torch.train import grounding
from neuma_tpu_torch.utils import profiling
from neuma_tpu_torch.utils.profiling import span
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LAYERS = ("train.", "loss.", "material.", "mpm.", "binding.", "raster.", "test.")


def scene(**over):
    kw = dict(n_particles=300, grid=32, substeps=1, width=32, height=32, n_views=1,
              force_mask=False, max_pairs=1 << 12, max_per_tile=64, layer_widths=(16, 16),
              lora_r=4)
    return grounding.build_scene(**{**kw, **over}, device="cpu")


def traced(fn):
    """``fn()`` under the profiler; returns its spans as (thread, path,
    start, end), each path the names of the spans open on the thread from
    the outermost down, joined by ``/``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    by_thread = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(LAYERS):
            by_thread[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                                   e.name()))
    out = []
    for tid, spans in by_thread.items():
        stack = []
        for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][1] <= start:
                stack.pop()
            stack.append((start, end, name))
            out.append((tid, "/".join(s[2] for s in stack), start, end))
    return out


def substep_fwd_bwd():
    sc = scene()
    step = make_packed_substep(sc.constants, sc.statics, sc.elasticity, sc.plasticity)
    x = sc.init_x.clone().requires_grad_(True)
    out = step(ParticleState.initial(x, torch.zeros_like(x)), None)
    params = [p for m in (sc.elasticity, sc.plasticity) for p in m.parameters() if p.requires_grad]
    torch.autograd.grad(out.x.sum() + out.F.sum(), [x] + params)


def binding_fwd():
    sc = scene()
    table = sc.binding.with_inverse(sc.init_x.shape[0])
    x = sc.init_x.clone().requires_grad_(True)
    means = apply_binding_xyz(table, x, sc.init_x, sc.gaussians.xyz)
    F = torch.eye(3).expand(x.shape[0], 3, 3)
    deform_cov_by_F(sc.gaussians.get_covariance(), apply_binding_F(table, F))
    torch.autograd.grad(means.sum(), x)


def raster_fwd_bwd():
    sc = scene()
    g = sc.gaussians
    means = g.xyz.detach().clone().requires_grad_(True)
    img, _ = rasterize_with_aux(means, g.get_covariance().detach(), g.get_opacity.detach(),
                                sc.cameras[0], sc.background, shs=g.get_features.detach(),
                                sh_degree=g.sh_degree, cfg=sc.raster_cfg)
    torch.autograd.grad(img.sum(), means)


CASES = {
    "substep": (substep_fwd_bwd, {
        "mpm.substep", "mpm.substep/mpm.layouts", "mpm.substep/material.elasticity",
        "mpm.substep/mpm.step", "mpm.substep/material.plasticity",
        "mpm.substep.bwd", "mpm.substep.bwd/material.plasticity",
        "mpm.substep.bwd/mpm.step.bwd", "mpm.substep.bwd/material.elasticity"}),
    "binding": (binding_fwd, {"binding.xyz", "binding.F", "binding.cov"}),
    "raster": (raster_fwd_bwd, {
        "raster.view", "raster.view/raster.pairs", "raster.view/raster.composite",
        "raster.composite.bwd"}),
}


@pytest.mark.parametrize("form", ["context", "decorator"])
def test_span_without_profiler_records_nothing(monkeypatch, form):
    """No profiler: neither the port's recorder nor ``record_function``
    runs, in the span itself or anywhere on the substep's path."""

    def refuse(*args, **kwargs):
        raise AssertionError("recorded with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if form == "context":
        with span("test.context"):
            value = 1
    else:
        value = span("test.decorator")(lambda: 1)()
    assert value == 1
    substep_fwd_bwd()


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_and_nesting(case):
    fn, want = CASES[case]
    assert {path for _, path, _, _ in traced(fn)} == want


def test_span_records_on_the_host_timeline_only():
    """A span is a host operation of the thread that opens it, with the
    profiler's start and end, and its decorator keeps the function."""

    @span("test.decorated")
    def double(x):
        return 2 * x

    spans = traced(lambda: double(torch.ones(3)))
    assert [p for _, p, _, _ in spans] == ["test.decorated"]
    assert spans[0][3] > spans[0][2]
    assert double.__name__ == "double"


def test_trainer_spans_close_before_log_fn():
    """Two epochs of stage 2: each epoch opens ``train.loss``,
    ``train.grad``, ``train.optim`` and ``train.read`` (once inside the
    optimizer step, once after it), the frame's spans lie under
    ``train.loss``, and none is open while ``log_fn`` runs."""
    cfg = {"num_epochs": 2, "elasticity_lr": 0.02, "plasticity_lr": 0.01, "warmup_step": 1,
           "elasticity_scheduler": {"type": "cos", "max_steps": 2},
           "plasticity_scheduler": {"type": "exp", "max_steps": 2, "lr_final": 1e-3},
           "decay_init": 0.5, "decay_final": 1.0, "decay_steps": 1, "lambda_max_decay": 0.33}
    sc = scene(grid=16)
    gt = np.full((2, 1, 3, 32, 32), 0.3, np.float32)
    logged = []

    def log_fn(epoch, *_):
        with span("test.log"):
            logged.append(epoch)

    spans = traced(lambda: grounding.finetune_constitutive(
        sc, gt, np.array([0.4, -0.2, 0.1], np.float32), cfg, log_fn=log_fn,
        write_state=False, device="cpu"))
    assert logged == [1, 2]
    paths = collections.Counter(p for _, p, _, _ in spans)
    for name in ("train.loss", "train.grad", "train.optim", "train.optim/train.read",
                 "train.read"):
        assert paths[name] == 2, name
    assert paths["train.loss/loss.frame"] == 4
    assert paths["train.loss/loss.frame/mpm.substep/mpm.step"] == 4
    logs = [start for _, p, start, _ in spans if p == "test.log"]
    trainer = [(s, e) for _, p, s, e in spans if p.startswith("train.")]
    assert len(logs) == 2 and trainer
    assert not any(s <= t < e for t in logs for s, e in trainer)


@pytest.mark.parametrize("speed,rebuilt", [(0.0, 0), (2.0, 1)])
def test_layout_counters(speed, rebuilt):
    """A slab-grid rollout of 12 steps refreshes its layouts once a step
    and rebuilds them when a particle changed block: never when nothing
    moves, once for particles that cross one block boundary (block 1 to
    block 2 where the stencil's base reaches cell 28 of 32)."""
    sc = scene(grid=32)
    n = 8
    edge = 28.5 / 32
    x0 = torch.full((n, 3), 0.5)
    x0[:, 0] = edge - 0.005 + 0.001 * torch.arange(n) / n
    v0 = torch.zeros((n, 3))
    v0[:, 0] = speed
    statics = dataclasses.replace(sc.statics, vol=sc.statics.vol[:n], rho=sc.statics.rho[:n],
                                  clip_bound=sc.statics.clip_bound[:n],
                                  enabled=sc.statics.enabled[:n])
    constants = dataclasses.replace(sc.constants, gravity=torch.zeros(3))
    step = make_step_fn(constants, statics, lambda F: torch.zeros_like(F), lambda F: F,
                        diff=False)
    profiling.reset_counters()
    with torch.no_grad():
        final, _ = rollout(step, ParticleState.initial(x0, v0), 12, constants=constants)
    assert profiling.counters["layouts.refreshed"] == 12
    assert profiling.counters["layouts.rebuilt"] == rebuilt
    assert bool((final.x[:, 0] > edge).all()) == bool(speed)
