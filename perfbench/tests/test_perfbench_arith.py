"""The harness's arithmetic: rates, the tail, the trace's reductions,
the frozen roofline, the check's numbers, the result line and the
whole-name import check."""
import sys
import types

import pytest
import torch

from perfbench import check, devtrace, harness, program, roofline


def window(start, ends, frames=1, peak=0):
    return program.Window(t_start=start, ends=list(ends), frames_per_unit=frames, peak_bytes=peak)


def test_train_rate_over_whole_iterations():
    win = window(10.0, [16.0, 22.5], frames=2, peak=3 * 2 ** 30)
    e2e = harness.end_to_end("train", win, 30.0)
    assert e2e["train_frame_ms"] == (1e3 * 12.5 / 4, "ms")
    assert e2e["train_peak_gib"] == (3.0, "GiB")
    assert e2e["setup_s"] == (30.0, "s")


def test_serve_rate_and_tail_over_all_frames():
    ends = [0.1 * (i + 1) for i in range(99)] + [9.9 + 1.0]
    e2e = harness.end_to_end("serve", window(0.0, ends), 5.0)
    assert e2e["serve_frame_ms"][0] == pytest.approx(1e3 * 10.9 / 100)
    lat = harness.frame_latencies(window(0.0, ends))
    assert len(lat) == 100 and lat[-1] == pytest.approx(1.0)
    assert e2e["serve_frame_p95_ms"][0] == pytest.approx(100.0)


def test_trace_union_gaps_and_kernels():
    ns = 1_000_000  # 1 ms
    device_ops = [
        ("void at::native::vectorized_elementwise_kernel<4, x>(int, y)", 0, 2 * ns, True),
        ("(anonymous namespace)::k4_summaries(float const*, int)", 1 * ns, 2 * ns, True),
        ("p2g_chunk_kernel(float const*)", 10 * ns, 1 * ns, True),
        ("Memcpy DtoH (Device -> Pinned)", 20 * ns, 1 * ns, False),
    ]
    host_ops = [("aten::mm", 2 * ns, 11 * ns), ("cudaLaunchKernel", 9 * ns, 9 * ns + 100),
                ("aten::copy_", 12 * ns, 21 * ns)]
    out = devtrace.summarize(device_ops, host_ops, wall_s=0.05)
    assert out["busy_s"] == pytest.approx(0.005)
    assert out["launches"] == 3
    assert out["kernel_s"] == {"composite": pytest.approx(0.002), "p2g": pytest.approx(0.001)}
    gaps = dict(out["idle_gaps"])
    assert gaps == {"aten::mm": pytest.approx(0.007), "aten::copy_": pytest.approx(0.009)}
    assert out["device_ops"][0][0] == "at::native::vectorized_elementwise_kernel"


@pytest.mark.parametrize("name,kernel", [
    ("(anonymous namespace)::k5_tile_end(float const*)", "composite_bwd"),
    ("g2p_gather_kernel(float const*, int)", "g2p"),
    ("g2p_gather_derivs_kernel(float const*, int)", "g2p_derivs"),
    ("p2g_block_sum_kernel", "p2g"),
    ("void at::native::index_elementwise_kernel<128, 4>(int)", None),
])
def test_kernel_names(name, kernel):
    assert devtrace.kernel_of(name) == kernel


def test_frozen_roofline():
    assert roofline.H100_SXM == {"name": "h100-sxm", "bf16_flops": 989e12, "f32_flops": 67e12,
                                 "hbm_bps": 3.35e12}
    assert roofline.composite(1000, 1920, 1080) == (1000 * 256 * 25.0, 36000.0 + 1920 * 1080 * 20)
    assert roofline.p2g(30000, 70) == (27.0 * 30000 * 35.0, 30000 * 140 + 70 ** 3 * 16)
    f, b = roofline.sim_step(10, 4)
    assert roofline.sol_time(f, b) == max(f / 67e12, b / 3.35e12)
    t = roofline.grounding_step_frame(30000, 70, 1920, 1080, 200000, 524288, 20, 3, 3.0)
    assert 1e-4 < t < 1e-1


def test_metric_readers_share_and_silence():
    rl = roofline
    ctx = types.SimpleNamespace(
        kind="serve", cfg={"scene": {"particles": 1000}, "sim": {"num_grids": 32, "substeps": 20},
                           "views": [{"width": 64, "height": 64}], "raster": {"max_pairs": 4096}},
        roofline=rl, frame_s=0.05, pairs=[[500], [700]],
        trace={"busy_s": 0.1, "window_s": 0.4, "launches": 900, "frames": 3,
               "kernel_s": {"p2g": 0.002, "g2p": 0.001, "composite": 0.004},
               "counters": {"p2g": 2, "g2p": 1, "composite": 2},
               "spans": {"sim_s": 0.3, "render_s": 0.06, "frames": 3, "views": 1}})
    read = lambda n: harness.reader(n)(ctx)
    assert read("idle_share.serve") == pytest.approx(75.0)
    assert read("idle_share.train") is None
    assert read("launches_per_frame.serve") == pytest.approx(300.0)
    bound = 2 * rl.sol_time(*rl.p2g(1000, 32)) + rl.sol_time(*rl.g2p(1000, 32))
    assert read("mpm_kernel_roofline.serve") == pytest.approx(100 * bound / 0.003)
    comp = (rl.sol_time(*rl.composite(500, 64, 64)) + rl.sol_time(*rl.composite(700, 64, 64))) / 2
    assert read("composite_kernel_roofline.serve") == pytest.approx(100 * 2 * comp / 0.004)
    assert read("sim_ms_per_frame.serve") == pytest.approx(100.0)
    assert read("render_ms_per_view.serve") == pytest.approx(20.0)
    step = rl.grounding_step_frame(1000, 32, 64, 64, 600, 4096, substeps=1, n_views=1, bwd_factor=1)
    assert read("step_mfu.serve") == pytest.approx(100 * step / 0.05)
    ctx.trace["kernel_s"] = {}
    assert read("mpm_kernel_roofline.serve") is None
    assert read("composite_kernel_roofline.serve") is None


def test_leaf_gap_and_judge():
    ref = {"a": torch.ones(4), "b": 2 * torch.ones(4), "c": 1e-9 * torch.ones(4)}
    prog = {"a": torch.ones(4), "b": 2.2 * torch.ones(4), "c": 2e-9 * torch.ones(4)}
    # c's gap is measured against the median leaf's norm (2), not its own
    assert check.leaf_gap(prog, ref) == pytest.approx(0.1)
    ok, rows = check.judge({"x": 1e-4, "y": float("nan")}, {"x": {"limit": 1e-3}, "y": {"limit": 1}})
    assert not ok and rows[0] == ("x", 1e-4, 1e-3)
    ok, _ = check.judge({"x": 1e-4}, {"x": {"limit": 1e-3}})
    assert ok


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("neuma_tpu_torch", "neuma_tpu_torch.sim", "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not harness.forbidden_modules() & {"neuma_tpu_torch", "jaxtyping", "flax_like"}
    for name, top in (("neuma_tpu.sim", "neuma_tpu"), ("jaxlib.xla_client", "jaxlib"),
                      ("jax", "jax"), ("flax.linen", "flax")):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert top in harness.forbidden_modules()
