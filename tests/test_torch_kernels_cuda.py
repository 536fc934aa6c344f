"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips without one (marker
``cuda``). The file imports neither JAX nor the JAX package, so it also
runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``tests/conftest.py`` imports JAX, hence ``--noconftest`` there.)
Bounds: K1, K2 and K3 at a scaled 1e-5 (both sides full FP32; K3 per
output group); K4 at atol 2e-5 on T and C with ``last`` equal; K5 at a
scaled 1e-5 per column (the kernel starts each segment of a walk from
per-segment summaries and takes one reciprocal per visit, and sums the
256 pixels in another order). On a planted frame whose stop tests land
within rounding of 1e-4, K4 counts those pixels as taking the plain
walk and matches the plain version bit for bit there. K1, K3, K4 and K5 also run twice on the
same inputs and must agree bit for bit, and so do K2 and the dense-grid
MPM step (plain PyTorch on the card, ``num_grids <= 24``), which is held
to the same code on the CPU at a scaled 1e-5 forward and 1e-4 backward
(cuBLAS contracts the tap sums in other orders than the CPU). The
training CLI runs on a small config on the card and on the CPU, with
each epoch's loss within rtol 1e-4, the stage-1 velocity and one
value-and-grad at the end state within a scaled 1e-3
(``chip_smoke.app_card_vs_cpu``). The serving surface: ``apic_scatter``
and ``g2p_core`` on a slab grid (K1, K2, K3 with their VJPs) within a
scaled 1e-5 of the CPU and bitwise repeatable; ``sim.rollout.rollout``
bitwise equal to a loop of steps; the inference CLI on a small copy of
multiobj-bb-cc.yaml within 1 of 255 levels per pixel and a scaled 1e-5
per step's positions of the CPU. The registration and evaluation
surface: ``register_gaussians`` on a small scene (K4, K5, the D-SSIM
gradient, the SH rotation) within rtol 1e-4 of the CPU per logged loss
and a scaled 1e-4 per parameter, bitwise repeatable; SSIM and LPIPS-VGG
on the card within rtol 1e-5 and 1e-4 of the CPU with TF32 off. K4 and
K5 over ranges of a frame's tiles (a tile base, as tile sharding runs
them) give the whole-frame kernels' rows of those tiles bit for bit.
K6 and K7 (the batched 3x3 SVD and its adjoint) agree bit for bit with the
component code run on the card, alone, through autograd and inside the
materials, and repeat bit for bit.
"""
import numpy as np
import pytest
import torch

from neuma_tpu_torch.core.types import MPMConstants, ParticleState, Statics
from neuma_tpu_torch.render import raster_kernel as rk
from neuma_tpu_torch.sim import p2g_kernel as pk
from neuma_tpu_torch.sim.mpm import _p2g_terms, mpm_step_diff
from test_torch_composite_segments import _planted_frame
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scaled_err(a, b):
    """Max error over the reference's largest value; the absolute max
    error where the reference is all zero (no floor hides a small column)."""
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return err / scale if scale > 0 else err


def _payload(g, n, device, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    c = MPMConstants(num_grids=g, dt=f(8e-4), gravity=f([0, -9.8, 0]), eps=f(6e-7))
    statics = Statics(vol=f(np.full(n, 2e-8)), rho=f(np.full(n, 1e3)),
                      clip_bound=f(np.full(n, 0.1)),
                      enabled=torch.ones(n, dtype=torch.int32, device=device))
    state = ParticleState(
        x=f(0.25 + 0.5 * rng.random((n, 3))), v=f(0.3 * rng.standard_normal((n, 3))),
        C=f(0.5 * rng.standard_normal((n, 3, 3))), F=f(np.tile(np.eye(3), (n, 1, 1))))
    lay = pk.build_step_layouts(c, state.x)
    mass, b, affine = _p2g_terms(c, statics, state, f(1e-3 * rng.standard_normal((n, 3, 3))))
    payload = pk.pack_payload(c, lay.scatter, lay.sort.fx, lay.sort.loc, mass, b, affine)
    return c, lay, payload


@pytest.mark.cuda
@pytest.mark.parametrize("g,n", [(32, 3000), (70, 20000)])
def test_p2g_kernel_matches_plain(cuda, g, n):
    c, lay, payload = _payload(g, n, cuda)
    _, NB = pk._num_blocks(c)
    out = pk.run_p2g_fwd(payload, lay.scatter.c2b, NB)
    assert _scaled_err(out, pk.run_p2g_fwd_plain(payload, lay.scatter.c2b, NB)) <= 1e-5
    assert torch.equal(out, pk.run_p2g_fwd(payload, lay.scatter.c2b, NB))  # bitwise repeatable


@pytest.mark.cuda
@pytest.mark.parametrize("g,n", [(32, 3000), (70, 20000)])
def test_g2p_kernel_matches_plain(cuda, g, n):
    c, lay, payload = _payload(g, n, cuda, seed=1)
    _, NB = pk._num_blocks(c)
    slabs = torch.randn((NB, 4, 16, 16, 16), generator=torch.Generator().manual_seed(g)).to(cuda)
    args = (payload, slabs, lay.gather.c2b, float(c.inv_dx))
    out = pk.run_apic_gather(*args)
    assert _scaled_err(out, pk.run_apic_gather_plain(*args)) <= 1e-5
    assert torch.equal(out, pk.run_apic_gather(*args))  # bitwise repeatable


@pytest.mark.cuda
def test_composite_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(2)
    tiles_x, tiles_y = 5, 3
    counts = torch.randint(0, 400, (tiles_x * tiles_y,), generator=gen)
    aligned = (counts + rk.CHUNK - 1) // rk.CHUNK * rk.CHUNK
    start = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(aligned, 0)])
    P = int(start[-1]) + rk.CHUNK
    pf = torch.rand((P, 9), generator=gen)
    pf[:, 0] *= 16 * tiles_x
    pf[:, 1] *= 16 * tiles_y
    pf[:, 2:5] = torch.tensor([0.05, 0.01, 0.05]) * (0.5 + pf[:, 2:5])
    args = (pf.to(cuda), start.to(torch.int32).to(cuda), counts.to(torch.int32).to(cuda), tiles_x)
    Tk, Ck, lk = rk.composite_fwd(*args)
    Tp, Cp, lp = rk.composite_fwd_plain(*args)
    assert float((Tk - Tp).abs().max()) <= 2e-5 and float((Ck - Cp).abs().max()) <= 2e-5
    assert torch.equal(lk, lp)


@pytest.mark.cuda
@pytest.mark.parametrize("g,n", [(32, 3000), (70, 20000)])
def test_g2p_derivs_kernel_matches_plain(cuda, g, n):
    c, lay, payload = _payload(g, n, cuda, seed=3)
    _, NB = pk._num_blocks(c)
    slabs = torch.randn((NB, 4, 16, 16, 16), generator=torch.Generator().manual_seed(g)).to(cuda)
    args = (payload, slabs, lay.gather.c2b, float(c.inv_dx), True)
    out, ref = pk.run_apic_gather(*args), pk.run_apic_gather_plain(*args)
    for cols in (slice(0, 1), slice(1, 4), slice(4, 13), slice(13, 16)):
        assert _scaled_err(out[:, cols], ref[:, cols]) <= 1e-5, cols
    assert torch.equal(out, pk.run_apic_gather(*args))  # bitwise repeatable


def _composite_inputs(device, seed=2, tiles_x=5, tiles_y=3):
    gen = torch.Generator().manual_seed(seed)
    counts = torch.randint(0, 400, (tiles_x * tiles_y,), generator=gen)
    aligned = (counts + rk.CHUNK - 1) // rk.CHUNK * rk.CHUNK
    start = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(aligned, 0)])
    P = int(start[-1]) + rk.CHUNK
    pf = torch.rand((P, 9), generator=gen)
    pf[:, 0] *= 16 * tiles_x
    pf[:, 1] *= 16 * tiles_y
    pf[:, 2:5] = torch.tensor([0.05, 0.01, 0.05]) * (0.5 + pf[:, 2:5])
    return pf.to(device), start.to(torch.int32).to(device), counts.to(torch.int32).to(device), tiles_x


@pytest.mark.cuda
def test_composite_bwd_kernel_matches_plain(cuda):
    pf, start, counts, tiles_x = _composite_inputs(cuda, seed=4)
    T, _, last = rk.composite_fwd(pf, start, counts, tiles_x)
    gen = torch.Generator().manual_seed(5)
    dT = torch.randn(T.shape, generator=gen).to(cuda)
    dC = torch.randn((T.shape[0], 768), generator=gen).to(cuda)
    args = (pf, start, counts, T, last, dT, dC, tiles_x)
    out, ref = rk.composite_bwd(*args), rk.composite_bwd_plain(*args)
    end = int(start[-1])
    assert (ref[:end] != 0).any()
    for j in range(9):
        assert _scaled_err(out[:end, j], ref[:end, j]) <= 1e-5, j
    assert torch.equal(out, rk.composite_bwd(*args))  # bitwise repeatable


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    payload = torch.zeros((pk.CHUNK, 48), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        pk.run_p2g_fwd(payload, torch.zeros(1, dtype=torch.int32, device=cuda), 1)
    slabs = torch.zeros((1, 4, 16, 16, 16), device=cuda)
    c2b = torch.zeros(1, dtype=torch.int32, device=cuda)
    for derivs in (False, True):  # K2 and K3
        misaligned = torch.zeros(pk.CHUNK * 48 + 1, device=cuda)[1:].view(pk.CHUNK, 48)
        with pytest.raises(ValueError, match="aligned"):
            pk.run_apic_gather(misaligned, slabs, c2b, 32.0, derivs)
        odd_chunk = torch.zeros((pk.CHUNK - 40, 48), device=cuda)  # 88 rows
        with pytest.raises(ValueError, match="multiple"):
            pk.run_apic_gather(odd_chunk, slabs, c2b, 32.0, derivs)
    with pytest.raises(ValueError, match="int32"):
        rk.composite_fwd(torch.zeros((32, 9), device=cuda), torch.zeros(2, dtype=torch.int64, device=cuda),
                         torch.zeros(1, dtype=torch.int32, device=cuda), 1)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dC"):
        rk.composite_bwd(torch.zeros((32, 9), device=cuda), i32(2), i32(1),
                         *(torch.zeros((1, 256), device=cuda) for _ in range(3)),
                         torch.zeros((1, 256), device=cuda), 1)


def _dense_block_payload(device):
    """K1 inputs on a 32^3 grid: one block holding >= 64 chunks beside
    blocks holding one chunk each (with pad rows), and particles at both
    domain faces whose taps are clipped onto one line."""
    rng = np.random.default_rng(7)
    g = 32
    core = (14 + 14 * rng.random((9000, 3))) / g  # block (1, 1, 1)
    singles = [(np.array(o) * 14 + 3 + 8 * rng.random((40, 3))) / g
               for o in ((0, 0, 0), (2, 0, 1), (0, 2, 2), (1, 0, 2))]
    faces = np.concatenate([0.2 * rng.random((30, 3)) / g, 1 - 0.2 * rng.random((30, 3)) / g])
    x = np.concatenate([core, *singles, faces])
    n = x.shape[0]
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    c = MPMConstants(num_grids=g, dt=f(8e-4), gravity=f([0, -9.8, 0]), eps=f(6e-7))
    statics = Statics(vol=f(np.full(n, 2e-8)), rho=f(np.full(n, 1e3)),
                      clip_bound=f(np.full(n, 0.1)),
                      enabled=torch.ones(n, dtype=torch.int32, device=device))
    state = ParticleState(x=f(x), v=f(0.3 * rng.standard_normal((n, 3))),
                          C=f(0.5 * rng.standard_normal((n, 3, 3))), F=f(np.tile(np.eye(3), (n, 1, 1))))
    lay = pk.build_step_layouts(c, state.x)
    mass, b, affine = _p2g_terms(c, statics, state, f(1e-3 * rng.standard_normal((n, 3, 3))))
    payload = pk.pack_payload(c, lay.scatter, lay.sort.fx, lay.sort.loc, mass, b, affine)
    return c, lay, payload


@pytest.mark.cuda
def test_p2g_kernel_dense_block_and_clipped_taps(cuda):
    c, lay, payload = _dense_block_payload(cuda)
    _, NB = pk._num_blocks(c)
    c2b = lay.scatter.c2b
    per_block = torch.bincount(c2b.long(), minlength=NB)
    assert int(per_block.max()) >= 64 and int((per_block == 1).sum()) >= 4
    loc = lay.sort.loc
    assert bool((loc[:, :, 0] == loc[:, :, 1]).any()) and bool((loc[:, :, 1] == loc[:, :, 2]).any())
    out = pk.run_p2g_fwd(payload, c2b, NB)
    ref = pk.run_p2g_fwd_plain(payload, c2b, NB)
    for ch in range(4):
        assert _scaled_err(out[:, ch], ref[:, ch]) <= 1e-5, ch
    assert torch.equal(out, pk.run_p2g_fwd(payload, c2b, NB))  # bitwise repeatable


def _skewed_frame(device, long=2100):
    """An 8x4-tile frame: one tile with ``long`` weak pairs that every
    pixel walks to the end, a tile of strong wide pairs whose pixels stop
    early, a tile whose pairs sit on its top rows (the lower warps never
    contribute), and 28 empty tiles."""
    rng = np.random.default_rng(11)
    tiles_x, tiles_y = 8, 4
    counts = np.zeros(tiles_x * tiles_y, np.int64)
    counts[[9, 10, 21, 30]] = [long, 300, 120, 40]
    aligned = (counts + rk.CHUNK - 1) // rk.CHUNK * rk.CHUNK
    start = np.concatenate([[0], np.cumsum(aligned)])
    pf = np.zeros((int(start[-1]) + rk.CHUNK, 9), np.float32)
    for t in np.nonzero(counts)[0]:
        n, s = counts[t], slice(start[t], start[t] + counts[t])
        ox, oy = 16 * (t % tiles_x), 16 * (t // tiles_x)
        pf[s, 0], pf[s, 1] = ox + 16 * rng.random(n), oy + 16 * rng.random(n)
        pf[s, 2:5] = [0.5, 0.0, 0.5]
        pf[s, 5] = 0.02 + 0.03 * rng.random(n)
        pf[s, 6:9] = rng.random((n, 3))
    s10 = slice(start[10], start[10] + counts[10])
    pf[s10, 2:5], pf[s10, 5] = [0.01, 0.0, 0.01], 0.9  # saturates: pixels stop early
    s21 = slice(start[21], start[21] + counts[21])
    pf[s21, 1] = 32 + 2 * rng.random(counts[21])  # top rows of tile 21 only
    as_i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return torch.as_tensor(pf, device=device), as_i32(start), as_i32(counts), tiles_x


@pytest.mark.cuda
def test_composite_bwd_kernel_skewed_frame(cuda):
    pf, start, counts, tiles_x = _skewed_frame(cuda)
    T, _, last = rk.composite_fwd(pf, start, counts, tiles_x)
    walk = last.max(1).values - start[:-1].float() + 1
    assert float(walk[9]) >= 2000 and int((counts == 0).sum()) == 28
    assert float(walk[10]) < 100  # a long range that stops early
    assert bool((last[21, 128:] == -1).all()) and bool((last[21, :64] >= 0).any())
    gen = torch.Generator().manual_seed(12)
    dT = torch.randn(T.shape, generator=gen).to(cuda)
    dC = torch.randn((T.shape[0], 768), generator=gen).to(cuda)
    args = (pf, start, counts, T, last, dT, dC, tiles_x)
    out, ref = rk.composite_bwd(*args), rk.composite_bwd_plain(*args)
    end = int(start[-1])
    assert torch.equal(out[end:], ref[end:])
    for j in range(9):
        assert _scaled_err(out[:end, j], ref[:end, j]) <= 1e-5, j
    assert torch.equal(out, rk.composite_bwd(*args))  # bitwise repeatable


@pytest.mark.cuda
def test_composite_kernel_skewed_frame(cuda):
    """K4 on one 1,500-pair tile beside 28 empty ones, with a tile whose
    pixels all stop on the 1e-4 test within the first of its five
    64-slot segments."""
    pf, start, counts, tiles_x = _skewed_frame(cuda, long=1500)
    args = (pf, start, counts, tiles_x)
    Tk, Ck, lk = rk.composite_fwd(*args)
    Tp, Cp, lp = rk.composite_fwd_plain(*args)
    walk = lp.max(1).values - start[:-1].float() + 1
    assert float(walk[9]) >= 1400 and int((counts == 0).sum()) == 28
    assert float(walk[10]) < 64 and int(counts[10]) == 300 and float(Tp[10].max()) < 1e-3
    assert float((Tk - Tp).abs().max()) <= 2e-5 and float((Ck - Cp).abs().max()) <= 2e-5
    assert torch.equal(lk, lp)
    for a, b in zip((Tk, Ck, lk), rk.composite_fwd(*args)):
        assert torch.equal(a, b)  # bitwise repeatable


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["random", "skewed"])
def test_composite_kernels_over_a_tile_range(cuda, frame):
    """K4 and K5 over ranges of a frame's tiles (a tile base; the
    ``tile_sharding`` split of 4, a range without pairs, an empty range)
    give the whole-frame kernels' T, C, ``last`` and pair rows of those
    tiles bit for bit, zero rows elsewhere, and match their plain versions
    run with the same base."""
    pf, start, counts, tiles_x = (_composite_inputs(cuda, seed=6) if frame == "random"
                                  else _skewed_frame(cuda))
    n = counts.shape[0]
    T, C, last = rk.composite_fwd(pf, start, counts, tiles_x)
    gen = torch.Generator().manual_seed(7)
    dT = torch.randn(T.shape, generator=gen).to(cuda)
    dC = torch.randn(C.shape, generator=gen).to(cuda)
    rows = rk.composite_bwd(pf, start, counts, T, last, dT, dC, tiles_x)
    k = -(-n // 4)
    ranges = [(min(c * k, n), min((c + 1) * k, n)) for c in range(4)] + [(n, n)]
    for t0, t1 in ranges:
        ts, cn = start[t0:t1 + 1], counts[t0:t1]
        Tr, Cr, lr = rk.composite_fwd(pf, ts, cn, tiles_x, t0)
        for a, b in ((Tr, T[t0:t1]), (Cr, C[t0:t1]), (lr, last[t0:t1])):
            assert torch.equal(a, b), (t0, t1)
        Tp, Cp, lp = rk.composite_fwd_plain(pf, ts, cn, tiles_x, t0)
        if t1 > t0:
            assert float((Tr - Tp).abs().max()) <= 2e-5 and float((Cr - Cp).abs().max()) <= 2e-5
        assert torch.equal(lr, lp)
        a5 = (pf, ts, cn, Tr, lr, dT[t0:t1].contiguous(), dC[t0:t1].contiguous(), tiles_x, t0)
        rr, rp = rk.composite_bwd(*a5), rk.composite_bwd_plain(*a5)
        lo, hi = int(start[t0]), int(start[t1])
        assert torch.equal(rr[lo:hi], rows[lo:hi]), (t0, t1)
        assert not rr[:lo].any() and not rr[hi:].any()
        for j in range(9 if hi > lo else 0):
            assert _scaled_err(rr[lo:hi, j], rp[lo:hi, j]) <= 1e-5, (t0, t1, j)


@pytest.mark.cuda
def test_composite_kernel_band_pixels_match_plain_bitwise(cuda):
    """K4 on the planted frame of ``tests/test_torch_composite_segments.py``:
    the 240 pixels per tile whose stop test lands within rounding of 1e-4
    (where the product form and the sequential walk can decide apart)
    are counted as taking the plain version's walk, and their T, C and
    ``last`` equal the plain version's bit for bit; ``last`` equal
    everywhere, T and C within K4's bound."""
    pf, start, counts, tiles_x = _planted_frame()
    args = (pf.to(cuda), start.to(cuda), counts.to(cuda), tiles_x)
    T, C, last, exact = rk.composite_fwd(*args, with_exact=True)
    Tp, Cp, lp = rk.composite_fwd_plain(*args)
    assert exact.tolist() == [240, 240, 0]
    assert torch.equal(last, lp)
    band = torch.arange(rk.PIX, device=cuda) % rk.TILE != 3
    for t in (0, 1):
        assert torch.equal(T[t, band], Tp[t, band])
        assert torch.equal(C[t].reshape(3, rk.PIX)[:, band], Cp[t].reshape(3, rk.PIX)[:, band])
    assert float((T - Tp).abs().max()) <= 2e-5 and float((C - Cp).abs().max()) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["p2g_adjoint", "g2p_adjoint"])
def test_g2p_derivs_kernel_clipped_taps_and_padding(cuda, role):
    """K3 in both roles of the step backward (the forward (mass, b, affine)
    payload; zero mass with (d new_v, kappa d new_C)), on a payload with
    padding rows and with tap lines moved outside 0..15 on some rows."""
    c, lay, payload = _payload(32, 3000, cuda, seed=5)
    _, NB = pk._num_blocks(c)
    gen = torch.Generator().manual_seed(6)
    if role == "g2p_adjoint":
        n = lay.sort.fx.shape[0]
        kappa = 4.0 * float(c.inv_dx) ** 2
        payload = pk.pack_payload(c, lay.gather, lay.sort.fx, lay.sort.loc, None,
                                  torch.randn((n, 3), generator=gen).to(cuda),
                                  kappa * 1e-2 * torch.randn((n, 3, 3), generator=gen).to(cuda))
    live = torch.nonzero(payload[:, 0:9].abs().sum(1) > 0).squeeze(1)
    assert live.numel() < payload.shape[0]  # padding rows
    payload = payload.clone()
    for k, (col, line) in enumerate([(pk._L0, -1.0), (pk._L0 + 5, 16.0), (pk._L0 + 7, -3.0)]):
        payload[live[k::7], col] = line  # one x, one y, one z tap clipped
    slabs = torch.randn((NB, 4, 16, 16, 16), generator=gen).to(cuda)
    args = (payload, slabs, lay.gather.c2b, float(c.inv_dx), True)
    out, ref = pk.run_apic_gather(*args), pk.run_apic_gather_plain(*args)
    assert bool((out[payload[:, 0:9].abs().sum(1) == 0] == 0).all())
    for cols in (slice(0, 1), slice(1, 4), slice(4, 13), slice(13, 16)):
        assert _scaled_err(out[:, cols], ref[:, cols]) <= 1e-5, cols
    assert torch.equal(out, pk.run_apic_gather(*args))  # bitwise repeatable


@pytest.mark.cuda
def test_g2p_kernel_clipped_taps_and_padding(cuda):
    """K2 on a payload with padding rows and with tap lines moved outside
    0..15 (-1, 16) on some rows: those taps read zero, padding rows give
    zero rows, and the result repeats bit for bit."""
    c, lay, payload = _payload(32, 3000, cuda, seed=8)
    _, NB = pk._num_blocks(c)
    live = torch.nonzero(payload[:, 0:9].abs().sum(1) > 0).squeeze(1)
    assert live.numel() < payload.shape[0]  # padding rows
    payload = payload.clone()
    for k, (col, line) in enumerate([(pk._L0 + 2, 16.0), (pk._L0 + 3, -1.0), (pk._L0 + 8, 16.0)]):
        payload[live[k::7], col] = line  # one x, one y, one z tap clipped
    slabs = torch.randn((NB, 4, 16, 16, 16), generator=torch.Generator().manual_seed(9)).to(cuda)
    args = (payload, slabs, lay.gather.c2b, float(c.inv_dx))
    out, ref = pk.run_apic_gather(*args), pk.run_apic_gather_plain(*args)
    assert bool((out[payload[:, 0:9].abs().sum(1) == 0] == 0).all())
    assert bool((out[:, 13:] == 0).all())
    for cols in (slice(0, 1), slice(1, 4), slice(4, 13)):
        assert _scaled_err(out[:, cols], ref[:, cols]) <= 1e-5, cols
    assert torch.equal(out, pk.run_apic_gather(*args))  # bitwise repeatable


def _dense_step(device, n=3000, seed=10):
    """One dense-grid step (num_grids = 24) forward and its direct adjoint
    for seeded cotangents; 100 particles sit within a cell of a wall."""
    rng = np.random.default_rng(seed)
    g = 24
    x = 0.3 + 0.4 * rng.random((n, 3))
    near = (0.1 + 0.9 * rng.random(100)) / g
    x[np.arange(100), rng.integers(0, 3, 100)] = np.where(rng.random(100) < 0.5, near, 1 - near)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    c = MPMConstants(num_grids=g, bound=2, bc="noslip", dt=f(8e-4), gravity=f([0, -9.8, 0]), eps=f(6e-7))
    statics = Statics(vol=f(np.full(n, 2e-8)), rho=f(np.full(n, 1e3)), clip_bound=f(np.full(n, 0.1)),
                      enabled=torch.ones(n, dtype=torch.int32, device=device))
    leaves = [f(x), f(0.3 * rng.standard_normal((n, 3))), f(0.5 * rng.standard_normal((n, 3, 3))),
              f(np.eye(3) + 0.02 * rng.standard_normal((n, 3, 3))), f(1e-3 * rng.standard_normal((n, 3, 3)))]
    leaves = [t.requires_grad_(True) for t in leaves]
    out = mpm_step_diff(c, statics, ParticleState(*leaves[:4]), leaves[4])
    outs = [out.x, out.v, out.C, out.F]
    cots = [f(rng.standard_normal(tuple(o.shape))) for o in outs]
    grads = torch.autograd.grad(outs, leaves, cots)
    return [o.detach() for o in outs], list(grads)


@pytest.mark.cuda
def test_dense_step_matches_cpu_and_repeats(cuda):
    """The dense step forward (x, v, C, F) within a scaled 1e-5 and its
    backward (d x, v, C, F, stress) within a scaled 1e-4 of the same code
    on the CPU; two card runs are bitwise equal (the ordered scatter
    uses no atomics)."""
    outs_cpu, grads_cpu = _dense_step("cpu")
    outs_a, grads_a = _dense_step(cuda)
    outs_b, grads_b = _dense_step(cuda)
    for a, r in zip(outs_a, outs_cpu):
        assert _scaled_err(a.cpu(), r) <= 1e-5
    for a, r in zip(grads_a, grads_cpu):
        assert float(r.abs().max()) > 0
        assert _scaled_err(a.cpu(), r) <= 1e-4
    for a, b in zip(outs_a + grads_a, outs_b + grads_b):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_finetune_app_small_card_matches_cpu(cuda, tmp_path):
    """The training CLI on a small copy of finetune-bb.yaml (a 64x64 view,
    uniform mesh sampling at resolution 10, (16, 16) widths, LoRA r 4,
    ``num_grids`` 32 so the card runs K1-K5): each epoch's loss of both
    stages on the card within rtol 1e-4 of the CPU's from the same
    prepared folder, the card's data preparation equal to the CPU's
    (particles.ply bitwise, bindings.npz weights equal and indices equal
    where the weight is above 0), the stage-1 velocity within a scaled
    1e-3, and one value-and-grad of the stage-2 loss at the card run's
    end state (``chip_smoke.app_value_and_grad``): loss within rtol 1e-4,
    each gradient leaf within a scaled 1e-3."""
    import chip_smoke

    out = chip_smoke.app_card_vs_cpu(tmp_path)
    assert out["n_losses"] == 4 and out["max_rel_gap"] <= 1e-4
    assert out["particles_bitwise"] and out["bindings_equal"]
    assert out["init_v_err"] <= chip_smoke.GRAD_TOL
    vg = out["value_and_grad"]
    assert vg["loss_rel_gap"] <= 1e-4 and max(vg["grad_errs"]) <= chip_smoke.GRAD_TOL


def _api_scene(device, g=32, n=3000, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    c = MPMConstants(num_grids=g, dt=f(8e-4), gravity=f([0, -9.8, 0]), eps=f(6e-7))
    ins = dict(x=f(0.25 + 0.5 * rng.random((n, 3))), gm=f(1e-5 * rng.random(n)),
               b=f(1e-5 * rng.standard_normal((n, 3))), A=f(1e-4 * rng.standard_normal((n, 3, 3))),
               du=f(rng.standard_normal(g ** 3)), df=f(rng.standard_normal((g ** 3, 3))),
               grid_v=f(rng.standard_normal((g ** 3, 3))))
    return c, ins


def _apic_and_g2p(device):
    """apic_scatter (K1 forward, K3 backward) and g2p's tap contractions
    (K2 forward; K1 and K3 backward) on a slab grid, with their VJPs."""
    from neuma_tpu_torch.sim.blocked import apic_scatter
    from neuma_tpu_torch.sim.mpm import g2p_core

    c, ins = _api_scene(device)
    leaves = [ins[k].clone().requires_grad_(True) for k in ("x", "gm", "b", "A")]
    m, f = apic_scatter(c, *leaves)
    grads = torch.autograd.grad([m, f], leaves, [ins["du"], ins["df"]])
    x, gv = ins["x"].clone().requires_grad_(True), ins["grid_v"].clone().requires_grad_(True)
    v, C = g2p_core(c, x, gv)
    cv, cC = torch.ones_like(v), 0.01 * torch.ones_like(C)
    g2 = torch.autograd.grad([v, C], [x, gv], [cv, cC])
    return [t.detach() for t in (m, f, *grads, v, C, *g2)]


@pytest.mark.cuda
def test_public_scatter_and_gather_match_cpu_and_repeat(cuda):
    """``apic_scatter`` and ``g2p_core`` on a 32^3 slab grid: values and
    VJPs on the card (K1, K2, K3) within a scaled 1e-5 of the same code on
    the CPU (the plain versions), and two card runs bitwise equal."""
    from neuma_tpu_torch import kernels

    cpu = _apic_and_g2p("cpu")
    kernels.reset_launches()
    a = _apic_and_g2p(cuda)
    assert all(kernels.launches[k] > 0 for k in ("p2g", "g2p", "g2p_derivs"))
    b = _apic_and_g2p(cuda)
    for x, y, z in zip(a, b, cpu):
        assert _scaled_err(x.cpu(), z) <= 1e-5
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_rollout_equals_a_loop_of_steps_on_the_card(cuda):
    """``sim.rollout.rollout`` (the block sort carried and refreshed) for 3
    frames x 2 substeps equals a loop of ``make_step_fn`` steps bit for
    bit on a 32^3 slab grid."""
    from neuma_tpu_torch.materials import (
        InvariantFullMetaElasticity, InvariantFullMetaPlasticity, MetaMaterialConfig)
    from neuma_tpu_torch.sim.rollout import make_step_fn, rollout

    c, ins = _api_scene(cuda, n=2000)
    n = ins["x"].shape[0]
    statics = Statics(vol=torch.full((n,), 2e-8, device=cuda), rho=torch.full((n,), 1e3, device=cuda),
                      clip_bound=torch.full((n,), 0.1, device=cuda),
                      enabled=torch.ones(n, dtype=torch.int32, device=cuda))
    gen = torch.Generator().manual_seed(0)
    cfg = MetaMaterialConfig(layer_widths=(16, 16))
    e = InvariantFullMetaElasticity.init(cfg, gen, cuda)
    p = InvariantFullMetaPlasticity.init(cfg, gen, cuda)
    step = make_step_fn(c, statics, e, p)
    s0 = ParticleState.initial(ins["x"], 0.3 * ins["grid_v"][:n])
    with torch.no_grad():
        final, traj = rollout(step, s0, 3, substeps=2, constants=c)
        loop = s0
        for _ in range(6):
            loop = step(loop)
    for k in "xvCF":
        assert torch.equal(getattr(final, k), getattr(loop, k))
        assert torch.equal(getattr(traj, k)[-1], getattr(loop, k))


@pytest.mark.cuda
def test_inference_app_small_card_matches_cpu(cuda, tmp_path):
    """The inference CLI on a small copy of multiobj-bb-cc.yaml (two
    fabricated objects, a 64x64 view, uniform sampling at resolution 10,
    (16, 16) widths, LoRA r 4 on object 1, ``num_grids`` 32 so the card
    runs K1, K2 and K4) on the card and on the CPU for 20 steps: the same
    files, every PNG pixel within 1 of 255 levels and every step's
    positions within a scaled 1e-5 (``chip_smoke.serve_inference_card_vs_cpu``)."""
    import chip_smoke

    out = chip_smoke.serve_inference_card_vs_cpu(tmp_path)
    assert out["png_names_equal"] and out["n_png"] == 21 and out["png_gap"] <= 1
    assert out["ply_names_equal"] and out["n_ply"] == 20 and out["ply_err"] <= 1e-5


@pytest.mark.cuda
def test_register_small_card_matches_cpu_and_repeats(cuda):
    """``register_gaussians`` on ``tests/test_register.py``'s scene (150
    SH-1 Gaussians, three 48x48 views, lambda_dssim 0.2, so K4, K5, the
    SSIM gradient and the SH rotation run) for 10 iterations: each
    logged loss within rtol 1e-4 of the CPU's, the params within a scaled
    1e-4, and two card runs bitwise equal (``chip_smoke.regist_small_copy``)."""
    import chip_smoke

    out = chip_smoke.regist_small_copy()
    assert len(out["losses_card"]) == 10
    assert out["loss_rel_gap"] <= 1e-4 and out["params_err"] <= 1e-4 and out["bitwise"]


@pytest.mark.cuda
def test_ssim_and_lpips_card_match_cpu(cuda):
    """SSIM (value and input gradient) and LPIPS-VGG (random weights) on a
    (2, 3, 45, 61) batch: card within rtol 1e-5 (SSIM) and 1e-4 (LPIPS)
    of the CPU, with TF32 off inside the metrics even when the global
    flag allows it, and the SSIM gradient bitwise equal over two card
    runs (deterministic cuDNN)."""
    from neuma_tpu_torch.train.losses import ssim
    from neuma_tpu_torch.train.lpips import _init_random, lpips

    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.random((2, 3, 45, 61)).astype(np.float32))
    b = torch.as_tensor(rng.random((2, 3, 45, 61)).astype(np.float32))

    def ssim_and_grad(device):
        x = a.to(device).requires_grad_(True)
        value = ssim(x, b.to(device))
        (g,) = torch.autograd.grad(value, x)
        return value.detach().cpu(), g.cpu()

    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        v_gpu, g_gpu = ssim_and_grad(cuda)
        _, g_gpu2 = ssim_and_grad(cuda)
        params = _init_random(device=cuda)
        with torch.no_grad():
            l_gpu = lpips(a.to(cuda), b.to(cuda), params).cpu()
        assert torch.backends.cudnn.allow_tf32  # restored after the metric
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    v_cpu, g_cpu = ssim_and_grad("cpu")
    with torch.no_grad():
        l_cpu = lpips(a, b, _init_random())
    torch.testing.assert_close(v_gpu, v_cpu, rtol=1e-5, atol=0)
    assert _scaled_err(g_gpu, g_cpu) <= 1e-5 and torch.equal(g_gpu, g_gpu2)
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_kernels_on_out_of_view_lines_and_halo_views(cuda):
    """K1, K2 and K3 on a payload with tap lines -1 and 16 planted on each
    axis (a tap outside a halo view adds and reads nothing), and in the
    four slab views of a 70^3 grid cut for 4 ranks (26 x 70 x 70 cells at
    x origins -4, 14, 32, 50; nbs (2, 5, 5)), each view's own particles
    and every particle in one view: each kernel within a scaled 1e-5 of
    its plain version (K3 per output group), K1 bitwise repeatable on the
    planted payload (``chip_smoke.view_kernel_checks``)."""
    import chip_smoke
    from neuma_tpu_torch.train.grounding import build_scene

    scene = build_scene(n_particles=20000, grid=70, substeps=1, width=64, height=64, n_views=1,
                        force_mask=True, max_pairs=1 << 12, max_per_tile=64, layer_widths=(8,),
                        lora_r=2, spread=0.7, device=cuda)
    out = chip_smoke.view_kernel_checks(scene, 4, 2, torch.Generator().manual_seed(0))
    assert [r["origin"] for r in out["views"][:4]] == [-4, 14, 32, 50]
    assert all(r["nbs"] == [2, 5, 5] for r in out["views"])
    assert out["views"][-1]["taps_outside"] > 0 and out["planted"]["rows_planted"] > 0
    for r in out["views"]:
        assert r["p2g"]["err"] <= 1e-5 and r["g2p"]["err"] <= 1e-5, r
        assert r["g2p_derivs"]["err"] <= 1e-5, r
    pl = out["planted"]
    assert pl["p2g_err"] <= 1e-5 and pl["p2g_bitwise"], pl
    assert pl["g2p_err"] <= 1e-5 and pl["g2p_derivs_err"] <= 1e-5, pl
    assert out["ok"]


# --------------------------------------------------------------------------
# K6 / K7: the batched 3x3 SVD and its adjoint, bit for bit the component
# path (``svd3_fwd_plain`` / ``svd3_bwd_plain``) run on the card
# --------------------------------------------------------------------------


def _bits(t):
    return t.contiguous().view(torch.int32)


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _svd_matrices(case, n, seed=0):
    """(n, 3, 3) float32 F: near identity (the sim's regime), random well
    conditioned (sigma in [0.5, 2]), repeated singular values (I,
    diag(2, 2, 1)), a collapsed third column (sigma[2] < 1e-8: U's
    cross-product column), det F < 0, and tiny F with near-equal sigma
    (the adjoint's 1e-10 clamp)."""
    rng = np.random.default_rng(seed)
    if case == "near_identity":
        F = np.eye(3) + 0.05 * rng.standard_normal((n, 3, 3))
    elif case == "conditioned":
        F = _rotations(rng, n) @ (rng.uniform(0.5, 2.0, (n, 3))[:, :, None]
                                  * _rotations(rng, n))
    elif case == "identity":
        F = np.tile(np.eye(3), (n, 1, 1))
    elif case == "diag221":
        F = np.tile(np.diag([2.0, 2.0, 1.0]), (n, 1, 1))
    elif case == "collapsed":
        F = np.eye(3) + 0.3 * rng.standard_normal((n, 3, 3))
        F[:, :, 2] = 0.0
    elif case == "negdet":
        F = np.eye(3) + 0.2 * rng.standard_normal((n, 3, 3))
        F[:, :, 0] *= -1.0
    elif case == "near_equal":
        F = 1e-5 * (_rotations(rng, n) @ (np.array([1.0, 1.0 + 1e-3, 0.5])[:, None]
                                          * _rotations(rng, n)))
    return F.astype(np.float32)


SVD_CASES = [("near_identity", 30000), ("conditioned", 4096), ("identity", 256),
             ("diag221", 256), ("collapsed", 1000), ("negdet", 1000), ("near_equal", 1000),
             ("near_identity", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,n", SVD_CASES, ids=[f"{c}-{n}" for c, n in SVD_CASES])
def test_svd3_kernels_match_plain_bitwise(cuda, case, n):
    """K6 on the strided views of an (N, 9) buffer and K7 on 21 random
    cotangents, against the component path on the card: bit for bit,
    and bit for bit on a second launch (N 30,000, 4,096 and 1,000 are not
    multiples of the 128-thread block; N = 1 fills one lane)."""
    from neuma_tpu_torch.ops.svd3 import (run_svd3_bwd, run_svd3_fwd, svd3_bwd_plain,
                                          svd3_fwd_plain, unpack33)

    F = torch.as_tensor(_svd_matrices(case, n), device=cuda)
    F9 = unpack33(F)
    assert F9[1].data_ptr() == F.data_ptr() + 4 and F9[1].stride() == (9,)
    out = run_svd3_fwd(F9)
    ref = svd3_fwd_plain(F9)
    assert torch.equal(_bits(out), _bits(ref)), case
    assert torch.equal(_bits(out), _bits(run_svd3_fwd(F9)))
    if case == "collapsed":
        assert bool((ref[11].abs() < 1e-8).all())
    if case == "negdet":
        assert bool((ref[11] < 0).all())
    cots = list(torch.randn((21, n), generator=torch.Generator().manual_seed(n)).to(cuda))
    dA = run_svd3_bwd(out, cots)
    assert torch.equal(_bits(dA), _bits(svd3_bwd_plain(ref, cots))), case
    assert torch.equal(_bits(dA), _bits(run_svd3_bwd(out, cots)))


@pytest.mark.cuda
@pytest.mark.parametrize("live", ["sigma", "u", "vh", "s0_expanded"])
def test_svd3_bwd_kernel_none_and_expanded_cotangents(cuda, live):
    """K7 with None cotangents (counted as zero) and with an expanded
    (stride 0) one, on F with near-equal singular values (the 1e-10
    clamp) and on F near the identity, against the plain adjoint."""
    from neuma_tpu_torch.ops.svd3 import run_svd3_bwd, run_svd3_fwd, svd3_bwd_plain, unpack33

    gen = torch.Generator().manual_seed(7)
    for case in ("near_equal", "near_identity"):
        F9 = unpack33(torch.as_tensor(_svd_matrices(case, 3001, seed=2), device=cuda))
        saved = run_svd3_fwd(F9)
        rows = {"u": range(9), "sigma": range(9, 12), "vh": range(12, 21), "s0_expanded": (9,)}
        cots = [None] * 21
        for k in rows[live]:
            cots[k] = (torch.ones((), device=cuda).expand(3001) if live == "s0_expanded"
                       else torch.randn(3001, generator=gen).to(cuda))
        dA = run_svd3_bwd(saved, cots)
        assert torch.equal(_bits(dA), _bits(svd3_bwd_plain(saved, cots))), (case, live)


@pytest.mark.cuda
def test_svd3_kernels_through_autograd_and_launch_counts(cuda):
    """``svd3c`` on CUDA components: one K6 launch a forward and one K7 a
    backward, counted in ``kernels.launches``; the factors and the input
    gradient are the plain path's bit for bit (separate component tensors,
    not views of one buffer); N = 0 launches nothing."""
    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.ops.svd3 import svd3_bwd_plain, svd3_fwd_plain, svd3c

    F = torch.as_tensor(_svd_matrices("conditioned", 5000, seed=3), device=cuda)
    F9 = [F[:, r, c].clone().requires_grad_(True) for r in range(3) for c in range(3)]
    W = torch.randn((21, 5000), generator=torch.Generator().manual_seed(3)).to(cuda)
    kernels.reset_launches()
    u9, s3, vh9 = svd3c(F9)
    rows = [*u9, *s3, *vh9]
    sum((f * w).sum() for f, w in zip(rows, W)).backward()
    assert dict(kernels.launches) == {"svd3": 1, "svd3_bwd": 1}
    ref = svd3_fwd_plain([f.detach() for f in F9])
    assert torch.equal(_bits(torch.stack(rows).detach()), _bits(ref))
    assert torch.equal(_bits(torch.stack([f.grad for f in F9])),
                       _bits(svd3_bwd_plain(ref, list(W))))
    kernels.reset_launches()
    E9 = [torch.zeros(0, device=cuda, requires_grad=True) for _ in range(9)]
    u9, s3, vh9 = svd3c(E9)
    sum(f.sum() for f in (*u9, *s3, *vh9)).backward()
    assert u9[0].shape == (0,) and E9[0].grad.shape == (0,) and not kernels.launches


@pytest.mark.cuda
def test_svd3_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """A float64, mixed-device or mixed-shape CUDA input raises, in the
    forward and in the adjoint: no fallback to the component path."""
    from neuma_tpu_torch.ops.svd3 import run_svd3_bwd, run_svd3_fwd, svd3c

    ok = [torch.ones(8, device=cuda) for _ in range(9)]
    with pytest.raises(ValueError, match="float32"):
        svd3c([t.double() for t in ok])
    with pytest.raises(ValueError, match="CUDA"):
        svd3c(ok[:8] + [torch.ones(8)])
    with pytest.raises(ValueError, match="shape"):
        svd3c(ok[:8] + [torch.ones(9, device=cuda)])
    saved = run_svd3_fwd(ok)
    with pytest.raises(ValueError, match="shape"):
        run_svd3_bwd(saved[:20], [None] * 21)
    with pytest.raises(ValueError, match="float32"):
        run_svd3_bwd(saved, [torch.ones(8, device=cuda, dtype=torch.float64)] + [None] * 20)
    with pytest.raises(ValueError, match="shape"):
        run_svd3_bwd(saved, [torch.ones(7, device=cuda)] + [None] * 20)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["InvariantFullMetaElasticity", "InvariantFullMetaPlasticity",
                                  "PolarMetaElasticity", "SVDMetaPlasticity",
                                  "SplineMetaElasticity", "CorotatedElasticity",
                                  "VonMisesPlasticity"])
def test_materials_through_svd3_kernels_match_the_component_path(cuda, name, monkeypatch):
    """A material's value and F-gradient on the card through K6 and K7
    against the same material with the component path on the card, bit
    for bit; one K6 and one K7 launch per value-and-grad."""
    import importlib

    from neuma_tpu_torch import kernels
    from test_torch_svd3 import MATERIALS, make_material, near_identity, value_and_grad

    svd3m = importlib.import_module("neuma_tpu_torch.ops.svd3")
    mat = make_material(name, dict(MATERIALS)[name], device=cuda)
    F = near_identity(20000, seed=8, scale=0.1).to(cuda)
    W = torch.randn((20000, 3, 3), generator=torch.Generator().manual_seed(9)).to(cuda)
    kernels.reset_launches()
    got = value_and_grad(mat, F, W)
    assert dict(kernels.launches) == {"svd3": 1, "svd3_bwd": 1}
    monkeypatch.setattr(svd3m, "_on_card", lambda F9: False)
    want = value_and_grad(mat, F, W)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want)), name
