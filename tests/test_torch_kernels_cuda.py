"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips without one (marker
``cuda``). The file imports neither JAX nor the JAX package, so it also
runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``tests/conftest.py`` imports JAX, hence ``--noconftest`` there.)
Bounds: K1, K2 and K3 at a scaled 1e-5 (both sides full FP32; K3 per
output group); K4 at atol 2e-5 on T and C with ``last`` equal; K5 at a
scaled 1e-5 per column (each pixel's partials round as the plain
version's, the 256-pixel sums run in another order).
"""
import numpy as np
import pytest
import torch

from neuma_tpu_torch.core.types import MPMConstants, ParticleState, Statics
from neuma_tpu_torch.render import raster_kernel as rk
from neuma_tpu_torch.sim import p2g_kernel as pk
from neuma_tpu_torch.sim.mpm import _p2g_terms


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scaled_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-8)


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
    assert _scaled_err(pk.run_apic_gather(*args), pk.run_apic_gather_plain(*args)) <= 1e-5


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
    with pytest.raises(ValueError, match="int32"):
        rk.composite_fwd(torch.zeros((32, 9), device=cuda), torch.zeros(2, dtype=torch.int64, device=cuda),
                         torch.zeros(1, dtype=torch.int32, device=cuda), 1)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dC"):
        rk.composite_bwd(torch.zeros((32, 9), device=cuda), i32(2), i32(1),
                         *(torch.zeros((1, 256), device=cuda) for _ in range(3)),
                         torch.zeros((1, 256), device=cuda), 1)
