// K3: G2P 27-tap gather with spline derivatives, for Hopper (sm_90a).
//
// Replaces neuma_tpu/sim/p2g_kernel.py::_make_gather_kernel(derivs=True)
// (launched by run_apic_gather). The step backward runs it twice: on the
// slab cotangents with the forward (mass, b, affine) payload (the P2G
// adjoint), and on the grid velocities with (d new_v, kappa d new_C) (the
// G2P position adjoint).
//
// One thread per payload row, as K2 (csrc/g2p.cu). The row's chunk gives
// its block (c2b[row / chunk]); the thread reads its 27 taps straight from
// that block's halo-complete slab in (ch, x, y, z) layout and accumulates
// 16 outputs in registers:
//   col 0      dgm      = sum W u
//   cols 1-3   db[r]    = sum W v_r
//   cols 4-12  dA[r][c] = dx * sum W (t_c - fx_c) v_r
//   cols 13-15 dx_a     = inv_dx * sum dW_a s  -  inv_dx * sum_i a_col[i][a] db_i
//              s        = u gm + sum_r v_r (b_eff_r + sum_c a_col[r][c] t_c)
// where W = wx wy wz, dW_a is W with the axis-a factor replaced by the
// spline derivative column (payload cols 32-40), u is the slab's channel 3
// and v its channels 0-2. The (t - fx) weighting stays inside each tap's
// factor, as the TPU kernel keeps it inside its one-hot factor, so there
// is no O(1) - O(1) cancellation after the tap sums. Padding rows carry
// zero weights and produce zero rows.
//
// What bounds it on this card: per row 192 B of payload, 27x4 slab floats
// that stay in L1/L2 (a chunk's 128 rows share one 64 KB slab), 64 B out,
// and ~27*70 FLOPs; at the main path's 13.5k-46k rows the launch has few
// CTAs, so latency of the dependent slab loads dominates. The design keeps
// every intermediate in registers and reads each tap once for all outputs.
#include <cuda_runtime.h>

namespace {

constexpr int S = 16;
constexpr int S3 = S * S * S;
constexpr int COLS = 48;
constexpr int OUT_COLS = 16;
constexpr int W0 = 0, L0 = 9, BE0 = 18, AC0 = 21, GM = 30, WD0 = 32, FX0 = 41;

__global__ void __launch_bounds__(128)
g2p_gather_derivs_kernel(const float* __restrict__ payload, const float* __restrict__ slabs,
                         const int* __restrict__ c2b, int rows, int chunk, float dxc,
                         float inv_dx, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const float* r = payload + (size_t)i * COLS;
  const float* slab = slabs + (size_t)c2b[i / chunk] * 4 * S3;

  float w[3][3], wp[3][3], wd[3][3];
  int l[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float fx = r[FX0 + a];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w[a][k] = r[W0 + 3 * a + k];
      wp[a][k] = w[a][k] * ((float)k - fx);
      wd[a][k] = r[WD0 + 3 * a + k];
      l[a][k] = (int)r[L0 + 3 * a + k];
    }
  }
  const float gm = r[GM];
  float be[3], ac[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    be[c] = r[BE0 + c];
#pragma unroll
    for (int d = 0; d < 3; ++d) ac[c][d] = r[AC0 + 3 * c + d];
  }

  float dgm = 0.f, db[3] = {0.f, 0.f, 0.f}, ds[3] = {0.f, 0.f, 0.f};
  float dA[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
  for (int ix = 0; ix < 3; ++ix) {
#pragma unroll
    for (int iy = 0; iy < 3; ++iy) {
#pragma unroll
      for (int iz = 0; iz < 3; ++iz) {
        const int lx = l[0][ix], ly = l[1][iy], lz = l[2][iz];
        if ((unsigned)lx >= S || (unsigned)ly >= S || (unsigned)lz >= S) continue;
        const float W = w[0][ix] * w[1][iy] * w[2][iz];
        const float Wp[3] = {wp[0][ix] * w[1][iy] * w[2][iz],
                             w[0][ix] * wp[1][iy] * w[2][iz],
                             w[0][ix] * w[1][iy] * wp[2][iz]};
        const float dW[3] = {wd[0][ix] * w[1][iy] * w[2][iz],
                             w[0][ix] * wd[1][iy] * w[2][iz],
                             w[0][ix] * w[1][iy] * wd[2][iz]};
        const int off = (lx * S + ly) * S + lz;
        const float u = slab[3 * S3 + off];
        dgm += W * u;
        float s = u * gm;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float vr = slab[c * S3 + off];
          db[c] += W * vr;
#pragma unroll
          for (int d = 0; d < 3; ++d) dA[c][d] += Wp[d] * vr;
          s += vr * (be[c] + (ac[c][0] * (float)ix + ac[c][1] * (float)iy + ac[c][2] * (float)iz));
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) ds[a] += dW[a] * s;
      }
    }
  }

  float* o = out + (size_t)i * OUT_COLS;
  o[0] = dgm;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[1 + c] = db[c];
#pragma unroll
    for (int d = 0; d < 3; ++d) o[4 + 3 * c + d] = dxc * dA[c][d];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float minus = ac[0][a] * db[0] + ac[1][a] * db[1] + ac[2][a] * db[2];
    o[13 + a] = inv_dx * ds[a] - inv_dx * minus;
  }
}

}  // namespace

extern "C" int neuma_g2p_gather_derivs(const void* payload, const void* slabs, const void* c2b,
                                       int rows, int chunk, float dxc, float inv_dx, void* out,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const int blocks = (rows + threads - 1) / threads;
  if (blocks > 0) {
    g2p_gather_derivs_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float*>(payload), static_cast<const float*>(slabs),
        static_cast<const int*>(c2b), rows, chunk, dxc, inv_dx, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
