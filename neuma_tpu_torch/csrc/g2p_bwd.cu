// K3: G2P 27-tap gather with spline derivatives, for Hopper (sm_90a).
//
// Replaces neuma_tpu/sim/p2g_kernel.py::_make_gather_kernel(derivs=True)
// (launched by run_apic_gather). The step backward runs it twice: on the
// slab cotangents with the forward (mass, b, affine) payload (the P2G
// adjoint), and on the grid velocities with (d new_v, kappa d new_C) (the
// G2P position adjoint).
//
// Per payload row, its 27 taps read from its block's halo-complete slab in
// (ch, x, y, z) layout (the block is c2b[row / chunk]) give 16 outputs:
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
// The design: one CTA per chunk of ROWS = 128 rows, which all read one
// block's slab. The CTA stages the chunk's 128 x 48 payload (24 KB) in
// shared memory with 16-byte cp.async copies (rows padded to 52 floats, so
// the 16-byte reads of 8 neighbouring rows hit distinct banks), and gives
// each row SPLIT = 3 threads, one per x tap, each summing its 9 (y, z)
// taps: 3x the threads in flight of a thread per row and a third of each
// thread's dependent slab loads, with the loads of a thread independent of
// each other. Three, not nine (one per (x, y) line): 9 x 128 threads do not
// fit in one CTA, and a 64-row CTA would stage half a chunk. The x-tap
// threads of a row sit in warps 0-3, 4-7 and 8-11, so the split is
// warp-uniform. The three partials of the 16 sums (dx's s terms included)
// are added in x-tap order through shared memory, and the (128, 16) output
// block is staged there and written with coalesced stores. No atomics: the
// result repeats bit for bit.
//
// What bounds it (H100): per row 192 B of payload, 27 x 4 slab floats that
// stay in L1/L2 (a chunk's rows share one 64 KB slab) and 64 B out, ~27 x 70
// FLOPs; at the main path's 13.5k-46k rows there are 106-360 CTAs, so the
// latency of the slab loads and the launch itself dominate.
#include <cuda_runtime.h>

#include "g2p_common.cuh"

namespace {

using namespace g2p;

constexpr int ROWS = 128;        // payload rows per CTA: one gather chunk
constexpr int SPLIT = 3;         // threads per row, one per x tap
constexpr int THREADS = ROWS * SPLIT;
constexpr int PSTRIDE = 52;      // staged row stride in floats (16-byte aligned)
constexpr int OSTRIDE = OUT_COLS + 1;

__global__ void __launch_bounds__(THREADS)
g2p_gather_derivs_kernel(const float* __restrict__ payload, const float* __restrict__ slabs,
                         const int* __restrict__ c2b, int chunk, float dxc, float inv_dx,
                         float* __restrict__ out) {
  // The staged payload, then (rows 1 and 2 of the split) the partial sums.
  __shared__ __align__(16) float sp[ROWS * PSTRIDE];
  __shared__ float so[ROWS * OSTRIDE];
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const float* src = payload + row0 * COLS;
  for (int k = tid; k < ROWS * COLS / 4; k += THREADS)
    copy16(sp + (k / (COLS / 4)) * PSTRIDE + 4 * (k % (COLS / 4)), src + 4 * k);
  asm volatile("cp.async.commit_group;\n" ::);
  const float* slab = slabs + (size_t)c2b[row0 / chunk] * 4 * S3;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int ix = tid / ROWS;  // this thread's x tap
  const int r = tid % ROWS;
  const float4* p4 = reinterpret_cast<const float4*>(sp + r * PSTRIDE);
  float v[44];
#pragma unroll
  for (int q = 0; q < 11; ++q) {
    const float4 x = p4[q];
    v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
  }
  const float wx = pick(v[W0], v[W0 + 1], v[W0 + 2], ix);
  const float wpx = wx * ((float)ix - v[FX0]);
  const float wdx = pick(v[WD0], v[WD0 + 1], v[WD0 + 2], ix);
  const int lx = (int)pick(v[L0], v[L0 + 1], v[L0 + 2], ix);
  float w[3][3], wp[3][3], wd[3][3];
  int l[3][3];
#pragma unroll
  for (int a = 1; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w[a][k] = v[W0 + 3 * a + k];
      wp[a][k] = w[a][k] * ((float)k - v[FX0 + a]);
      wd[a][k] = v[WD0 + 3 * a + k];
      l[a][k] = (int)v[L0 + 3 * a + k];
    }
  }
  const float gm = v[GM];
  float be[3], ac[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    be[c] = v[BE0 + c];
#pragma unroll
    for (int d = 0; d < 3; ++d) ac[c][d] = v[AC0 + 3 * c + d];
  }

  // acc: dgm | db (3) | dA (9) | ds (3)
  float acc[OUT_COLS];
#pragma unroll
  for (int k = 0; k < OUT_COLS; ++k) acc[k] = 0.f;
  if ((unsigned)lx < S) {
#pragma unroll
    for (int iy = 0; iy < 3; ++iy) {
#pragma unroll
      for (int iz = 0; iz < 3; ++iz) {
        const int ly = l[1][iy], lz = l[2][iz];
        if ((unsigned)ly >= S || (unsigned)lz >= S) continue;
        const float W = wx * w[1][iy] * w[2][iz];
        const float Wp[3] = {wpx * w[1][iy] * w[2][iz], wx * wp[1][iy] * w[2][iz],
                             wx * w[1][iy] * wp[2][iz]};
        const float dW[3] = {wdx * w[1][iy] * w[2][iz], wx * wd[1][iy] * w[2][iz],
                             wx * w[1][iy] * wd[2][iz]};
        const int off = (lx * S + ly) * S + lz;
        const float u = slab[3 * S3 + off];
        acc[0] += W * u;
        float s = u * gm;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float vr = slab[c * S3 + off];
          acc[1 + c] += W * vr;
#pragma unroll
          for (int d = 0; d < 3; ++d) acc[4 + 3 * c + d] += Wp[d] * vr;
          s += vr * (be[c] + (ac[c][0] * (float)ix + ac[c][1] * (float)iy + ac[c][2] * (float)iz));
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) acc[13 + a] += dW[a] * s;
      }
    }
  }

  // Partials of x taps 1 and 2 into the payload's space, summed in x-tap order.
  __syncthreads();
  float* red = sp;  // [SPLIT - 1][OUT_COLS][ROWS]
  if (ix > 0) {
#pragma unroll
    for (int k = 0; k < OUT_COLS; ++k) red[((ix - 1) * OUT_COLS + k) * ROWS + r] = acc[k];
  }
  __syncthreads();
  if (ix == 0) {
#pragma unroll
    for (int k = 0; k < OUT_COLS; ++k)
      acc[k] = (acc[k] + red[k * ROWS + r]) + red[(OUT_COLS + k) * ROWS + r];
    float* o = so + r * OSTRIDE;
    o[0] = acc[0];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[1 + c] = acc[1 + c];
#pragma unroll
      for (int d = 0; d < 3; ++d) o[4 + 3 * c + d] = dxc * acc[4 + 3 * c + d];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float minus = ac[0][a] * acc[1] + ac[1][a] * acc[2] + ac[2][a] * acc[3];
      o[13 + a] = inv_dx * acc[13 + a] - inv_dx * minus;
    }
  }
  __syncthreads();
  float* dst = out + row0 * OUT_COLS;
  for (int k = tid; k < ROWS * OUT_COLS; k += THREADS)
    dst[k] = so[(k / OUT_COLS) * OSTRIDE + k % OUT_COLS];
}

}  // namespace

extern "C" int neuma_g2p_derivs_rows_per_cta() { return ROWS; }
extern "C" int neuma_g2p_derivs_threads_per_row() { return SPLIT; }

extern "C" int neuma_g2p_gather_derivs(const void* payload, const void* slabs, const void* c2b,
                                       int rows, int chunk, float dxc, float inv_dx, void* out,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk <= 0 || chunk % ROWS || rows % chunk) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    g2p_gather_derivs_kernel<<<rows / ROWS, THREADS, 0, s>>>(
        static_cast<const float*>(payload), static_cast<const float*>(slabs),
        static_cast<const int*>(c2b), chunk, dxc, inv_dx, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
