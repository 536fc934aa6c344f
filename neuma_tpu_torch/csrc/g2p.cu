// K2: G2P 27-tap gather for Hopper (sm_90a).
//
// Replaces neuma_tpu/sim/p2g_kernel.py::_make_gather_kernel(derivs=False)
// (launched by run_apic_gather).
//
// Per payload row, its 27 taps read from its block's halo-complete slab in
// (ch, x, y, z) layout (the block is c2b[row / chunk]) give
//   col 0      dgm      = sum W u
//   cols 1-3   db[r]    = sum W v_r                       (new_v)
//   cols 4-12  dA[r][c] = dx * sum W (t_c - fx_c) v_r
//   cols 13-15 0        (the position adjoint of K3)
// where W = wx wy wz, u is the slab's channel 3 and v its channels 0-2.
// The (t - fx) weighting stays inside each tap's factor, as the TPU kernel
// keeps it inside its one-hot factor, so there is no O(1) - O(1)
// cancellation after the tap sums. A tap line outside 0..15 reads zero;
// padding rows carry zero weights and produce zero rows.
//
// The design: a CTA of ROWS = 64 rows, half a 128-row gather chunk, so
// all its rows read one block's 64 KB slab, which stays in L1/L2. The CTA
// stages only the payload columns K2 reads (weights and lines, cols 0-19,
// and fx, cols 40-43: 6 of the row's 12 float4) with 16-byte cp.async
// copies, into rows padded to 7 float4 so the 16-byte reads of 8
// neighbouring rows hit distinct banks. Each row gets SPLIT = 3 threads,
// one per x tap (as K3), in warps 0-1, 2-3 and 4-5 so the split is
// warp-uniform; each sums its 9 (y, z) taps from 36 independent slab loads
// (an out-of-range tap reads zero). The three partials
// of the 13 sums are written to shared memory and added in x-tap order,
// and the (64, 16) output block is written with coalesced stores. No
// atomics: the result repeats bit for bit.
//
// What bounds it (H100): per row 128 B of the payload's 192 (4 of its 6
// 32-byte sectors), 27 x 4 slab floats that stay in L1/L2 and 64 B out,
// ~27 x 34 FLOPs. At the main path's 13.5k-46k rows the launch has
// 212-720 CTAs of 192 threads. A thread per row gave too few warps, each
// with one long chain of 27 taps: dropping its slab loads or its payload
// loads saved little of its time. Split designs with 9 threads per row
// (one per (x, y) line, 32 or 64 rows per CTA) or 128 rows per CTA were
// no faster on the H100.
#include <cuda_runtime.h>

#include "g2p_common.cuh"

namespace {

using namespace g2p;

constexpr int ROWS = 64;   // payload rows per CTA (divides the gather chunk)
constexpr int SPLIT = 3;   // threads per row, one per x tap
constexpr int THREADS = ROWS * SPLIT;
constexpr int QROW = 6;    // staged float4 per row: cols 0-19 and 40-43
constexpr int PSTRIDE = 28;  // staged row stride in floats: 7 float4, odd
constexpr int ACC = 13;    // dgm | db (3) | dA (9)

__global__ void __launch_bounds__(THREADS)
g2p_gather_kernel(const float* __restrict__ payload, const float* __restrict__ slabs,
                  const int* __restrict__ c2b, int chunk, float dxc, float* __restrict__ out) {
  __shared__ __align__(16) float sp[ROWS * PSTRIDE];
  __shared__ float part_sums[SPLIT * ROWS * ACC];  // [x tap][row][13]
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const float* src = payload + row0 * COLS;
  for (int k = tid; k < ROWS * QROW; k += THREADS) {
    const int r = k / QROW, q = k % QROW;
    copy16(sp + r * PSTRIDE + 4 * q, src + (size_t)r * COLS + 4 * (q < 5 ? q : FX0 / 4));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const float* slab = slabs + (size_t)c2b[row0 / chunk] * 4 * S3;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int ix = tid / ROWS;  // this thread's x tap
  const int r = tid % ROWS;
  const float4* p4 = reinterpret_cast<const float4*>(sp + r * PSTRIDE);
  float v[4 * QROW];  // cols 0-19, then 40-43
#pragma unroll
  for (int q = 0; q < QROW; ++q) {
    const float4 x = p4[q];
    v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
  }
  const float* fx = v + 20 + (FX0 - 40);
  const float wx = pick(v[W0], v[W0 + 1], v[W0 + 2], ix);
  const float wpx = wx * ((float)ix - fx[0]);
  const int lx = (int)pick(v[L0], v[L0 + 1], v[L0 + 2], ix);
  float wz[3], wpz[3];
  int lz[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    wz[k] = v[W0 + 6 + k];
    wpz[k] = wz[k] * ((float)k - fx[2]);
    lz[k] = (int)v[L0 + 6 + k];
  }

  float acc[ACC];
#pragma unroll
  for (int k = 0; k < ACC; ++k) acc[k] = 0.f;
#pragma unroll
  for (int iy = 0; iy < 3; ++iy) {
    const float wy = v[W0 + 3 + iy];
    const float wpy = wy * ((float)iy - fx[1]);
    const int ly = (int)v[L0 + 3 + iy];
    const bool in_xy = (unsigned)lx < S && (unsigned)ly < S;
#pragma unroll
    for (int iz = 0; iz < 3; ++iz) {
      const bool in = in_xy && (unsigned)lz[iz] < S;
      const int off = in ? (lx * S + ly) * S + lz[iz] : 0;
      const float u = in ? slab[3 * S3 + off] : 0.f;
      const float W = wx * wy * wz[iz];
      const float Wp[3] = {wpx * wy * wz[iz], wx * wpy * wz[iz], wx * wy * wpz[iz]};
      acc[0] += W * u;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float vr = in ? slab[c * S3 + off] : 0.f;
        acc[1 + c] += W * vr;
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[4 + 3 * c + d] += Wp[d] * vr;
      }
    }
  }
  float* mine = part_sums + (ix * ROWS + r) * ACC;  // stride 13: no bank conflicts
#pragma unroll
  for (int k = 0; k < ACC; ++k) mine[k] = acc[k];
  __syncthreads();

  // Each output element adds its three x-tap partials in x-tap order.
  float* dst = out + row0 * OUT_COLS;
  for (int k = tid; k < ROWS * OUT_COLS; k += THREADS) {
    const int rr = k / OUT_COLS, col = k % OUT_COLS;
    float s = 0.f;
    if (col < ACC) {
      s = part_sums[rr * ACC + col];
#pragma unroll
      for (int q = 1; q < SPLIT; ++q) s += part_sums[(q * ROWS + rr) * ACC + col];
      if (col >= 4) s *= dxc;
    }
    dst[k] = s;
  }
}

}  // namespace

extern "C" int neuma_g2p_rows_per_cta() { return ROWS; }
extern "C" int neuma_g2p_threads_per_row() { return SPLIT; }

extern "C" int neuma_g2p_gather(const void* payload, const void* slabs, const void* c2b,
                                int rows, int chunk, float dxc, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk <= 0 || chunk % ROWS || rows % chunk) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    g2p_gather_kernel<<<rows / ROWS, THREADS, 0, s>>>(
        static_cast<const float*>(payload), static_cast<const float*>(slabs),
        static_cast<const int*>(c2b), chunk, dxc, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
