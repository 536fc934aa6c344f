// What K2 (g2p.cu) and K3 (g2p_bwd.cu) share: the 48-column payload
// layout (neuma_tpu_torch/sim/p2g_kernel.py), the slab geometry and the
// staging copy.
#pragma once
#include <cuda_runtime.h>

namespace g2p {

constexpr int S = 16;  // slab side: a 14-cell block and its 2-line halo
constexpr int S3 = S * S * S;
constexpr int COLS = 48;      // payload row
constexpr int OUT_COLS = 16;  // dgm | db (3) | dA (9) | dx (3)
// payload columns: spline weights (3 taps x 3 axes), local tap lines,
// b_eff, A dx, mass, spline derivatives, fx
constexpr int W0 = 0, L0 = 9, BE0 = 18, AC0 = 21, GM = 30, WD0 = 32, FX0 = 41;

// 16-byte asynchronous copy, global -> shared (completes at wait_all).
__device__ __forceinline__ void copy16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ float pick(float a, float b, float c, int k) {
  return k == 0 ? a : (k == 1 ? b : c);
}

}  // namespace g2p
