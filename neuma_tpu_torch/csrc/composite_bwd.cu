// K5: tile-composite backward for Hopper (sm_90a).
//
// Replaces neuma_tpu/render/pallas_raster.py::_bwd_kernel (launched by
// _composite_vjp_bwd under composite_pairs_tpu).
//
// One CTA per 16x16 tile, one thread per pixel. The CTA walks the tile's
// depth-sorted pair range BACK TO FRONT, from the largest `last` of its
// pixels down to the first slot, staging batches of BATCH pair feature rows
// in shared memory. Each pixel carries T_after (starting at the forward's
// final T) and s_dot = sum of w * (rgb . dC) of the pairs behind it. A pair
// contributes to a pixel iff it is live (below the tile's true count),
// power <= 0, alpha = min(0.99, opacity * exp(power)) >= 1/255, and its
// slot index <= the pixel's `last` -- the same decisions as K4
// (csrc/composite.cu), made with the same __fmul_rn/__fadd_rn guard
// arithmetic. For a contributing pair:
//   T_excl   = T_after / (1 - alpha)          (exclusive T by division)
//   dL/dalpha = T_excl (rgb . dC) - s_dot / (1 - alpha) - T / (1 - alpha) dT
// and the 0.99 cap is ignored in the chain (dL/dopacity = G dL/dalpha,
// dL/dpower = opacity G dL/dalpha), as the CUDA rasterizer does. Every
// operation rounds as its plain PyTorch version
// (raster_kernel.composite_bwd_plain) does, so each pixel's partials agree
// bit for bit; only the order of the 256-pixel sums differs.
//
// Each pair's 9 partials (mean2d.xy, conic.abc, opacity, rgb) are reduced
// over the 256 pixels in a fixed order: a shuffle-down tree inside each
// warp, then the 8 warp sums in warp order. The CTA writes the pair's row:
// each slot belongs to one tile, so rows never collide -- no atomics, and
// the result repeats bit for bit. Slots past the tile's largest `last`,
// pad slots and rows past tile_start[-1] keep the zeros the wrapper
// allocated.
//
// What bounds it on this card: the exp and ~60 FP32 operations per
// (pixel, pair) visited plus 45 shuffles per (warp, pair); bytes are 36 B
// per visited pair and 4 KB per tile of T, last, dT and dC. The batch in
// shared memory makes each feature row one global read per CTA.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int BATCH = 64;
constexpr int NF = 9;

__global__ void __launch_bounds__(PIX)
composite_bwd_kernel(const float* __restrict__ feats, const int* __restrict__ tile_start,
                     const int* __restrict__ counts, int tiles_x,
                     const float* __restrict__ T_in, const float* __restrict__ last_in,
                     const float* __restrict__ dT_in, const float* __restrict__ dC_in,
                     float* __restrict__ out) {
  __shared__ float sf[BATCH * NF];
  __shared__ float red[BATCH][WARPS][NF];
  __shared__ float smax[WARPS];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const float px = (float)((t % tiles_x) * TILE + (lane % TILE));
  const float py = (float)((t / tiles_x) * TILE + (lane / TILE));
  const int start = tile_start[t];
  const int n = counts[t];
  const float inv255 = (float)(1.0 / 255.0);
  const float cap = (float)0.99;

  const size_t pix = (size_t)t * PIX + lane;
  const float T_fin = T_in[pix];
  const float last = last_in[pix];
  const float dT = dT_in[pix];
  const float dc0 = dC_in[(size_t)t * 3 * PIX + lane];
  const float dc1 = dC_in[(size_t)t * 3 * PIX + PIX + lane];
  const float dc2 = dC_in[(size_t)t * 3 * PIX + 2 * PIX + lane];

  // The tile's largest `last` bounds the walk.
  float m = last;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((lane & 31) == 0) smax[warp] = m;
  __syncthreads();
  m = smax[0];
#pragma unroll
  for (int k = 1; k < WARPS; ++k) m = fmaxf(m, smax[k]);
  const int end = min(n, (int)m - start + 1);  // local slots [0, end) can contribute

  float T_after = T_fin, s_dot = 0.f;
  for (int hi = end; hi > 0; hi -= BATCH) {
    const int lo = max(0, hi - BATCH);
    const int cnt = hi - lo;
    __syncthreads();  // the previous batch's shared rows are consumed
    const float* src = feats + (size_t)(start + lo) * NF;
    for (int i = lane; i < cnt * NF; i += PIX) sf[i] = src[i];
    __syncthreads();
    for (int j = cnt - 1; j >= 0; --j) {
      const float* f = sf + j * NF;
      float g[NF];
#pragma unroll
      for (int k = 0; k < NF; ++k) g[k] = 0.f;
      const float dx = __fsub_rn(f[0], px);
      const float dy = __fsub_rn(f[1], py);
      const float q = __fadd_rn(__fmul_rn(__fmul_rn(f[2], dx), dx),
                                __fmul_rn(__fmul_rn(f[4], dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(f[3], dx), dy));
      const float idx = (float)(start + lo + j);
      if (power <= 0.f && idx <= last) {
        const float G = expf(power);
        const float raw = __fmul_rn(f[5], G);
        const float alpha = raw > cap ? cap : raw;
        if (alpha >= inv255) {
          const float one_m = __fsub_rn(1.f, alpha);
          const float T_excl = __fdiv_rn(T_after, one_m);
          const float col_dot = __fadd_rn(__fadd_rn(__fmul_rn(f[6], dc0), __fmul_rn(f[7], dc1)),
                                          __fmul_rn(f[8], dc2));
          const float w = __fmul_rn(alpha, T_excl);
          const float inv = __fdiv_rn(1.f, one_m);
          const float dLda = __fsub_rn(__fsub_rn(__fmul_rn(T_excl, col_dot), __fmul_rn(s_dot, inv)),
                                       __fmul_rn(__fmul_rn(T_fin, inv), dT));
          const float dpow = __fmul_rn(__fmul_rn(f[5], G), dLda);
          g[0] = __fmul_rn(-__fadd_rn(__fmul_rn(f[2], dx), __fmul_rn(f[3], dy)), dpow);
          g[1] = __fmul_rn(-__fadd_rn(__fmul_rn(f[4], dy), __fmul_rn(f[3], dx)), dpow);
          g[2] = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, dx), dx), dpow);
          g[3] = __fmul_rn(__fmul_rn(-dx, dy), dpow);
          g[4] = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, dy), dy), dpow);
          g[5] = __fmul_rn(G, dLda);
          g[6] = __fmul_rn(w, dc0);
          g[7] = __fmul_rn(w, dc1);
          g[8] = __fmul_rn(w, dc2);
          s_dot = __fadd_rn(s_dot, __fmul_rn(w, col_dot));
          T_after = T_excl;
        }
      }
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        float v = g[k];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if ((lane & 31) == 0) red[j][warp][k] = v;
      }
    }
    __syncthreads();
    for (int i = lane; i < cnt * NF; i += PIX) {
      const int j = i / NF, k = i % NF;
      float acc = red[j][0][k];
#pragma unroll
      for (int wi = 1; wi < WARPS; ++wi) acc += red[j][wi][k];
      out[(size_t)(start + lo + j) * NF + k] = acc;
    }
  }
}

}  // namespace

extern "C" int neuma_composite_bwd(const void* feats, const void* tile_start, const void* counts,
                                   int num_tiles, int tiles_x, const void* T, const void* last,
                                   const void* dT, const void* dC, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, PIX, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const int*>(tile_start),
        static_cast<const int*>(counts), tiles_x, static_cast<const float*>(T),
        static_cast<const float*>(last), static_cast<const float*>(dT),
        static_cast<const float*>(dC), static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
