// What the tile-composite kernels K4 (csrc/composite.cu) and K5
// (csrc/composite_bwd.cu) share: the pixel geometry, the contribute guard,
// the row culling, the staging of a segment's pair rows and the plan that
// cuts each tile's range into (tile, SEG-slot segment) work items.
//
// Both files include it, so K4 and K5 decide whether a pair contributes
// with one function, and their segments are the same slots.
#pragma once

#include <cstdio>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int NF = 9;      // pair row: mean2d.xy, conic.abc, opacity, rgb
constexpr int SEG = 64;    // slots per work item
constexpr int PLAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// K4's guard: true iff the pair contributes to the pixel before the
// transmittance test (power <= 0, alpha = min(0.99, opacity exp(power)) >=
// 1/255; a NaN fails both). Also returns dx, dy, G = exp(power) and the
// capped alpha for the gradient. __fmul_rn/__fadd_rn keep nvcc from
// contracting the arithmetic into FMAs, so it rounds as the plain PyTorch
// versions do and the decisions agree with them.
__device__ __forceinline__ bool visit(const float* f, float px, float py, float& dx, float& dy,
                                      float& G, float& alpha) {
  dx = __fsub_rn(f[0], px);
  dy = __fsub_rn(f[1], py);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(f[2], dx), dx), __fmul_rn(__fmul_rn(f[4], dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(f[3], dx), dy));
  if (!(power <= 0.f)) return false;
  G = expf(power);
  const float raw = __fmul_rn(f[5], G);
  const float cap = (float)0.99;
  alpha = raw > cap ? cap : raw;
  return alpha >= (float)(1.0 / 255.0);
}

// Pixel coordinates of lane `lane` of frame tile t. A launch over a range of
// a frame's tiles (one rank's share under tile sharding) indexes its tiles
// from 0 and passes t + tile_base, the range's first tile in the frame; the
// pair slots (tile_start, `last`, the gradient rows) stay the frame's.
__device__ __forceinline__ float pixel_x(int t, int tiles_x, int lane) {
  return (float)((t % tiles_x) * TILE + (lane % TILE));
}
__device__ __forceinline__ float pixel_y(int t, int tiles_x, int lane) {
  return (float)((t / tiles_x) * TILE + (lane / TILE));
}

// Rows of pixels outside [y0, y1] fail the guard for the pair f:
// alpha >= 1/255 needs opacity >= 1/255 and Q = a dx^2 + 2 b dx dy + c dy^2
// <= 2 ln(255 opacity), hence dy^2 <= 2 ln(255 opacity) a / det. Margins
// (0.1% + 1e-3 on the log, 0.1% + 0.01 px on the extent) cover the rounding
// of the guard's own arithmetic, which stays bounded relative to Q only for
// conics with det > 0.1 a c; others (and non-finite rows) are not culled.
__device__ __forceinline__ float2 row_bounds(const float* f) {
  const float a = f[2], b = f[3], c = f[4], op = f[5];
  if (!(op >= (float)(1.0 / 255.0))) return make_float2(INFINITY, -INFINITY);  // none
  const float det = a * c - b * b;
  const float tau = logf(op * 255.f);
  if (!(a > 0.f && c > 0.f && det > 0.1f * a * c && tau < 1e30f && f[1] == f[1]))
    return make_float2(-INFINITY, INFINITY);  // all rows
  const float ext = sqrtf(2.f * (tau * 1.001f + 1e-3f) * a / det) * 1.001f + 0.01f;
  return make_float2(f[1] - ext, f[1] + ext);
}

// Stage the pair rows [first, first + cnt) and their row bounds in shared
// memory (cnt <= SEG; the CTA has PIX threads).
__device__ __forceinline__ void load_rows(float* sf, float2* sy, const float* __restrict__ feats,
                                          int first, int cnt) {
  __syncthreads();  // the previous item's rows are consumed
  const float* src = feats + (size_t)first * NF;
  for (int k = threadIdx.x; k < cnt * NF; k += PIX) sf[k] = src[k];
  __syncthreads();
  if (threadIdx.x < cnt) sy[threadIdx.x] = row_bounds(sf + threadIdx.x * NF);
  __syncthreads();
}

// One CTA: a block scan of ceil(len_t / SEG) lays out the work list tile
// by tile, work[i] = (tile, segment, first item of the tile, segments of
// the tile), so a tile's segments are consecutive items; *total is the
// item count and, when tile_first is given, tile_first[t] the tile's first
// item. Traps rather than write past max_items.
__global__ void __launch_bounds__(PLAN_THREADS)
plan_segments(const int* __restrict__ len, int num_tiles, int max_items, int4* __restrict__ work,
              int* __restrict__ total, int* __restrict__ tile_first) {
  __shared__ int wsum[PLAN_THREADS / 32];
  const int per = (num_tiles + PLAN_THREADS - 1) / PLAN_THREADS;
  const int t0 = min(num_tiles, (int)threadIdx.x * per);
  const int t1 = min(num_tiles, t0 + per);
  int local = 0;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) local += (len[t] + SEG - 1) / SEG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    wsum[lane] = v;
  }
  __syncthreads();
  if (wsum[PLAN_THREADS / 32 - 1] > max_items) {  // refuse rather than write past the list
    if (threadIdx.x == 0)
      printf("plan_segments: %d work items exceed the scratch's %d\n",
             wsum[PLAN_THREADS / 32 - 1], max_items);
    __trap();
  }
  int base = (warp ? wsum[warp - 1] : 0) + incl - local;
  if (threadIdx.x == PLAN_THREADS - 1) *total = base + local;
  for (int t = t0; t < t1; ++t) {
    const int n = (len[t] + SEG - 1) / SEG;
    if (tile_first) tile_first[t] = base;
    for (int k = 0; k < n; ++k) work[base + k] = make_int4(t, k, base, n);
    base += n;
  }
}

// CTAs of `kernel` (PIX threads) that fit on the card at once, cached per
// kernel.
template <typename K>
int resident_ctas(K kernel, int* cache) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PIX, 0);
    *cache = max(1, sms * per_sm);
  }
  return *cache;
}

// Work items any tile ranges of P pair slots can need: sum_t ceil(len_t /
// SEG) <= P / SEG + num_tiles, since the ranges hold at most P slots.
inline size_t items_bound(int P, int num_tiles) { return (size_t)P / SEG + num_tiles + 1; }

}  // namespace
