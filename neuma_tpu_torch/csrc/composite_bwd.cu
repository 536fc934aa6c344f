// K5: tile-composite backward for Hopper (sm_90a).
//
// Replaces neuma_tpu/render/pallas_raster.py::_bwd_kernel (launched by
// _composite_vjp_bwd under composite_pairs_tpu).
//
// Per pixel the backward walks its tile's depth-sorted pairs back to front
// from its `last` contributor, carrying T_after (the transmittance after the
// current pair) and s_dot (the sum of w * (rgb . dC) of the pairs behind it).
// A pair contributes iff it is live, power <= 0, alpha = min(0.99, opacity *
// exp(power)) >= 1/255 and its slot index <= the pixel's `last` -- K4's
// decisions (csrc/composite.cu), made with the same __fmul_rn/__fadd_rn guard
// arithmetic so they agree bit for bit. For a contributing pair:
//   T_excl    = T_after / (1 - alpha)
//   dL/dalpha = T_excl (rgb . dC) - s_dot / (1 - alpha) - T / (1 - alpha) dT
// and the 0.99 cap is ignored in the chain (dL/dopacity = G dL/dalpha,
// dL/dpower = opacity G dL/dalpha), as the CUDA rasterizer does.
//
// The design: the walk of tile t, slots [0, end_t) with end_t the tile's
// largest `last` + 1 (capped by its count), is cut into segments of SEG slots,
// and each (tile, segment) is one work item. Four launches:
//   1. k5_tile_end: end_t per tile (one warp per tile).
//   2. k5_plan (one CTA): a block scan of ceil(end_t / SEG) lays out the
//      work list tile by tile, so a tile's segments are consecutive items.
//   3. k5_summaries: per (item, pixel), front to back over the segment's
//      contributing slots, P = prod (1 - alpha) and S = sum alpha T_local
//      (rgb . dC), T_local the product so far.
//   4. k5_gradients: each pixel combines its tile's summaries in segment
//      order: T_after = (prod of P over segments <= s) and s_dot = sum over
//      later segments s' of T_front(s') S(s'), T_front the product of the P
//      before s'. It then walks its segment back to front as above, with one
//      approximate reciprocal of (1 - alpha) per visit (rcp.approx, within
//      1 ulp), so per-pixel partials round apart from the plain version's
//      divides; the check is the scaled 1e-5 per column.
// Launches 3 and 4 are persistent: as many CTAs as fit on the card, each
// taking items i, i + gridDim.x, ... The per-slot sum over the 256 pixels is
// off the walk's critical path: the CTA stages the 9 partials of BATCH slots
// in shared memory and then reduces all 9 * BATCH rows at once, each warp
// taking rows in turn (8 strided adds per lane, then a 5-level shuffle tree):
// a fixed order, one write per slot. A pixel whose `last` lies below a slot,
// or whose row lies outside the rows the pair can reach with alpha >= 1/255
// (bounds per staged row, with margins, so the culled pixels are ones K4's
// guard rejects), stages zeros without any arithmetic -- a whole warp (two
// pixel rows) at once when none of its pixels is left. A slot belongs to
// one tile and one segment, so rows never collide -- no atomics, and the
// result repeats bit for bit. Slots past end_t, pad slots and rows past
// tile_start[-1] keep the wrapper's zeros.
//
// What bounds it now (H100, device time, PERF.md): ~0.14 ms per headline view
// and ~0.47 ms per realworld view against a 0.014 / 0.057 ms operation
// bound. Launch 4 takes ~75% and is bound by instruction issue: ~130
// instructions per (pixel, slot) on the contributing path (the guard and
// exp, the gradient, the staging) where the bound counts 60 FLOPs; launch 3
// repeats the guard and exp for the summaries (~25%).
//
// Scratch: one buffer the wrapper allocates at the size
// neuma_composite_bwd_scratch_words gives (layout below). k5_plan traps if
// the work list would not fit it, which only tile ranges that overrun the P
// pair slots can cause.
#include <cstdio>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int NF = 9;
constexpr int SEG = 64;    // slots per work item
constexpr int BATCH = 4;   // slots staged per reduction
constexpr int PLAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// K4's guard arithmetic: true iff the pair contributes (before the `last`
// test); dx, dy, G and the capped alpha for the gradient.
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

__device__ __forceinline__ float pixel_x(int t, int tiles_x, int lane) {
  return (float)((t % tiles_x) * TILE + (lane % TILE));
}
__device__ __forceinline__ float pixel_y(int t, int tiles_x, int lane) {
  return (float)((t / tiles_x) * TILE + (lane / TILE));
}

__global__ void __launch_bounds__(PIX)
k5_tile_end(const int* __restrict__ tile_start, const int* __restrict__ counts,
            const float* __restrict__ last, int num_tiles, int* __restrict__ tile_end) {
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= num_tiles) return;  // whole warps
  float m = -1.f;
  for (int k = lane; k < PIX; k += 32) m = fmaxf(m, last[(size_t)t * PIX + k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  if (lane == 0) tile_end[t] = max(0, min(counts[t], (int)m - tile_start[t] + 1));
}

__global__ void __launch_bounds__(PLAN_THREADS)
k5_plan(const int* __restrict__ tile_end, int num_tiles, int max_items, int4* __restrict__ work,
        int* __restrict__ total) {
  __shared__ int wsum[PLAN_THREADS / 32];
  const int per = (num_tiles + PLAN_THREADS - 1) / PLAN_THREADS;
  const int t0 = min(num_tiles, (int)threadIdx.x * per);
  const int t1 = min(num_tiles, t0 + per);
  int local = 0;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) local += (tile_end[t] + SEG - 1) / SEG;
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
      printf("k5_plan: %d work items exceed the scratch's %d\n", wsum[PLAN_THREADS / 32 - 1],
             max_items);
    __trap();
  }
  int base = (warp ? wsum[warp - 1] : 0) + incl - local;
  if (threadIdx.x == PLAN_THREADS - 1) *total = base + local;
  for (int t = t0; t < t1; ++t) {
    const int n = (tile_end[t] + SEG - 1) / SEG;
    for (int k = 0; k < n; ++k) work[base + k] = make_int4(t, k, base, n);
    base += n;
  }
}

// Rows of pixels outside [y0, y1] fail K4's guard for the pair f:
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

// Stage the item's feature rows [lo, hi) and their row bounds in shared memory.
__device__ __forceinline__ void load_rows(float* sf, float2* sy, const float* __restrict__ feats,
                                          int first, int cnt) {
  __syncthreads();  // the previous item's rows are consumed
  const float* src = feats + (size_t)first * NF;
  for (int k = threadIdx.x; k < cnt * NF; k += PIX) sf[k] = src[k];
  __syncthreads();
  if (threadIdx.x < cnt) sy[threadIdx.x] = row_bounds(sf + threadIdx.x * NF);
  __syncthreads();
}

__global__ void __launch_bounds__(PIX, 4)
k5_summaries(const float* __restrict__ feats, const int* __restrict__ tile_start,
             const int* __restrict__ tile_end, const int4* __restrict__ work,
             const int* __restrict__ total, int tiles_x, const float* __restrict__ last_in,
             const float* __restrict__ dC_in, float2* __restrict__ summ) {
  __shared__ float sf[SEG * NF];
  __shared__ float2 sy[SEG];
  const int lane = threadIdx.x;
  const int n_items = *total;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const int4 wi = work[i];
    const int t = wi.x;
    const int start = tile_start[t];
    const int lo = wi.y * SEG;
    const int hi = min(tile_end[t], lo + SEG);
    load_rows(sf, sy, feats, start + lo, hi - lo);
    const size_t pix = (size_t)t * PIX + lane;
    const int lim = min(hi, (int)last_in[pix] - start + 1);
    float Tl = 1.f, S = 0.f;
    if (lim > lo) {
      const float px = pixel_x(t, tiles_x, lane), py = pixel_y(t, tiles_x, lane);
      const float dc0 = dC_in[(size_t)t * 3 * PIX + lane];
      const float dc1 = dC_in[(size_t)t * 3 * PIX + PIX + lane];
      const float dc2 = dC_in[(size_t)t * 3 * PIX + 2 * PIX + lane];
      for (int j = lo; j < lim; ++j) {
        const float* f = sf + (j - lo) * NF;
        const float2 yb = sy[j - lo];
        float dx, dy, G, alpha;
        if (py >= yb.x && py <= yb.y && visit(f, px, py, dx, dy, G, alpha)) {
          const float col_dot = f[6] * dc0 + f[7] * dc1 + f[8] * dc2;
          S = S + alpha * Tl * col_dot;
          Tl = Tl * (1.f - alpha);
        }
      }
    }
    summ[(size_t)i * PIX + lane] = make_float2(Tl, S);
  }
}

__global__ void __launch_bounds__(PIX, 4)
k5_gradients(const float* __restrict__ feats, const int* __restrict__ tile_start,
             const int* __restrict__ tile_end, const int4* __restrict__ work,
             const int* __restrict__ total, int tiles_x, const float* __restrict__ T_in,
             const float* __restrict__ last_in, const float* __restrict__ dT_in,
             const float* __restrict__ dC_in, const float2* __restrict__ summ,
             float* __restrict__ out) {
  __shared__ float sf[SEG * NF];
  __shared__ float2 sy[SEG];
  __shared__ float red[BATCH * NF][PIX];
  const int lane = threadIdx.x;
  const int wl = lane & 31, warp = lane >> 5;
  const int n_items = *total;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const int4 wi = work[i];
    const int t = wi.x, s = wi.y, base = wi.z, nseg = wi.w;
    const int start = tile_start[t];
    const int lo = s * SEG;
    const int hi = min(tile_end[t], lo + SEG);
    load_rows(sf, sy, feats, start + lo, hi - lo);

    const size_t pix = (size_t)t * PIX + lane;
    const int last_i = (int)last_in[pix] - start;  // local slot of the pixel's last contributor
    const float px = pixel_x(t, tiles_x, lane), py = pixel_y(t, tiles_x, lane);
    const float T_fin = T_in[pix];
    const float dT = dT_in[pix];
    const float dc0 = dC_in[(size_t)t * 3 * PIX + lane];
    const float dc1 = dC_in[(size_t)t * 3 * PIX + PIX + lane];
    const float dc2 = dC_in[(size_t)t * 3 * PIX + 2 * PIX + lane];
    // The state at the segment's back end, from the summaries in segment
    // order (segments past the pixel's last hold P = 1, S = 0: skipped).
    float T_after = 1.f, s_dot = 0.f;
    if (last_i >= lo) {
      const int kmax = min(nseg, last_i / SEG + 1);
      float Tf = 1.f;
      for (int k = 0; k < kmax; ++k) {
        const float2 ps = summ[(size_t)(base + k) * PIX + lane];
        if (k == s) T_after = Tf * ps.x;
        else if (k > s) s_dot = s_dot + Tf * ps.y;
        Tf = Tf * ps.x;
      }
    }

    for (int top = hi; top > lo; top -= BATCH) {
      const int cnt = min(BATCH, top - lo);
      for (int jj = 0; jj < cnt; ++jj) {
        const int j = top - 1 - jj;
        float g[NF];
#pragma unroll
        for (int k = 0; k < NF; ++k) g[k] = 0.f;
        float dx, dy, G, alpha;
        const float* f = sf + (j - lo) * NF;
        const float2 yb = sy[j - lo];
        if (j <= last_i && py >= yb.x && py <= yb.y && visit(f, px, py, dx, dy, G, alpha)) {
          float inv;  // 1 / (1 - alpha), 1 - alpha in [0.01, 1): MUFU.RCP, within 1 ulp
          asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(1.f - alpha));
          const float T_excl = T_after * inv;
          const float col_dot = f[6] * dc0 + f[7] * dc1 + f[8] * dc2;
          const float w = alpha * T_excl;
          const float dLda = T_excl * col_dot - s_dot * inv - T_fin * inv * dT;
          const float dpow = f[5] * G * dLda;
          g[0] = -(f[2] * dx + f[3] * dy) * dpow;
          g[1] = -(f[4] * dy + f[3] * dx) * dpow;
          g[2] = -0.5f * dx * dx * dpow;
          g[3] = -dx * dy * dpow;
          g[4] = -0.5f * dy * dy * dpow;
          g[5] = G * dLda;
          g[6] = w * dc0;
          g[7] = w * dc1;
          g[8] = w * dc2;
          s_dot = s_dot + w * col_dot;
          T_after = T_excl;
        }
#pragma unroll
        for (int k = 0; k < NF; ++k) red[jj * NF + k][lane] = g[k];
      }
      __syncthreads();
      for (int r = warp; r < cnt * NF; r += WARPS) {
        float v = red[r][wl];
#pragma unroll
        for (int m = 1; m < PIX / 32; ++m) v += red[r][wl + 32 * m];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
        if (wl == 0) out[(size_t)(start + top - 1 - r / NF) * NF + r % NF] = v;
      }
      __syncthreads();  // red is rewritten by the next batch
    }
  }
}

// CTAs of `kernel` that fit on the card at once (cached per kernel).
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

// Scratch layout in 4-byte words: int4 work[items] (t, segment, first item
// of t, segments of t) | int tile_end[num_tiles] | int item count | float2
// summaries[items * 256], 8-byte aligned. items = P / SEG + num_tiles + 1
// bounds sum_t ceil(end_t / SEG), since the tiles' ranges hold at most P
// slots in all.
struct Layout {
  size_t items, summ, words;
};
Layout layout(int P, int num_tiles) {
  const size_t items = (size_t)P / SEG + num_tiles + 1;
  const size_t summ = (4 * items + num_tiles + 2) & ~(size_t)1;
  return {items, summ, summ + 2 * items * PIX};
}

}  // namespace

extern "C" int neuma_composite_bwd_scratch_words(int P, int num_tiles) {
  return (int)layout(P, num_tiles).words;
}

extern "C" int neuma_k5_seg() { return SEG; }

extern "C" int neuma_composite_bwd(const void* feats, const void* tile_start, const void* counts,
                                   int num_tiles, int tiles_x, const void* T, const void* last,
                                   const void* dT, const void* dC, void* out, void* scratch,
                                   int P, void* stream) {
  static int ctas_summaries = 0, ctas_gradients = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const float* f = static_cast<const float*>(feats);
  const int* ts = static_cast<const int*>(tile_start);
  const Layout lay = layout(P, num_tiles);
  const int max_items = (int)lay.items;
  int* ints = static_cast<int*>(scratch);
  int4* work = reinterpret_cast<int4*>(ints);
  int* tile_end = ints + 4 * lay.items;
  int* total = tile_end + num_tiles;
  float2* summ = reinterpret_cast<float2*>(ints + lay.summ);
  const float* lastp = static_cast<const float*>(last);
  const float* dCp = static_cast<const float*>(dC);

  k5_tile_end<<<(num_tiles + WARPS - 1) / WARPS, PIX, 0, s>>>(
      ts, static_cast<const int*>(counts), lastp, num_tiles, tile_end);
  k5_plan<<<1, PLAN_THREADS, 0, s>>>(tile_end, num_tiles, max_items, work, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int g1 = min(max_items, resident_ctas(k5_summaries, &ctas_summaries));
  k5_summaries<<<g1, PIX, 0, s>>>(f, ts, tile_end, work, total, tiles_x, lastp, dCp, summ);
  const int g2 = min(max_items, resident_ctas(k5_gradients, &ctas_gradients));
  k5_gradients<<<g2, PIX, 0, s>>>(f, ts, tile_end, work, total, tiles_x,
                                  static_cast<const float*>(T), lastp,
                                  static_cast<const float*>(dT), dCp, summ,
                                  static_cast<float*>(out));
  return (int)cudaGetLastError();
}
