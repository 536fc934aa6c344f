// K4: tile-composite forward for Hopper (sm_90a).
//
// Replaces neuma_tpu/render/pallas_raster.py::_fwd_kernel (launched by
// _composite_fwd_impl under composite_pairs_tpu).
//
// Per pixel the forward walks its tile's depth-sorted range front to back
// up to the tile's TRUE count (pad slots of the 32-aligned range are never
// read), with the guard `visit` of csrc/composite_common.cuh: skip unless
// power <= 0 and alpha = min(0.99, opacity exp(power)) >= 1/255 (a NaN
// fails); when T (1 - alpha) < 1e-4 the pixel stops and that pair does not
// count. Outputs T, the three colour planes channel-blocked (T, 3*256), and
// `last` = the last contributing pair index as a float, -1 where none.
//
// The design: the range [0, count_t) of tile t is cut into SEG-slot
// segments, each (tile, segment) one work item, so a long tile is spread
// over the card instead of walked on one SM. Three launches:
//   1. plan_segments (one CTA): the device-side work list and each tile's
//      first item; no host sync.
//   2. k4_summaries (persistent CTAs, one thread per pixel): per (item,
//      pixel), front to back over the segment's contributing slots, the
//      product P = prod (1 - alpha), the colour sums S_c = sum alpha
//      T_local rgb_c (T_local the product so far) and the segment's last
//      contributing slot. Pixel rows a staged pair cannot reach are skipped
//      (row_bounds: only pixels the guard rejects). A pixel whose P falls
//      below 1e-4 leaves the segment: it must stop there (T_front <= 1), and
//      launch 3 walks that segment again.
//   3. k4_combine (one CTA per tile, one thread per pixel): the tile's
//      segments in order, carrying T. Where T P is at least 1e-4 (1 +
//      1e-4), the segment is taken whole: C += T S, T *= P, `last` = its
//      last contributing slot. Otherwise the pixel walks that segment again
//      from T with the sequential stop test and stops there if it fires
//      (else it goes on). T is non-increasing along a walk, so the smallest
//      test value of a segment is its end value; the product forms of it
//      differ by <= ~130 roundings (< 1e-5 relative), inside the margin,
//      so every stop decision is made by a sequential walk as in the plain
//      version. Summaries are read four segments at a time. The walks
//      again run in rounds: the CTA stages the earliest segment a pixel
//      waits for in shared memory, and the pixels waiting for it walk it.
// T is then a product of segment products: another rounding of the same
// function, as the TPU kernel's chunked prefix products are (abs 2e-5 on T
// and C against the plain version, `last` equal). No atomics; every sum
// runs in a fixed order, so the result repeats bit for bit.
//
// Scratch: one buffer the wrapper allocates at the size
// neuma_composite_fwd_scratch_words gives (layout below).
#include "composite_common.cuh"

namespace {

constexpr float T_MIN = 1e-4f;
constexpr float T_ACCEPT = 1e-4f * (1.f + 1e-4f);  // take a segment whole at or above
constexpr int AHEAD = 4;  // summaries read per step of the combine
constexpr int NO_SEG = 0x7fffffff;

__global__ void __launch_bounds__(PIX, 4)
k4_summaries(const float* __restrict__ feats, const int* __restrict__ tile_start,
             const int* __restrict__ counts, const int4* __restrict__ work,
             const int* __restrict__ total, int tiles_x, float4* __restrict__ summ,
             int* __restrict__ slast) {
  __shared__ float sf[SEG * NF];
  __shared__ float2 sy[SEG];
  const int lane = threadIdx.x;
  const int n_items = *total;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const int4 wi = work[i];
    const int t = wi.x;
    const int lo = wi.y * SEG;
    const int cnt = min(counts[t] - lo, SEG);
    load_rows(sf, sy, feats, tile_start[t] + lo, cnt);
    const float px = pixel_x(t, tiles_x, lane), py = pixel_y(t, tiles_x, lane);
    float P = 1.f, s0 = 0.f, s1 = 0.f, s2 = 0.f;
    int sl = -1;
    for (int j = 0; j < cnt; ++j) {
      const float* f = sf + j * NF;
      const float2 yb = sy[j];
      float dx, dy, G, alpha;
      if (py >= yb.x && py <= yb.y && visit(f, px, py, dx, dy, G, alpha)) {
        const float w = __fmul_rn(alpha, P);
        s0 = __fadd_rn(s0, __fmul_rn(w, f[6]));
        s1 = __fadd_rn(s1, __fmul_rn(w, f[7]));
        s2 = __fadd_rn(s2, __fmul_rn(w, f[8]));
        P = __fmul_rn(P, __fsub_rn(1.f, alpha));
        sl = j;
        if (P < T_MIN) break;  // the pixel stops in this segment
      }
    }
    summ[(size_t)i * PIX + lane] = make_float4(P, s0, s1, s2);
    slast[(size_t)i * PIX + lane] = sl;
  }
}

__global__ void __launch_bounds__(PIX)
k4_combine(const float* __restrict__ feats, const int* __restrict__ tile_start,
           const int* __restrict__ counts, const int* __restrict__ tile_first, int tiles_x,
           const float4* __restrict__ summ, const int* __restrict__ slast,
           float* __restrict__ T_out, float* __restrict__ C_out, float* __restrict__ last_out) {
  __shared__ float sf[SEG * NF];
  __shared__ int wmin[WARPS];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = counts[t];
  float T = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, last = -1.f;
  if (n > 0) {  // the whole CTA
    const int start = tile_start[t];
    const int nseg = (n + SEG - 1) / SEG;
    const size_t first = (size_t)tile_first[t] * PIX + lane;
    const float px = pixel_x(t, tiles_x, lane), py = pixel_y(t, tiles_x, lane);
    int k = 0;              // the pixel's next segment
    int again = NO_SEG;     // the segment it waits to walk again
    bool finished = false;  // stopped, or past its last segment
    while (true) {
      // Take whole segments until one must be walked again.
      while (!finished && again == NO_SEG) {
        float4 s[AHEAD];
        int sl[AHEAD];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          if (k + u < nseg) {
            s[u] = summ[first + (size_t)(k + u) * PIX];
            sl[u] = slast[first + (size_t)(k + u) * PIX];
          }
        }
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          if (again == NO_SEG && k + u < nseg) {
            const float Tn = __fmul_rn(T, s[u].x);
            if (Tn >= T_ACCEPT) {
              c0 = __fadd_rn(c0, __fmul_rn(T, s[u].y));
              c1 = __fadd_rn(c1, __fmul_rn(T, s[u].z));
              c2 = __fadd_rn(c2, __fmul_rn(T, s[u].w));
              T = Tn;
              if (sl[u] >= 0) last = (float)(start + (k + u) * SEG + sl[u]);
            } else {
              again = k + u;
            }
          }
        }
        if (again == NO_SEG) {
          k += AHEAD;
          finished = k >= nseg;
        }
      }
      // The CTA stages the earliest segment any pixel waits for, and those
      // pixels walk it from their T with the sequential stop test.
      int m = __reduce_min_sync(FULL, again);
      if ((lane & 31) == 0) wmin[lane >> 5] = m;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < WARPS; ++w) m = min(m, wmin[w]);
      if (m == NO_SEG) break;
      const int lo = m * SEG;
      const int cnt = min(n - lo, SEG);
      const float* src = feats + (size_t)(start + lo) * NF;
      for (int i = lane; i < cnt * NF; i += PIX) sf[i] = src[i];
      __syncthreads();
      if (again == m) {
        bool stopped = false;
        for (int j = 0; j < cnt; ++j) {
          const float* f = sf + j * NF;
          float dx, dy, G, alpha;
          if (!visit(f, px, py, dx, dy, G, alpha)) continue;
          const float test_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
          if (test_T < T_MIN) {
            stopped = true;
            break;
          }
          const float w = __fmul_rn(alpha, T);
          c0 = __fadd_rn(c0, __fmul_rn(w, f[6]));
          c1 = __fadd_rn(c1, __fmul_rn(w, f[7]));
          c2 = __fadd_rn(c2, __fmul_rn(w, f[8]));
          T = test_T;
          last = (float)(start + lo + j);
        }
        again = NO_SEG;
        k = m + 1;
        finished = stopped || k >= nseg;
      }
      __syncthreads();  // sf and wmin are rewritten in the next round
    }
  }
  T_out[(size_t)t * PIX + lane] = T;
  C_out[(size_t)t * 3 * PIX + lane] = c0;
  C_out[(size_t)t * 3 * PIX + PIX + lane] = c1;
  C_out[(size_t)t * 3 * PIX + 2 * PIX + lane] = c2;
  last_out[(size_t)t * PIX + lane] = last;
}

// Scratch layout in 4-byte words: int4 work[items] (t, segment, first item
// of t, segments of t) | int item count | int tile_first[num_tiles] |
// float4 summaries[items * 256], 16-byte aligned | int last slot[items *
// 256]; items = items_bound(P, num_tiles).
struct Layout {
  size_t items, summ, slast, words;
};
Layout layout(int P, int num_tiles) {
  const size_t items = items_bound(P, num_tiles);
  const size_t summ = (4 * items + 1 + num_tiles + 3) & ~(size_t)3;
  const size_t slast = summ + 4 * items * PIX;
  return {items, summ, slast, slast + items * PIX};
}

}  // namespace

extern "C" int neuma_composite_fwd_scratch_words(int P, int num_tiles) {
  const size_t words = layout(P, num_tiles).words;
  return words > 0x7fffffff ? -1 : (int)words;
}

extern "C" int neuma_composite_seg() { return SEG; }

extern "C" int neuma_composite_fwd(const void* feats, const void* tile_start, const void* counts,
                                   int num_tiles, int tiles_x, void* T, void* C, void* last,
                                   void* scratch, int P, void* stream) {
  static int ctas_summaries = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const float* f = static_cast<const float*>(feats);
  const int* ts = static_cast<const int*>(tile_start);
  const int* cn = static_cast<const int*>(counts);
  const Layout lay = layout(P, num_tiles);
  const int max_items = (int)lay.items;
  int* ints = static_cast<int*>(scratch);
  int4* work = reinterpret_cast<int4*>(ints);
  int* total = ints + 4 * lay.items;
  int* tile_first = total + 1;
  float4* summ = reinterpret_cast<float4*>(ints + lay.summ);
  int* slast = ints + lay.slast;

  plan_segments<<<1, PLAN_THREADS, 0, s>>>(cn, num_tiles, max_items, work, total, tile_first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int g = min(max_items, resident_ctas(k4_summaries, &ctas_summaries));
  k4_summaries<<<g, PIX, 0, s>>>(f, ts, cn, work, total, tiles_x, summ, slast);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k4_combine<<<num_tiles, PIX, 0, s>>>(f, ts, cn, tile_first, tiles_x, summ, slast,
                                       static_cast<float*>(T), static_cast<float*>(C),
                                       static_cast<float*>(last));
  return (int)cudaGetLastError();
}
