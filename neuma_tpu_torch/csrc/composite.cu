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
//      segments in order, carrying T. Where T P is at least 1e-4 (1 + m),
//      the segment is taken whole: C += T S, T *= P, `last` = its last
//      contributing slot. Otherwise the pixel walks that segment again
//      from T with the sequential stop test and stops there if it fires
//      (else it goes on). Summaries are read four segments at a time. The
//      walks again run in rounds: the CTA stages the earliest segment a
//      pixel waits for in shared memory, and the pixels waiting for it
//      walk it.
// T is then a product of segment products: another rounding of the same
// function, as the TPU kernel's chunked prefix products are (abs 2e-5 on T
// and C against the plain version). The stop decisions are the plain
// version's, `last` equal: two float products of the same n factors differ
// by at most 2 n u relative (u = 2^-24; n counts the multiplies that formed
// T, each summary carrying its own count beside its last slot), so the
// margin m is the larger of 1e-4 and that bound (T is non-increasing along
// a walk, so a segment taken whole holds no stop), and a pixel whose stop
// test lies within the bound of 1e-4 is left for the plain version's own
// walk, which the CTA runs at its end for such pixels from the tile's
// first slot (their T, C and `last` are then the plain version's bits):
// the guards of a staged segment are evaluated in parallel, and only the
// multiply chain is serial. A deep view has a few such pixels; each tile's
// count of them is written to the scratch's tail, for the work statistics.
// No atomics; every sum runs in a fixed order, so the result repeats bit
// for bit.
//
// A launch may cover a range of a frame's tiles: tile_start and counts are
// the range's slices, num_tiles its length and tile_base its first tile in
// the frame (0 for a whole frame).
//
// Scratch: one buffer the wrapper allocates at the size
// neuma_composite_fwd_scratch_words gives (layout below).
#include "composite_common.cuh"

namespace {

constexpr float T_MIN = 1e-4f;
constexpr int AHEAD = 4;  // summaries read per step of the combine
constexpr int EXACT_GROUP = 4;  // pixels per group of the plain version's walk
constexpr int NO_SEG = 0x7fffffff;

// Relative gap bound of two float products of at most n factors each
// (one rounding per multiply): 2 n u with u = 2^-24, and some slack.
__device__ __forceinline__ float product_gap(int n) { return 1.2e-7f * (float)(n + 2); }

// A segment's last contributing slot (-1 for none) and its number of
// contributing slots (the multiplies in its product), in one int.
__device__ __forceinline__ int pack_last(int sl, int nc) { return (sl + 1) | (nc << 8); }
__device__ __forceinline__ int last_slot(int v) { return (v & 0xff) - 1; }
__device__ __forceinline__ int factors(int v) { return v >> 8; }

__global__ void __launch_bounds__(PIX, 4)
k4_summaries(const float* __restrict__ feats, const int* __restrict__ tile_start,
             const int* __restrict__ counts, const int4* __restrict__ work,
             const int* __restrict__ total, int tiles_x, int tile_base,
             float4* __restrict__ summ, int* __restrict__ slast) {
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
    const float px = pixel_x(t + tile_base, tiles_x, lane);
    const float py = pixel_y(t + tile_base, tiles_x, lane);
    float P = 1.f, s0 = 0.f, s1 = 0.f, s2 = 0.f;
    int sl = -1, nc = 0;
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
        ++nc;
        if (P < T_MIN) break;  // the pixel stops in this segment
      }
    }
    summ[(size_t)i * PIX + lane] = make_float4(P, s0, s1, s2);
    slast[(size_t)i * PIX + lane] = pack_last(sl, nc);
  }
}

__global__ void __launch_bounds__(PIX)
k4_combine(const float* __restrict__ feats, const int* __restrict__ tile_start,
           const int* __restrict__ counts, const int* __restrict__ tile_first, int tiles_x,
           int tile_base, const float4* __restrict__ summ, const int* __restrict__ slast,
           float* __restrict__ T_out, float* __restrict__ C_out, float* __restrict__ last_out,
           int* __restrict__ exact_out) {
  __shared__ float sf[SEG * NF];
  __shared__ int wmin[WARPS];
  __shared__ int exact_lane[PIX];
  __shared__ float q_exact[EXACT_GROUP * SEG], a_exact[EXACT_GROUP * SEG];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = counts[t];
  float T = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, last = -1.f;
  int n_exact = 0;  // the tile's pixels left for the plain version's walk
  if (n > 0) {  // the whole CTA
    const int start = tile_start[t];
    const int nseg = (n + SEG - 1) / SEG;
    const size_t first = (size_t)tile_first[t] * PIX + lane;
    const int tp = t + tile_base;  // the tile's index in the frame
    const float px = pixel_x(tp, tiles_x, lane), py = pixel_y(tp, tiles_x, lane);
    int k = 0;              // the pixel's next segment
    int again = NO_SEG;     // the segment it waits to walk again
    bool finished = false;  // stopped, or past its last segment
    bool exact = false;     // left for the plain version's walk below
    int nf = 0;             // multiplies that formed T
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
            const int nf_after = nf + factors(sl[u]) + 1;
            if (Tn >= T_MIN * (1.f + fmaxf(1e-4f, product_gap(nf_after)))) {
              c0 = __fadd_rn(c0, __fmul_rn(T, s[u].y));
              c1 = __fadd_rn(c1, __fmul_rn(T, s[u].z));
              c2 = __fadd_rn(c2, __fmul_rn(T, s[u].w));
              T = Tn;
              nf = nf_after;
              if (last_slot(sl[u]) >= 0) last = (float)(start + (k + u) * SEG + last_slot(sl[u]));
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
          if (fabsf(__fsub_rn(test_T, T_MIN)) <= T_MIN * product_gap(nf + 1)) {
            exact = true;  // within rounding of 1e-4: the plain version's walk decides
            stopped = true;
            break;
          }
          if (test_T < T_MIN) {
            stopped = true;
            break;
          }
          const float w = __fmul_rn(alpha, T);
          c0 = __fadd_rn(c0, __fmul_rn(w, f[6]));
          c1 = __fadd_rn(c1, __fmul_rn(w, f[7]));
          c2 = __fadd_rn(c2, __fmul_rn(w, f[8]));
          T = test_T;
          ++nf;
          last = (float)(start + lo + j);
        }
        again = NO_SEG;
        k = m + 1;
        finished = stopped || k >= nseg;
      }
      __syncthreads();  // sf and wmin are rewritten in the next round
    }
    // The pixels left for it walk the tile as the plain version does, from
    // its first slot with T = 1, EXACT_GROUP pixels at a time: per staged
    // segment the CTA evaluates their guards for every slot in parallel,
    // then each pixel's own thread runs the multiply chain over them.
    if (__syncthreads_or(exact)) {
      if (exact) {
        T = 1.f;
        c0 = c1 = c2 = 0.f;
        last = -1.f;
      }
      const unsigned ballot = __ballot_sync(FULL, exact);
      if ((lane & 31) == 0) wmin[lane >> 5] = __popc(ballot);
      __syncthreads();
      int rank = __popc(ballot & ((1u << (lane & 31)) - 1u));
      for (int w = 0; w < WARPS; ++w) {
        rank += w < (lane >> 5) ? wmin[w] : 0;
        n_exact += wmin[w];
      }
      if (exact) exact_lane[rank] = lane;
      __syncthreads();
      for (int g0 = 0; g0 < n_exact; g0 += EXACT_GROUP) {
        const int ng = min(EXACT_GROUP, n_exact - g0);
        const int mine = exact && rank >= g0 && rank < g0 + ng ? rank - g0 : -1;
        bool done = mine < 0;
        for (int lo = 0; lo < n && __syncthreads_or(!done); lo += SEG) {
          const int cnt = min(n - lo, SEG);
          const float* src = feats + (size_t)(start + lo) * NF;
          for (int i = lane; i < cnt * NF; i += PIX) sf[i] = src[i];
          __syncthreads();
          for (int i = lane; i < ng * cnt; i += PIX) {
            const int e = exact_lane[g0 + i / cnt], j = i % cnt;
            float dx, dy, G, alpha;
            const bool v = visit(sf + j * NF, pixel_x(tp, tiles_x, e), pixel_y(tp, tiles_x, e),
                                 dx, dy, G, alpha);
            q_exact[(i / cnt) * SEG + j] = v ? __fsub_rn(1.f, alpha) : -1.f;  // -1: skipped
            a_exact[(i / cnt) * SEG + j] = alpha;
          }
          __syncthreads();
          for (int j = 0; j < cnt && !done; ++j) {
            const float q = q_exact[mine * SEG + j];
            if (q < 0.f) continue;
            const float test_T = __fmul_rn(T, q);
            if (test_T < T_MIN) {
              done = true;
              break;
            }
            const float* f = sf + j * NF;
            const float w = __fmul_rn(a_exact[mine * SEG + j], T);
            c0 = __fadd_rn(c0, __fmul_rn(w, f[6]));
            c1 = __fadd_rn(c1, __fmul_rn(w, f[7]));
            c2 = __fadd_rn(c2, __fmul_rn(w, f[8]));
            T = test_T;
            last = (float)(start + lo + j);
          }
          __syncthreads();  // sf and the guard values are rewritten in the next round
        }
      }
    }
  }
  T_out[(size_t)t * PIX + lane] = T;
  C_out[(size_t)t * 3 * PIX + lane] = c0;
  C_out[(size_t)t * 3 * PIX + PIX + lane] = c1;
  C_out[(size_t)t * 3 * PIX + 2 * PIX + lane] = c2;
  last_out[(size_t)t * PIX + lane] = last;
  if (lane == 0) exact_out[t] = n_exact;
}

// Scratch layout in 4-byte words: int4 work[items] (t, segment, first item
// of t, segments of t) | int item count | int tile_first[num_tiles] |
// float4 summaries[items * 256], 16-byte aligned | int last slot[items *
// 256] | int exact-walk pixels[num_tiles]; items = items_bound(P, num_tiles).
struct Layout {
  size_t items, summ, slast, exact, words;
};
Layout layout(int P, int num_tiles) {
  const size_t items = items_bound(P, num_tiles);
  const size_t summ = (4 * items + 1 + num_tiles + 3) & ~(size_t)3;
  const size_t slast = summ + 4 * items * PIX;
  const size_t exact = slast + items * PIX;
  return {items, summ, slast, exact, exact + num_tiles};
}

}  // namespace

extern "C" int neuma_composite_fwd_scratch_words(int P, int num_tiles) {
  const size_t words = layout(P, num_tiles).words;
  return words > 0x7fffffff ? -1 : (int)words;
}

extern "C" int neuma_composite_seg() { return SEG; }

extern "C" int neuma_composite_fwd(const void* feats, const void* tile_start, const void* counts,
                                   int num_tiles, int tiles_x, int tile_base, void* T, void* C,
                                   void* last, void* scratch, int P, void* stream) {
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
  k4_summaries<<<g, PIX, 0, s>>>(f, ts, cn, work, total, tiles_x, tile_base, summ, slast);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k4_combine<<<num_tiles, PIX, 0, s>>>(f, ts, cn, tile_first, tiles_x, tile_base, summ, slast,
                                       static_cast<float*>(T), static_cast<float*>(C),
                                       static_cast<float*>(last), ints + lay.exact);
  return (int)cudaGetLastError();
}
