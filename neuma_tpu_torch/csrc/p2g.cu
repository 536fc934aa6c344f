// K1: blocked APIC particle-to-grid scatter for Hopper (sm_90a).
//
// Replaces neuma_tpu/sim/p2g_kernel.py::_p2g_fwd_kernel (launched by
// run_p2g_fwd) and the chunk -> block `.at[c2b].add` that follows it in
// p2g_slab_scatter.
//
// Input: the padded payload (M*128, 48) of block-sorted particles (column
// layout in neuma_tpu_torch/sim/p2g_kernel.py) and c2b (M,), the
// non-decreasing block id of each 128-row chunk. Output: per-block sums
// (NB, 4, 16, 256) = channels (momentum xyz, mass) x 16 x lines x 256
// (y, z) lanes. Full FP32: the TPU's bf16 "high3" splits are a TPU
// workaround and are not kept.
//
// The design: one CTA of 256 threads per chunk, clusters of 8 CTAs.
//  1. The chunk's rows are staged in shared memory. Its 1,152 (particle,
//     y tap, z tap) entries are binned by destination (y, z) lane with a
//     deterministic counting sort: warp w takes entries [144 w, 144 w + 144)
//     in order; __match_any_sync/__popc rank an entry among the warp's
//     earlier entries of its lane; per-warp lane counts are scanned
//     (warps in order, then lanes) into each entry's position. Entries
//     whose y/z weight product is 0 (pad rows) or whose y or z line lies
//     outside [0, 16) (a tap outside a grid view) are dropped. Each entry is
//     stored with its 7 lane values: v_c = yz b_eff_c + yz_i a_c1 + yz_k a_c2,
//     v0_c = yz a_c0 and gm yz.
//  2. The entries of a lane are walked in (particle, y tap, z tap) order,
//     adding w_x v_c + k w_x v0_c and w_x gm yz for each x tap k into an
//     accumulator column of a 64 KB shared array indexed by the tap's x
//     line (taps clipped onto one line are merged first, so the three lines
//     are distinct and each entry loads its 12 sums before storing any). A
//     lane with many entries -- under a chunk whose particles fill a few
//     (y, z) columns -- gets several threads, each walking a contiguous part
//     of its list into its own column; the parts are then summed in order.
//  3. Chunk -> block: the cluster's CTAs sum their accumulators through
//     distributed shared memory, each CTA one eighth of the 16,384 elements,
//     one run of equal c2b at a time, in chunk order. A run that holds its
//     block's whole chunk range is written to the output; a run cut by the
//     cluster's edge goes to a partial slot (0: the cluster's first run,
//     1: its last). A second launch sums, for each block whose chunks span
//     clusters, its partials in cluster order, and zeroes blocks with no
//     chunk; it finds a block's chunk range in block_first, a table the
//     chunk kernel writes (each entry once).
// No float atomics anywhere and every sum runs in a fixed order, so the
// result repeats bit for bit run to run.
//
// What bounds it now (H100, device time, PERF.md): ~21 us at the headline
// shape and ~34 us at the realworld one against a 1.3 / 5.1 us byte bound.
// Each CTA spends ~15-17 us in nine barrier-separated steps of ~1-4 us each
// (staging, the two passes of the sort, the walk, the part sums, the cluster
// reduction), and the realworld scatter's 360 chunks run as two waves at two
// CTAs per SM (104 KB of shared memory each): latency, not bytes or FLOPs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int S = 16;
constexpr int S2 = S * S;
constexpr int CHUNK = 128;
constexpr int COLS = 48;
constexpr int W0 = 0, L0 = 9, BE0 = 18, AC0 = 21, GM = 30;
constexpr int BLOCK_ELEMS = 4 * S * S2;  // 16384 floats per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ENTRIES = CHUNK * 9;  // (particle, y tap, z tap)
constexpr int PER_WARP = ENTRIES / WARPS;  // 144
constexpr int CLUSTER = 8;
constexpr int NV = 7;  // values per entry: v (3), v0 (3), gm yz
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory, in bytes. The accumulator region first holds the
// staged rows, the per-warp lane counts and the entry ranks.
constexpr int OFF_ACC = 0;                                   // float[BLOCK_ELEMS]
constexpr int OFF_ROWS = 0;                                  // float[CHUNK * COLS]
constexpr int OFF_WCNT = OFF_ROWS + CHUNK * COLS * 4;        // int[WARPS * S2]
constexpr int OFF_RANK = OFF_WCNT + WARPS * S2 * 4;          // ushort[ENTRIES]
constexpr int OFF_EV = BLOCK_ELEMS * 4;                      // float[NV * ENTRIES]
constexpr int OFF_EP = OFF_EV + NV * ENTRIES * 4;            // ushort[ENTRIES]
constexpr int OFF_XW = OFF_EP + ENTRIES * 2;                 // float[CHUNK * 3]
constexpr int OFF_XWI = OFF_XW + CHUNK * 3 * 4;              // float[CHUNK * 3]
constexpr int OFF_XL = OFF_XWI + CHUNK * 3 * 4;              // int[CHUNK * 3]
constexpr int OFF_LOFF = OFF_XL + CHUNK * 3 * 4;             // int[S2 + 1]
constexpr int OFF_WSUM = OFF_LOFF + (S2 + 1) * 4;            // int[WARPS]
constexpr int OFF_OWNER = OFF_WSUM + WARPS * 4;              // int[THREADS]: lane of thread
constexpr int OFF_PART = OFF_OWNER + THREADS * 4;            // int[THREADS]: its part
constexpr int OFF_NPART = OFF_PART + THREADS * 4;            // int[S2]: parts of a lane
constexpr int OFF_COL = OFF_NPART + S2 * 4;                  // int[S2]: lane -> column
constexpr int OFF_MULTI = OFF_COL + S2 * 4;                 // int[S2]: lanes with >= 2 parts
constexpr int SMEM_BYTES = OFF_MULTI + S2 * 4;
static_assert(OFF_RANK + ENTRIES * 2 <= BLOCK_ELEMS * 4, "sort scratch must fit the accumulator");
static_assert(OFF_EV % 16 == 0 && OFF_XW % 4 == 0, "alignment");
constexpr int SUM_SPLIT = 16;  // CTAs per block in the second launch
constexpr int SUM_PER_THREAD = BLOCK_ELEMS / SUM_SPLIT / THREADS;  // 4

// Entry e of the chunk: its lane (y * 16 + z), or -1 when its weight is 0
// or its y or z line lies outside [0, 16) (a tap outside a grid view).
__device__ __forceinline__ int entry_key(const float* rows, int e, float& wy, float& wz) {
  const int p = e / 9, ky = (e % 9) / 3, kz = e % 3;
  const float* r = rows + p * COLS;
  wy = r[W0 + 3 + ky];
  wz = r[W0 + 6 + kz];
  if (wy * wz == 0.f) return -1;
  const int ly = (int)r[L0 + 3 + ky], lz = (int)r[L0 + 6 + kz];
  if ((unsigned)ly >= (unsigned)S || (unsigned)lz >= (unsigned)S) return -1;
  return ly * S + lz;
}

// A line in [0, 3) other than a and b.
__device__ __forceinline__ int free_line(int a, int b) {
  return (a != 0 && b != 0) ? 0 : ((a != 1 && b != 1) ? 1 : 2);
}

struct Entry {
  int l[3];
  float w[3], wi[3], v[NV];
};

__device__ __forceinline__ Entry fetch(const float* ev, const unsigned short* ep, const float* xw,
                                       const float* xwi, const int* xl, int q) {
  Entry x;
  const int p = ep[q];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x.l[k] = xl[p * 3 + k];
    x.w[k] = xw[p * 3 + k];
    x.wi[k] = xwi[p * 3 + k];
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) x.v[j] = ev[j * ENTRIES + q];
  return x;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 2)
p2g_chunk_kernel(const float* __restrict__ payload, const int* __restrict__ c2b, int M, int NB,
                 float* __restrict__ partials, int* __restrict__ block_first,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem + OFF_ACC);
  float* rows = reinterpret_cast<float*>(smem + OFF_ROWS);
  int* wcnt = reinterpret_cast<int*>(smem + OFF_WCNT);
  unsigned short* rank = reinterpret_cast<unsigned short*>(smem + OFF_RANK);
  float* ev = reinterpret_cast<float*>(smem + OFF_EV);
  unsigned short* ep = reinterpret_cast<unsigned short*>(smem + OFF_EP);
  float* xw = reinterpret_cast<float*>(smem + OFF_XW);
  float* xwi = reinterpret_cast<float*>(smem + OFF_XWI);
  int* xl = reinterpret_cast<int*>(smem + OFF_XL);
  int* loff = reinterpret_cast<int*>(smem + OFF_LOFF);
  int* wsum = reinterpret_cast<int*>(smem + OFF_WSUM);
  int* owner = reinterpret_cast<int*>(smem + OFF_OWNER);
  int* part = reinterpret_cast<int*>(smem + OFF_PART);
  int* npart = reinterpret_cast<int*>(smem + OFF_NPART);
  int* col_of = reinterpret_cast<int*>(smem + OFF_COL);
  int* multi = reinterpret_cast<int*>(smem + OFF_MULTI);

  cg::cluster_group cluster = cg::this_cluster();
  const int m = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  if (m < M) {  // the last cluster's spare CTAs only help with the sums
    // block_first[b] = first chunk with c2b >= b, for b in [0, NB]: chunk m
    // writes the blocks in (c2b[m - 1], c2b[m]], the last chunk also those
    // past c2b[M - 1]; each entry is written once.
    const int prev = m ? c2b[m - 1] : -1;
    const int hi = m == M - 1 ? NB : c2b[m];
    for (int b = prev + 1 + t; b <= hi; b += THREADS) block_first[b] = b <= c2b[m] ? m : M;

    // 1. stage rows, clear the counts
    const float4* src = reinterpret_cast<const float4*>(payload + (size_t)m * CHUNK * COLS);
    float4* dst = reinterpret_cast<float4*>(rows);
    for (int i = t; i < CHUNK * COLS / 4; i += THREADS) dst[i] = src[i];
    for (int i = t; i < WARPS * S2; i += THREADS) wcnt[i] = 0;
    __syncthreads();
    // x taps per particle; taps on one line (clipped at the domain face) are
    // merged into the first, and a merged-away tap moves to a free line with
    // zero weight, so the walk's three taps always hit three distinct lines.
    // A line outside [0, 16) (a tap outside a grid view, line -1) stays as it
    // is: the walk skips it, and the in-range lines stay distinct.
    for (int p = t; p < CHUNK; p += THREADS) {
      int l[3];
      float w[3], wi[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        l[k] = (int)rows[p * COLS + L0 + k];
        w[k] = rows[p * COLS + W0 + k];
        wi[k] = (float)k * w[k];
      }
      bool gone1 = false, gone2 = false;
      if (l[1] == l[0]) { w[0] += w[1]; wi[0] += wi[1]; gone1 = true; }
      if (l[2] == l[0]) { w[0] += w[2]; wi[0] += wi[2]; gone2 = true; }
      else if (!gone1 && l[2] == l[1]) { w[1] += w[2]; wi[1] += wi[2]; gone2 = true; }
      if (gone1) { w[1] = wi[1] = 0.f; l[1] = free_line(l[0], l[2]); }
      if (gone2) { w[2] = wi[2] = 0.f; l[2] = free_line(l[0], l[1]); }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        xl[p * 3 + k] = l[k];
        xw[p * 3 + k] = w[k];
        xwi[p * 3 + k] = wi[k];
      }
    }

    // 2. rank each entry among its warp's earlier entries of the same lane
    const unsigned lt = (1u << lane) - 1u;
    for (int i0 = 0; i0 < PER_WARP; i0 += 32) {  // rounds in entry order
      const int i = i0 + lane;
      const int e = warp * PER_WARP + i;
      float wy, wz;
      const int key = i < PER_WARP ? entry_key(rows, e, wy, wz) : -1;
      const unsigned peers = __match_any_sync(FULL, key);
      int base = 0;
      if (key >= 0) {
        base = wcnt[warp * S2 + key];
        rank[e] = (unsigned short)(base + __popc(peers & lt));
      }
      __syncwarp();
      if (key >= 0 && lane == __ffs(peers) - 1) wcnt[warp * S2 + key] = base + __popc(peers);
      __syncwarp();
    }
    __syncthreads();

    // 3. lane offsets: warps in order within a lane, then lanes in order
    int run = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcnt[w * S2 + t];
      wcnt[w * S2 + t] = run;
      run += c;
    }
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int first = incl - run;
    for (int w = 0; w < warp; ++w) first += wsum[w];
    loff[t] = first;
    if (t == THREADS - 1) loff[S2] = first + run;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) wcnt[w * S2 + t] += first;
    __syncthreads();

    // 4. place each entry with its lane values
    for (int i = lane; i < PER_WARP; i += 32) {
      const int e = warp * PER_WARP + i;
      float wy, wz;
      const int key = entry_key(rows, e, wy, wz);
      if (key < 0) continue;
      const int pos = wcnt[warp * S2 + key] + rank[e];
      const int p = e / 9, ky = (e % 9) / 3, kz = e % 3;
      const float* r = rows + p * COLS;
      const float yz = wy * wz;
      const float yz_i = ((float)ky * wy) * wz;
      const float yz_k = wy * ((float)kz * wz);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ev[c * ENTRIES + pos] = yz * r[BE0 + c] + yz_i * r[AC0 + 3 * c + 1] + yz_k * r[AC0 + 3 * c + 2];
        ev[(3 + c) * ENTRIES + pos] = yz * r[AC0 + 3 * c];
      }
      ev[6 * ENTRIES + pos] = r[GM] * yz;
      ep[pos] = (unsigned short)p;
    }
    __syncthreads();  // rows, counts and ranks are dead: the region becomes acc

    // 5. spread each lane's entries over threads: lane L gets
    // ceil(n_L / target) consecutive threads (target chosen so that at most
    // 256 are needed), each walking a contiguous part of the lane's list
    // into its own accumulator column. A lane under a concentrated chunk
    // then no longer walks 128 entries alone.
    const int n_all = loff[S2];
    const int n_own = loff[t + 1] - loff[t];
    const int spare = THREADS - __syncthreads_count(n_own > 0);
    const int target = spare > 0 ? max(1, (n_all + spare - 1) / spare) : ENTRIES;
    const int parts = (n_own + target - 1) / target;
    owner[t] = -1;
    npart[t] = parts;
    // one scan of (parts, lane has >= 2 parts), packed 16 + 16 bits
    const int packed = parts | ((parts >= 2) << 16);
    int pincl = packed;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, pincl, o);
      if (lane >= o) pincl += v;
    }
    if (lane == 31) wsum[warp] = pincl;
    __syncthreads();
    int before = pincl - packed, all = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before += wsum[w];
      all += wsum[w];
    }
    const int first_col = before & 0xffff, n_multi = all >> 16;
    col_of[t] = parts ? first_col : -1;
    if (parts >= 2) multi[before >> 16] = t;
    for (int j = 0; j < parts; ++j) {
      owner[first_col + j] = t;
      part[first_col + j] = j;
    }
    __syncthreads();

    // 6. thread t walks its part into column t. The three taps' lines are
    // distinct, so each entry loads its 12 sums before it stores any; the
    // next entry's operands are fetched meanwhile.
#pragma unroll 16
    for (int i = 0; i < 4 * S; ++i) acc[i * S2 + t] = 0.f;
    const int L = owner[t];
    if (L >= 0) {
      const int n_l = loff[L + 1] - loff[L], k_l = npart[L], j = part[t];
      int q = loff[L] + j * n_l / k_l;
      const int q1 = loff[L] + (j + 1) * n_l / k_l;
      if (q < q1) {
        Entry cur = fetch(ev, ep, xw, xwi, xl, q);
        for (; q < q1; ++q) {
          // an x tap on a line outside [0, 16) (outside a grid view) adds nothing
          bool in[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) in[k] = (unsigned)cur.l[k] < (unsigned)S;
          float o[3][4];
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c) o[k][c] = in[k] ? acc[(c * S + cur.l[k]) * S2 + t] : 0.f;
          const Entry nxt = fetch(ev, ep, xw, xwi, xl, q + 1 < q1 ? q + 1 : q);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
#pragma unroll
            for (int c = 0; c < 3; ++c) o[k][c] += cur.w[k] * cur.v[c] + cur.wi[k] * cur.v[3 + c];
            o[k][3] += cur.w[k] * cur.v[6];
          }
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (in[k]) acc[(c * S + cur.l[k]) * S2 + t] = o[k][c];
          cur = nxt;
        }
      }
    }
    __syncthreads();

    // 7. a lane's parts are summed in part order into its first column,
    // one (lane, element) per thread at a time; neighbouring threads take
    // different lanes, whose columns lie in different banks
    for (int i = t; i < n_multi * 4 * S; i += THREADS) {
      const int Lm = multi[i % n_multi], e = i / n_multi;
      const int c = col_of[Lm], k_l = npart[Lm];
      float sum = acc[e * S2 + c];
      for (int jj = 1; jj < k_l; ++jj) sum += acc[e * S2 + c + jj];
      acc[e * S2 + c] = sum;
    }
  }

  // 8. chunk -> block through the cluster's shared memory: lane t's sums
  // sit in column col_of[t] of each CTA (none where the lane got no entry)
  cluster.sync();
  const int r = (int)cluster.block_rank();
  const int m0 = m - r;
  const int n_here = min(CLUSTER, M - m0);
  const int k = m0 / CLUSTER;
  constexpr int PER = BLOCK_ELEMS / CLUSTER / THREADS;  // 8
  for (int a = 0; a < n_here;) {
    const int b = c2b[m0 + a];
    int a2 = a + 1;
    while (a2 < n_here && c2b[m0 + a2] == b) ++a2;
    const bool whole = (m0 + a == 0 || c2b[m0 + a - 1] != b) && (m0 + a2 == M || c2b[m0 + a2] != b);
    float* dst = whole ? out + (size_t)b * BLOCK_ELEMS
                       : partials + ((size_t)k * 2 + (a == 0 ? 0 : 1)) * BLOCK_ELEMS;
    const int row0 = r * PER;  // rows (channel, x line) of this CTA's eighth
    float sum[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) sum[i] = 0.f;
    int cols[CLUSTER];
#pragma unroll
    for (int j = 0; j < CLUSTER; ++j)
      cols[j] = (j >= a && j < a2) ? cluster.map_shared_rank(col_of, j)[t] : -1;
#pragma unroll
    for (int j = 0; j < CLUSTER; ++j) {
      if (cols[j] < 0) continue;
      const float* src = cluster.map_shared_rank(acc, j);
#pragma unroll
      for (int i = 0; i < PER; ++i) sum[i] += src[(row0 + i) * S2 + cols[j]];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) dst[(row0 + i) * S2 + t] = sum[i];
    a = a2;
  }
  cluster.sync();  // keep each accumulator alive until the cluster has read it
}

// grid (NB, SUM_SPLIT): blocks whose chunks span clusters sum their
// partials in cluster order; blocks with no chunk are zero; blocks whose
// chunks lie in one cluster were written whole by the chunk kernel.
__global__ void __launch_bounds__(THREADS)
p2g_block_sum_kernel(const float* __restrict__ partials, const int* __restrict__ block_first,
                     float* __restrict__ out) {
  const int b = blockIdx.x;
  const int r0 = block_first[b], r1 = block_first[b + 1];
  const int e0 = blockIdx.y * (BLOCK_ELEMS / SUM_SPLIT) + threadIdx.x;
  float* dst = out + (size_t)b * BLOCK_ELEMS + e0;
  if (r0 == r1) {
#pragma unroll
    for (int i = 0; i < SUM_PER_THREAD; ++i) dst[i * THREADS] = 0.f;
    return;
  }
  const int k0 = r0 / CLUSTER, k1 = (r1 - 1) / CLUSTER;
  if (k0 == k1) return;
  const float* src = partials + ((size_t)k0 * 2 + (r0 == k0 * CLUSTER ? 0 : 1)) * BLOCK_ELEMS + e0;
  float sum[SUM_PER_THREAD];
#pragma unroll
  for (int i = 0; i < SUM_PER_THREAD; ++i) sum[i] = src[i * THREADS];
#pragma unroll 4
  for (int kk = k0 + 1; kk <= k1; ++kk) {
    const float* p = partials + (size_t)kk * 2 * BLOCK_ELEMS + e0;
#pragma unroll
    for (int i = 0; i < SUM_PER_THREAD; ++i) sum[i] += p[i * THREADS];
  }
#pragma unroll
  for (int i = 0; i < SUM_PER_THREAD; ++i) dst[i * THREADS] = sum[i];
}

// Scratch layout in 4-byte words: float partials[2 * ceil(M / CLUSTER)]
// [BLOCK_ELEMS] (two per cluster: its first and its last run) | int
// block_first[NB + 1].
size_t partial_words(int M) { return (size_t)2 * ((M + CLUSTER - 1) / CLUSTER) * BLOCK_ELEMS; }

}  // namespace

extern "C" int neuma_p2g_scratch_words(int M, int NB) { return (int)(partial_words(M) + NB + 1); }

extern "C" int neuma_p2g_fwd(const void* payload, const void* c2b, int M, int NB, void* scratch,
                             void* out, void* stream) {
  static bool smem_set = false;
  float* partials = static_cast<float*>(scratch);
  int* block_first = reinterpret_cast<int*>(partials + partial_words(M));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(p2g_chunk_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int grid = (M + CLUSTER - 1) / CLUSTER * CLUSTER;
  p2g_chunk_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const float*>(payload), static_cast<const int*>(c2b), M, NB,
      partials, block_first, static_cast<float*>(out));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  p2g_block_sum_kernel<<<dim3(NB, SUM_SPLIT), THREADS, 0, s>>>(partials, block_first,
                                                               static_cast<float*>(out));
  return (int)cudaGetLastError();
}
