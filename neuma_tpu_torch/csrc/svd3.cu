// K6: batched signed 3x3 SVD; K7: its closed-form adjoint (sm_90a).
//
// Replaces no pl.pallas_call: the JAX package's SVD (neuma_tpu/ops/svd3.py,
// svd3c and _svd3c_bwd) is jnp code that XLA fuses into a few loops. Eager
// PyTorch dispatched the port's copy of it (neuma_tpu_torch/ops/svd3.py,
// _svd3_core on nine (N,) component tensors) as ~1,480 elementwise launches
// a forward and ~430 an adjoint, which the material layer paid several times
// per substep with the card idle. Here each is one launch.
//
// K6 runs exactly what _svd3_core runs, in the same order, for one matrix
// per thread with every component in registers: 6 one-sided Jacobi sweeps
// over the column pairs (0,1), (0,2), (1,2) (identity rotation unless
// gamma^2 > 1e-14 alpha beta + 1e-38), the (0,1)(1,2)(0,1) sort network by
// sigma, descending, U's columns normalized with the 1e-30 clamp and the
// cross-product fallback when sigma[2] < 1e-8, and the det(U) > 0, det(V) > 0
// flips folded into sigma[2]. K7 is _svd3c_bwd: U^T dU, V^T dV, the
// F_ij = sign(diff) / max(|diff|, 1e-10) weights and dA = U inner Vh.
//
// Rounding: every operation is one correctly rounded float op, as each
// eager PyTorch op is: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn are never contracted into FMAs, and the source is built without
// fast math or flush-to-zero, so 1e-38 (a denormal) stays one. x ** 2 is
// x * x in PyTorch, 1.0 / x is reciprocal(x) * 1.0, and Python's sum()
// starts from 0 (so -0 + 0 = +0); the code below repeats each of these, and
// the factors agree bit for bit with the component path on the card.
//
// Layout: K6 reads the nine components where they stand (one pointer and
// one element stride each: the strided views of an (N, 9) buffer that
// unpack33 makes, separate tensors or an expanded one) and writes one
// (21, N) buffer: rows 0-8 u9 (U[r,c] at 3r+c), 9-11 sigma, 12-20 vh9. K7
// reads that buffer and 21 cotangents (a null pointer counts as zero) and
// writes (9, N) dA9.
//
// What bounds it (H100): per matrix 36 B in and 84 B out for K6, 84 + up to
// 84 B in and 36 B out for K7, and ~1,350 / ~430 float ops. At the main
// path's N = 30,000 that is ~3.6 MB and ~40 MFLOP a K6 launch: ~1 us of HBM
// traffic, so a launch's own cost (a few us) is the floor. The Jacobi's
// dependent chain of divisions and square roots sets each thread's latency;
// 128 threads a block give 235 blocks at N = 30,000, about two per SM.
// No atomics, no shared memory: the result repeats bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int SWEEPS = 6;

struct Cols9 {
  const float* p[9];
  long long s[9];
};

struct Cots21 {
  const float* p[21];
  long long s[21];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
// torch.sign: 0 for 0 and NaN
__device__ __forceinline__ float sgn(float a) { return (float)((0.f < a) - (a < 0.f)); }
// torch.clamp(x, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float a, float lo) { return a < lo ? lo : a; }
// 1.0 / x in PyTorch: reciprocal(x) * 1.0
__device__ __forceinline__ float recip(float a) { return dvd(1.f, a); }

// det of a column-major 3x3 m[c][r], in _svd3_core's det3 order
__device__ __forceinline__ float det3(float m[3][3]) {
  const float a = mul(m[0][0], sub(mul(m[1][1], m[2][2]), mul(m[1][2], m[2][1])));
  const float b = mul(m[1][0], sub(mul(m[0][1], m[2][2]), mul(m[0][2], m[2][1])));
  const float c = mul(m[2][0], sub(mul(m[0][1], m[1][2]), mul(m[0][2], m[1][1])));
  return add(sub(a, b), c);
}

__device__ __forceinline__ float norm3(const float x[3]) {
  return root(add(add(mul(x[0], x[0]), mul(x[1], x[1])), mul(x[2], x[2])));
}

__device__ __forceinline__ void rotate(float b[3][3], float v[3][3], int p, int q) {
  const float alpha = add(add(mul(b[p][0], b[p][0]), mul(b[p][1], b[p][1])), mul(b[p][2], b[p][2]));
  const float beta = add(add(mul(b[q][0], b[q][0]), mul(b[q][1], b[q][1])), mul(b[q][2], b[q][2]));
  const float gamma = add(add(mul(b[p][0], b[q][0]), mul(b[p][1], b[q][1])), mul(b[p][2], b[q][2]));
  const bool ok = mul(gamma, gamma) > add(mul(mul((float)1e-14, alpha), beta), (float)1e-38);
  float t = 0.f;
  if (ok) {
    const float zeta = dvd(sub(beta, alpha), mul(2.f, gamma));
    t = dvd(sgn(zeta), add(fabsf(zeta), root(add(mul(zeta, zeta), 1.f))));
  }
  const float c = recip(root(add(mul(t, t), 1.f)));
  const float s = mul(c, t);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float bp = b[p][r], bq = b[q][r];
    b[p][r] = sub(mul(c, bp), mul(s, bq));
    b[q][r] = add(mul(s, bp), mul(c, bq));
    const float vp = v[p][r], vq = v[q][r];
    v[p][r] = sub(mul(c, vp), mul(s, vq));
    v[q][r] = add(mul(s, vp), mul(c, vq));
  }
}

__device__ __forceinline__ void swap_if(bool sw, float& x, float& y) {
  const float a = x, b = y;
  x = sw ? b : a;
  y = sw ? a : b;
}

__device__ __forceinline__ void cswap(float sig[3], float b[3][3], float v[3][3], int i, int j) {
  const bool sw = sig[i] < sig[j];
  swap_if(sw, sig[i], sig[j]);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    swap_if(sw, b[i][r], b[j][r]);
    swap_if(sw, v[i][r], v[j][r]);
  }
}

__global__ void __launch_bounds__(THREADS)
svd3_fwd_kernel(Cols9 a, int n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  // b[c][r] = A[r, c]: column-major, as _svd3_core's component lists
  float b[3][3], v[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c][r] = a.p[3 * r + c][i * a.s[3 * r + c]];
      v[c][r] = r == c ? 1.f : 0.f;
    }
  }
#pragma unroll 1
  for (int sweep = 0; sweep < SWEEPS; ++sweep) {
    rotate(b, v, 0, 1);
    rotate(b, v, 0, 2);
    rotate(b, v, 1, 2);
  }
  float sig[3] = {norm3(b[0]), norm3(b[1]), norm3(b[2])};
  cswap(sig, b, v, 0, 1);
  cswap(sig, b, v, 1, 2);
  cswap(sig, b, v, 0, 1);

  float u[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float inv = recip(clamp_min(sig[c], (float)1e-30));
#pragma unroll
    for (int r = 0; r < 3; ++r) u[c][r] = mul(b[c][r], inv);
  }
  const float cx = sub(mul(u[0][1], u[1][2]), mul(u[0][2], u[1][1]));
  const float cy = sub(mul(u[0][2], u[1][0]), mul(u[0][0], u[1][2]));
  const float cz = sub(mul(u[0][0], u[1][1]), mul(u[0][1], u[1][0]));
  const float cn = clamp_min(root(add(add(mul(cx, cx), mul(cy, cy)), mul(cz, cz))), (float)1e-30);
  if (sig[2] < (float)1e-8) {
    u[2][0] = dvd(cx, cn);
    u[2][1] = dvd(cy, cn);
    u[2][2] = dvd(cz, cn);
  }
  // det(U) > 0, then det(V) > 0: third-column flips folded into sigma[2]
  const float su = det3(u) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) u[2][r] = mul(u[2][r], su);
  sig[2] = mul(sig[2], su);
  const float sv = det3(v) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) v[2][r] = mul(v[2][r], sv);
  sig[2] = mul(sig[2], sv);

#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[(3 * r + c) * (long long)n + i] = u[c][r];       // u9[3r+c] = U[r,c]
      out[(12 + 3 * r + c) * (long long)n + i] = v[r][c];  // vh9[3i+j] = V[j,i]
    }
    out[(9 + r) * (long long)n + i] = sig[r];
  }
}

__device__ __forceinline__ float cot(const Cots21& g, int k, long long i) {
  return g.p[k] ? g.p[k][i * g.s[k]] : 0.f;
}

__global__ void __launch_bounds__(THREADS)
svd3_bwd_kernel(const float* __restrict__ saved, Cots21 g, int n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float u[9], s[3], vh[9], du[9], ds[3], dvh[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    u[k] = saved[k * (long long)n + i];
    vh[k] = saved[(12 + k) * (long long)n + i];
    du[k] = cot(g, k, i);
    dvh[k] = cot(g, 12 + k, i);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s[k] = saved[(9 + k) * (long long)n + i];
    ds[k] = cot(g, 9 + k, i);
  }
  float s2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) s2[k] = mul(s[k], s[k]);
  // UtdU[i][j] = sum_r U[r,i] dU[r,j];  VtdV[i][j] = sum_r Vh[i,r] dVh[j,r]
  // (Python's sum(): 0 + first term, then the rest in order)
  float utdu[3][3], vtdv[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float x = add(mul(u[a], du[b]), 0.f);
      float y = add(mul(vh[3 * a], dvh[3 * b]), 0.f);
#pragma unroll
      for (int r = 1; r < 3; ++r) {
        x = add(x, mul(u[3 * r + a], du[3 * r + b]));
        y = add(y, mul(vh[3 * a + r], dvh[3 * b + r]));
      }
      utdu[a][b] = x;
      vtdv[a][b] = y;
    }
  }
  float inner[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      if (a == b) {
        inner[a][b] = ds[a];
      } else {
        const float diff = sub(s2[b], s2[a]);
        const float f = dvd(sgn(diff), clamp_min(fabsf(diff), (float)1e-10));
        const float J = mul(f, sub(utdu[a][b], utdu[b][a]));
        const float K = mul(f, sub(vtdv[a][b], vtdv[b][a]));
        inner[a][b] = add(mul(J, s[b]), mul(s[a], K));
      }
    }
  }
  // dA[r, c] = sum_{a,b} U[r,a] inner[a][b] Vh[b,c], from a zero start
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) acc = add(acc, mul(mul(u[3 * r + a], inner[a][b]), vh[3 * b + c]));
      }
      out[(3 * r + c) * (long long)n + i] = acc;
    }
  }
}

}  // namespace

// ptrs: 9 device addresses (host array); strides: their element strides.
extern "C" int neuma_svd3_fwd(const void* ptrs, const void* strides, int n, void* out,
                              void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  Cols9 a;
  for (int k = 0; k < 9; ++k) {
    a.p[k] = reinterpret_cast<const float*>(static_cast<const unsigned long long*>(ptrs)[k]);
    a.s[k] = static_cast<const long long*>(strides)[k];
    if (!a.p[k]) return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    svd3_fwd_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, n, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// saved: K6's (21, n) buffer; ptrs / strides: the 21 cotangents (host
// arrays; address 0 counts as a zero cotangent).
extern "C" int neuma_svd3_bwd(const void* saved, const void* ptrs, const void* strides, int n,
                              void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  Cots21 g;
  for (int k = 0; k < 21; ++k) {
    g.p[k] = reinterpret_cast<const float*>(static_cast<const unsigned long long*>(ptrs)[k]);
    g.s[k] = static_cast<const long long*>(strides)[k];
  }
  if (n > 0) {
    svd3_bwd_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(saved), g, n, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
