// Row LayerNorm forward (K4) and backward (K5) for Hopper (sm_90a),
// hand-written.
//
// Replaces the JAX package's Pallas kernels ``ever_tpu/ops/norm.py``
// ``_fwd_kernel`` (K4) and ``_bwd_kernel`` (K5).  Same functions, over the
// last axis of x [R, C] (bf16 or f32) with f32 gamma and beta:
//
//   forward:  mu = mean(x), var = mean(x*x) - mu*mu (one pass, unclamped),
//             rstd = 1/sqrt(var + eps), y = (x - mu)*rstd*gamma + beta in f32,
//             rounded once to x's type; mu and rstd written as f32 [R].
//   backward: xh = (x - mu)*rstd, dxh = dy*gamma,
//             dx = rstd*(dxh - mean(dxh) - xh*mean(dxh*xh)) in x's type,
//             dgamma = sum over rows of dy*xh, dbeta = sum of dy, in f32.
//
// Bound on an H100 SXM at DinoSeg ViT-L/16's shape (x [8232, 1024] bf16):
// K4 reads x (16.9 MB) and writes y (16.9 MB), 33.8 MB, 10.1 us at 3.35
// TB/s; K5 reads x and dy and writes dx, 50.6 MB, 15.1 us.  A few flops per
// element: memory bounds both.
//
// Design.  K4: one warp per row, eight rows per CTA.  A lane reads 16-byte
// vectors of the row (8 bf16 or 4 f32), keeps sum(x) and sum(x*x) in f32
// registers, and the warp adds them with shuffles; a second sweep over the
// same row (from L1, so device memory sees one read) writes y.  The loops
// are unrolled by 4 so that a lane has several loads in flight.  K5: the
// TPU kernel carries dgamma/dbeta in VMEM along its sequential row grid;
// Hopper CTAs run in no order and carry nothing between them, and float
// atomics would make two runs differ.  So a CTA takes 32 rows: first one
// warp per row finds mean(dxh) and mean(dxh*xh); then each thread owns a
// vector of columns, walks the 32 rows writing dx and summing dy*xh and
// dy, and writes the CTA's [2, C] f32 partial sums; a second small launch
// adds the partials of all CTAs in a fixed order.  When C is not a
// multiple of the vector width, or a pointer is not 16-byte aligned, the
// same kernels load and store element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kFwdWarps = 8;      // K4: rows (warps) per CTA
constexpr int kBwdRows = 32;      // K5: rows per CTA (_BWD_ROWS_PER_CTA in ops/norm.py)
constexpr int kBwdThreads = 128;  // K5: threads per CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V consecutive elements from p as floats: 16-byte loads when kVector,
// else element by element with the n valid ones read and the rest 0.
template <int V, bool kVector, typename T>
__device__ __forceinline__ void load_vec(float (&f)[V], const T* __restrict__ p,
                                         int n) {
  if (kVector) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int j = 0; j < V / E; ++j) {
      uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + j);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < E; ++k) f[j * E + k] = to_f32(e[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = k < n ? to_f32(p[k]) : 0.f;
  }
}

// The first min(n, V) of f to p, rounded to T.
template <int V, bool kVector, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&f)[V],
                                          int n) {
  if (kVector) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int j = 0; j < V / E; ++j) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int k = 0; k < E; ++k) e[k] = from_f32<T>(f[j * E + k]);
      reinterpret_cast<uint4*>(p)[j] = u;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < n) p[k] = from_f32<T>(f[k]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K4: one warp per row.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kFwdWarps * 32)
ever_ln_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, T* __restrict__ y,
            float* __restrict__ mean, float* __restrict__ rstd, int R, int C,
            float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // whole warps leave together
  const int64_t off = static_cast<int64_t>(r) * C;
  const int groups = (C + V - 1) / V;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int gi = lane; gi < groups; gi += 32) {
    const int c0 = gi * V;
    float f[V];
    load_vec<V, kVector>(f, x + off + c0, C - c0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s1 += f[k];
      s2 += f[k] * f[k];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mu = s1 / static_cast<float>(C);
  const float var = s2 / static_cast<float>(C) - mu * mu;
  const float rs = 1.0f / sqrtf(var + eps);
#pragma unroll 4
  for (int gi = lane; gi < groups; gi += 32) {
    const int c0 = gi * V;
    float f[V], g[V], b[V];
    load_vec<V, kVector>(f, x + off + c0, C - c0);
    load_vec<V, kVector>(g, gamma + c0, C - c0);
    load_vec<V, kVector>(b, beta + c0, C - c0);
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = (f[k] - mu) * rs * g[k] + b[k];
    store_vec<V, kVector>(y + off + c0, f, C - c0);
  }
  if (lane == 0) {
    mean[r] = mu;
    rstd[r] = rs;
  }
}

// K5, first launch: dx for kBwdRows rows, and their [2, C] partial sums
// (dgamma | dbeta) as row blockIdx.x of `partial`.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kBwdThreads)
ever_ln_bwd(const T* __restrict__ x, const T* __restrict__ dy,
            const float* __restrict__ gamma, const float* __restrict__ mean,
            const float* __restrict__ rstd, T* __restrict__ dx,
            float* __restrict__ partial, int R, int C) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kWarps = kBwdThreads / 32;
  __shared__ float s_mu[kBwdRows], s_rs[kBwdRows], s_m1[kBwdRows], s_m2[kBwdRows];
  const int r0 = blockIdx.x * kBwdRows;
  const int rows = min(kBwdRows, R - r0);
  const int lane = threadIdx.x & 31;
  const int groups = (C + V - 1) / V;

  // pass 1, one warp per row: mean(dxh) and mean(dxh*xh)
  for (int i = threadIdx.x >> 5; i < rows; i += kWarps) {
    const int64_t off = static_cast<int64_t>(r0 + i) * C;
    const float mu = mean[r0 + i], rs = rstd[r0 + i];
    float a = 0.f, b = 0.f;
  #pragma unroll 4
  for (int gi = lane; gi < groups; gi += 32) {
      const int c0 = gi * V;
      float xf[V], df[V], g[V];
      load_vec<V, kVector>(xf, x + off + c0, C - c0);
      load_vec<V, kVector>(df, dy + off + c0, C - c0);
      load_vec<V, kVector>(g, gamma + c0, C - c0);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float dxh = df[k] * g[k];
        a += dxh;
        b += dxh * ((xf[k] - mu) * rs);
      }
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      s_mu[i] = mu;
      s_rs[i] = rs;
      s_m1[i] = a / static_cast<float>(C);
      s_m2[i] = b / static_cast<float>(C);
    }
  }
  __syncthreads();

  // pass 2, a thread per column vector: dx row by row, and the column sums
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * 2 * C;
  for (int gi = threadIdx.x; gi < groups; gi += kBwdThreads) {
    const int c0 = gi * V, n = C - c0;
    float g[V], ag[V], ab[V];
    load_vec<V, kVector>(g, gamma + c0, n);
#pragma unroll
    for (int k = 0; k < V; ++k) ag[k] = ab[k] = 0.f;
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const int64_t off = static_cast<int64_t>(r0 + i) * C + c0;
      const float mu = s_mu[i], rs = s_rs[i], m1 = s_m1[i], m2 = s_m2[i];
      float xf[V], df[V];
      load_vec<V, kVector>(xf, x + off, n);
      load_vec<V, kVector>(df, dy + off, n);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = (xf[k] - mu) * rs;
        ag[k] += df[k] * xh;
        ab[k] += df[k];
        xf[k] = rs * (df[k] * g[k] - m1 - xh * m2);
      }
      store_vec<V, kVector>(dx + off, xf, n);
    }
    store_vec<V, kVector>(prow + c0, ag, n);
    store_vec<V, kVector>(prow + C + c0, ab, n);
  }
}

// K5, second launch: out[c] = sum over the P partial rows of partial[p, c],
// c < C2 = 2C, in a fixed order (rows p = y, y+8, ... per thread, then the
// eight threads' sums in order).  Block (32, 8).
__global__ void __launch_bounds__(256)
ever_ln_bwd_reduce(const float* __restrict__ partial, float* __restrict__ out,
                   int P, int C2) {
  __shared__ float s[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < C2)
    for (int p = threadIdx.y; p < P; p += 8)
      acc += partial[static_cast<int64_t>(p) * C2 + c];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < C2) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) t += s[j][threadIdx.x];
    out[c] = t;
  }
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15) == 0;
}

template <typename T>
int launch_fwd(const void* x, const void* g, const void* b, void* y, void* mean,
               void* rstd, int R, int C, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const unsigned blocks = static_cast<unsigned>((R + kFwdWarps - 1) / kFwdWarps);
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  if (C % V == 0 && aligned16({x, g, b, y}))
    ever_ln_fwd<T, true><<<blocks, kFwdWarps * 32, 0, st>>>(xp, gp, bp, yp, mp,
                                                            rp, R, C, eps);
  else
    ever_ln_fwd<T, false><<<blocks, kFwdWarps * 32, 0, st>>>(xp, gp, bp, yp, mp,
                                                             rp, R, C, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* g, const void* mean,
               const void* rstd, void* dx, void* partial, void* dwb, int R,
               int C, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int ctas = (R + kBwdRows - 1) / kBwdRows;
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  const float* gp = static_cast<const float*>(g);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partial);
  if (C % V == 0 && aligned16({x, dy, g, dx, partial}))
    ever_ln_bwd<T, true><<<ctas, kBwdThreads, 0, st>>>(xp, dyp, gp, mp, rp, dxp,
                                                       pp, R, C);
  else
    ever_ln_bwd<T, false><<<ctas, kBwdThreads, 0, st>>>(xp, dyp, gp, mp, rp, dxp,
                                                        pp, R, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((2 * C + 31) / 32);
  ever_ln_bwd_reduce<<<blocks, dim3(32, 8), 0, st>>>(
      pp, static_cast<float*>(dwb), ctas, 2 * C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [R, C] contiguous (dtype 0 = bf16, 1 = f32); gamma, beta: f32 [C];
// mean, rstd: f32 [R].  Launches on ``stream``; returns the CUDA error of
// the launch (0 on success).
extern "C" int ever_layernorm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int dtype, int R, int C, float eps,
                                  void* stream) {
  if (R < 0 || C < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, R, C, eps, st);
  return launch_fwd<float>(x, gamma, beta, y, mean, rstd, R, C, eps, st);
}

// x, dy, dx: [R, C] contiguous, of one type (dtype 0 = bf16, 1 = f32);
// gamma: f32 [C]; mean, rstd: f32 [R] from the forward; partial: f32
// scratch of partial_rows >= ceil(R / 32) rows of 2C; dwb: f32 [2C], out
// (dgamma then dbeta).  Two launches on ``stream``; returns the first CUDA
// error (0 on success).
extern "C" int ever_layernorm_bwd(const void* x, const void* dy, const void* gamma,
                                  const void* mean, const void* rstd, void* dx,
                                  void* partial, void* dwb, int dtype, int R,
                                  int C, int partial_rows, void* stream) {
  if (R < 0 || C < 1 || (dtype != 0 && dtype != 1) ||
      partial_rows < (R + kBwdRows - 1) / kBwdRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R == 0)
    return static_cast<int>(
        cudaMemsetAsync(dwb, 0, sizeof(float) * 2 * static_cast<size_t>(C), st));
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(x, dy, gamma, mean, rstd, dx, partial, dwb,
                                     R, C, st);
  return launch_bwd<float>(x, dy, gamma, mean, rstd, dx, partial, dwb, R, C, st);
}
