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
// TB/s; K5 reads x and dy and writes dx, 50.7 MB, 15.1 us.  A few flops per
// element: memory bounds both.
//
// Design.  K4: one warp per row, eight rows per CTA.  A lane reads 16-byte
// vectors of the row (8 bf16 or 4 f32), keeps sum(x) and sum(x*x) in f32
// registers, and the warp adds them with shuffles; a second sweep over the
// same row (from L1, so device memory sees one read) writes y.  The loops
// are unrolled by 4 so that a lane has several loads in flight.
//
// K5: the TPU kernel carries dgamma/dbeta in VMEM along its sequential row
// grid; Hopper CTAs run in no order and carry nothing between them, and
// float atomics would make two runs differ.  So every CTA takes 32 rows and
// writes one [2, C] f32 row of partial sums (dgamma | dbeta), and a second
// launch adds the partial rows of all CTAs in a fixed order (each thread a
// fixed stride of rows, then a fixed tree): the same inputs give the same
// bits.  Three paths, chosen from the width and the pointers before the
// launch (``ever_layernorm_bwd_path``):
// - one pass (C a multiple of 32 vectors, C <= 1280: every ViT width up to
//   ViT-H's): one warp per row, 8 warps of 4 rows each.  A lane holds its
//   C/32 values of x and dy in 16-byte vectors, the warp finds mean(dxh)
//   and mean(dxh*xh) with shuffles, and the lane writes dx straight from
//   its registers, so x and dy are read from device memory once.  Each
//   warp adds dy*xh and dy for its lanes' columns over its rows into its
//   own slice of shared memory (kept in registers, they spilled at C =
//   1024), and the CTA adds the 8 slices in warp order.  Two CTAs of 256
//   threads fit an SM: 16 warps with a whole row of loads in flight each.
// - two sweeps (wider rows, C a multiple of the vector): first one warp per
//   row finds the two means; then each thread owns a vector of columns and
//   walks the CTA's 32 rows (from L2) writing dx and adding the column sums.
// - element by element: the two-sweep kernels with scalar loads, for a C
//   off the 16-byte vector or a pointer off 16 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kFwdWarps = 8;      // K4: rows (warps) per CTA
constexpr int kBwdRows = 32;      // K5: rows per CTA (_BWD_ROWS_PER_CTA in ops/norm.py)
constexpr int kBwdThreads = 128;  // K5, two sweeps: threads per CTA
constexpr int kRowWarps = 8;      // K5, one pass: warps per CTA, kBwdRows / 8 rows each
constexpr int kOnePassMaxWidth = 1280;  // K5, one pass: widest row in registers

// K5's paths (ever_layernorm_bwd_path; BWD_PATHS in ops/norm.py)
enum BwdPath { kOnePass = 0, kTwoSweep = 1, kElementwise = 2 };

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

// V consecutive floats of shared memory (16-byte aligned), V a multiple of 4.
template <int V>
__device__ __forceinline__ void load4s(float (&f)[V], const float* p) {
#pragma unroll
  for (int j = 0; j < V / 4; ++j) {
    const float4 u = reinterpret_cast<const float4*>(p)[j];
    f[4 * j] = u.x;
    f[4 * j + 1] = u.y;
    f[4 * j + 2] = u.z;
    f[4 * j + 3] = u.w;
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

// K5, two sweeps (kVector) or element by element: dx for kBwdRows rows,
// and their [2, C] partial sums (dgamma | dbeta) as row blockIdx.x of
// `partial`.
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

// K5, one pass: rows [32 * blockIdx.x, +32) of x, dy [R, C], C = 32 * V * NV
// (NV 16-byte vectors of V values a lane).  Writes dx and the CTA's [2, C]
// partial sums (dgamma | dbeta) as row blockIdx.x of `partial`.  Dynamic
// shared memory: gamma [C], then each warp's column sums, 2C floats, laid
// out so that value e of lane l sits at float4 (e / 4) * 32 + l: a lane's
// read-modify-write of its sums touches 32 consecutive float4s a warp.
template <typename T, int NV>
__host__ __device__ constexpr int rows_smem_bytes() {
  return (32 * (16 / static_cast<int>(sizeof(T))) * NV) * (1 + 2 * kRowWarps) * 4;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kRowWarps * 32, 2)
ever_ln_bwd_rows(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ gamma, const float* __restrict__ mean,
                 const float* __restrict__ rstd, T* __restrict__ dx,
                 float* __restrict__ partial, int R) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = 32 * V * NV;
  constexpr int E = V * NV;                      // values a lane holds
  extern __shared__ __align__(16) float smem[];
  float* s_g = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* acc = reinterpret_cast<float4*>(smem + C + warp * 2 * C) + lane;
  for (int c = threadIdx.x; c < C; c += kRowWarps * 32) s_g[c] = gamma[c];
#pragma unroll
  for (int j = 0; j < 2 * E / 4; ++j) acc[32 * j] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // the lane's vector v covers columns (32 v + lane) V .. + V - 1; its sums
  // of dy*xh are values 0..E-1, of dy values E..2E-1
  for (int i = warp; i < kBwdRows; i += kRowWarps) {
    const int r = blockIdx.x * kBwdRows + i;
    if (r >= R) break;                           // whole warps leave together
    const int64_t off = static_cast<int64_t>(r) * C;
    uint4 xr[NV], dr[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      xr[v] = __ldg(reinterpret_cast<const uint4*>(x + off) + 32 * v + lane);
      dr[v] = __ldg(reinterpret_cast<const uint4*>(dy + off) + 32 * v + lane);
    }
    const float mu = mean[r], rs = rstd[r];
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const T* xe = reinterpret_cast<const T*>(&xr[v]);
      const T* de = reinterpret_cast<const T*>(&dr[v]);
      float g[V];
      load4s<V>(g, s_g + (32 * v + lane) * V);
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        float4 ag = acc[32 * (v * V / 4 + j)], ab = acc[32 * ((E + v * V) / 4 + j)];
        float* agp = &ag.x;
        float* abp = &ab.x;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float xh = (to_f32(xe[4 * j + k]) - mu) * rs, d = to_f32(de[4 * j + k]);
          const float dxh = d * g[4 * j + k];
          a += dxh;
          b += dxh * xh;
          agp[k] += d * xh;
          abp[k] += d;
        }
        acc[32 * (v * V / 4 + j)] = ag;
        acc[32 * ((E + v * V) / 4 + j)] = ab;
      }
    }
    const float m1 = warp_sum(a) / static_cast<float>(C);
    const float m2 = warp_sum(b) / static_cast<float>(C);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const T* xe = reinterpret_cast<const T*>(&xr[v]);
      const T* de = reinterpret_cast<const T*>(&dr[v]);
      uint4 u;
      T* oe = reinterpret_cast<T*>(&u);
      float g[V];
      load4s<V>(g, s_g + (32 * v + lane) * V);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = (to_f32(xe[k]) - mu) * rs;
        const float dxh = to_f32(de[k]) * g[k];
        oe[k] = from_f32<T>(rs * (dxh - m1 - xh * m2));
      }
      reinterpret_cast<uint4*>(dx + off)[32 * v + lane] = u;
    }
  }
  __syncthreads();
  // the CTA's sums: float4 group j of lane l, added over the warps in warp
  // order, is columns (32 v + l) V + 4 (j mod V/4) .. + 3 of vector
  // v = (j mod E/4) / (V/4), in dgamma (j < E/4) or dbeta
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * 2 * C;
  for (int j = warp; j < 2 * E / 4; j += kRowWarps) {
    const float4* src = reinterpret_cast<const float4*>(smem + C) + 32 * j + lane;
    float4 t = src[0];
#pragma unroll
    for (int w = 1; w < kRowWarps; ++w) {
      const float4 u = src[w * 2 * C / 4];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    const int jj = j % (E / 4), v = jj / (V / 4);
    const int c = (32 * v + lane) * V + 4 * (jj % (V / 4));
    reinterpret_cast<float4*>(prow + (j < E / 4 ? 0 : C) + c)[0] = t;
  }
}

// K5, second launch: out[c] = sum over the P partial rows of partial[p, c],
// c < C2 = 2C, in a fixed order: thread (x, y) of a (32, 32) block adds rows
// y, y + 32, ... of column 32 * blockIdx.x + x, then the 32 sums of a column
// are added as a fixed tree.
__global__ void __launch_bounds__(1024)
ever_ln_bwd_reduce(const float* __restrict__ partial, float* __restrict__ out,
                   int P, int C2) {
  __shared__ float s[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < C2)
    for (int p = threadIdx.y; p < P; p += 32)
      acc += partial[static_cast<int64_t>(p) * C2 + c];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    if (threadIdx.y < half) s[threadIdx.y][threadIdx.x] += s[threadIdx.y + half][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < C2) out[c] = s[0][threadIdx.x];
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
BwdPath choose_bwd(const void* x, const void* dy, const void* g, const void* dx,
                   const void* partial, int C) {
  constexpr int V = 16 / sizeof(T);
  if (C % V != 0 || !aligned16({x, dy, g, dx, partial})) return kElementwise;
  if (C % (32 * V) == 0 && C <= kOnePassMaxWidth) return kOnePass;
  return kTwoSweep;
}

// The one-pass kernel for C = 32 * V * NV, NV = C / (32 V) <= NV_MAX.
template <typename T, int NV_MAX>
int launch_rows(int nv, const T* x, const T* dy, const float* g, const float* mean,
                 const float* rstd, T* dx, float* partial, int R, int ctas,
                 cudaStream_t st) {
  if constexpr (NV_MAX > 1) {
    if (nv < NV_MAX)
      return launch_rows<T, NV_MAX - 1>(nv, x, dy, g, mean, rstd, dx, partial, R, ctas, st);
  }
  constexpr int smem = rows_smem_bytes<T, NV_MAX>();
  const cudaError_t e = cudaFuncSetAttribute(
      ever_ln_bwd_rows<T, NV_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ever_ln_bwd_rows<T, NV_MAX><<<ctas, kRowWarps * 32, smem, st>>>(x, dy, g, mean, rstd,
                                                                 dx, partial, R);
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
  switch (choose_bwd<T>(x, dy, g, dx, partial, C)) {
    case kOnePass: {
      const int err = launch_rows<T, kOnePassMaxWidth / (32 * V)>(
          C / (32 * V), xp, dyp, gp, mp, rp, dxp, pp, R, ctas, st);
      if (err != 0) return err;
      break;
    }
    case kTwoSweep:
      ever_ln_bwd<T, true><<<ctas, kBwdThreads, 0, st>>>(xp, dyp, gp, mp, rp, dxp,
                                                         pp, R, C);
      break;
    default:
      ever_ln_bwd<T, false><<<ctas, kBwdThreads, 0, st>>>(xp, dyp, gp, mp, rp, dxp,
                                                          pp, R, C);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((2 * C + 31) / 32);
  ever_ln_bwd_reduce<<<blocks, dim3(32, 32), 0, st>>>(
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

// The path K5 takes for these operands (0 one pass, 1 two sweeps, 2
// element by element); `dtype` as in ever_layernorm_bwd, -1 if invalid.
extern "C" int ever_layernorm_bwd_path(const void* x, const void* dy, const void* gamma,
                                       const void* dx, const void* partial, int dtype,
                                       int C) {
  if (C < 1 || (dtype != 0 && dtype != 1)) return -1;
  return static_cast<int>(dtype == 0
                              ? choose_bwd<__nv_bfloat16>(x, dy, gamma, dx, partial, C)
                              : choose_bwd<float>(x, dy, gamma, dx, partial, C));
}

// x, dy, dx: [R, C] contiguous, of one type (dtype 0 = bf16, 1 = f32);
// gamma: f32 [C]; mean, rstd: f32 [R] from the forward; partial: f32
// scratch of partial_rows >= ceil(R / 32) rows of 2C; dwb: f32 [2C], out
// (dgamma then dbeta).  Two launches on ``stream`` (the rows, then the
// partial sums); returns the first CUDA error (0 on success).
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
