// Backward of the 3x3 / stride-2 max pool with padding ((1,1),(1,1)), for
// Hopper (sm_90a), hand-written.
//
// Replaces the JAX package's Pallas kernel ``ever_tpu/ops/pool.py:_bwd_kernel``
// (launched by ``max_pool_32_pallas``).  Same function, on NHWC tensors with
// H and W even:
//
//   dx[n,y,x,c] = sum over the <= 4 windows (oy, ox) covering (y, x) of
//                 g[n,oy,ox,c] * [x[n,y,x,c] == out[n,oy,ox,c]]
//
// Row y is covered by window row y/2 and, when y is odd, also by y/2 + 1
// (when that row exists); columns likewise.  Every tied maximum receives
// the gradient.  The comparison is made in f32 (exact for bf16), the terms
// are summed in f32 and dx is rounded once to the input type.
//
// Bound on an H100 SXM at the FarSeg-R50 stem's shape (x [8,256,256,64]
// bf16): x 67.1 MB, out and g 16.8 MB each read, dx 67.1 MB written =
// 167.8 MB, 50.1 us at 3.35 TB/s; a few compares and adds per element, so
// memory bounds it.
//
// Design.  The TPU kernel views column parity as lanes and row parity as a
// separate output plane to fit Mosaic's layout rules; none of that is
// needed here.  One thread owns 16 bytes of channels (8 bf16 or 4 f32) of
// one dx pixel: it reads its x vector once, the out and g vectors of the
// <= 4 covering windows (neighbouring threads read the same windows, which
// L1 and L2 serve), and writes dx once.  Threads run fastest over the
// channel vectors, then over x, so a warp's loads and stores are
// contiguous 16-byte accesses.  When C is not a multiple of the vector
// width, or a pointer is not 16-byte aligned, the same thread layout loads
// and stores element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// 16 bytes of T, loaded and stored as one uint4
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, bool kVector>
__device__ __forceinline__ void load(Vec<T>& dst, const T* __restrict__ src,
                                     int n) {
  if (kVector) {
    *reinterpret_cast<uint4*>(dst.v) =
        __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int k = 0; k < Vec<T>::N; ++k) dst.v[k] = k < n ? src[k] : T();
  }
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(256)
maxpool32_bwd(const T* __restrict__ x, const T* __restrict__ out,
              const T* __restrict__ g, T* __restrict__ dx, int H, int W,
              int C, int groups, long long total) {
  constexpr int V = Vec<T>::N;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cg = static_cast<int>(idx % groups);
  const long long pix = idx / groups;  // (n*H + y)*W + x
  const int xc = static_cast<int>(pix % W);
  const long long ny = pix / W;  // n*H + y
  const int y = static_cast<int>(ny % H);
  const long long n = ny / H;
  const int OH = H / 2, OW = W / 2;
  const int c0 = cg * V;
  const int nc = min(V, C - c0);

  Vec<T> xv;
  load<T, kVector>(xv, x + pix * C + c0, nc);
  float xs[V], acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    xs[k] = to_f32(xv.v[k]);
    acc[k] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int oy = y / 2 + a;
    if (a == 1 && (!(y & 1) || oy >= OH)) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int ox = xc / 2 + b;
      if (b == 1 && (!(xc & 1) || ox >= OW)) continue;
      const long long o = ((n * OH + oy) * OW + ox) * C + c0;
      Vec<T> ov, gv;
      load<T, kVector>(ov, out + o, nc);
      load<T, kVector>(gv, g + o, nc);
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (xs[k] == to_f32(ov.v[k])) acc[k] += to_f32(gv.v[k]);
    }
  }
  Vec<T> r;
#pragma unroll
  for (int k = 0; k < V; ++k) r.v[k] = from_f32<T>(acc[k]);
  T* dst = dx + pix * C + c0;
  if (kVector) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(r.v);
  } else {
    for (int k = 0; k < nc; ++k) dst[k] = r.v[k];
  }
}

template <typename T>
int launch(const void* x, const void* out, const void* g, void* dx, int N,
           int H, int W, int C, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  const int groups = (C + V - 1) / V;
  const long long total = static_cast<long long>(N) * H * W * groups;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      C % V == 0 && ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out) |
                      reinterpret_cast<uintptr_t>(g) |
                      reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  const T* xp = static_cast<const T*>(x);
  const T* op = static_cast<const T*>(out);
  const T* gp = static_cast<const T*>(g);
  T* dp = static_cast<T*>(dx);
  if (aligned)
    maxpool32_bwd<T, true><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        xp, op, gp, dp, H, W, C, groups, total);
  else
    maxpool32_bwd<T, false><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        xp, op, gp, dp, H, W, C, groups, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dx: [N,H,W,C]; out, g: [N,H/2,W/2,C]; all contiguous, of one type
// (dtype 0 = bf16, 1 = f32).  Launches on ``stream``; returns the CUDA
// error of the launch (0 on success).
extern "C" int ever_maxpool32_bwd(const void* x, const void* out,
                                  const void* g, void* dx, int dtype, int N,
                                  int H, int W, int C, void* stream) {
  if (N < 1 || H < 2 || W < 2 || C < 1 || (H & 1) || (W & 1) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, out, g, dx, N, H, W, C, st);
  return launch<float>(x, out, g, dx, N, H, W, C, st);
}
