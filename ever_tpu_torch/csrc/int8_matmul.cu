// int8 x int8 matrix product with an f32 rescale (K7) for Hopper (sm_90a),
// hand-written.
//
// Replaces the JAX package's Pallas kernel ``ever_tpu/ops/quant.py``
// ``_matmul_kernel``.  Same function:
//
//   out[m, n] = float(sum_k xq[m, k] * wq[k, n]) * (x_scale * w_scale)
//
// with int32 accumulation and the two scales multiplied in f32 first, as
// the TPU kernel does, so that the kernel and its plain version agree to the
// bit.  A = xq is [M, K] row-major.  The tensor cores take B k-contiguous
// (``.col``), and ``ldmatrix.trans`` moves 16-bit elements only, so it
// cannot transpose 8-bit tiles: the kernel takes W as [N, K] (``QuantDense``
// keeps that copy; ``int8_matmul``'s [K, N] API transposes per call).
//
// Bound on an H100 SXM at ViT-L/16's fc2 over 8 tiles of 1024² ([32808,
// 4096] x [4096, 1024]): 275.2 G int8 operations, 0.139 ms at 1979 TOP/s,
// against 273.0 MB moved (0.081 ms at 3.35 TB/s): the tensor cores bound it.
//
// Design.  A CTA of 8 warps owns a 128 x 128 output tile and walks K in
// 64-byte steps through a two-stage shared-memory ring filled by 16-byte
// ``cp.async`` copies (rows past M or N zero-filled); each warp owns 64 x 32
// outputs, loads fragments with ``ldmatrix`` (an 8 x 16-byte int8 tile is an
// 8 x 8 b16 tile, so the plain form gives the s8 fragment layout) and
// issues ``mma.sync.m16n8k32.s8`` into int32 registers.  The 80-byte row
// pitch in shared memory keeps both the copies and ``ldmatrix`` free of
// bank conflicts.  When K is not a multiple of 16 or a pointer is not
// 16-byte aligned, the tiles are filled by plain byte loads instead, zero
// past K.  No ``wgmma`` or TMA yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kThreads = 256;        // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;      // one warp's output tile
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int LDS = BK + 16;         // shared row pitch in bytes
constexpr int kChunks = BK / 16;     // 16-byte chunks per tile row
static_assert(BM == BN, "load_tile fills BM rows of either operand");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D = A*B + D for one 16x8x32 tile: A row-major (4 regs), B col-major (2).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + 128) x bytes [k0, k0 + 64) of a [rows, K] int8 matrix
// into a shared tile of pitch LDS; rows past `rows` and bytes past K read 0.
template <bool kAsync>
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int row0, int rows, int k0, int K) {
  for (int u = threadIdx.x; u < BM * kChunks; u += kThreads) {
    const int r = u / kChunks, c = (u % kChunks) * 16;
    const int gr = row0 + r, gk = k0 + c;
    if (kAsync) {
      // K is a multiple of 16 here: a chunk is wholly inside or outside
      const bool ok = gr < rows && gk < K;
      cp_async16(dst + r * LDS + c,
                 src + (ok ? static_cast<int64_t>(gr) * K + gk : 0), ok ? 16 : 0);
    } else {
      alignas(16) int8_t v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = (gr < rows && gk + j < K) ? src[static_cast<int64_t>(gr) * K + gk + j]
                                         : int8_t(0);
      *reinterpret_cast<uint4*>(dst + r * LDS + c) = *reinterpret_cast<uint4*>(v);
    }
  }
}

template <bool kAsync>
__global__ void __launch_bounds__(kThreads)
ever_int8_gemm(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               const float* __restrict__ x_scale, const float* __restrict__ w_scale,
               float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[2][BM * LDS];
  __shared__ __align__(16) int8_t sB[2][BN * LDS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  if (ktiles > 0) {
    load_tile<kAsync>(sA[0], A, m0, M, 0, K);
    load_tile<kAsync>(sB[0], B, n0, N, 0, K);
  }
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile<kAsync>(sA[cur ^ 1], A, m0, M, (kt + 1) * BK, K);
      load_tile<kAsync>(sB[cur ^ 1], B, n0, N, (kt + 1) * BK, K);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile kt has landed
    __syncthreads();
    const int8_t* a = sA[cur];
    const int8_t* b = sB[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // lanes 8i..8i+7 address 8x16-byte tile i: i&1 picks rows +8 (A) or
      // the k half (B), i>>1 the k half (A) or the next n8 tile (B)
      const int i = lane >> 3, r8 = lane & 7;
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], a + (wm * WM + mt * 16 + (i & 1) * 8 + r8) * LDS +
                                kk + (i >> 1) * 16);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, b + (wn * WN + (nt + (i >> 1)) * 8 + r8) * LDS + kk +
                           (i & 1) * 16);
        bf[nt][0] = r[0];
        bf[nt][1] = r[1];
        bf[nt + 1][0] = r[2];
        bf[nt + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // epilogue: float(acc) * (x_scale * w_scale), the scales' product first
  const float s = x_scale[0] * w_scale[0];
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + mt * 16 + g + h * 8;
        const int col = n0 + wn * WN + nt * 8 + t * 2;
        if (row >= M || col >= N) continue;
        const float v0 = static_cast<float>(acc[mt][nt][2 * h]) * s;
        const float v1 = static_cast<float>(acc[mt][nt][2 * h + 1]) * s;
        float* dst = out + static_cast<int64_t>(row) * N + col;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (col + 1 < N) dst[1] = v1;
        }
      }
}

}  // namespace

// x_q: int8 [M, K]; w_t: int8 [N, K] (W transposed); x_scale, w_scale: f32
// [1] on the device; out: f32 [M, N]; all contiguous.  Launches on
// ``stream``; returns the CUDA error of the launch (0 on success).
extern "C" int ever_int8_matmul(const void* x_q, const void* w_t,
                                const void* x_scale, const void* w_scale,
                                void* out, int M, int N, int K, void* stream) {
  if (M < 0 || N < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(x_q);
  const int8_t* b = static_cast<const int8_t*>(w_t);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  float* o = static_cast<float*>(out);
  const bool async = K % 16 == 0 && ((reinterpret_cast<uintptr_t>(x_q) |
                                      reinterpret_cast<uintptr_t>(w_t)) & 15) == 0;
  if (async)
    ever_int8_gemm<true><<<grid, kThreads, 0, st>>>(a, b, xs, ws, o, M, N, K);
  else
    ever_int8_gemm<false><<<grid, kThreads, 0, st>>>(a, b, xs, ws, o, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
