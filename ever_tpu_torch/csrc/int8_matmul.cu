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
// bit.  A = xq is [M, K] row-major; W comes as [N, K] (``QuantDense`` keeps
// that copy; ``int8_matmul``'s [K, N] API transposes per call): the tensor
// cores take both 8-bit operands K-major, and 8-bit tiles take no transpose.
//
// Bound on an H100 SXM at ViT-L/16's fc2 over 8 tiles of 1024² ([32808,
// 4096] x [4096, 1024]): 275.2 G int8 operations, 0.139 ms at 1979 TOP/s,
// against 273.0 MB moved (0.081 ms at 3.35 TB/s): the tensor cores bound it.
//
// Two paths, chosen from the shapes and pointers before the launch
// (``ever_int8_matmul_path``), never after a failure:
//
// - kWgmmaTma, whenever K is a positive multiple of 16 and both operands
//   start on 16 bytes (what TMA can address).  A persistent grid of one CTA
//   per SM walks 128 x 256 output tiles, N fastest, so that the CTAs in
//   flight share A's rows and W (4 MB at fc2) stays in L2.  One producer
//   warp keeps TMA loads in flight through a 4-stage ring of 128-byte K
//   slices (A 16 KB + W 32 KB a stage, 128-byte swizzle, rows past M or N
//   and bytes past K zero-filled by TMA); two consumer warpgroups, 64 rows
//   each, issue ``wgmma.m64n256k32.s32.s8.s8`` from shared memory into 128
//   int32 registers a thread, keeping one k-slice of MMAs in flight while
//   the previous slice's stage is released.  The epilogue scales and stores
//   straight from the registers (each 4-lane group writes 32 contiguous
//   bytes of a row, whole sectors), masked at the ragged edges; the
//   producer meanwhile loads the next tile's first slices.
// - kMmaSyncBytes, for a K that is not a multiple of 16 or an operand off
//   16 bytes: a CTA of 8 warps per 128 x 128 tile fills its shared tiles by
//   byte loads (zero past K, M or N) and issues ``mma.sync.m16n8k32.s8``.
//   Correct for any shape and slow; no main path reaches it.

#include "hopper.cuh"

namespace {

enum Path { kWgmmaTma = 0, kMmaSyncBytes = 1 };

Path choose_path(const void* x_q, const void* w_t, int K) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x_q) |
                         reinterpret_cast<uintptr_t>(w_t)) & 15) == 0;
  return (K > 0 && K % 16 == 0 && aligned) ? kWgmmaTma : kMmaSyncBytes;
}

// ------------------------------------------------------------ wgmma + TMA

constexpr int BM = 128, BN = 256, BK = 128, STAGES = 4;
constexpr int kConsumerWarps = 8;                     // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 32;    // + one producer warp
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const float* __restrict__ x_scale,
                const float* __restrict__ w_scale, float* __restrict__ out,
                int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024 bytes
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sA = base;
  unsigned char* sB = base + STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int kblocks = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one lane issues every load of this CTA's tiles
    if (lane == 0) {
      tma_prefetch_desc(&map_a);
      tma_prefetch_desc(&map_b);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[st], STAGE_BYTES);
          tma_load_2d(sA + st * A_BYTES, &map_a, &full[st], kb * BK, m0);
          tma_load_2d(sB + st * B_BYTES, &map_b, &full[st], kb * BK, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const float scale = x_scale[0] * w_scale[0];
  const bool pairs = (N & 1) == 0;
  int acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      const uint64_t da = desc_kmajor(sA + st * A_BYTES + wg * 64 * BK);
      const uint64_t db = desc_kmajor(sB + st * B_BYTES);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)   // 32 bytes of K per MMA: +2 in 16-byte units
        wgmma_s8_ss_n256(acc, da + 2 * k, db + 2 * k, (kb | k) != 0);
      wgmma_commit();
      fence_regs(acc);
      if (kb > 0) {
        wgmma_wait<1>();                   // slice kb-1 is done: free its stage
        mbar_arrive(&empty[(it - 1) % STAGES], lane == 0);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(it - 1) % STAGES], lane == 0);

    // epilogue: float(acc) * (x_scale * w_scale), the scales' product first.
    // Accumulator 4j+e holds row g (+8 for e >= 2), column 8j + 2t + (e & 1).
    const int r0 = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= M || col >= N) continue;
        const float v0 = static_cast<float>(acc[4 * j + 2 * h]) * scale;
        const float v1 = static_cast<float>(acc[4 * j + 2 * h + 1]) * scale;
        float* dst = out + static_cast<int64_t>(row) * N + col;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (col + 1 < N) dst[1] = v1;
        }
      }
    }
  }
}

int launch_wgmma(const int8_t* a, const int8_t* b, const float* xs,
                 const float* ws, float* o, int M, int N, int K,
                 cudaStream_t st) {
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t dims_b[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(N)};
  const uint64_t stride[1] = {static_cast<uint64_t>(K)};
  const uint32_t box_a[2] = {BK, BM}, box_b[2] = {BK, BN};
  int err = make_tensor_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a, dims_a,
                            stride, box_a, true);
  if (err != 0) return err;
  err = make_tensor_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, b, dims_b,
                        stride, box_b, true);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(int8_gemm_wgmma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t tiles = static_cast<int64_t>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  int8_gemm_wgmma<<<grid, kThreads, SMEM_BYTES, st>>>(map_a, map_b, xs, ws,
                                                      o, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- mma.sync with byte loads

constexpr int SB = 128, SK = 64;      // tile rows (M and N), K bytes per step
constexpr int kSyncThreads = 256;     // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;       // one warp's output tile
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int LDS = SK + 16;          // shared row pitch in bytes

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(smem)));
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
// into a shared tile of pitch LDS, byte by byte; past `rows` or K read 0.
__device__ __forceinline__ void load_tile_bytes(int8_t* dst, const int8_t* src,
                                                int row0, int rows, int k0,
                                                int K) {
  for (int u = threadIdx.x; u < SB * SK / 16; u += kSyncThreads) {
    const int r = u / (SK / 16), c = (u % (SK / 16)) * 16;
    const int gr = row0 + r, gk = k0 + c;
    alignas(16) int8_t v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = (gr < rows && gk + j < K) ? src[static_cast<int64_t>(gr) * K + gk + j]
                                       : int8_t(0);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = *reinterpret_cast<uint4*>(v);
  }
}

__global__ void __launch_bounds__(kSyncThreads)
int8_gemm_mma_sync(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale, float* __restrict__ out,
                   int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[SB * LDS];
  __shared__ __align__(16) int8_t sB[SB * LDS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / (SB / WN), wn = warp % (SB / WN);
  const int m0 = blockIdx.y * SB, n0 = blockIdx.x * SB;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += SK) {
    load_tile_bytes(sA, A, m0, M, k0, K);
    load_tile_bytes(sB, B, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SK; kk += 32) {
      // lanes 8i..8i+7 address 8x16-byte tile i: i&1 picks rows +8 (A) or
      // the k half (B), i>>1 the k half (A) or the next n8 tile (B)
      const int i = lane >> 3, r8 = lane & 7;
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], sA + (wm * WM + mt * 16 + (i & 1) * 8 + r8) * LDS +
                                kk + (i >> 1) * 16);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, sB + (wn * WN + (nt + (i >> 1)) * 8 + r8) * LDS + kk +
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
    __syncthreads();  // the next step refills the tiles
  }

  const float s = x_scale[0] * w_scale[0];
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + mt * 16 + g + h * 8;
        const int col = n0 + wn * WN + nt * 8 + t * 2;
        if (row >= M || col >= N) continue;
        float* dst = out + static_cast<int64_t>(row) * N + col;
        dst[0] = static_cast<float>(acc[mt][nt][2 * h]) * s;
        if (col + 1 < N) dst[1] = static_cast<float>(acc[mt][nt][2 * h + 1]) * s;
      }
}

}  // namespace

// The path ``ever_int8_matmul`` takes for these operands: 0 = kWgmmaTma,
// 1 = kMmaSyncBytes.
extern "C" int ever_int8_matmul_path(const void* x_q, const void* w_t, int K) {
  return static_cast<int>(choose_path(x_q, w_t, K));
}

// x_q: int8 [M, K]; w_t: int8 [N, K] (W transposed); x_scale, w_scale: f32
// [1] on the device; out: f32 [M, N]; all contiguous.  Launches on
// ``stream``; returns the CUDA error of the launch (0 on success).
extern "C" int ever_int8_matmul(const void* x_q, const void* w_t,
                                const void* x_scale, const void* w_scale,
                                void* out, int M, int N, int K, void* stream) {
  if (M < 0 || N < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(x_q);
  const int8_t* b = static_cast<const int8_t*>(w_t);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  float* o = static_cast<float*>(out);
  if (choose_path(x_q, w_t, K) == kWgmmaTma)
    return launch_wgmma(a, b, xs, ws, o, M, N, K, st);
  const dim3 grid((N + SB - 1) / SB, (M + SB - 1) / SB);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int8_gemm_mma_sync<<<grid, kSyncThreads, 0, st>>>(a, b, xs, ws, o, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
