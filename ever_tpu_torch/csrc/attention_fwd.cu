// Non-causal multi-head attention forward for Hopper (sm_90a), hand-written.
//
// Replaces the JAX package's fused Pallas kernel
// ``ever_tpu/ops/attention.py:_fa_fwd_kernel`` (launched by
// ``_fused_fwd_impl``).  Same function: q is scaled by 1/sqrt(D); optional
// RoPE ``x*cos + rotate_half(x)*sin`` on q and K (the TPU kernel's lane roll
// with a sign-folded sin table; here one thread owns both halves, so the
// sign goes into the arithmetic and the tables arrive as they are); key
// columns >= n_valid are masked with -1e30;
// outputs o (normalised, in the input type) and lse = m + log(l) (f32,
// [B,H,S]).  Inputs are bf16 or f32; f32 operands are rounded to bf16 for
// the tensor cores (q after RoPE and the scale, K after RoPE, V as is),
// while scores, softmax, accumulation, lse and o stay f32.
//
// Bound on an H100 SXM at the ViT-L/16 serving shape (B=8, H=16, S=1029,
// D=64, bf16): 4*B*H*S^2*D = 34.7 GFLOP, 35 us at 989 TFLOP/s, against
// ~68 MB of q/k/v/o/lse traffic, 20 us at 3.35 TB/s.  Compute bounds it, so
// the design keeps the tensor cores fed and moves every other cost off the
// inner loop.
//
// Design.  The TPU kernel keeps the whole [S,D] K/V of a head resident in
// VMEM; an SM has 227 KB of shared memory, so here K/V stream through it
// FA2-style instead:
// - one CTA of 8 warps per (b, h, 128-row q tile); each warp owns 16 rows;
// - K/V tiles of 64 keys go through a two-stage cp.async ring in shared
//   memory: the next tile is in flight while the tensor cores work on this
//   one;
// - both products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32,
//   operands fetched with ldmatrix): the score tile never leaves registers,
//   and its accumulator layout is re-packed in place as the A operand of
//   P*V (the FA2 register trick);
// - online softmax in f32 with running m and l per row, exponentials as
//   one FFMA + ex2 each;
// - RoPE: the q tile is rotated and scaled once per CTA on its way into
//   registers (one thread owns each (i, i+D/2) chunk pair, so the roll
//   needs no exchange).  K is rotated once per (b, h) by a small
//   memory-bound prologue kernel into a bf16 scratch buffer, instead of once
//   per q tile (9 times per head at S=1029), which keeps the K tiles plain
//   asynchronous copies.  With f32 inputs the same prologue also rounds K
//   and V to bf16 scratch, so the main loop is the same for both types;
// - key tiles wholly at or past n_valid are skipped, so no tile is all
//   -1e30; the ragged tail of S is zero-filled and masked, and warps whose
//   rows all lie past S skip the products;
// - q/k/v/o are addressed through strides, so the packed qkv projection
//   [B,N,3,H,D] is read and o is written as [B,N,H,D] without transposes.
// wgmma/TMA with warp specialisation are the next steps toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = WARPS * 16;  // query rows per CTA
constexpr int BK = 64;          // keys per K/V tile
constexpr float MASK = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// T: the element type of q, o and the RoPE tables (bf16 or f32).  K and V
// always reach the main kernel as bf16.
template <typename T>
struct Params {
  const T* q;
  const __nv_bfloat16* k;     // rotated by RoPE already, when RoPE is on
  const __nv_bfloat16* v;
  const T* sin_tab;           // [S, D] RoPE tables for q, or null
  const T* cos_tab;           // [S, D]
  T* o;
  float* lse;                 // [B, H, S]
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int S, H, n_valid;
  float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 u;
  u.x = pack_bf16(f[0], f[1]);
  u.y = pack_bf16(f[2], f[3]);
  u.z = pack_bf16(f[4], f[5]);
  u.w = pack_bf16(f[6], f[7]);
  return u;
}

// Eight consecutive elements as floats; `p` is 16-byte aligned.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Two consecutive output elements.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D = A*B + D for one 16x8x16 tile: A row-major (4 regs), B col-major (2).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 tiles from shared memory; lanes 8i..8i+7 address tile i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each tile transposed (B operands of P*V).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte asynchronous copy global -> shared; `valid` false zero-fills.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// RoPE of one row's 8-element chunk pair (c, c + D/16), times `scale`,
// rounded to bf16: rotated[i] = x[i]*cos[i] - x[i+D/2]*sin[i] on the low
// half and x[i]*cos[i] + x[i-D/2]*sin[i] on the high half.  `row` is the
// row's first element and `t` its offset into the tables; null tables mean
// no rotation.
template <int D, typename T>
__device__ __forceinline__ void rope_pair(uint4& lo, uint4& hi, const T* row,
                                          const T* sin_tab, const T* cos_tab,
                                          int64_t t, int c, float scale) {
  constexpr int HALF = D / 16;
  float xl[8], xh[8], yl[8], yh[8];
  load8(row + c * 8, xl);
  load8(row + (c + HALF) * 8, xh);
  if (sin_tab != nullptr) {
    float cl[8], ch[8], sl[8], sh[8];
    load8(cos_tab + t + c * 8, cl);
    load8(cos_tab + t + (c + HALF) * 8, ch);
    load8(sin_tab + t + c * 8, sl);
    load8(sin_tab + t + (c + HALF) * 8, sh);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      yl[j] = (xl[j] * cl[j] - xh[j] * sl[j]) * scale;
      yh[j] = (xh[j] * ch[j] + xl[j] * sh[j]) * scale;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      yl[j] = xl[j] * scale;
      yh[j] = xh[j] * scale;
    }
  }
  lo = pack8(yl);
  hi = pack8(yh);
}

// Stage the BQ rows [row0, row0+BQ) of a [S, D] head slice into shared
// memory, rotated (when sin_tab != null) and multiplied by `scale`.  Rows past
// S are zero.
template <int D, int LD, typename T>
__device__ __forceinline__ void load_q_rope(
    __nv_bfloat16* dst, const T* src, int64_t ss, int row0, int S,
    const T* sin_tab, const T* cos_tab, float scale, int tid) {
  constexpr int HALF = D / 16;
  for (int u = tid; u < BQ * HALF; u += THREADS) {
    const int r = u / HALF, c = u % HALF, gr = row0 + r;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (gr < S)
      rope_pair<D>(lo, hi, src + gr * ss, sin_tab, cos_tab,
                   static_cast<int64_t>(gr) * D, c, scale);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = lo;
    *reinterpret_cast<uint4*>(dst + r * LD + (c + HALF) * 8) = hi;
  }
}

// Start the copy of BK rows [row0, row0+BK) of a [S, D] slice into shared
// memory; rows past S are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int64_t ss, int row0, int S,
                                                int tid) {
  constexpr int CH = D / 8;
  for (int u = tid; u < BK * CH; u += THREADS) {
    const int r = u / CH, c = u % CH, gr = row0 + r;
    const bool ok = gr < S;
    cp_async16(dst + r * LD + c * 8, src + (ok ? gr : 0) * ss + c * 8, ok);
  }
}

// Prologue: out[b, h, s, :] = bf16(RoPE(x[b, s, h, :])) for every row,
// contiguous [B, H, S, D]; null tables copy without rotating.  One thread
// per (row, chunk pair).
template <int D, typename T>
__global__ void stage_kernel(const T* x, int64_t x_sb, int64_t x_sh,
                             int64_t x_ss, const T* sin_tab, const T* cos_tab,
                             __nv_bfloat16* out, int H, int S,
                             int64_t n_units) {
  constexpr int HALF = D / 16;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= n_units) return;
  const int64_t row = u / HALF;
  const int c = static_cast<int>(u % HALF);
  const int s = static_cast<int>(row % S);
  const int64_t bh = row / S;
  uint4 lo, hi;
  rope_pair<D>(lo, hi, x + (bh / H) * x_sb + (bh % H) * x_sh + s * x_ss,
               sin_tab, cos_tab, static_cast<int64_t>(s) * D, c, 1.f);
  __nv_bfloat16* dst = out + row * D;
  *reinterpret_cast<uint4*>(dst + c * 8) = lo;
  *reinterpret_cast<uint4*>(dst + (c + HALF) * 8) = hi;
}

template <int D>
constexpr int smem_bytes() {
  return 4 * BK * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

static_assert(BQ == 2 * BK, "the q tile is staged in one ring stage");

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
attn_fwd_kernel(const Params<T> p) {
  constexpr int LD = D + 8;       // padded shared row: conflict-free ldmatrix
  constexpr int TILE = BK * LD;   // elements of one K or V tile
  constexpr int KSTEPS = D / 16;  // k-steps of Q*K^T
  constexpr int NT = BK / 8;      // 8-key column tiles of the score tile
  constexpr int DT = D / 8;       // 8-wide column tiles of the output
  // Ring stage i holds K at smem + 2*i*TILE and V right after it; stage 1
  // (2*BK = BQ rows) first stages the q tile.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int n_kt = (p.n_valid + BK - 1) / BK;

  load_tile_async<D, LD>(smem, kb, p.k_ss, 0, p.S, tid);
  load_tile_async<D, LD>(smem + TILE, vb, p.v_ss, 0, p.S, tid);
  cp_async_commit();

  // Q tile: rotated and scaled once, then held as A fragments.
  load_q_rope<D, LD>(smem + 2 * TILE, qb, p.q_ss, q0, p.S, p.sin_tab,
                     p.cos_tab, p.scale, tid);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
  {
    const __nv_bfloat16* r0 = smem + 2 * TILE + (warp * 16 + g) * LD + 2 * t;
    const __nv_bfloat16* r1 = r0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0 + kk * 16);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(r1 + kk * 16);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + kk * 16 + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + kk * 16 + 8);
    }
  }
  __syncthreads();

  const bool active = q0 + warp * 16 < p.S;
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = MASK, m1 = MASK, l0 = 0.f, l1 = 0.f;  // rows g and g+8

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < n_kt) {
      __nv_bfloat16* nxt = smem + 2 * ((kt + 1) & 1) * TILE;
      load_tile_async<D, LD>(nxt, kb, p.k_ss, k0 + BK, p.S, tid);
      load_tile_async<D, LD>(nxt + TILE, vb, p.v_ss, k0 + BK, p.S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const __nv_bfloat16* Ks = smem + 2 * (kt & 1) * TILE;
      const __nv_bfloat16* Vs = Ks + TILE;
      // S = Q K^T for this warp's 16 rows x 64 keys.  One ldmatrix.x4
      // fetches the B fragments of two 8-key column tiles.
      float s[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      const __nv_bfloat16* kr =
          Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kr + nt * 8 * LD + kk * 16);
          mma_bf16(s[nt], qf[kk], kf[0], kf[1]);
          mma_bf16(s[nt + 1], qf[kk], kf[2], kf[3]);
        }
      }
      // Mask key columns at or past n_valid (finite, so exp stays NaN-free).
      if (k0 + BK > p.n_valid) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k0 + nt * 8 + 2 * t + (e & 1) >= p.n_valid) s[nt][e] = MASK;
          }
        }
      }
      // Online softmax: rows g (elements 0,1) and g+8 (elements 2,3); the
      // four lanes of a quad share a row.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float ml0 = mx0 * LOG2E, ml1 = mx1 * LOG2E;
      const float a0 = exp2_approx(fmaf(m0, LOG2E, -ml0));
      const float a1 = exp2_approx(fmaf(m1, LOG2E, -ml1));
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = exp2_approx(fmaf(s[nt][0], LOG2E, -ml0));
        s[nt][1] = exp2_approx(fmaf(s[nt][1], LOG2E, -ml0));
        s[nt][2] = exp2_approx(fmaf(s[nt][2], LOG2E, -ml1));
        s[nt][3] = exp2_approx(fmaf(s[nt][3], LOG2E, -ml1));
        rs0 += s[nt][0] + s[nt][1];
        rs1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * a0 + rs0;  // per-lane partial sums; the quad adds them at the end
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][0] *= a0;
        acc[dt][1] *= a0;
        acc[dt][2] *= a1;
        acc[dt][3] *= a1;
      }
      // O += P V.  Score tiles 2j and 2j+1 form the A operand of key step j.
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * j][0], s[2 * j][1]),
            pack_bf16(s[2 * j][2], s[2 * j][3]),
            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const __nv_bfloat16* vr =
            Vs + (j * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vr + dt * 8);
          mma_bf16(acc[dt], pa, vf[0], vf[1]);
          mma_bf16(acc[dt + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

  if (!active) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  T* ob = p.o + b * p.o_sb + h * p.o_sh;
  float* lb = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.S;
  if (r0 < p.S) {
    const float inv = 1.f / l0;
    T* orow = ob + r0 * p.o_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store2(orow + dt * 8, acc[dt][0] * inv, acc[dt][1] * inv);
    if (t == 0) lb[r0] = m0 + logf(l0);
  }
  if (r1 < p.S) {
    const float inv = 1.f / l1;
    T* orow = ob + r1 * p.o_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store2(orow + dt * 8, acc[dt][2] * inv, acc[dt][3] * inv);
    if (t == 0) lb[r1] = m1 + logf(l1);
  }
}

// x -> bf16(RoPE(x)) as contiguous [B, H, S, D] in `out`.
template <int D, typename T>
int stage(const T* x, int64_t sb, int64_t sh, int64_t ss, const T* sin_tab,
          const T* cos_tab, void* out, int B, int H, int S, cudaStream_t st) {
  const int64_t units = static_cast<int64_t>(B) * H * S * (D / 16);
  const int threads = 256;
  const int64_t blocks = (units + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  stage_kernel<D, T><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      x, sb, sh, ss, sin_tab, cos_tab, static_cast<__nv_bfloat16*>(out), H, S,
      units);
  return static_cast<int>(cudaGetLastError());
}

// k/v/kbuf/vbuf as in ever_attn_fwd; p.k/p.v are filled in here.
template <int D, typename T>
int launch(Params<T> p, int B, const T* k, const int64_t ks[3], const T* v,
           const int64_t vs[3], void* kbuf, void* vbuf, cudaStream_t st) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int64_t sb = static_cast<int64_t>(p.H) * p.S * D, sh = static_cast<int64_t>(p.S) * D;
  if (p.sin_tab != nullptr || kF32) {
    // rotate (and for f32 round) K once into the bf16 scratch buffer
    const int err = stage<D, T>(k, ks[0], ks[1], ks[2], p.sin_tab, p.cos_tab,
                                kbuf, B, p.H, p.S, st);
    if (err != 0) return err;
    p.k = static_cast<const __nv_bfloat16*>(kbuf);
    p.k_sb = sb; p.k_sh = sh; p.k_ss = D;
  } else {
    p.k = reinterpret_cast<const __nv_bfloat16*>(k);
    p.k_sb = ks[0]; p.k_sh = ks[1]; p.k_ss = ks[2];
  }
  if (kF32) {
    const int err = stage<D, T>(v, vs[0], vs[1], vs[2], nullptr, nullptr, vbuf,
                                B, p.H, p.S, st);
    if (err != 0) return err;
    p.v = static_cast<const __nv_bfloat16*>(vbuf);
    p.v_sb = sb; p.v_sh = sh; p.v_ss = D;
  } else {
    p.v = reinterpret_cast<const __nv_bfloat16*>(v);
    p.v_sb = vs[0]; p.v_sh = vs[1]; p.v_ss = vs[2];
  }
  constexpr int smem = smem_bytes<D>();
  if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB (D=128)
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  attn_fwd_kernel<D, T><<<grid, THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* sin_tab,
             const void* cos_tab, void* kbuf, void* vbuf, void* o, void* lse,
             int B, int H, int S, int D, int n_valid, const int64_t qs[3],
             const int64_t ks[3], const int64_t vs[3], const int64_t os[3],
             float scale, cudaStream_t st) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.sin_tab = static_cast<const T*>(sin_tab);
  p.cos_tab = static_cast<const T*>(cos_tab);
  p.o = static_cast<T*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = qs[0]; p.q_sh = qs[1]; p.q_ss = qs[2];
  p.o_sb = os[0]; p.o_sh = os[1]; p.o_ss = os[2];
  p.S = S; p.H = H; p.n_valid = n_valid; p.scale = scale;
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (D == 64) return launch<64, T>(p, B, kt, ks, vt, vs, kbuf, vbuf, st);
  if (D == 128) return launch<128, T>(p, B, kt, ks, vt, vs, kbuf, vbuf, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device addresses; strides are in
// elements, and the last (D) stride of q/k/v/o is 1.  `dtype` is the element
// type of q/k/v/o and the tables: 0 = bf16, 1 = f32.  `kbuf` is a [B, H, S, D]
// bf16 scratch buffer for the staged K, needed with RoPE (sin_tab and cos_tab
// non-null) or f32; `vbuf` is the same for V, needed with f32.  Launches on
// `stream` without synchronising and returns the first cudaError_t met
// (0 = success).
extern "C" int ever_attn_fwd(
    const void* q, const void* k, const void* v, const void* sin_tab,
    const void* cos_tab, void* kbuf, void* vbuf, void* o, void* lse,
    int dtype, int B, int H, int S, int D, int n_valid, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    void* stream) {
  if (B < 1 || H < 1 || S < 1 || n_valid < 1 || n_valid > S ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1) ||
      (sin_tab == nullptr) != (cos_tab == nullptr) ||
      ((sin_tab != nullptr || dtype == 1) && kbuf == nullptr) ||
      (dtype == 1 && vbuf == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss};
  const int64_t vs[3] = {v_sb, v_sh, v_ss}, os[3] = {o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(q, k, v, sin_tab, cos_tab, kbuf, vbuf, o,
                                   lse, B, H, S, D, n_valid, qs, ks, vs, os,
                                   scale, st);
  return dispatch<float>(q, k, v, sin_tab, cos_tab, kbuf, vbuf, o, lse, B, H,
                         S, D, n_valid, qs, ks, vs, os, scale, st);
}
