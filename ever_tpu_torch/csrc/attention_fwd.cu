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

#include "attention_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = WARPS * 16;  // query rows per CTA
constexpr int BK = 64;          // keys per K/V tile

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

  load_rows_async<D, LD>(smem, kb, p.k_ss, 0, BK, p.S, tid, THREADS);
  load_rows_async<D, LD>(smem + TILE, vb, p.v_ss, 0, BK, p.S, tid, THREADS);
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
      load_rows_async<D, LD>(nxt, kb, p.k_ss, k0 + BK, BK, p.S, tid, THREADS);
      load_rows_async<D, LD>(nxt + TILE, vb, p.v_ss, k0 + BK, BK, p.S, tid, THREADS);
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

// k/v/kbuf/vbuf as in ever_attn_fwd; p.k/p.v are filled in here.
template <int D, typename T>
int launch(Params<T> p, int B, const T* k, const int64_t ks[3], const T* v,
           const int64_t vs[3], void* kbuf, void* vbuf, cudaStream_t st) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int64_t sb = static_cast<int64_t>(p.H) * p.S * D, sh = static_cast<int64_t>(p.S) * D;
  if (p.sin_tab != nullptr || kF32) {
    // rotate (and for f32 round) K once into the bf16 scratch buffer
    const int err = stage<D, T>(k, ks[0], ks[1], ks[2], p.sin_tab, p.cos_tab,
                                1.f, kbuf, B, p.H, p.S, st);
    if (err != 0) return err;
    p.k = static_cast<const __nv_bfloat16*>(kbuf);
    p.k_sb = sb; p.k_sh = sh; p.k_ss = D;
  } else {
    p.k = reinterpret_cast<const __nv_bfloat16*>(k);
    p.k_sb = ks[0]; p.k_sh = ks[1]; p.k_ss = ks[2];
  }
  if (kF32) {
    const int err = stage<D, T>(v, vs[0], vs[1], vs[2], nullptr, nullptr, 1.f,
                                vbuf, B, p.H, p.S, st);
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
