// Non-causal multi-head attention backward for Hopper (sm_90a), hand-written.
//
// Replaces the JAX package's fused Pallas kernel
// ``ever_tpu/ops/attention.py:_fa_bwd_kernel`` (launched by
// ``_fused_bwd_impl``).  Same function, from q, k, v, o, do [B,N,H,D] (any
// strides with a unit last stride), lse [B,H,S] f32 from the forward, and
// optional [S,D] RoPE tables:
//   Rq = rope(q), Rk = rope(k), s = scale * Rq Rk^T, key columns >= n_valid
//   masked;  p = exp(s - lse);  dp = do v^T;  delta = rowsum(do * o), with o
//   in the input type as the forward wrote it;  ds = p * (dp - delta);
//   dq = R^T(scale * ds Rk),  dk = R^T(scale * ds^T Rq),  dv = p^T do.
// p and ds are rounded to bf16 for the products, which accumulate in f32;
// dq, dk and dv are written in the input type (bf16 or f32).  f32 inputs are
// staged to bf16 for the tensor cores, as in the forward kernel.
//
// The inverse rotation is R^T(y) = y*cos - rotate_half(y)*sin.  It is the
// transpose of the forward rotation only for half-tiled tables
// (sin[:, :D/2] == sin[:, D/2:], the same for cos), the contract of the JAX
// kernel (attention.py:381-384).  The ViT's axial RoPE tables are always
// half-tiled (``RopePositionEmbedding`` repeats the angles twice).
//
// Bound on an H100 SXM at the ViT-L/16 training shape (B=8, H=16, S=1029,
// D=64, bf16): five products of 2*B*H*S^2*D each, 86.7 GFLOP, 88 us at
// 989 TFLOP/s, against ~0.14 GB of q/k/v/o/do/lse/dq/dk/dv traffic, 41 us at
// 3.35 TB/s.  Compute bounds it, so the design keeps every product on the
// tensor cores and the score tiles in registers.
//
// Design.  The TPU kernel keeps a head's whole K/V and f32 dK/dV
// accumulators in VMEM and carries them across its sequential q-block grid
// dimension.  Hopper blocks run in parallel and in no order, so:
// - prologue kernels compute delta [B,H,S] f32 and stage bf16 copies of
//   scale*rope(q) and rope(k) once per head (and of v and do from f32
//   inputs), so the main loops are plain asynchronous copies;
// - dK/dV pass: one CTA of 4 warps per (b, h, 64-key tile), each warp owning
//   16 keys.  The K/V tile stays in shared memory; the CTA loops over q
//   tiles through a two-stage cp.async ring of (q, do, lse, delta).  It
//   computes the TRANSPOSED score tile s^T = K Q^T (keys x queries), so that
//   p^T and ds^T come out of the MMA accumulators already in the row layout
//   of the A operand of dV += p^T do and dK += ds^T Rq: the accumulators are
//   re-packed in registers (the FA2 trick of the forward kernel) and p and ds
//   never go through shared memory.  dK and dV accumulate in f32 registers;
//   the epilogue inverse-rotates dK with the key rows' tables.
// - dQ pass: one CTA of 4 warps per (b, h, 64-row q tile), looping over key
//   tiles through a two-stage cp.async ring of (K, V), recomputing s and dp.
//   Chosen over f32 atomicAdd of dq from the dK/dV pass because it is
//   deterministic (the same inputs give the same bits, which remat relies
//   on) and needs no f32 scratch or convert pass; it costs two of the five
//   products again (s and dp).  The epilogue scales and inverse-rotates dQ.
// - key tiles wholly at or past n_valid are skipped (their p is 0, so their
//   dk and dv are written as exact zeros); rows past S are zero-filled on
//   load, which makes their p exactly 1 against zero do and q rows, so they
//   add exactly 0, and they are never written.
// Products are mma.sync m16n8k16 bf16 -> f32 with ldmatrix operands.  At
// head dim 128 the streamed tiles are 32 rows, to keep the four f32
// accumulators of a warp in registers.  wgmma/TMA and a fused dQ are the
// next steps toward the bound.

#include "attention_common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BR = WARPS * 16;  // rows a CTA owns: keys (dK/dV) or queries (dQ)

// Rows of the tile that streams through the ring: q rows in the dK/dV pass,
// keys in the dQ pass.
template <int D>
__host__ __device__ constexpr int stream_rows() { return D == 64 ? 64 : 32; }

template <typename T>
struct Params {
  const __nv_bfloat16* q;   // scale * rope(q), [B, H, S, D] contiguous
  const __nv_bfloat16* k;   // rope(k)
  const __nv_bfloat16* v;
  const __nv_bfloat16* dO;
  const float* lse;         // [B, H, S]
  const float* delta;       // [B, H, S]
  const T* sin_tab;         // [S, D] or null
  const T* cos_tab;
  T* dq;
  T* dk;
  T* dv;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int S, H, n_valid;
  float scale;
};

// delta[b, h, s] = sum_d do*o in f32, from the input type.  D/8 lanes per
// row, each summing 8 elements, then a shuffle reduction.
template <int D, typename T>
__global__ void delta_kernel(const T* o, int64_t o_sb, int64_t o_sh,
                             int64_t o_ss, const T* dO, int64_t do_sb,
                             int64_t do_sh, int64_t do_ss, float* delta, int H,
                             int S, int64_t rows) {
  constexpr int G = D / 8;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = u / G;
  const int c = static_cast<int>(u % G);
  float acc = 0.f;
  if (row < rows) {
    const int s = static_cast<int>(row % S);
    const int64_t bh = row / S, b = bh / H, h = bh % H;
    float a[8], d[8];
    load8(o + b * o_sb + h * o_sh + s * o_ss + c * 8, a);
    load8(dO + b * do_sb + h * do_sh + s * do_ss + c * 8, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(a[j], d[j], acc);
  }
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && c == 0) delta[row] = acc;
}

// Write a warp's 16 x D f32 accumulator tile (rows r0 + g, r0 + g + 8) to
// out[row, :] through its row stride, after `scale` and, with tables, the
// inverse rotation R^T(y) = y*cos - rotate_half(y)*sin of each row.  Rows at
// or past S are not written.
template <int D, typename T>
__device__ __forceinline__ void store_rows(float acc[D / 8][4], T* out,
                                           int64_t ss, int r0, int S,
                                           const T* sin_tab, const T* cos_tab,
                                           float scale, int g, int t) {
  constexpr int DT = D / 8, HT = D / 16;  // HT: column tiles per half
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    if (r >= S) continue;
    float y[DT][2];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      y[dt][0] = acc[dt][2 * hr] * scale;
      y[dt][1] = acc[dt][2 * hr + 1] * scale;
    }
    if (sin_tab != nullptr) {
      const int64_t tr = static_cast<int64_t>(r) * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < HT; ++dt) {
        const float2 cl = load2(cos_tab + tr + dt * 8);
        const float2 sl = load2(sin_tab + tr + dt * 8);
        const float2 ch = load2(cos_tab + tr + (dt + HT) * 8);
        const float2 sh = load2(sin_tab + tr + (dt + HT) * 8);
        const float l0 = y[dt][0], l1 = y[dt][1];
        const float h0 = y[dt + HT][0], h1 = y[dt + HT][1];
        // rotate_half(y) = [-y_hi, y_lo]
        y[dt][0] = l0 * cl.x + h0 * sl.x;
        y[dt][1] = l1 * cl.y + h1 * sl.y;
        y[dt + HT][0] = h0 * ch.x - l0 * sh.x;
        y[dt + HT][1] = h1 * ch.y - l1 * sh.y;
      }
    }
    T* orow = out + r * ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) store2(orow + dt * 8, y[dt][0], y[dt][1]);
  }
}

template <int D>
constexpr int dkdv_smem_bytes() {
  constexpr int LD = D + 8, BN = stream_rows<D>();
  return (2 * BR * LD + 4 * BN * LD) * 2 + 4 * BN * 4;
}

// dK/dV pass: grid (ceil(S/BR), H, B).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const Params<T> p) {
  constexpr int LD = D + 8;             // padded shared row: conflict-free ldmatrix
  constexpr int BN = stream_rows<D>();  // q rows per streamed tile
  constexpr int KSTEPS = D / 16;        // k-steps of K Q^T and V dO^T
  constexpr int NT = BN / 8;            // 8-query column tiles of s^T
  constexpr int DT = D / 8;             // 8-wide column tiles of dK, dV
  // Layout: K tile, V tile (BR rows each), then ring stage i at
  // ring + i*2*BN*LD holding q then do; lse/delta of stage i after them.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BR * LD;
  __nv_bfloat16* ring = Vs + BR * LD;
  float* stats = reinterpret_cast<float*>(ring + 4 * BN * LD);  // [2][2][BN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int kw = k0 + warp * 16;        // this warp's first key
  T* dkb = p.dk + b * p.dk_sb + h * p.dk_sh;
  T* dvb = p.dv + b * p.dv_sb + h * p.dv_sh;

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  if (k0 < p.n_valid) {
    const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dob = p.dO + b * p.do_sb + h * p.do_sh;
    const int64_t bh = static_cast<int64_t>(b) * p.H + h;
    const float* lseb = p.lse + bh * p.S;
    const float* delb = p.delta + bh * p.S;
    const int n_qt = (p.S + BN - 1) / BN;

    load_rows_async<D, LD>(Ks, p.k + b * p.k_sb + h * p.k_sh, p.k_ss, k0, BR,
                           p.S, tid, THREADS);
    load_rows_async<D, LD>(Vs, p.v + b * p.v_sb + h * p.v_sh, p.v_ss, k0, BR,
                           p.S, tid, THREADS);
    auto load_stage = [&](int qt) {
      const int st = qt & 1, q0 = qt * BN;
      __nv_bfloat16* qs = ring + st * 2 * BN * LD;
      load_rows_async<D, LD>(qs, qb, p.q_ss, q0, BN, p.S, tid, THREADS);
      load_rows_async<D, LD>(qs + BN * LD, dob, p.do_ss, q0, BN, p.S, tid,
                             THREADS);
      float* sl = stats + st * 2 * BN;
      for (int i = tid; i < 2 * BN; i += THREADS) {
        const int r = q0 + (i % BN);
        const bool ok = r < p.S;
        cp_async4(sl + i, (i < BN ? lseb : delb) + (ok ? r : 0), ok);
      }
      cp_async_commit();
    };
    load_stage(0);
    const bool active = kw < p.n_valid;   // some of the warp's keys are real

    for (int qt = 0; qt < n_qt; ++qt) {
      if (qt + 1 < n_qt) {
        load_stage(qt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      if (active) {
        const int st = qt & 1;
        const __nv_bfloat16* Qs = ring + st * 2 * BN * LD;
        const __nv_bfloat16* dOs = Qs + BN * LD;
        const float* lse_s = stats + st * 2 * BN;
        const float* del_s = lse_s + BN;
        // s^T = K Q^T and dp^T = V dO^T for this warp's 16 keys x BN queries.
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
        const int arow = warp * 16 + (lane & 15), acol = (lane >> 4) * 8;
        const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t ka[4], va[4];
          ldmatrix_x4(ka, Ks + arow * LD + kk * 16 + acol);
          ldmatrix_x4(va, Vs + arow * LD + kk * 16 + acol);
#pragma unroll
          for (int nt = 0; nt < NT; nt += 2) {
            uint32_t f[4];
            ldmatrix_x4(f, Qs + (nt * 8 + brow) * LD + kk * 16 + bcol);
            mma_bf16(s[nt], ka, f[0], f[1]);
            mma_bf16(s[nt + 1], ka, f[2], f[3]);
            ldmatrix_x4(f, dOs + (nt * 8 + brow) * LD + kk * 16 + bcol);
            mma_bf16(dp[nt], va, f[0], f[1]);
            mma_bf16(dp[nt + 1], va, f[2], f[3]);
          }
        }
        // p^T and ds^T in place: element (key kw+g(+8), query q0+nt*8+2t(+1)).
        const bool key0 = kw + g < p.n_valid, key1 = kw + g + 8 < p.n_valid;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + 2 * t + (e & 1);
            const bool real = e < 2 ? key0 : key1;
            const float pe = real ? exp2_approx(fmaf(s[nt][e], LOG2E, -lse_s[c] * LOG2E)) : 0.f;
            s[nt][e] = pe;
            dp[nt][e] = pe * (dp[nt][e] - del_s[c]);
          }
        }
        // dV += p^T dO and dK += ds^T (scale Rq): tiles 2j, 2j+1 of the
        // accumulators are the A operand of query step j.
        const int trow = lane & 15, tcol = (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          const uint32_t pa[4] = {
              pack_bf16(s[2 * j][0], s[2 * j][1]),
              pack_bf16(s[2 * j][2], s[2 * j][3]),
              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
          const uint32_t da[4] = {
              pack_bf16(dp[2 * j][0], dp[2 * j][1]),
              pack_bf16(dp[2 * j][2], dp[2 * j][3]),
              pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
              pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
          const __nv_bfloat16* dor = dOs + (j * 16 + trow) * LD + tcol;
          const __nv_bfloat16* qr = Qs + (j * 16 + trow) * LD + tcol;
#pragma unroll
          for (int dt = 0; dt < DT; dt += 2) {
            uint32_t f[4];
            ldmatrix_x4_trans(f, dor + dt * 8);
            mma_bf16(dv[dt], pa, f[0], f[1]);
            mma_bf16(dv[dt + 1], pa, f[2], f[3]);
            ldmatrix_x4_trans(f, qr + dt * 8);
            mma_bf16(dk[dt], da, f[0], f[1]);
            mma_bf16(dk[dt + 1], da, f[2], f[3]);
          }
        }
      }
      __syncthreads();  // this stage is refilled by the next iteration's copy
    }
  }
  // dk = R^T(ds^T (scale Rq)) with the key rows' tables; dv = p^T dO.  Keys
  // at or past n_valid hold exact zeros.
  store_rows<D, T>(dk, dkb, p.dk_ss, kw, p.S, p.sin_tab, p.cos_tab, 1.f, g, t);
  store_rows<D, T>(dv, dvb, p.dv_ss, kw, p.S, nullptr, nullptr, 1.f, g, t);
}

template <int D>
constexpr int dq_smem_bytes() {
  constexpr int LD = D + 8, BN = stream_rows<D>();
  return (2 * BR * LD + 4 * BN * LD) * 2;
}

// dQ pass: grid (ceil(S/BR), H, B).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const Params<T> p) {
  constexpr int LD = D + 8;
  constexpr int BN = stream_rows<D>();  // keys per streamed tile
  constexpr int KSTEPS = D / 16;
  constexpr int NT = BN / 8;            // 8-key column tiles of s
  constexpr int DT = D / 8;
  // Layout: q tile and do tile (BR rows each), then ring stage i at
  // ring + i*2*BN*LD holding K then V.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BR * LD;
  __nv_bfloat16* ring = dOs + BR * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int qw = q0 + warp * 16;        // this warp's first query row
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int n_kt = (p.n_valid + BN - 1) / BN;

  load_rows_async<D, LD>(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, BR,
                         p.S, tid, THREADS);
  load_rows_async<D, LD>(dOs, p.dO + b * p.do_sb + h * p.do_sh, p.do_ss, q0,
                         BR, p.S, tid, THREADS);
  cp_async_commit();
  load_rows_async<D, LD>(ring, kb, p.k_ss, 0, BN, p.S, tid, THREADS);
  load_rows_async<D, LD>(ring + BN * LD, vb, p.v_ss, 0, BN, p.S, tid, THREADS);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // q and do of this warp's 16 rows as A fragments, lse and delta per row.
  uint32_t qf[KSTEPS][4], df[KSTEPS][4];
  {
    const int arow = warp * 16 + (lane & 15), acol = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      ldmatrix_x4(qf[kk], Qs + arow * LD + kk * 16 + acol);
      ldmatrix_x4(df[kk], dOs + arow * LD + kk * 16 + acol);
    }
  }
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const int r0 = qw + g, r1 = r0 + 8;
  const float ls0 = r0 < p.S ? p.lse[bh * p.S + r0] * LOG2E : 0.f;
  const float ls1 = r1 < p.S ? p.lse[bh * p.S + r1] * LOG2E : 0.f;
  const float dl0 = r0 < p.S ? p.delta[bh * p.S + r0] : 0.f;
  const float dl1 = r1 < p.S ? p.delta[bh * p.S + r1] : 0.f;

  const bool active = qw < p.S;
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    if (kt + 1 < n_kt) {
      __nv_bfloat16* nxt = ring + ((kt + 1) & 1) * 2 * BN * LD;
      load_rows_async<D, LD>(nxt, kb, p.k_ss, k0 + BN, BN, p.S, tid, THREADS);
      load_rows_async<D, LD>(nxt + BN * LD, vb, p.v_ss, k0 + BN, BN, p.S, tid,
                             THREADS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const __nv_bfloat16* Ks = ring + (kt & 1) * 2 * BN * LD;
      const __nv_bfloat16* Vs = Ks + BN * LD;
      // s = (scale Rq) Rk^T and dp = dO V^T for 16 rows x BN keys.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
      const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t f[4];
          ldmatrix_x4(f, Ks + (nt * 8 + brow) * LD + kk * 16 + bcol);
          mma_bf16(s[nt], qf[kk], f[0], f[1]);
          mma_bf16(s[nt + 1], qf[kk], f[2], f[3]);
          ldmatrix_x4(f, Vs + (nt * 8 + brow) * LD + kk * 16 + bcol);
          mma_bf16(dp[nt], df[kk], f[0], f[1]);
          mma_bf16(dp[nt + 1], df[kk], f[2], f[3]);
        }
      }
      // ds = p (dp - delta), p = exp(s - lse), 0 on key columns >= n_valid.
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool real = k0 + nt * 8 + 2 * t + (e & 1) < p.n_valid;
          const float pe = real ? exp2_approx(fmaf(s[nt][e], LOG2E, e < 2 ? -ls0 : -ls1)) : 0.f;
          dp[nt][e] = pe * (dp[nt][e] - (e < 2 ? dl0 : dl1));
        }
      }
      // dQ += ds Rk: ds tiles 2j, 2j+1 form the A operand of key step j.
      const int trow = lane & 15, tcol = (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const uint32_t da[4] = {
            pack_bf16(dp[2 * j][0], dp[2 * j][1]),
            pack_bf16(dp[2 * j][2], dp[2 * j][3]),
            pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
            pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
        const __nv_bfloat16* kr = Ks + (j * 16 + trow) * LD + tcol;
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t f[4];
          ldmatrix_x4_trans(f, kr + dt * 8);
          mma_bf16(acc[dt], da, f[0], f[1]);
          mma_bf16(acc[dt + 1], da, f[2], f[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }
  if (!active) return;
  // dq = R^T(scale * ds Rk) with the q rows' tables.
  store_rows<D, T>(acc, p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, qw, p.S,
                   p.sin_tab, p.cos_tab, p.scale, g, t);
}

template <int D, typename T>
int launch(Params<T> p, int B, const T* q, const int64_t qs[3], const T* k,
           const int64_t ks[3], const T* v, const int64_t vs[3], const T* o,
           const int64_t os[3], const T* dO, const int64_t dos[3], void* qbuf,
           void* kbuf, void* vbuf, void* dobuf, float* delta,
           cudaStream_t st) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int64_t sb = static_cast<int64_t>(p.H) * p.S * D, sh = static_cast<int64_t>(p.S) * D;
  const int64_t rows = static_cast<int64_t>(B) * p.H * p.S;
  {  // delta = rowsum(do * o)
    const int64_t threads = rows * (D / 8), blocks = (threads + 255) / 256;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    delta_kernel<D, T><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        o, os[0], os[1], os[2], dO, dos[0], dos[1], dos[2], delta, p.H, p.S,
        rows);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  p.delta = delta;
  // scale * rope(q) always; rope(k) with RoPE or f32; v and do with f32
  int err = stage<D, T>(q, qs[0], qs[1], qs[2], p.sin_tab, p.cos_tab, p.scale,
                        qbuf, B, p.H, p.S, st);
  if (err != 0) return err;
  p.q = static_cast<const __nv_bfloat16*>(qbuf);
  p.q_sb = sb; p.q_sh = sh; p.q_ss = D;
  if (p.sin_tab != nullptr || kF32) {
    err = stage<D, T>(k, ks[0], ks[1], ks[2], p.sin_tab, p.cos_tab, 1.f, kbuf,
                      B, p.H, p.S, st);
    if (err != 0) return err;
    p.k = static_cast<const __nv_bfloat16*>(kbuf);
    p.k_sb = sb; p.k_sh = sh; p.k_ss = D;
  } else {
    p.k = reinterpret_cast<const __nv_bfloat16*>(k);
    p.k_sb = ks[0]; p.k_sh = ks[1]; p.k_ss = ks[2];
  }
  if (kF32) {
    err = stage<D, T>(v, vs[0], vs[1], vs[2], nullptr, nullptr, 1.f, vbuf, B,
                      p.H, p.S, st);
    if (err != 0) return err;
    err = stage<D, T>(dO, dos[0], dos[1], dos[2], nullptr, nullptr, 1.f, dobuf,
                      B, p.H, p.S, st);
    if (err != 0) return err;
    p.v = static_cast<const __nv_bfloat16*>(vbuf);
    p.v_sb = sb; p.v_sh = sh; p.v_ss = D;
    p.dO = static_cast<const __nv_bfloat16*>(dobuf);
    p.do_sb = sb; p.do_sh = sh; p.do_ss = D;
  } else {
    p.v = reinterpret_cast<const __nv_bfloat16*>(v);
    p.v_sb = vs[0]; p.v_sh = vs[1]; p.v_ss = vs[2];
    p.dO = reinterpret_cast<const __nv_bfloat16*>(dO);
    p.do_sb = dos[0]; p.do_sh = dos[1]; p.do_ss = dos[2];
  }
  const dim3 grid((p.S + BR - 1) / BR, p.H, B);
  // both kernels need more than the default 48 KB of dynamic shared memory
  constexpr int smem_kv = dkdv_smem_bytes<D>(), smem_q = dq_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkdv_kernel<D, T><<<grid, THREADS, smem_kv, st>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  e = cudaFuncSetAttribute(attn_bwd_dq_kernel<D, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dq_kernel<D, T><<<grid, THREADS, smem_q, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* const* ptr, const int64_t* const* strides, int B,
             int H, int S, int D, int n_valid, float scale, cudaStream_t st) {
  // ptr: q k v o do lse sin cos qbuf kbuf vbuf dobuf delta dq dk dv
  // strides: q k v o do dq dk dv, each (b, h, s)
  Params<T> p;
  p.lse = static_cast<const float*>(ptr[5]);
  p.sin_tab = static_cast<const T*>(ptr[6]);
  p.cos_tab = static_cast<const T*>(ptr[7]);
  p.dq = static_cast<T*>(const_cast<void*>(ptr[13]));
  p.dk = static_cast<T*>(const_cast<void*>(ptr[14]));
  p.dv = static_cast<T*>(const_cast<void*>(ptr[15]));
  p.dq_sb = strides[5][0]; p.dq_sh = strides[5][1]; p.dq_ss = strides[5][2];
  p.dk_sb = strides[6][0]; p.dk_sh = strides[6][1]; p.dk_ss = strides[6][2];
  p.dv_sb = strides[7][0]; p.dv_sh = strides[7][1]; p.dv_ss = strides[7][2];
  p.S = S; p.H = H; p.n_valid = n_valid; p.scale = scale;
  const T* q = static_cast<const T*>(ptr[0]);
  const T* k = static_cast<const T*>(ptr[1]);
  const T* v = static_cast<const T*>(ptr[2]);
  const T* o = static_cast<const T*>(ptr[3]);
  const T* dO = static_cast<const T*>(ptr[4]);
  void* qbuf = const_cast<void*>(ptr[8]);
  void* kbuf = const_cast<void*>(ptr[9]);
  void* vbuf = const_cast<void*>(ptr[10]);
  void* dobuf = const_cast<void*>(ptr[11]);
  float* delta = static_cast<float*>(const_cast<void*>(ptr[12]));
  if (D == 64)
    return launch<64, T>(p, B, q, strides[0], k, strides[1], v, strides[2], o,
                         strides[3], dO, strides[4], qbuf, kbuf, vbuf, dobuf,
                         delta, st);
  if (D == 128)
    return launch<128, T>(p, B, q, strides[0], k, strides[1], v, strides[2], o,
                          strides[3], dO, strides[4], qbuf, kbuf, vbuf, dobuf,
                          delta, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device addresses; strides are in
// elements (b, h, s order), and the last (D) stride of every [B,N,H,D]
// tensor is 1.  `dtype` is the element type of q/k/v/o/do/dq/dk/dv and the
// tables: 0 = bf16, 1 = f32.  Scratch, all [B, H, S, D] bf16 contiguous:
// `qbuf` always; `kbuf` with RoPE (sin_tab, cos_tab non-null) or f32; `vbuf`
// and `dobuf` with f32.  `delta` is [B, H, S] f32 scratch.  Launches on
// `stream` without synchronising and returns the first cudaError_t met
// (0 = success).
extern "C" int ever_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, const void* sin_tab, const void* cos_tab,
    void* qbuf, void* kbuf, void* vbuf, void* dobuf, void* delta, void* dq,
    void* dk, void* dv, int dtype, int B, int H, int S, int D, int n_valid,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    float scale, void* stream) {
  if (B < 1 || H < 1 || S < 1 || n_valid < 1 || n_valid > S ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1) ||
      (sin_tab == nullptr) != (cos_tab == nullptr) || qbuf == nullptr ||
      delta == nullptr ||
      ((sin_tab != nullptr || dtype == 1) && kbuf == nullptr) ||
      (dtype == 1 && (vbuf == nullptr || dobuf == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptr[16] = {q, k, v, o, dO, lse, sin_tab, cos_tab,
                         qbuf, kbuf, vbuf, dobuf, delta, dq, dk, dv};
  const int64_t sq[3] = {q_sb, q_sh, q_ss}, sk[3] = {k_sb, k_sh, k_ss};
  const int64_t sv[3] = {v_sb, v_sh, v_ss}, so[3] = {o_sb, o_sh, o_ss};
  const int64_t sdo[3] = {do_sb, do_sh, do_ss}, sdq[3] = {dq_sb, dq_sh, dq_ss};
  const int64_t sdk[3] = {dk_sb, dk_sh, dk_ss}, sdv[3] = {dv_sb, dv_sh, dv_ss};
  const int64_t* strides[8] = {sq, sk, sv, so, sdo, sdq, sdk, sdv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(ptr, strides, B, H, S, D, n_valid, scale, st);
  return dispatch<float>(ptr, strides, B, H, S, D, n_valid, scale, st);
}
