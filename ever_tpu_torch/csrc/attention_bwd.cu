// Non-causal multi-head attention backward (K2) for Hopper (sm_90a),
// hand-written.
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
// 3.35 TB/s.  Compute bounds it, so every product runs on the tensor cores
// as ``wgmma`` fed by TMA, and the score tiles stay in registers.
//
// Design.  The TPU kernel keeps a head's whole K/V and f32 dK/dV
// accumulators in VMEM and carries them across its sequential q-block grid
// dimension.  Hopper blocks run in parallel and in no order, so three
// launches:
// - one prologue launch writes bf16 copies of scale*rope(q) and, with RoPE
//   or f32 inputs, rope(k) (and of v and do from f32 inputs), and a padded
//   f32 [B, H, 2, S_pad] table of lse*log2(e) and delta = rowsum(do*o), zero
//   on the pad rows, so that TMA can fetch both for any q tile;
// - dK/dV pass: one CTA per (b, h, 128 keys) of two consumer warpgroups (64
//   keys each, 240 registers a thread by ``setmaxnreg``) and a producer
//   warpgroup (24).  One producer thread loads the K and V tiles once and
//   streams (q, do, lse, delta) tiles through a 4-stage TMA ring (128-byte
//   swizzled, rows past S zero-filled).  Each warpgroup computes the
//   TRANSPOSED tiles s^T = K Q^T and dp^T = V dO^T with ``wgmma`` from
//   shared memory (both operands K-major), so that p^T and ds^T come out of
//   the accumulators in the register layout of wgmma's A operand: dV += p^T
//   dO and dK += ds^T Rq then read A from registers and B (dO, Q) MN-major
//   from the same stage.  p and ds never go through shared memory.  The four
//   products are four wgmma groups, overlapped with the element-wise work
//   (p^T while dp^T runs, ds^T while dV runs, dK while the next tile's s^T
//   and dp^T start).  The epilogue inverse-rotates dK with the key rows'
//   tables.
// - dQ pass: one CTA per (b, h, 128 q rows), the same roles, streaming (K, V)
//   tiles: s = Q K^T and dp = dO V^T from shared memory, then dQ += ds K with
//   ds from registers.  It repeats two of the five products (s and dp)
//   rather than adding dq across CTAs with f32 atomics: the same inputs give
//   the same bits, and no f32 accumulator, zeroing or convert pass is
//   needed.
//   The epilogue scales and inverse-rotates dQ.
// - ptxas serializes a warpgroup's wgmmas (its C7514-C7520 notes) when a
//   branch parts the warpgroup's threads around them, or when other
//   instructions read or write an accumulator while its wgmma may run:
//   hence no per-warpgroup branches, predicated barrier arrivals, and
//   register fences that keep each register's class.  Serialized, the two
//   passes took 0.262 and 0.177 ms at the main shape; unserialized, 0.198
//   and 0.134 (H100 SXM).
// - key tiles wholly at or past n_valid are skipped (their p is 0, so their
//   dk and dv are written as exact zeros); rows past S are zero-filled by
//   TMA, which makes their p exactly 1 against zero do, q rows and stats, so
//   they add exactly 0, and they are never written.
// Tiles at head dim 64: 128 keys and 64-row q tiles (dK/dV), 128 q rows and
// 64-key tiles (dQ); at head dim 128 the streamed tiles are 32 rows, to keep
// the f32 accumulators in registers.  At S = 1029 the last 128-row tile holds
// 5 real rows: its second warpgroup is idle and the first computes 59 rows
// of zero fill, so each pass does 5.7 % more work along each of its two
// sequence axes than S needs (about 12 % more MMA work in all).

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CONSUMER_WARPS = 8;                    // two warpgroups
constexpr int THREADS = CONSUMER_WARPS * 32 + 128;   // + a producer warpgroup
constexpr int TILE = 128;                            // rows a CTA owns
constexpr int STAGES = 4;
constexpr int STATS_PAD = 64;                        // S_pad = S rounded up

// Rows of the tile that streams through the ring: q rows in the dK/dV
// pass, keys in the dQ pass.
template <int D>
__host__ __device__ constexpr int stream_rows() { return D == 64 ? 64 : 32; }

// A [rows][D] bf16 tile in shared memory is D/64 column blocks of
// [rows][64] (128-byte rows, swizzled), one after the other.
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * D * 2; }

// wgmma with N = 32 or 64 output columns, A and B from shared memory, both
// K-major.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_bf16_ss_n64(d, a, b, scale_d);
  else wgmma_bf16_ss_n32(d, a, b, scale_d);
}

// wgmma with N = D output columns, A from registers, B MN-major.
template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                       uint64_t b) {
  if constexpr (D == 64) wgmma_bf16_rs_n64(d, a, b, 1);
  else wgmma_bf16_rs_n128(d, a, b, 1);
}

// C[64 x N] = A[64 x D] B[N x D]^T over the head dim: `a` rows of this
// warpgroup in a tile of `a_rows`, `b` a tile of N rows; both K-major.
template <int D, int N>
__device__ __forceinline__ void mma_over_d(float (&c)[N / 2],
                                           const unsigned char* a, int a_rows,
                                           const unsigned char* b) {
  const uint64_t da = desc_kmajor(a), db = desc_kmajor(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // column block kk/4, then 32 bytes (2 units of 16) per k16 step
    const uint64_t off_a = (kk / 4) * (a_rows * 128 / 16) + 2 * (kk % 4);
    const uint64_t off_b = (kk / 4) * (N * 128 / 16) + 2 * (kk % 4);
    mma_ss<N>(c, da + off_a, db + off_b, kk > 0);
  }
}

// The A fragment of k16 chunk c from an m64 accumulator: columns 16c..16c+15
// of rows g and g+8, rounded to bf16.
template <int NREG>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&acc)[NREG],
                                       int c) {
  a[0] = pack_bf16(acc[8 * c + 0], acc[8 * c + 1]);
  a[1] = pack_bf16(acc[8 * c + 2], acc[8 * c + 3]);
  a[2] = pack_bf16(acc[8 * c + 4], acc[8 * c + 5]);
  a[3] = pack_bf16(acc[8 * c + 6], acc[8 * c + 7]);
}

template <typename T>
struct Params {
  const T* sin_tab;         // [S, D] or null
  const T* cos_tab;
  const float* stats;       // [B, H, 2, S_pad]: lse*log2(e), delta
  T* dq;
  T* dk;
  T* dv;
  int64_t dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int S, S_pad, H, n_valid;
  float scale;
};

// Prologue, one thread per (row, chunk pair) over B*S_pad*H rows: stages
// bf16 scale*rope(q) into qbuf and, where given, rope(k), v and do into
// kbuf, vbuf and dobuf (all [B, H, S, D]); the row's D/16 threads sum do*o
// in f32 and write lse*log2(e) and delta into stats (zeros on pad rows).
template <int D, typename T>
struct Prologue {
  const T *q, *k, *v, *o, *dO, *sin_tab, *cos_tab;
  const float* lse;
  __nv_bfloat16 *qbuf, *kbuf, *vbuf, *dobuf;
  float* stats;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  int H, S, S_pad;
  int64_t units;
  float scale;
};

// Rows are taken in (b, s, h) order, the memory order of the [B, N, H, D]
// inputs (a warp reads whole runs of heads), and each thread issues all of
// its loads before any store.
template <int D, typename T>
__global__ void prologue_kernel(const Prologue<D, T> p) {
  constexpr int HALF = D / 16;                 // threads per row
  const int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool valid = u < p.units;
  const int64_t row = u / HALF;                // over B*S_pad*H
  const int c = static_cast<int>(u % HALF);
  const int h = static_cast<int>(row % p.H);
  const int64_t bs = row / p.H, b = bs / p.S_pad;
  const int s = static_cast<int>(bs % p.S_pad);
  const int64_t bh = b * p.H + h;
  const bool real = valid && s < p.S;
  const bool rope = p.sin_tab != nullptr;
  const int lo = c * 8, hi = (c + HALF) * 8;   // the thread's two 8-wide chunks
  float acc = 0.f;
  if (real) {
    float ol[8], oh[8], dl[8], dh[8], ql[8], qh[8], kl[8], kh[8];
    float cl[8], ch[8], sl[8], sh[8];
    const T* orow = p.o + b * p.o_sb + h * p.o_sh + s * p.o_ss;
    const T* drow = p.dO + b * p.do_sb + h * p.do_sh + s * p.do_ss;
    const T* qrow = p.q + b * p.q_sb + h * p.q_sh + s * p.q_ss;
    const T* krow = p.k + b * p.k_sb + h * p.k_sh + s * p.k_ss;
    const int64_t t = static_cast<int64_t>(s) * D;
    load8(orow + lo, ol);
    load8(orow + hi, oh);
    load8(drow + lo, dl);
    load8(drow + hi, dh);
    load8(qrow + lo, ql);
    load8(qrow + hi, qh);
    if (p.kbuf != nullptr) {
      load8(krow + lo, kl);
      load8(krow + hi, kh);
    }
    if (rope) {
      load8(p.cos_tab + t + lo, cl);
      load8(p.cos_tab + t + hi, ch);
      load8(p.sin_tab + t + lo, sl);
      load8(p.sin_tab + t + hi, sh);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(oh[j], dh[j], fmaf(ol[j], dl[j], acc));
    // rope(x) = x*cos + rotate_half(x)*sin, rotate_half(x) = [-x_hi, x_lo]
    float yl[8], yh[8];
    const int64_t dst = (bh * p.S + s) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      yl[j] = (rope ? ql[j] * cl[j] - qh[j] * sl[j] : ql[j]) * p.scale;
      yh[j] = (rope ? qh[j] * ch[j] + ql[j] * sh[j] : qh[j]) * p.scale;
    }
    *reinterpret_cast<uint4*>(p.qbuf + dst + lo) = pack8(yl);
    *reinterpret_cast<uint4*>(p.qbuf + dst + hi) = pack8(yh);
    if (p.kbuf != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        yl[j] = rope ? kl[j] * cl[j] - kh[j] * sl[j] : kl[j];
        yh[j] = rope ? kh[j] * ch[j] + kl[j] * sh[j] : kh[j];
      }
      *reinterpret_cast<uint4*>(p.kbuf + dst + lo) = pack8(yl);
      *reinterpret_cast<uint4*>(p.kbuf + dst + hi) = pack8(yh);
    }
    if (p.vbuf != nullptr) {                   // f32 inputs: v and do in bf16
      const T* vrow = p.v + b * p.v_sb + h * p.v_sh + s * p.v_ss;
      load8(vrow + lo, yl);
      load8(vrow + hi, yh);
      *reinterpret_cast<uint4*>(p.vbuf + dst + lo) = pack8(yl);
      *reinterpret_cast<uint4*>(p.vbuf + dst + hi) = pack8(yh);
      *reinterpret_cast<uint4*>(p.dobuf + dst + lo) = pack8(dl);
      *reinterpret_cast<uint4*>(p.dobuf + dst + hi) = pack8(dh);
    }
  }
#pragma unroll
  for (int m = HALF / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (valid && c == 0) {
    float* st = p.stats + bh * 2 * p.S_pad + s;
    st[0] = real ? p.lse[bh * p.S + s] * LOG2E : 0.f;
    st[p.S_pad] = real ? acc : 0.f;
  }
}

// Write a warp's 16 x D f32 accumulator tile (rows r0 + g, r0 + g + 8) to
// out[row, :] through its row stride, after `scale` and, with tables, the
// inverse rotation R^T(y) = y*cos - rotate_half(y)*sin of each row.  Rows at
// or past S are not written.  The m64 wgmma accumulator of a warp has the
// layout of acc[D/8][4] (columns 8j + 2t, +1; rows g, g + 8).
template <int D, typename T>
__device__ __forceinline__ void store_rows(const float (&flat)[D / 2], T* out,
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
      y[dt][0] = flat[4 * dt + 2 * hr] * scale;
      y[dt][1] = flat[4 * dt + 2 * hr + 1] * scale;
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

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int D>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  return 2 * tile_bytes<D>(stream_rows<D>()) + 1024;
}

template <int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  return 2 * tile_bytes<D>(TILE) + STAGES * dkdv_stage_bytes<D>() + 1024 + 1024;
}

// Load a [rows][D] tile (D/64 boxes of 64 columns) of a [B, H, S, D] map at
// sequence row s0 of head (b, h).
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int s0, int h,
                                          int b) {
#pragma unroll
  for (int blk = 0; blk < D / 64; ++blk)
    tma_load_4d(dst + blk * rows * 128, map, bar, blk * 64, s0, h, b);
}

// dK/dV pass: grid (ceil(S/128), H, B).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_stats,
                     const Params<T> p) {
  constexpr int BQ = stream_rows<D>();          // q rows per streamed tile
  constexpr int NQ = BQ / 2;                    // s^T registers a thread
  constexpr int STAGE = dkdv_stage_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + tile_bytes<D>(TILE);
  unsigned char* ring = sV + tile_bytes<D>(TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_bar = empty + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const bool cta_active = k0 < p.n_valid;
  const int n_qt = (p.S + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {                // producer warpgroup
    setmaxnreg_dec<24>();
    if (warp == CONSUMER_WARPS && lane == 0 && cta_active) {
      mbar_expect_tx(kv_bar, 2 * tile_bytes<D>(TILE));
      load_tile<D>(sK, &map_k, kv_bar, TILE, k0, h, b);
      load_tile<D>(sV, &map_v, kv_bar, TILE, k0, h, b);
      for (int qt = 0; qt < n_qt; ++qt) {
        const int st = qt % STAGES;
        unsigned char* stage = ring + st * STAGE;
        mbar_wait(&empty[st], ((qt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * tile_bytes<D>(BQ) + 2 * BQ * 4);
        load_tile<D>(stage, &map_q, &full[st], BQ, qt * BQ, h, b);
        load_tile<D>(stage + tile_bytes<D>(BQ), &map_do, &full[st], BQ, qt * BQ, h, b);
        tma_load_2d(stage + 2 * tile_bytes<D>(BQ), &map_stats, &full[st], qt * BQ,
                    2 * (b * p.H + h));
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int kw = k0 + wg * 64 + (warp & 3) * 16;  // this warp's first key
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (cta_active) {
    // a warpgroup whose keys all lie at or past n_valid runs the same code
    // (its p is 0, so dk and dv stay 0): no branch may part a warpgroup's
    // threads around its wgmma pipeline, or ptxas serializes the wgmmas
    const bool key0 = kw + g < p.n_valid, key1 = kw + g + 8 < p.n_valid;
    const unsigned char* kt = sK + wg * 64 * 128;
    const unsigned char* vt = sV + wg * 64 * 128;
    mbar_wait(kv_bar, 0);
    // One q tile's products in four wgmma groups, overlapped with the
    // element-wise work: s^T, dp^T; then p^T while dp^T runs, dV while ds^T
    // is formed, and dK while the next tile's s^T and dp^T start.
    float s[NQ], dp[NQ];
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];   // p^T, ds^T as A fragments
    for (int qt = 0; qt < n_qt; ++qt) {
      const int st = qt % STAGES;
      const unsigned char* Qs = ring + st * STAGE;
      const unsigned char* dOs = Qs + tile_bytes<D>(BQ);
      const float* lse_s = reinterpret_cast<const float*>(dOs + tile_bytes<D>(BQ));
      const float* del_s = lse_s + BQ;
      mbar_wait(&full[st], (qt / STAGES) & 1);
      // s^T = K Q^T and dp^T = V dO^T for the warpgroup's 64 keys x BQ queries
      wgmma_fence();
      mma_over_d<D, BQ>(s, kt, TILE, Qs);
      wgmma_commit();
      wgmma_fence();
      mma_over_d<D, BQ>(dp, vt, TILE, dOs);
      wgmma_commit();
      wgmma_wait<2>();                   // the previous tile's dV and dK are done
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(&empty[(qt + STAGES - 1) % STAGES], qt > 0 && lane == 0);
      wgmma_wait<1>();                   // s^T is done
      fence_regs(s);
      // p^T in place: element 4j+e is (key g (+8 for e >= 2), query
      // 8j + 2t + (e & 1))
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool real = e < 2 ? key0 : key1;
          s[4 * j + e] = real ? exp2_approx(fmaf(s[4 * j + e], LOG2E,
                                                 -((e & 1) ? ls.y : ls.x)))
                              : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) a_frag(pa[c], s, c);
      // dV += p^T dO: A from registers, one k16 chunk of queries at a time;
      // B MN-major, 16 q rows = 2048 bytes
      wgmma_fence();
      fence_regs(dv);
      const uint64_t ddo = desc_mnmajor(dOs, BQ * 128);
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) mma_rs<D>(dv, pa[c], ddo + 128 * c);
      wgmma_commit();
      wgmma_wait<1>();                   // dp^T is done
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(del_s + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) a_frag(da[c], dp, c);
      // dK += ds^T (scale Rq)
      wgmma_fence();
      fence_regs(dk);
      const uint64_t dq_ = desc_mnmajor(Qs, BQ * 128);
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) mma_rs<D>(dk, da[c], dq_ + 128 * c);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(&empty[(n_qt - 1) % STAGES], lane == 0);
  }
  // dk = R^T(ds^T (scale Rq)) with the key rows' tables; dv = p^T dO.  Keys
  // at or past n_valid hold exact zeros.
  store_rows<D, T>(dk, p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_ss, kw, p.S,
                   p.sin_tab, p.cos_tab, 1.f, g, t);
  store_rows<D, T>(dv, p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_ss, kw, p.S,
                   nullptr, nullptr, 1.f, g, t);
}

template <int D>
__host__ __device__ constexpr int dq_stage_bytes() {
  return 2 * tile_bytes<D>(stream_rows<D>());
}

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 2 * tile_bytes<D>(TILE) + STAGES * dq_stage_bytes<D>() + 1024 + 1024;
}

// dQ pass: grid (ceil(S/128), H, B).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const Params<T> p) {
  constexpr int BKV = stream_rows<D>();         // keys per streamed tile
  constexpr int NK = BKV / 2;
  constexpr int STAGE = dq_stage_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sdO = sQ + tile_bytes<D>(TILE);
  unsigned char* ring = sdO + tile_bytes<D>(TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int n_kt = (p.n_valid + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {                // producer warpgroup
    setmaxnreg_dec<24>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(q_bar, 2 * tile_bytes<D>(TILE));
      load_tile<D>(sQ, &map_q, q_bar, TILE, q0, h, b);
      load_tile<D>(sdO, &map_do, q_bar, TILE, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % STAGES;
        unsigned char* stage = ring + st * STAGE;
        mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * tile_bytes<D>(BKV));
        load_tile<D>(stage, &map_k, &full[st], BKV, kt * BKV, h, b);
        load_tile<D>(stage + tile_bytes<D>(BKV), &map_v, &full[st], BKV, kt * BKV, h, b);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int qw = q0 + wg * 64 + (warp & 3) * 16;  // this warp's first q row
  // a warpgroup whose rows all lie past S runs the same code on zero rows
  // (no branch may part a warpgroup's threads around its wgmma pipeline)
  // and writes nothing
  mbar_wait(q_bar, 0);
  const int64_t sb = (static_cast<int64_t>(b) * p.H + h) * 2 * p.S_pad;
  const int r0 = qw + g, r1 = r0 + 8;
  const float ls0 = r0 < p.S ? p.stats[sb + r0] : 0.f;
  const float ls1 = r1 < p.S ? p.stats[sb + r1] : 0.f;
  const float dl0 = r0 < p.S ? p.stats[sb + p.S_pad + r0] : 0.f;
  const float dl1 = r1 < p.S ? p.stats[sb + p.S_pad + r1] : 0.f;
  const unsigned char* qt = sQ + wg * 64 * 128;
  const unsigned char* dot = sdO + wg * 64 * 128;

  // One key tile's products in three wgmma groups: s, dp (p is formed while
  // dp runs), then dQ, waited for within the tile.  Letting dQ run on into
  // the next tile's s and dp, as the dK/dV pass does with dK, makes ptxas
  // serialize this pass's wgmmas (0.163 against 0.134 ms at B=8, H=16,
  // S=1029, D=64 on an H100 SXM).
  float acc[D / 2], s[NK], dp[NK];
  uint32_t da[BKV / 16][4];                      // ds as A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES;
    const int k0 = kt * BKV;
    const unsigned char* Ks = ring + st * STAGE;
    const unsigned char* Vs = Ks + tile_bytes<D>(BKV);
    mbar_wait(&full[st], (kt / STAGES) & 1);
    // s = (scale Rq) Rk^T and dp = dO V^T for 64 rows x BKV keys
    wgmma_fence();
    mma_over_d<D, BKV>(s, qt, TILE, Ks);
    wgmma_commit();
    wgmma_fence();
    mma_over_d<D, BKV>(dp, dot, TILE, Vs);
    wgmma_commit();
    wgmma_wait<1>();                     // s is done
    fence_regs(s);
    // p = exp(s - lse), 0 on key columns >= n_valid
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool real = k0 + 8 * j + 2 * t + (e & 1) < p.n_valid;
        s[4 * j + e] = real ? exp2_approx(fmaf(s[4 * j + e], LOG2E,
                                               e < 2 ? -ls0 : -ls1))
                            : 0.f;
      }
    }
    wgmma_wait<0>();                     // dp is done
    fence_regs(dp);
    // ds = p (dp - delta)
#pragma unroll
    for (int i = 0; i < NK; ++i)
      dp[i] = s[i] * (dp[i] - ((i & 2) ? dl1 : dl0));
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) a_frag(da[c], dp, c);
    // dQ += ds Rk: A from registers, B = the K tile MN-major
    wgmma_fence();
    fence_regs(acc);
    const uint64_t dk_ = desc_mnmajor(Ks, BKV * 128);
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) mma_rs<D>(acc, da[c], dk_ + 128 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    mbar_arrive(&empty[st], lane == 0);  // the stage may be refilled
  }
  // dq = R^T(scale * ds Rk) with the q rows' tables.
  store_rows<D, T>(acc, p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, qw, p.S,
                   p.sin_tab, p.cos_tab, p.scale, g, t);
}

// A [B, H, S, D] bf16 tensor map with boxes of 64 columns x `rows` rows,
// from strides in elements; a size-1 dim gets a nominal 16-byte stride.
int seq_map(CUtensorMap* map, const void* base, int B, int H, int S, int D,
            int64_t sb, int64_t sh, int64_t ss, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(S > 1 ? ss * 2 : 16),
                               static_cast<uint64_t>(H > 1 ? sh * 2 : 16),
                               static_cast<uint64_t>(B > 1 ? sb * 2 : 16)};
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                         strides, box, true);
}

struct Strided {
  const void* ptr;
  int64_t sb, sh, ss;
};

template <int D, typename T>
int launch(Params<T> p, Prologue<D, T> pro, int B, Strided q, Strided k,
           Strided v, Strided dO, cudaStream_t st) {
  {  // prologue: staged copies and the stats table, one launch
    const int64_t blocks = (pro.units + 255) / 256;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    prologue_kernel<D, T><<<static_cast<unsigned>(blocks), 256, 0, st>>>(pro);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  constexpr int BS = stream_rows<D>();
  CUtensorMap kv_k, kv_v, kv_q, kv_do, kv_stats, dq_q, dq_do, dq_k, dq_v;
  const int H = p.H, S = p.S;
  int err = 0;
  err = err ? err : seq_map(&kv_k, k.ptr, B, H, S, D, k.sb, k.sh, k.ss, TILE);
  err = err ? err : seq_map(&kv_v, v.ptr, B, H, S, D, v.sb, v.sh, v.ss, TILE);
  err = err ? err : seq_map(&kv_q, q.ptr, B, H, S, D, q.sb, q.sh, q.ss, BS);
  err = err ? err : seq_map(&kv_do, dO.ptr, B, H, S, D, dO.sb, dO.sh, dO.ss, BS);
  err = err ? err : seq_map(&dq_q, q.ptr, B, H, S, D, q.sb, q.sh, q.ss, TILE);
  err = err ? err : seq_map(&dq_do, dO.ptr, B, H, S, D, dO.sb, dO.sh, dO.ss, TILE);
  err = err ? err : seq_map(&dq_k, k.ptr, B, H, S, D, k.sb, k.sh, k.ss, BS);
  err = err ? err : seq_map(&dq_v, v.ptr, B, H, S, D, v.sb, v.sh, v.ss, BS);
  if (err == 0) {  // stats [B*H*2, S_pad] f32, boxes of BS x 2 rows (lse, delta)
    const uint64_t dims[2] = {static_cast<uint64_t>(p.S_pad),
                              static_cast<uint64_t>(B) * H * 2};
    const uint64_t strides[1] = {static_cast<uint64_t>(p.S_pad) * 4};
    const uint32_t box[2] = {static_cast<uint32_t>(BS), 2};
    err = make_tensor_map(&kv_stats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, p.stats,
                          dims, strides, box, false);
  }
  if (err != 0) return err;
  const dim3 grid((S + TILE - 1) / TILE, H, B);
  constexpr int smem_kv = dkdv_smem_bytes<D>(), smem_q = dq_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkdv_kernel<D, T><<<grid, THREADS, smem_kv, st>>>(
      kv_k, kv_v, kv_q, kv_do, kv_stats, p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  e = cudaFuncSetAttribute(attn_bwd_dq_kernel<D, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dq_kernel<D, T><<<grid, THREADS, smem_q, st>>>(dq_q, dq_do, dq_k,
                                                          dq_v, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int dispatch_d(const void* const* ptr, const int64_t* const* strides, int B,
               int H, int S, int n_valid, float scale, cudaStream_t st) {
  // ptr: q k v o do lse sin cos qbuf kbuf vbuf dobuf stats dq dk dv
  // strides: q k v o do dq dk dv, each (b, h, s)
  const int S_pad = (S + STATS_PAD - 1) / STATS_PAD * STATS_PAD;
  Params<T> p;
  p.sin_tab = static_cast<const T*>(ptr[6]);
  p.cos_tab = static_cast<const T*>(ptr[7]);
  p.stats = static_cast<const float*>(ptr[12]);
  p.dq = static_cast<T*>(const_cast<void*>(ptr[13]));
  p.dk = static_cast<T*>(const_cast<void*>(ptr[14]));
  p.dv = static_cast<T*>(const_cast<void*>(ptr[15]));
  p.dq_sb = strides[5][0]; p.dq_sh = strides[5][1]; p.dq_ss = strides[5][2];
  p.dk_sb = strides[6][0]; p.dk_sh = strides[6][1]; p.dk_ss = strides[6][2];
  p.dv_sb = strides[7][0]; p.dv_sh = strides[7][1]; p.dv_ss = strides[7][2];
  p.S = S; p.S_pad = S_pad; p.H = H; p.n_valid = n_valid; p.scale = scale;

  constexpr bool kF32 = sizeof(T) == 4;
  const bool rope = p.sin_tab != nullptr;
  Prologue<D, T> pro;
  pro.q = static_cast<const T*>(ptr[0]);
  pro.k = static_cast<const T*>(ptr[1]);
  pro.v = static_cast<const T*>(ptr[2]);
  pro.o = static_cast<const T*>(ptr[3]);
  pro.dO = static_cast<const T*>(ptr[4]);
  pro.lse = static_cast<const float*>(ptr[5]);
  pro.sin_tab = p.sin_tab;
  pro.cos_tab = p.cos_tab;
  pro.qbuf = static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[8]));
  pro.kbuf = (rope || kF32) ? static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[9])) : nullptr;
  pro.vbuf = kF32 ? static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[10])) : nullptr;
  pro.dobuf = kF32 ? static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[11])) : nullptr;
  pro.stats = const_cast<float*>(p.stats);
  pro.q_sb = strides[0][0]; pro.q_sh = strides[0][1]; pro.q_ss = strides[0][2];
  pro.k_sb = strides[1][0]; pro.k_sh = strides[1][1]; pro.k_ss = strides[1][2];
  pro.v_sb = strides[2][0]; pro.v_sh = strides[2][1]; pro.v_ss = strides[2][2];
  pro.o_sb = strides[3][0]; pro.o_sh = strides[3][1]; pro.o_ss = strides[3][2];
  pro.do_sb = strides[4][0]; pro.do_sh = strides[4][1]; pro.do_ss = strides[4][2];
  pro.H = H; pro.S = S; pro.S_pad = S_pad;
  pro.units = static_cast<int64_t>(B) * H * S_pad * (D / 16);
  pro.scale = scale;

  // what the main passes read: the staged copies, or the inputs themselves
  const int64_t sb = static_cast<int64_t>(H) * S * D, sh = static_cast<int64_t>(S) * D;
  const Strided staged_q = {pro.qbuf, sb, sh, D};
  const Strided k = pro.kbuf ? Strided{pro.kbuf, sb, sh, D}
                             : Strided{ptr[1], pro.k_sb, pro.k_sh, pro.k_ss};
  const Strided v = kF32 ? Strided{pro.vbuf, sb, sh, D}
                         : Strided{ptr[2], pro.v_sb, pro.v_sh, pro.v_ss};
  const Strided dO = kF32 ? Strided{pro.dobuf, sb, sh, D}
                          : Strided{ptr[4], pro.do_sb, pro.do_sh, pro.do_ss};
  return launch<D, T>(p, pro, B, staged_q, k, v, dO, st);
}

template <typename T>
int dispatch(const void* const* ptr, const int64_t* const* strides, int B,
             int H, int S, int D, int n_valid, float scale, cudaStream_t st) {
  if (D == 64)
    return dispatch_d<64, T>(ptr, strides, B, H, S, n_valid, scale, st);
  if (D == 128)
    return dispatch_d<128, T>(ptr, strides, B, H, S, n_valid, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device addresses; strides are in
// elements (b, h, s order), and the last (D) stride of every [B,N,H,D]
// tensor is 1; every other stride of q, k, v and do is a multiple of 16
// bytes and every pointer 16-byte aligned (TMA addresses them).  `dtype` is
// the element type of q/k/v/o/do/dq/dk/dv and the tables: 0 = bf16, 1 =
// f32.  Scratch, all [B, H, S, D] bf16 contiguous: `qbuf` always; `kbuf`
// with RoPE (sin_tab, cos_tab non-null) or f32; `vbuf` and `dobuf` with
// f32.  `stats` is [B, H, 2, S_pad] f32 scratch, S_pad = S rounded up to a
// multiple of 64; nothing needs zeroing.  Launches on `stream` without
// synchronising and returns the first cudaError_t met (0 = success).
extern "C" int ever_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, const void* sin_tab, const void* cos_tab,
    void* qbuf, void* kbuf, void* vbuf, void* dobuf, void* stats, void* dq,
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
      stats == nullptr ||
      ((sin_tab != nullptr || dtype == 1) && kbuf == nullptr) ||
      (dtype == 1 && (vbuf == nullptr || dobuf == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptr[16] = {q, k, v, o, dO, lse, sin_tab, cos_tab,
                         qbuf, kbuf, vbuf, dobuf, stats, dq, dk, dv};
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
