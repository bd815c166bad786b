// Non-causal multi-head attention forward (K1) for Hopper (sm_90a),
// hand-written.
//
// Replaces the JAX package's fused Pallas kernel
// ``ever_tpu/ops/attention.py:_fa_fwd_kernel`` (line 175, launched by
// ``_fused_fwd_impl``).  Same function: q is scaled by 1/sqrt(D); optional
// RoPE ``x*cos + rotate_half(x)*sin`` on q and K (the TPU kernel's lane roll
// with a sign-folded sin table; here one thread owns both halves, so the
// sign goes into the arithmetic and the tables arrive as they are); key
// columns >= n_valid are masked with -1e30;
// outputs o (normalised, in the input type) and lse = m + log(l) (f32,
// [B,H,S_q]).  q has S_q rows and K/V S_kv, each with its own RoPE rows, as
// the TPU kernel reads a q block's tables apart from the keys'; a
// same-length call is S_q = S_kv on the same path.  Under a spatial step a
// rank's queries are its strip's tokens and its keys the whole tile's
// (parallel/spatial.py, module/vit.py).  Inputs are bf16 or f32; f32 operands are rounded to bf16 for
// the tensor cores (q after RoPE and the scale, K after RoPE, V as is),
// while scores, softmax, accumulation, lse and o stay f32.
//
// Bound on an H100 SXM at the ViT-L/16 serving shape (B=8, H=16, S=1029,
// D=64, bf16): 4*B*H*S_q*S_kv*D = 34.7 GFLOP, 0.0351 ms at 989 TFLOP/s,
// against ~68 MB of q/k/v/o/lse traffic, 0.020 ms at 3.35 TB/s; at a
// 1024² tile's strip of two (B=1, S_q=2053, S_kv=4101) 34.5 GFLOP, 0.0349
// ms.  Compute bounds it, so both products run as ``wgmma`` fed by TMA, and
// the softmax hides behind them.
//
// Design.  The TPU kernel keeps the whole [S,D] K/V of a head resident in
// VMEM; an SM has 227 KB of shared memory, so here K/V stream through it,
// FlashAttention-3 style:
// - K is rotated once per (b, h) by a small memory-bound staging launch
//   (``stage`` in attention_common.cuh) into a bf16 [B,H,S_kv,D] buffer,
//   instead of once per q tile (6 times per head at S=1029); with f32
//   inputs the same launch rounds K and V to bf16, so one main kernel
//   serves both types.  Without RoPE, bf16 K and V are read in place.
// - main kernel: one CTA per (b, h, q tile) of three consumer warpgroups
//   (192 q rows, 64 each) at head dim 64, two (128 rows) at head dim 128,
//   and a producer warpgroup that gives its registers to the consumers
//   (``setmaxnreg``: 160 a thread with three, 240 with two; ptxas
//   allocates within that limit).  One producer thread keeps TMA loads of
//   64-key K and V tiles in flight through a 4-stage ring (128-byte
//   swizzle, rows past S zero-filled, full and empty mbarriers).  At the
//   main shape that is 768 CTAs, 5.8 waves of one CTA per SM.  Three
//   warpgroups rather than two give each SM sub-partition three warps to
//   interleave the softmax's ``ex2`` (as much MUFU time per tile as the
//   tile's tensor-core time at head dim 64) with the products: the main
//   kernel took 0.125 against 0.139 ms with 128-row tiles (H100 80GB HBM3,
//   700 W).  64-key tiles rather than 128 keep scores and P in the
//   registers three warpgroups have; at two warpgroups, 128-key tiles were
//   slower too (0.157 ms).
// - q is rotated and scaled once per CTA by the consumers themselves, from
//   device memory straight into registers in the layout of wgmma's A
//   operand (a thread owns columns c and c + D/2 of its rows, so the
//   rotation needs no exchange): no staging pass for q (it would move
//   another 33.8 MB) and no shared tile or proxy fence.  S = (scale Rq) Rk^T
//   is a ``wgmma`` with A from registers and K K-major in shared memory.
// - online softmax in f32 registers with ``ex2``; P is re-packed in the
//   registers as the A operand of O += P V (V MN-major in shared memory),
//   and O stays in registers until the epilogue.
// - overlap inside a warpgroup (FA3): tile j's S = Q K_j^T and tile j-1's
//   O += P V are issued back to back, and tile j's softmax runs on the CUDA
//   cores while P V runs on the tensor cores.  (Ping-pong between the
//   warpgroups on named barriers measured no faster, so there is none.)
// - key tiles wholly at or past n_valid are never loaded; only the ragged
//   last tile is masked, by selects; q rows past S_q compute on zeros and
//   are never written, and a warpgroup whose 64 rows all lie past S_q leaves
//   at once (the last q tile of each head at S=1029 keeps two of three;
//   the empty barriers count the warps that stayed).  ptxas serializes a
//   warpgroup's wgmmas when a branch parts its threads around them, when
//   other instructions touch an accumulator while its wgmma may run, or
//   when registers run short (notes C7510-C7520): hence no branch inside a
//   warpgroup, the register fences of hopper.cuh, and the tile sizes above.
// - q/k/v/o are addressed through strides, so the packed qkv projection
//   [B,N,3,H,D] is read and o is written as [B,N,H,D] without transposes;
//   the wrapper copies any bf16 view off TMA's 16-byte rules first.

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int STAGES = 4;
constexpr int BKV = 64;                              // keys per K/V tile

// The CTA at head dim D: WGS consumer warpgroups of 64 q rows each, with
// REGS registers a thread, and a producer warpgroup with 24.
template <int D>
struct Tile {
  static constexpr int WGS = D == 64 ? 3 : 2;
  static constexpr int WARPS = 4 * WGS;              // consumer warps
  static constexpr int THREADS = 32 * WARPS + 128;
  static constexpr int BQ = 64 * WGS;                // q rows a CTA owns
  static constexpr int REGS = D == 64 ? 160 : 240;   // WGS * 128 * REGS + 128 * 24 <= 65536
};

// A [rows][D] bf16 tile in shared memory is D/64 column blocks of
// [rows][64] (128-byte rows, swizzled), one after the other.
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * D * 2; }

template <int D>
__host__ __device__ constexpr int stage_bytes() { return 2 * tile_bytes<D>(BKV); }

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<D>() + 1024 + 2 * STAGES * 8;
}

// T: the element type of q, o and the RoPE tables (bf16 or f32).  K and V
// reach the main kernel as bf16, through the tensor maps.
template <typename T>
struct Params {
  const T* q;
  const T* sin_tab;           // [S_q, D] RoPE tables for q, or null
  const T* cos_tab;           // [S_q, D]
  T* o;
  float* lse;                 // [B, H, S_q]
  int64_t q_sb, q_sh, q_ss, o_sb, o_sh, o_ss;
  int S_q, H, n_valid;        // n_valid <= S_kv: the keys read
  float scale;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
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

// The A fragments of this warp's 16 q rows (r0 = row g, r0 + 8 = row g + 8),
// rotated, scaled and rounded to bf16: qa[kk] covers columns 16kk..16kk+15.
// The thread reads columns c = 16kk + 8j + 2t (+1) and c + D/2 of both rows,
// so it rotates them itself.  Rows past S_q are zero; their loads read row
// S_q - 1 instead, so that no branch parts the warp.
template <int D, typename T>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4], const Params<T>& p,
                                       const T* qb, int r0, int t) {
  constexpr int HK = D / 32;  // k16 steps per half of the head dim
  const bool rope = p.sin_tab != nullptr;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    const int rc = min(r, p.S_q - 1);
    const float keep = r < p.S_q ? p.scale : 0.f;
    const T* row = qb + rc * p.q_ss;
    const int64_t tr = static_cast<int64_t>(rc) * D;
#pragma unroll
    for (int kk = 0; kk < HK; ++kk) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 16 * kk + 8 * j + 2 * t, c2 = c + D / 2;
        const float2 xl = load2(row + c), xh = load2(row + c2);
        float2 yl = xl, yh = xh;
        if (rope) {  // rope(x) = x*cos + rotate_half(x)*sin, rotate_half = [-x_hi, x_lo]
          const float2 cl = load2(p.cos_tab + tr + c), sl = load2(p.sin_tab + tr + c);
          const float2 ch = load2(p.cos_tab + tr + c2), sh = load2(p.sin_tab + tr + c2);
          yl = make_float2(xl.x * cl.x - xh.x * sl.x, xl.y * cl.y - xh.y * sl.y);
          yh = make_float2(xh.x * ch.x + xl.x * sh.x, xh.y * ch.y + xl.y * sh.y);
        }
        qa[kk][hr + 2 * j] = pack_bf16(yl.x * keep, yl.y * keep);
        qa[kk + HK][hr + 2 * j] = pack_bf16(yh.x * keep, yh.y * keep);
      }
    }
  }
}

// S[64 x BKV] = Q K^T over the head dim: A from registers, the K tile
// K-major in shared memory.
template <int D>
__device__ __forceinline__ void mma_qk(float (&s)[BKV / 2],
                                       const uint32_t (&qa)[D / 16][4],
                                       const unsigned char* ks) {
  const uint64_t dk = desc_kmajor(ks);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // column block kk/4, then 32 bytes (2 units of 16) per k16 step
    const uint64_t off = (kk / 4) * (BKV * 128 / 16) + 2 * (kk % 4);
    wgmma_bf16_rs_n64<0>(s, qa[kk], dk + off, kk > 0);
  }
}

// O[64 x D] += P V over the tile's keys: A (P) from registers, the V tile
// MN-major in shared memory, 16 keys (2048 bytes) per k16 step.
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2],
                                       const uint32_t (&pa)[BKV / 16][4],
                                       const unsigned char* vs) {
  const uint64_t dv = desc_mnmajor(vs, BKV * 128);
#pragma unroll
  for (int c = 0; c < BKV / 16; ++c) {
    if constexpr (D == 64) wgmma_bf16_rs_n64(o, pa[c], dv + 128 * c, 1);
    else wgmma_bf16_rs_n128(o, pa[c], dv + 128 * c, 1);
  }
}

// The online softmax of one score tile in place: mask key columns at or
// past n_valid (k_lim = n_valid - first key of the tile), update the row
// maxima m and the per-lane partial sums l of rows g (0) and g + 8 (1), and
// leave p = exp(s - m) in s.  Returns the factors that rescale the rows'
// earlier sums in a0, a1.  Element 4j+e of s is row g (+8 for e >= 2),
// column 8j + 2t + (e & 1).
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float& m0, float& m1,
                                             float& l0, float& l1, float& a0,
                                             float& a1, int k_lim, int t) {
  float mx0 = m0, mx1 = m1;
  if (k_lim < 2 * NS) {  // the ragged last tile: finite, so exp stays NaN-free
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = 8 * j + 2 * t + (e & 1) < k_lim ? s[4 * j + e] : MASK;
    }
  }
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  // the four lanes of a quad share a row
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float ml0 = mx0 * LOG2E, ml1 = mx1 * LOG2E;
  a0 = exp2_approx(fmaf(m0, LOG2E, -ml0));
  a1 = exp2_approx(fmaf(m1, LOG2E, -ml1));
  m0 = mx0;
  m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    s[4 * j] = exp2_approx(fmaf(s[4 * j], LOG2E, -ml0));
    s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], LOG2E, -ml0));
    s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], LOG2E, -ml1));
    s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], LOG2E, -ml1));
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * a0 + rs0;  // per-lane partial sums; the quad adds them at the end
  l1 = l1 * a1 + rs1;
}

// P as A fragments: k16 chunk c is columns 16c..16c+15 of rows g and g+8,
// rounded to bf16.
template <int NS>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[NS / 8][4], const float (&s)[NS]) {
#pragma unroll
  for (int c = 0; c < NS / 8; ++c) {
    pa[c][0] = pack_bf16(s[8 * c + 0], s[8 * c + 1]);
    pa[c][1] = pack_bf16(s[8 * c + 2], s[8 * c + 3]);
    pa[c][2] = pack_bf16(s[8 * c + 4], s[8 * c + 5]);
    pa[c][3] = pack_bf16(s[8 * c + 6], s[8 * c + 7]);
  }
}

// grid (ceil(S_q / BQ), H, B)
template <int D, typename T>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const Params<T> p) {
  constexpr int NS = BKV / 2;                   // score registers a thread
  constexpr int STAGE = stage_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * Tile<D>::BQ, h = blockIdx.y, b = blockIdx.z;
  const int n_kt = (p.n_valid + BKV - 1) / BKV;
  // warpgroups whose 64 rows all lie past S_q leave at once
  const int n_wg = min(Tile<D>::WGS, (p.S_q - q0 + 63) / 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * n_wg);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= Tile<D>::WARPS) {                // producer warpgroup
    setmaxnreg_dec<24>();
    if (warp == Tile<D>::WARPS && lane == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % STAGES;
        unsigned char* stage = ring + st * STAGE;
        mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], STAGE);
        load_tile<D>(stage, &map_k, &full[st], BKV, kt * BKV, h, b);
        load_tile<D>(stage + tile_bytes<D>(BKV), &map_v, &full[st], BKV, kt * BKV, h, b);
      }
    }
    return;
  }

  setmaxnreg_inc<Tile<D>::REGS>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  if (wg >= n_wg) return;
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + g;  // this thread's rows r0, r0 + 8
  uint32_t qa[D / 16][4];
  load_q<D, T>(qa, p, p.q + b * p.q_sb + h * p.q_sh, r0, t);

  float o[D / 2], s[NS];
  uint32_t pa[BKV / 16][4];                     // P of the previous tile
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = MASK, m1 = MASK, l0 = 0.f, l1 = 0.f, a0, a1;

  // tile 0: S, then its softmax
  mbar_wait(&full[0], 0);
  wgmma_fence();
  mma_qk<D>(s, qa, ring);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, m0, m1, l0, l1, a0, a1, p.n_valid, t);
  pack_p(pa, s);

  // tile kt: S_kt and O += P_{kt-1} V_{kt-1} in flight together; the
  // softmax of S_kt runs while P V does
  for (int kt = 1; kt < n_kt; ++kt) {
    const int st = kt % STAGES, prev = (kt - 1) % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    wgmma_fence();
    mma_qk<D>(s, qa, ring + st * STAGE);
    wgmma_commit();
    fence_regs(o);
    mma_pv<D>(o, pa, ring + prev * STAGE + tile_bytes<D>(BKV));
    wgmma_commit();
    wgmma_wait<1>();                             // S_kt is done
    fence_regs(s);
    softmax_tile(s, m0, m1, l0, l1, a0, a1, p.n_valid - kt * BKV, t);
    wgmma_wait<0>();                             // P V is done
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[prev], lane == 0);        // the stage may be refilled
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {         // rows g (i, i+1), g+8 (i+2, i+3)
      o[i] *= a0;
      o[i + 1] *= a0;
      o[i + 2] *= a1;
      o[i + 3] *= a1;
    }
    pack_p(pa, s);
  }
  wgmma_fence();
  fence_regs(o);
  mma_pv<D>(o, pa, ring + ((n_kt - 1) % STAGES) * STAGE + tile_bytes<D>(BKV));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  mbar_arrive(&empty[(n_kt - 1) % STAGES], lane == 0);

  // epilogue: o / l in the input type, lse = m + log(l); rows past S_q unwritten
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  T* ob = p.o + b * p.o_sb + h * p.o_sh;
  float* lb = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.S_q;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r >= p.S_q) continue;
    const float l = hr ? l1 : l0, inv = 1.f / l;
    T* orow = ob + r * p.o_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(orow + dt * 8, o[4 * dt + 2 * hr] * inv, o[4 * dt + 2 * hr + 1] * inv);
    if (t == 0) lb[r] = (hr ? m1 : m0) + logf(l);
  }
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

// k/v/sin_k/cos_k/kbuf/vbuf as in ever_attn_fwd; S_kv rows of K and V.
template <int D, typename T>
int launch(const Params<T>& p, int B, int S_kv, const T* k, const int64_t ks[3],
           const T* v, const int64_t vs[3], const T* sin_k, const T* cos_k,
           void* kbuf, void* vbuf, cudaStream_t st) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int64_t sb = static_cast<int64_t>(p.H) * S_kv * D, sh = static_cast<int64_t>(S_kv) * D;
  // what the main kernel reads: the staged copies, or the inputs themselves
  const void* kp = k;
  int64_t kst[3] = {ks[0], ks[1], ks[2]};
  if (sin_k != nullptr || kF32) {
    // rotate (and for f32 round) K once into the bf16 scratch buffer
    const int err = stage<D, T>(k, ks[0], ks[1], ks[2], sin_k, cos_k,
                                1.f, kbuf, B, p.H, S_kv, st);
    if (err != 0) return err;
    kp = kbuf;
    kst[0] = sb; kst[1] = sh; kst[2] = D;
  }
  const void* vp = v;
  int64_t vst[3] = {vs[0], vs[1], vs[2]};
  if (kF32) {
    const int err = stage<D, T>(v, vs[0], vs[1], vs[2], nullptr, nullptr, 1.f,
                                vbuf, B, p.H, S_kv, st);
    if (err != 0) return err;
    vp = vbuf;
    vst[0] = sb; vst[1] = sh; vst[2] = D;
  }
  CUtensorMap map_k, map_v;
  int err = seq_map(&map_k, kp, B, p.H, S_kv, D, kst[0], kst[1], kst[2], BKV);
  err = err ? err : seq_map(&map_v, vp, B, p.H, S_kv, D, vst[0], vst[1], vst[2], BKV);
  if (err != 0) return err;
  constexpr int smem = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.S_q + Tile<D>::BQ - 1) / Tile<D>::BQ, p.H, B);
  attn_fwd_kernel<D, T><<<grid, Tile<D>::THREADS, smem, st>>>(map_k, map_v, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* sin_q,
             const void* cos_q, const void* sin_k, const void* cos_k, void* kbuf,
             void* vbuf, void* o, void* lse, int B, int H, int S_q, int S_kv, int D,
             int n_valid, const int64_t qs[3], const int64_t ks[3],
             const int64_t vs[3], const int64_t os[3], float scale,
             cudaStream_t st) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.sin_tab = static_cast<const T*>(sin_q);
  p.cos_tab = static_cast<const T*>(cos_q);
  p.o = static_cast<T*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = qs[0]; p.q_sh = qs[1]; p.q_ss = qs[2];
  p.o_sb = os[0]; p.o_sh = os[1]; p.o_ss = os[2];
  p.S_q = S_q; p.H = H; p.n_valid = n_valid; p.scale = scale;
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* sk = static_cast<const T*>(sin_k);
  const T* ck = static_cast<const T*>(cos_k);
  if (D == 64) return launch<64, T>(p, B, S_kv, kt, ks, vt, vs, sk, ck, kbuf, vbuf, st);
  if (D == 128) return launch<128, T>(p, B, S_kv, kt, ks, vt, vs, sk, ck, kbuf, vbuf, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device addresses; strides are in
// elements, and the last (D) stride of q/k/v/o is 1; K and V (when read in
// place: bf16) start on 16 bytes with their other strides multiples of 16
// bytes, as TMA addresses them.  `dtype` is the element type of q/k/v/o and
// the tables: 0 = bf16, 1 = f32.  q and o have S_q rows, k and v S_kv;
// sin_q/cos_q are [S_q, D] and sin_k/cos_k [S_kv, D] (all four null: no
// RoPE); keys at or past n_valid <= S_kv are masked.  `kbuf` is a [B, H,
// S_kv, D] bf16 scratch buffer for the staged K, needed with RoPE or f32;
// `vbuf` is the same for V, needed with f32.  Launches on `stream` without
// synchronising and returns the first cudaError_t met (0 = success).
extern "C" int ever_attn_fwd(
    const void* q, const void* k, const void* v, const void* sin_q,
    const void* cos_q, const void* sin_k, const void* cos_k, void* kbuf,
    void* vbuf, void* o, void* lse, int dtype, int B, int H, int S_q,
    int S_kv, int D, int n_valid, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    void* stream) {
  const bool rope = sin_q != nullptr;
  if (B < 1 || H < 1 || S_q < 1 || S_kv < 1 || n_valid < 1 || n_valid > S_kv ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1) ||
      (cos_q != nullptr) != rope || (sin_k != nullptr) != rope ||
      (cos_k != nullptr) != rope || ((rope || dtype == 1) && kbuf == nullptr) ||
      (dtype == 1 && vbuf == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss};
  const int64_t vs[3] = {v_sb, v_sh, v_ss}, os[3] = {o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(q, k, v, sin_q, cos_q, sin_k, cos_k, kbuf,
                                   vbuf, o, lse, B, H, S_q, S_kv, D, n_valid,
                                   qs, ks, vs, os, scale, st);
  return dispatch<float>(q, k, v, sin_q, cos_q, sin_k, cos_k, kbuf, vbuf, o,
                         lse, B, H, S_q, S_kv, D, n_valid, qs, ks, vs, os,
                         scale, st);
}
