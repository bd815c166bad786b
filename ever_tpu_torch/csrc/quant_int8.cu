// Per-tensor int8 quantization of float32 values (K6) for Hopper (sm_90a),
// hand-written.
//
// Replaces the JAX package's Pallas kernel ``ever_tpu/ops/quant.py``
// ``_quant_kernel``.  Given x [n] f32 and the per-tensor scale s (computed
// beforehand, as the JAX package does outside its kernel):
//
//   stochastic: q = clip(floor(x/s + u), -128, 127), u = (bits >> 8) * 2^-24
//   nearest:    q = clip(rint(x/s), -128, 127)      (round half to even)
//
// x/s is an IEEE division (the build has no fast-math).  The TPU kernel
// draws its bits from the TPU's hardware generator, whose stream cannot be
// reproduced; here they come from a counter-based hash of (key, element
// index i): bits = mix(mix(lo32(i) ^ key) ^ hi32(i)), with mix murmur3's
// 32-bit finaliser and key derived from the seed by the caller.  The plain
// version (``ops/quant.py``) computes the same bits with integer tensor
// operations, so kernel and plain version agree exactly in both modes.
//
// Bound on an H100 SXM at the int8 serving layer's activation ([32808,
// 4096]): 537.5 MB of f32 read and 134.4 MB of int8 written, 671.9 MB,
// 0.2006 ms at 3.35 TB/s; a division, two hash rounds and a floor per
// element on the CUDA cores stay below that.  One thread takes 4 elements:
// one 16-byte load and one 4-byte store where the pointers allow,
// element by element at the tail or when they do not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

template <bool kStochastic>
__device__ __forceinline__ int8_t quantize(float x, float s, uint32_t key,
                                           int64_t i) {
  const float v = x / s;
  float q;
  if (kStochastic) {
    const uint64_t u64 = static_cast<uint64_t>(i);
    const uint32_t bits = mix32(mix32(static_cast<uint32_t>(u64) ^ key) ^
                                static_cast<uint32_t>(u64 >> 32));
    q = floorf(v + static_cast<float>(bits >> 8) * (1.0f / 16777216.0f));
  } else {
    q = rintf(v);
  }
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(q, -128.f), 127.f)));
}

template <bool kStochastic, bool kVector>
__global__ void __launch_bounds__(256)
ever_quant_int8_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                int8_t* __restrict__ q, int64_t n, uint32_t key) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i0 >= n) return;
  const float s = *scale;
  if (kVector && i0 + 4 <= n) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + i0));
    char4 o;
    o.x = quantize<kStochastic>(v.x, s, key, i0);
    o.y = quantize<kStochastic>(v.y, s, key, i0 + 1);
    o.z = quantize<kStochastic>(v.z, s, key, i0 + 2);
    o.w = quantize<kStochastic>(v.w, s, key, i0 + 3);
    *reinterpret_cast<char4*>(q + i0) = o;
  } else {
    for (int64_t i = i0; i < n && i < i0 + 4; ++i)
      q[i] = quantize<kStochastic>(x[i], s, key, i);
  }
}

template <bool kStochastic>
int launch(const float* x, const float* scale, int8_t* q, int64_t n,
           uint32_t key, cudaStream_t st) {
  const int threads = 256;
  const int64_t blocks = (n + 4LL * threads - 1) / (4LL * threads);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) & 15) |
                        (reinterpret_cast<uintptr_t>(q) & 3)) == 0;
  if (aligned)
    ever_quant_int8_kernel<kStochastic, true>
        <<<static_cast<unsigned>(blocks), threads, 0, st>>>(x, scale, q, n, key);
  else
    ever_quant_int8_kernel<kStochastic, false>
        <<<static_cast<unsigned>(blocks), threads, 0, st>>>(x, scale, q, n, key);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: f32 [n] contiguous; scale: f32 [1] on the device; q: int8 [n].
// stochastic 1 rounds with the hashed u of (key, i), 0 to nearest even.
// Launches on ``stream``; returns the CUDA error of the launch (0 on success).
extern "C" int ever_quant_int8(const void* x, const void* scale, void* q,
                               long long n, unsigned int key, int stochastic,
                               void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scale);
  int8_t* qp = static_cast<int8_t*>(q);
  if (stochastic) return launch<true>(xp, sp, qp, n, key, st);
  return launch<false>(xp, sp, qp, n, key, st);
}
