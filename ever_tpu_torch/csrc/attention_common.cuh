// Device helpers of the attention kernels: bf16 packing, loads and stores
// of 2 and 8 elements and exp2 (attention_fwd.cu, attention_bwd.cu), and
// the RoPE staging launch of the forward (attention_fwd.cu).  Each kernel
// source compiles on its own and includes this header.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float MASK = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

// Two consecutive elements as floats; `p` is aligned to two elements.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
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

// Staging: out[b, h, s, :] = bf16(scale * RoPE(x[b, s, h, :])) for every
// row, contiguous [B, H, S, D]; null tables copy without rotating.  One
// thread per (row, chunk pair), rows taken in (b, s, h) order, the memory
// order of the [B, N, H, D] inputs.
template <int D, typename T>
__global__ void stage_kernel(const T* x, int64_t x_sb, int64_t x_sh,
                             int64_t x_ss, const T* sin_tab, const T* cos_tab,
                             float scale, __nv_bfloat16* out, int H, int S,
                             int64_t n_units) {
  constexpr int HALF = D / 16;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= n_units) return;
  const int64_t row = u / HALF;              // over B*S*H
  const int c = static_cast<int>(u % HALF);
  const int h = static_cast<int>(row % H);
  const int64_t bs = row / H, b = bs / S;
  const int s = static_cast<int>(bs % S);
  uint4 lo, hi;
  rope_pair<D>(lo, hi, x + b * x_sb + h * x_sh + s * x_ss,
               sin_tab, cos_tab, static_cast<int64_t>(s) * D, c, scale);
  __nv_bfloat16* dst = out + ((b * H + h) * S + s) * D;
  *reinterpret_cast<uint4*>(dst + c * 8) = lo;
  *reinterpret_cast<uint4*>(dst + (c + HALF) * 8) = hi;
}

// x -> bf16(scale * RoPE(x)) as contiguous [B, H, S, D] in `out`.
template <int D, typename T>
int stage(const T* x, int64_t sb, int64_t sh, int64_t ss, const T* sin_tab,
          const T* cos_tab, float scale, void* out, int B, int H, int S,
          cudaStream_t st) {
  const int64_t units = static_cast<int64_t>(B) * H * S * (D / 16);
  const int threads = 256;
  const int64_t blocks = (units + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  stage_kernel<D, T><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      x, sb, sh, ss, sin_tab, cos_tab, scale,
      static_cast<__nv_bfloat16*>(out), H, S, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
