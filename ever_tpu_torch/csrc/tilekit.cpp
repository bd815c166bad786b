// tilekit: the port's host-side data-path routines, in C++ with a plain C
// interface for ctypes (the GIL is released for the duration of a call).
//
//   1. ever_extract_tiles_u8: gather N fixed-size tiles from a uint8 HWC
//      scene, one row memcpy at a time, tiles on parallel threads;
//      GeoTileDataset's batched read (the tile gather of the JAX package's
//      ever_tpu/native/tilekit.cpp, without its dihedral codes).
//   2. ever_png_unfilter: undo PNG's per-row filters (None, Sub, Up,
//      Average, Paeth) for bit depth 8.  Average and Paeth read the byte
//      just decoded to their left, so rows are decoded in order; this is
//      the hot loop of data/_png.py's decoder.
//   3. ever_normalize_u8_f32 / ever_normalize_u8_bf16: (x - mean[c]) *
//      (1 / std[c]) of uint8 HWC pixels in one pass, to float32 or to
//      bfloat16 rounded from the float32 result (the JAX package's
//      ever_tpu/native/tilekit.cpp arithmetic, bit for bit);
//      preprocess.segm.MeanStdNormalize's uint8 path.
//
// Built with g++ at first use by ever_tpu_torch/ops/_build.py.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int nthreads_for(int64_t work_items) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int64_t t = std::min<int64_t>(hw, work_items);
  return static_cast<int>(std::max<int64_t>(t, 1));
}

template <typename F>
void parallel_for(int64_t n, F&& body) {
  int nt = nthreads_for(n);
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) body(i);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    ts.emplace_back([=]() {
      for (int64_t i = t; i < n; i += nt) body(i);
    });
  }
  for (auto& th : ts) th.join();
}

// the PNG predictor, without branches: p = a + b - c, and the neighbour
// nearest to p, ties to a, then b
inline int paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  int ab = pb < pa ? b : a;
  int pab = pb < pa ? pb : pa;
  return pc < pab ? c : ab;
}

// round-to-nearest-even float32 -> bfloat16 (the uint16 payload); a NaN
// stays a quiet NaN (the rounding increment could carry a low-mantissa
// NaN into the infinity encoding)
inline uint16_t f32_to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return static_cast<uint16_t>((u >> 16) | 0x0040u);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

// (x - mu[c]) * inv[c] over n_pixels pixels of C <= 64 channels, in chunks
// of 2^16 pixels on parallel threads; store(dst, value) writes one output
template <typename T, typename Store>
int normalize_u8(const uint8_t* in, int64_t n_pixels, int64_t C, const float* mean,
                 const float* stdv, T* out, Store store) {
  if (!in || !mean || !stdv || !out || C <= 0 || C > 64 || n_pixels < 0) return -1;
  float inv[64], mu[64];
  for (int64_t c = 0; c < C; ++c) {
    inv[c] = 1.0f / stdv[c];
    mu[c] = mean[c];
  }
  const int64_t chunk = 1 << 16;
  const int64_t n_chunks = (n_pixels + chunk - 1) / chunk;
  parallel_for(n_chunks, [=](int64_t k) {
    int64_t lo = k * chunk, hi = std::min(n_pixels, lo + chunk);
    const uint8_t* src = in + lo * C;
    T* dst = out + lo * C;
    for (int64_t p = lo; p < hi; ++p) {
      for (int64_t c = 0; c < C; ++c) store(dst++, (static_cast<float>(*src++) - mu[c]) * inv[c]);
    }
  });
  return 0;
}

}  // namespace

extern "C" {

// scene: [H, W, C] u8 contiguous; boxes: [N, 2] int64 (y0, x0);
// out: [N, th, tw, C] u8.  Returns 0, or a negative code for a bad
// argument (nothing written).
int ever_extract_tiles_u8(const uint8_t* scene, int64_t H, int64_t W,
                          int64_t C, const int64_t* boxes, int64_t N,
                          int64_t th, int64_t tw, uint8_t* out) {
  if (!scene || !boxes || !out || C <= 0 || th <= 0 || tw <= 0) return -1;
  for (int64_t i = 0; i < N; ++i) {
    int64_t y0 = boxes[2 * i], x0 = boxes[2 * i + 1];
    if (y0 < 0 || x0 < 0 || y0 + th > H || x0 + tw > W) return -2;
  }
  const int64_t row_bytes = tw * C;
  parallel_for(N, [=](int64_t i) {
    int64_t y0 = boxes[2 * i], x0 = boxes[2 * i + 1];
    uint8_t* dst = out + i * th * tw * C;
    for (int64_t r = 0; r < th; ++r) {
      std::memcpy(dst + r * row_bytes, scene + ((y0 + r) * W + x0) * C, row_bytes);
    }
  });
  return 0;
}

// The same gather emitting 2x2 space-to-depth tiles: out [N, th/2, tw/2,
// 4*C] with channel (dy*2 + dx)*C + c, what encoders with stem='s2d_input'
// take.  th and tw must be even (-5 otherwise).
int ever_extract_tiles_s2d_u8(const uint8_t* scene, int64_t H, int64_t W,
                              int64_t C, const int64_t* boxes, int64_t N,
                              int64_t th, int64_t tw, uint8_t* out) {
  if (!scene || !boxes || !out || C <= 0 || th <= 0 || tw <= 0) return -1;
  if ((th | tw) & 1) return -5;
  for (int64_t i = 0; i < N; ++i) {
    int64_t y0 = boxes[2 * i], x0 = boxes[2 * i + 1];
    if (y0 < 0 || x0 < 0 || y0 + th > H || x0 + tw > W) return -2;
  }
  const int64_t oh = th / 2, ow = tw / 2, oc = 4 * C;
  parallel_for(N, [=](int64_t i) {
    int64_t y0 = boxes[2 * i], x0 = boxes[2 * i + 1];
    uint8_t* dst = out + i * oh * ow * oc;
    for (int64_t r = 0; r < oh; ++r) {
      const uint8_t* row0 = scene + ((y0 + 2 * r) * W + x0) * C;
      const uint8_t* row1 = row0 + W * C;
      uint8_t* d = dst + r * ow * oc;
      for (int64_t c2 = 0; c2 < ow; ++c2) {
        std::memcpy(d, row0 + 2 * c2 * C, 2 * C);          // dy = 0: dx = 0, 1
        std::memcpy(d + 2 * C, row1 + 2 * c2 * C, 2 * C);  // dy = 1: dx = 0, 1
        d += oc;
      }
    }
  });
  return 0;
}

// in: H rows of (1 + stride) bytes, each a filter-type byte and the
// filtered row; out: [H, stride] raw bytes; bpp: bytes per pixel (>= 1).
// Returns 0, -1 for a bad argument, or -(2 + y) for an unknown filter type
// on row y.
int ever_png_unfilter(const uint8_t* in, int64_t H, int64_t stride,
                      int64_t bpp, uint8_t* out) {
  if (!in || !out || H < 0 || stride <= 0 || bpp <= 0 || bpp > stride) return -1;
  const std::vector<uint8_t> zeros(stride, 0);  // the row above the first
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t ft = in[y * (stride + 1)];
    const uint8_t* src = in + y * (stride + 1) + 1;
    uint8_t* dst = out + y * stride;
    const uint8_t* prev = y ? dst - stride : zeros.data();
    // the first pixel has no left neighbour (a = c = 0); the loops after it
    // run without branches on the position
    switch (ft) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        std::memcpy(dst, src, bpp);
        for (int64_t x = bpp; x < stride; ++x) dst[x] = src[x] + dst[x - bpp];
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x) dst[x] = src[x] + prev[x];
        break;
      case 3:
        for (int64_t x = 0; x < bpp; ++x) dst[x] = src[x] + (prev[x] >> 1);
        for (int64_t x = bpp; x < stride; ++x)
          dst[x] = static_cast<uint8_t>(src[x] + ((dst[x - bpp] + prev[x]) >> 1));
        break;
      case 4:
        for (int64_t x = 0; x < bpp; ++x) dst[x] = src[x] + prev[x];  // paeth(0, b, 0) = b
        for (int64_t x = bpp; x < stride; ++x)
          dst[x] = static_cast<uint8_t>(src[x] + paeth(dst[x - bpp], prev[x], prev[x - bpp]));
        break;
      default:
        return static_cast<int>(-(2 + y));
    }
  }
  return 0;
}

int ever_normalize_u8_f32(const uint8_t* in, int64_t n_pixels, int64_t C, const float* mean,
                          const float* stdv, float* out) {
  return normalize_u8(in, n_pixels, C, mean, stdv, out, [](float* d, float v) { *d = v; });
}

int ever_normalize_u8_bf16(const uint8_t* in, int64_t n_pixels, int64_t C, const float* mean,
                           const float* stdv, uint16_t* out) {
  return normalize_u8(in, n_pixels, C, mean, stdv, out,
                      [](uint16_t* d, float v) { *d = f32_to_bf16(v); });
}

int ever_tilekit_abi_version() { return 2; }

}  // extern "C"
