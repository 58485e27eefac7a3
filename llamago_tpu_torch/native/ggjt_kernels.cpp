// Native data-path kernels for checkpoint IO and quantization (host C++).
//
// The port's own copy of the JAX package's native/ggjt_kernels.cpp. The
// reference's host data path is slow scalar Go: the loader upconverts FP16
// checkpoints one element at a time (reference: pkg/llama/llama.go:938-941)
// and no quantizer exists at all (Makefile:132-133 shells out to
// llama.cpp). This library is the native equivalent: multithreaded FP16
// widening and ggml-bit-layout Q8_0/Q4_0 block quantization, bound into
// Python via ctypes (see __init__.py) with numpy fallbacks that give the
// same bytes. It runs on the host only; no GPU kernel lives here.
//
// Build (native/__init__.py does it at first use, into build/):
//   g++ -O3 -march=native -shared -fPIC -std=c++17 ggjt_kernels.cpp \
//       -o build/libggjt-<hash>.so -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr int kBlock = 32;           // quantization block (QK)
constexpr int kQ8BlockBytes = 2 + 32;
constexpr int kQ4BlockBytes = 2 + 16;

inline float fp16_to_fp32_scalar(uint16_t h) {
  // bit-exact IEEE half -> single widening
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {
      // subnormal: normalize
      int shift = 0;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t fp32_to_fp16_scalar(float f) {
  // round-to-nearest-even single -> half (enough for scale storage)
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = (int32_t)((bits >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = bits & 0x7FFFFFu;
  if (exp >= 31) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;
    mant |= 0x800000u;
    uint32_t shift = (uint32_t)(14 - exp);
    uint32_t half = (mant >> shift) & 0x3FFu;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1))) half++;
    return (uint16_t)(sign | half);
  }
  uint32_t half = (uint32_t)(exp << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
  return (uint16_t)(sign | half);
}

void parallel_rows(int64_t rows, int threads,
                   const std::function<void(int64_t, int64_t)>& fn) {
  if (threads <= 1 || rows < 2) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (rows + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(rows, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// FP16 -> FP32, multithreaded (replaces the reference's scalar loop,
// llama.go:938-941).
void ggjt_fp16_to_fp32(const uint16_t* src, float* dst, int64_t n,
                       int threads) {
  parallel_rows(n, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) dst[i] = fp16_to_fp32_scalar(src[i]);
  });
}

// Q8_0 row-block quantization, ggml bit layout: per 32-block {f16 d,
// int8 qs[32]}, blocks along the contiguous (in) dim.
void ggjt_quantize_q8_0(const float* src, uint8_t* dst, int64_t rows,
                        int64_t cols, int threads) {
  const int64_t nb = cols / kBlock;
  parallel_rows(rows, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const float* x = src + r * cols;
      uint8_t* out = dst + r * nb * kQ8BlockBytes;
      for (int64_t b = 0; b < nb; ++b) {
        const float* xb = x + b * kBlock;
        float amax = 0.f;
        for (int j = 0; j < kBlock; ++j) amax = std::max(amax, std::fabs(xb[j]));
        const float d = amax / 127.0f;
        const float inv = d > 0.f ? 1.0f / d : 0.0f;
        uint16_t dh = fp32_to_fp16_scalar(d);
        std::memcpy(out, &dh, 2);
        int8_t* qs = (int8_t*)(out + 2);
        for (int j = 0; j < kBlock; ++j) {
          float v = xb[j] * inv;
          qs[j] = (int8_t)std::max(-127.f, std::min(127.f, std::nearbyintf(v)));
        }
        out += kQ8BlockBytes;
      }
    }
  });
}

// Q4_0 row-block quantization: per 32-block {f16 d, uint8 qs[16]},
// qs[j] = elem j | elem (j+16) << 4, d = signed extreme / -8.
void ggjt_quantize_q4_0(const float* src, uint8_t* dst, int64_t rows,
                        int64_t cols, int threads) {
  const int64_t nb = cols / kBlock;
  parallel_rows(rows, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const float* x = src + r * cols;
      uint8_t* out = dst + r * nb * kQ4BlockBytes;
      for (int64_t b = 0; b < nb; ++b) {
        const float* xb = x + b * kBlock;
        float amax = 0.f, smax = 0.f;
        for (int j = 0; j < kBlock; ++j) {
          float a = std::fabs(xb[j]);
          if (a > amax) {
            amax = a;
            smax = xb[j];
          }
        }
        const float d = smax / -8.0f;
        const float inv = d != 0.f ? 1.0f / d : 0.0f;
        uint16_t dh = fp32_to_fp16_scalar(d);
        std::memcpy(out, &dh, 2);
        uint8_t* qs = out + 2;
        for (int j = 0; j < 16; ++j) {
          float v0 = xb[j] * inv + 8.0f;
          float v1 = xb[j + 16] * inv + 8.0f;
          uint8_t q0 = (uint8_t)std::max(0.f, std::min(15.f, std::nearbyintf(v0)));
          uint8_t q1 = (uint8_t)std::max(0.f, std::min(15.f, std::nearbyintf(v1)));
          qs[j] = (uint8_t)(q0 | (q1 << 4));
        }
        out += kQ4BlockBytes;
      }
    }
  });
}

// Cache-blocked transpose: [rows, cols] f32 -> [cols, rows] (used when
// repacking checkpoint layout to device layout host-side).
void ggjt_transpose_f32(const float* src, float* dst, int64_t rows,
                        int64_t cols, int threads) {
  constexpr int64_t T = 64;
  int64_t row_tiles = (rows + T - 1) / T;
  parallel_rows(row_tiles, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t rt = lo; rt < hi; ++rt) {
      int64_t r0 = rt * T, r1 = std::min(rows, r0 + T);
      for (int64_t c0 = 0; c0 < cols; c0 += T) {
        int64_t c1 = std::min(cols, c0 + T);
        for (int64_t r = r0; r < r1; ++r)
          for (int64_t c = c0; c < c1; ++c) dst[c * rows + r] = src[r * cols + c];
      }
    }
  });
}

}  // extern "C"
