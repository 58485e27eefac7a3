// The kernel lab's small-m quantized matmuls for Hopper (sm_90a): rows L2,
// L3 and L6 to L12 of the lab's table (llamago_tpu_torch/kernel_lab.py).
//
// Replaces scripts/kernel_lab.py (the lab of the JAX package, whose production
// forms live in llamago_tpu/ops/kernels.py): kern_i4native (L2), kern_bf16dot
// and kern_split_bf16_h (L3), kern_w4a8, kern_w4a8_raw and kern_w4a8_h (L6),
// kern_w8a8 and kern_w8a8_h (L7), kern_w8a8_fulltk and kern_w4a8_split_fulltk
// (L8), kern_bitcast_i4 and kern_bitcast_i4_bf16 (L9), kern_bitcast_i4_i8dot,
// kern_bitcast_i4_i4dot, kern_bitcast_i4_i8dot_g128 and its _lazy form (L10),
// kern_decode_only, kern_decode_bitcast, kern_dma_only and kern_dma_pure
// (L11), kern_w16dot (L12), and the bitcast probe of tests/test_quant.py.
// The variants of one row differed in the TPU's unpack chain only and share
// one kernel here.
//
// Every function takes tm rows of x (tm a multiple of 8; bf16 [tm, K], or int8
// with f32 scales where the row rounds its activations), weights of K rows and
// N columns with bf16 scales s [K/32, N], and gives f32 [tm, N]. K % 32 == 0,
// N % 16 == 0.
//
// Weight layouts: Q8_0 int8 [K, N]. Q4_0 uint8 [K/2, N]: byte j of a 32-row
// block (packed rows 16b .. 16b+15) holds row 32b+j in its low nibble and row
// 32b+j+16 in its high nibble, value = nibble - 8. int4-typed (L2; and what L9
// and L10 read the Q4_0 bytes as): uint8 [K/2, N], byte r holds rows 2r (low)
// and 2r+1 (high) as two's-complement nibbles. bf16 [K, N] (L12).
//
// What bounds them: at tm = 8 a weight element meets 16 operations. The
// integer rows (L6 to L8, L10: __dp4a, four products an instruction) and the
// probes are bound by the weight bytes over device-memory bandwidth (K*N/2
// bytes of Q4_0 at K = 8192, N = 7168: 8.8 us at 3.35 TB/s). The rows that
// dequantize to floating point and multiply outside the tensor cores (L2, L3,
// L9, L12) need 2*8*K*N f32 operations, 14 us at 67 TFLOP/s: more than their
// bytes take, so the FMA pipe bounds them here (on the paper of the data
// sheet L3, L9's bf16 form and L12 count as bf16 products, which the tensor
// cores would take; these kernels do not use them).
//
// What the design does about it: one split-K GEMV skeleton. A block of 256
// threads owns 128 columns (a thread four neighbouring ones: one 32-bit word
// of a Q8_0 or packed row, so a warp reads 128 or 256 contiguous bytes of a
// row) and at most 512 rows of K; it first stages its slice of x in shared
// memory (f32, or the int8 words __dp4a wants), which every lane then reads
// at one address. The eight warps take contiguous runs of 32-row quant blocks,
// a thread loads the 16 words of a block's rows before it uses them, and the
// block adds its warps' sums in warp order (one pass over a 32 KB buffer that
// reuses the memory x was staged in) into an f32 workspace [ksplit, tm, N]
// that a second kernel adds in order (no atomics: the same result from run to
// run). Rows past 8 go to blockIdx.z.
//  * Floating point (lab_fgemv): a weight is decoded once and meets the eight
//    rows of x in registers; the nibble becomes f32 by the mantissa-OR of the
//    lab's own `bitcast` variants (an OR and an exact subtraction, no
//    int-to-float convert). A product of two bf16 values is exact in f32, so
//    FMA on bf16-rounded values gives L3's, L9's and L12's numbers; the bf16
//    FMA of split_bf16_h is two explicit roundings.
//  * Integer (lab_igemv): four rows of a column are gathered into one register
//    by a 4x4 byte transpose (__byte_perm); nibbles stay raw (0..15, or
//    nibble ^ 8 for two's complement) and 8 * sum(xq) of the block is taken
//    off the int32 dot, the same integers as the centered dot. The int32 sums
//    run over a scale group (a 32-block, a 128-group, or a k-tile) as far as
//    the warp's run reaches and are folded with sx * s into f32 at its end.
//    Every one of these instructions runs on the INT32 pipe (half the FP32
//    lanes): that pipe, not the bytes, is what this kernel is up against.
//  * lab_quantize_x: x to int8 per (row, 32-block) with one warp each, the
//    plain version's rounding decisions bit for bit (product by fl(1/127),
//    IEEE division, rintf).
//  * Probes (lab_probe): column sums with no x. decode_bitcast keeps every
//    product and sum of its lossy chain a rounding of its own (__fmul_rn,
//    __fadd_rn: no contraction into FMA), as the plain version does. dma_pure
//    moves every packed byte of its span from device memory into a ring of
//    shared-memory stages with cp.async (16 bytes a thread) and reads the
//    8-row corner only.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry points return cudaGetLastError() after their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kCols = 128;     // columns per block: 32 lanes x 4
constexpr int kTM = 8;         // rows of x per block
constexpr int kMaxUnits = 16;  // 32-row quant blocks whose x a block stages
constexpr unsigned kFull = 0xffffffffu;

// modes of lab_fgemv
constexpr int kFI4 = 0, kFI4Bf16 = 1, kFQ4Bf16 = 2, kFQ4Bf16Fma = 3, kFW16 = 4;
// weight formats and x layouts of lab_igemv
constexpr int kWQ8 = 0, kWQ4 = 1, kWI4 = 2;
constexpr int kXRows = 0, kXBlocks = 1, kXHalves = 2;
// modes of lab_probe
constexpr int kPDecode = 0, kPDecodeBitcast = 1, kPDmaOnly = 2, kPDmaPure = 3;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four consecutive bf16 scales at p (8-byte aligned) -> f32.
__device__ __forceinline__ void load_scales4(const __nv_bfloat16* p, float out[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// Four words of four rows, each byte a column -> four words of four columns,
// each byte a row (byte i of col[c] is byte c of w[i]).
__device__ __forceinline__ void transpose4x4(const uint32_t w[4], uint32_t col[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

constexpr int kRedFloats = kWarps * kTM * 4 * 32;  // every warp's sums: 32 KB

// The warps' sums of a block, added in warp order, to ws[(y*tm + row0 + m)*N +
// n]. `red` (kRedFloats floats) may be the memory x was staged in: the first
// barrier waits until every warp has left the main loop.
__device__ __forceinline__ void block_reduce_store(float (&acc)[kTM][4], float* red,
                                                   float* __restrict__ ws, int tm, int N,
                                                   int row0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[((warp * kTM + m) * 4 + c) * 32 + lane] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < kTM * kCols; i += kThreads) {
    const int m = i / kCols, cc = i % kCols;
    const int nn = blockIdx.x * kCols + cc;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[((w * kTM + m) * 4 + (cc & 3)) * 32 + (cc >> 2)];
    if (nn < N) ws[((size_t)blockIdx.y * tm + row0 + m) * N + nn] = a;
  }
}

// ------------------------------------------------------- floating-point rows

// One weight of a float mode from its nibble (raw 0..15) and its scale.
// 0x4B000000 | v read as f32 is 2^23 + v for 0 <= v < 2^23, and the difference
// to 2^23 + 8 is exact: v - 8 as f32 without the slower int-to-float convert.
__device__ __forceinline__ float nibble_minus_8(int v) {
  return __uint_as_float(0x4B000000u | (uint32_t)v) - 8388616.f;
}

template <int MODE>
__device__ __forceinline__ float decode_nibble(int nib, float s, float bias) {
  if constexpr (MODE == kFI4) {
    return nibble_minus_8(nib ^ 8) * s;  // two's complement: (nib ^ 8) - 8
  } else if constexpr (MODE == kFI4Bf16) {
    return bf16_round(nibble_minus_8(nib ^ 8) * s);  // the product is exact in f32
  } else if constexpr (MODE == kFQ4Bf16) {
    return bf16_round(nibble_minus_8(nib) * s);  // nib * s - 8 s, exact in f32
  } else {
    // bf16(bf16(nib * s) + bf16(-8 s)); the product and the sum are exact in f32
    return bf16_round(__fadd_rn(bf16_round(__fmul_rn(nibble_minus_8(nib) + 8.f, s)), bias));
  }
}

// grid = (ceil(N/128), ksplit, tm/8). Block y covers quant blocks [y*upb,
// (y+1)*upb), upb <= 16. x: bf16 [tm, K], or for kFQ4Bf16Fma its halves x,
// x_hi [tm, K/2] (of every 32-block the first and the last 16 values).
template <int MODE>
__global__ void __launch_bounds__(kThreads) lab_fgemv(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ x_hi,
    const uint8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s, float* __restrict__ ws,
    int tm, int K, int N, int upb) {
  __shared__ __align__(16) float red[kRedFloats];
  float(*xs)[kTM] = reinterpret_cast<float(*)[kTM]>(red);  // x staged: [kMaxUnits * 32][kTM]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane * 4;
  const bool valid = n < N;
  const int u0 = blockIdx.y * upb, u1 = min(u0 + upb, K / 32);
  const int row0 = blockIdx.z * kTM;
  const int rows = (u1 - u0) * 32;

  for (int i = threadIdx.x; i < rows * kTM; i += kThreads) {
    const int m = i / rows, kk = i % rows, k = u0 * 32 + kk;
    __nv_bfloat16 v;
    if constexpr (MODE == kFQ4Bf16Fma) {
      const int j = k & 31;
      v = (j < 16 ? x : x_hi)[(size_t)(row0 + m) * (K / 2) + (k >> 5) * 16 + (j & 15)];
    } else {
      v = x[(size_t)(row0 + m) * K + k];
    }
    xs[kk][m] = __bfloat162float(v);
  }
  __syncthreads();

  float acc[kTM][4];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  const int upw = (u1 - u0 + kWarps - 1) / kWarps;
  const int ua = u0 + warp * upw, ub = min(ua + upw, u1);
  if (valid) {
    for (int u = ua; u < ub; ++u) {
      const int kl = (u - u0) * 32;
      if constexpr (MODE == kFW16) {
        const __nv_bfloat16* w16 = reinterpret_cast<const __nv_bfloat16*>(q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint2 wd[16];
#pragma unroll
          for (int r = 0; r < 16; ++r)
            wd[r] = __ldg(reinterpret_cast<const uint2*>(
                w16 + (size_t)(u * 32 + h * 16 + r) * N + n));
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const float2 w01 =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wd[r].x));
            const float2 w23 =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wd[r].y));
            const float wv[4] = {w01.x, w01.y, w23.x, w23.y};
            const float4* xp = reinterpret_cast<const float4*>(&xs[kl + h * 16 + r][0]);
            const float4 a = xp[0], b = xp[1];
            const float xv[kTM] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
            for (int m = 0; m < kTM; ++m)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv[m], wv[c], acc[m][c]);
          }
        }
      } else {
        float sc[4], bias[4];
        load_scales4(s + (size_t)u * N + n, sc);
#pragma unroll
        for (int c = 0; c < 4; ++c) bias[c] = bf16_round(-8.f * sc[c]);
        uint32_t wd[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          wd[j] = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(u * 16 + j) * N + n));
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          // the rows of the low and the high nibble of packed row j
          constexpr bool kI4 = MODE == kFI4 || MODE == kFI4Bf16;
          const int ra = kl + (kI4 ? 2 * j : j), rb = kl + (kI4 ? 2 * j + 1 : j + 16);
          const float4* pa = reinterpret_cast<const float4*>(&xs[ra][0]);
          const float4* pb = reinterpret_cast<const float4*>(&xs[rb][0]);
          const float4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
          const float xa[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float xb[kTM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int byte = (wd[j] >> (8 * c)) & 0xFF;
            const float wa = decode_nibble<MODE>(byte & 0xF, sc[c], bias[c]);
            const float wb = decode_nibble<MODE>(byte >> 4, sc[c], bias[c]);
#pragma unroll
            for (int m = 0; m < kTM; ++m)
              acc[m][c] = fmaf(xb[m], wb, fmaf(xa[m], wa, acc[m][c]));
          }
        }
      }
    }
  }
  block_reduce_store(acc, red, ws, tm, N, row0);
}

// ---------------------------------------------------------------- integer rows

// grid and K split as lab_fgemv. xq int8 in layout XL: kXRows [tm, K];
// kXBlocks [K/32, tm, 32]; kXHalves the halves xq, xq_hi [tm, K/2]. sx f32
// [K/(32*sg_units), tm] or null (activation scale 1). A scale group is
// sg_units quant blocks, a k-tile tile_units; group g of tile t takes scale
// row t*tile_units + g of s.
template <int WFMT>
__global__ void __launch_bounds__(kThreads) lab_igemv(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ xq_hi,
    const float* __restrict__ sx, const uint8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, float* __restrict__ ws, int tm, int K, int N, int upb,
    int xlayout, int sg_units, int tile_units) {
  __shared__ __align__(16) float red[kRedFloats];
  int(*xw)[kTM] = reinterpret_cast<int(*)[kTM]>(red);  // int8x4 words of x: [kMaxUnits * 8][kTM]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane * 4;
  const bool valid = n < N;
  const int u0 = blockIdx.y * upb, u1 = min(u0 + upb, K / 32);
  const int row0 = blockIdx.z * kTM;
  const int words = (u1 - u0) * 8;

  for (int i = threadIdx.x; i < words * kTM; i += kThreads) {
    const int m = i / words, wi = i % words, k = u0 * 32 + wi * 4;
    const int8_t* src;
    if (xlayout == kXRows) {
      src = xq + (size_t)(row0 + m) * K + k;
    } else if (xlayout == kXBlocks) {
      src = xq + ((size_t)(k >> 5) * tm + row0 + m) * 32 + (k & 31);
    } else {
      const int j = k & 31;
      src = (j < 16 ? xq : xq_hi) + (size_t)(row0 + m) * (K / 2) + (k >> 5) * 16 + (j & 15);
    }
    xw[wi][m] = *reinterpret_cast<const int*>(src);
  }
  __syncthreads();
  if constexpr (WFMT == kWI4) {
    // packed rows r..r+3 hold rows 2r, 2r+2, 2r+4, 2r+6 in their low nibbles
    // and the odd rows in their high ones: split each 8 values of x alike
    for (int i = threadIdx.x; i < (words / 2) * kTM; i += kThreads) {
      const int m = i / (words / 2), p = i % (words / 2);
      const uint32_t a = xw[2 * p][m], b = xw[2 * p + 1][m];
      xw[2 * p][m] = (int)__byte_perm(a, b, 0x6420);
      xw[2 * p + 1][m] = (int)__byte_perm(a, b, 0x7531);
    }
    __syncthreads();
  }

  float facc[kTM][4];
  int iacc[kTM][4];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      facc[m][c] = 0.f;
      iacc[m][c] = 0;
    }

  const int upw = (u1 - u0 + kWarps - 1) / kWarps;
  const int ua = u0 + warp * upw, ub = min(ua + upw, u1);
  if (valid) {
    for (int u = ua; u < ub; ++u) {
      const int wl = (u - u0) * 8;  // the block's first word of x
      if constexpr (WFMT == kWQ8) {
        uint32_t wd[32];
#pragma unroll
        for (int r = 0; r < 32; ++r)
          wd[r] = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(u * 32 + r) * N + n));
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          uint32_t col[4];
          transpose4x4(&wd[4 * t], col);
          const int4 a = *reinterpret_cast<const int4*>(&xw[wl + t][0]);
          const int4 b = *reinterpret_cast<const int4*>(&xw[wl + t][4]);
          const int xv[kTM] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int m = 0; m < kTM; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c) iacc[m][c] = __dp4a((int)col[c], xv[m], iacc[m][c]);
        }
      } else {
        uint32_t wd[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          wd[j] = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(u * 16 + j) * N + n));
        int xsum[kTM];
#pragma unroll
        for (int m = 0; m < kTM; ++m) xsum[m] = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          uint32_t col[4];
          transpose4x4(&wd[4 * t], col);
          // the words of x that meet the low and the high nibbles
          const int il = wl + (WFMT == kWQ4 ? t : 2 * t);
          const int ih = wl + (WFMT == kWQ4 ? 4 + t : 2 * t + 1);
          const int4 a0 = *reinterpret_cast<const int4*>(&xw[il][0]);
          const int4 a1 = *reinterpret_cast<const int4*>(&xw[il][4]);
          const int4 b0 = *reinterpret_cast<const int4*>(&xw[ih][0]);
          const int4 b1 = *reinterpret_cast<const int4*>(&xw[ih][4]);
          const int xl[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const int xh[kTM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int m = 0; m < kTM; ++m)
            xsum[m] = __dp4a(0x01010101, xl[m], __dp4a(0x01010101, xh[m], xsum[m]));
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            uint32_t lo = col[c] & 0x0F0F0F0Fu, hi = (col[c] >> 4) & 0x0F0F0F0Fu;
            if constexpr (WFMT == kWI4) {  // two's complement: (nib ^ 8) - 8
              lo ^= 0x08080808u;
              hi ^= 0x08080808u;
            }
#pragma unroll
            for (int m = 0; m < kTM; ++m)
              iacc[m][c] = __dp4a((int)lo, xl[m], __dp4a((int)hi, xh[m], iacc[m][c]));
          }
        }
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) iacc[m][c] -= 8 * xsum[m];
      }
      if ((u + 1) % sg_units == 0 || u + 1 == ub) {
        float sc[4];
        const int srow = (u / tile_units) * tile_units + (u % tile_units) / sg_units;
        load_scales4(s + (size_t)srow * N + n, sc);
#pragma unroll
        for (int m = 0; m < kTM; ++m) {
          const float sxv = sx ? sx[(size_t)(u / sg_units) * tm + row0 + m] : 1.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            facc[m][c] += (float)iacc[m][c] * sxv * sc[c];
            iacc[m][c] = 0;
          }
        }
      }
    }
  }
  block_reduce_store(facc, red, ws, tm, N, row0);
}

// One warp per (row, 32-block), a lane per value: xq int8 [tm, K], sx f32
// [K/32, tm].
__global__ void __launch_bounds__(128) lab_quantize_x(const __nv_bfloat16* __restrict__ x,
                                                      int8_t* __restrict__ xq,
                                                      float* __restrict__ sx, int tm, int K) {
  const int lane = threadIdx.x & 31;
  const int nb = K / 32;
  const int item = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (item >= tm * nb) return;
  const int m = item / nb, b = item % nb;
  const size_t off = (size_t)m * K + (size_t)b * 32 + lane;
  const float v = __bfloat162float(x[off]);
  float amax = fabsf(v);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, d));
  const float inv127 = 1.0f / 127.0f;  // rounded to f32 once, as the plain version's product
  const float sc = amax > 0.f ? __fmul_rn(amax, inv127) : 1.0f;
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, sc)), -127.f), 127.f);
  xq[off] = (int8_t)(int)r;
  if (lane == 0) sx[(size_t)b * tm + m] = sc;
}

// ---------------------------------------------------------------------- probes

// Column sums over the block's rows, no x. grid = (ceil(N/128), ksplit);
// block y covers quant blocks [y*upb, (y+1)*upb); partial sums to ws[y][N].
template <int MODE>
__global__ void __launch_bounds__(kThreads) lab_probe(const uint8_t* __restrict__ q,
                                                      const __nv_bfloat16* __restrict__ s,
                                                      float* __restrict__ ws, int K, int N,
                                                      int upb) {
  __shared__ float red[4 * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane * 4;
  const bool valid = n < N;
  const int u0 = blockIdx.y * upb, u1 = min(u0 + upb, K / 32);
  const int upw = (u1 - u0 + kWarps - 1) / kWarps;
  const int ua = u0 + warp * upw, ub = min(ua + upw, u1);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int isum[4] = {0, 0, 0, 0};
  if (valid) {
    for (int u = ua; u < ub; ++u) {
      uint32_t wd[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        wd[j] = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(u * 16 + j) * N + n));
      if constexpr (MODE == kPDmaOnly) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) isum[c] += (wd[j] >> (8 * c)) & 0xFF;
      } else {
        float sc[4];
        load_scales4(s + (size_t)u * N + n, sc);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int byte = (wd[j] >> (8 * c)) & 0xFF;
            if constexpr (MODE == kPDecode) {
              acc[c] += nibble_minus_8(byte & 0xF) * sc[c] + nibble_minus_8(byte >> 4) * sc[c];
            } else {
              // ((f_lo * s + bias) + f_hi * s) + bias, every step rounded
              const float bias = __fmul_rn(-(8388608.f + 8.f), sc[c]);
              const float f_lo = __uint_as_float(0x4B000000u | (byte & 0xF));
              const float f_hi = __uint_as_float(0x4B000000u | (byte >> 4));
              float t = __fadd_rn(__fmul_rn(f_lo, sc[c]), bias);
              t = __fadd_rn(t, __fmul_rn(f_hi, sc[c]));
              t = __fadd_rn(t, bias);
              acc[c] += t;
            }
          }
      }
    }
  }
  if constexpr (MODE == kPDmaOnly) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = (float)isum[c];  // exact below 2^24
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c * 32 + lane;
        red[i] = (w == 0 ? 0.f : red[i]) + acc[c];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < kCols) {
    const int cc = threadIdx.x, nn = blockIdx.x * kCols + cc;
    if (nn < N) ws[(size_t)blockIdx.y * N + nn] = red[(cc & 3) * 32 + (cc >> 2)];
  }
}

constexpr int kStages = 4;
constexpr int kStageRows = 32;  // packed rows of 128 bytes per stage: 256 x 16 bytes

// dma_pure: grid = (ceil(N/128), K/tk). The block copies its whole span of
// tk/2 packed rows by 128 columns from device memory into a ring of four
// shared-memory stages and sums the first 8 rows only.
__global__ void __launch_bounds__(kThreads) lab_probe_dma_pure(const uint8_t* __restrict__ q,
                                                               float* __restrict__ ws, int N,
                                                               int span_rows) {
  __shared__ __align__(16) uint8_t stage[kStages][kStageRows * kCols];
  const int n0 = blockIdx.x * kCols;
  const int r = threadIdx.x >> 3, cb = (threadIdx.x & 7) * 16;  // a thread's 16 bytes
  const uint8_t* base = q + (size_t)blockIdx.y * span_rows * N + n0;
  const int chunks = (span_rows + kStageRows - 1) / kStageRows;
  auto fetch = [&](int c) {
    const int row = c * kStageRows + r;
    if (c < chunks && row < span_rows && n0 + cb < N)
      cp_async16(&stage[c % kStages][r * kCols + cb], base + (size_t)row * N + cb);
    cp_async_commit();
  };
  for (int c = 0; c < kStages; ++c) fetch(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 1>();  // chunk c has landed
    __syncthreads();
    const int col = threadIdx.x;
    if (c == 0 && col < kCols && n0 + col < N) {
      int sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += stage[0][i * kCols + col];
      ws[(size_t)blockIdx.y * N + n0 + col] = (float)sum;
    }
    __syncthreads();  // stage c % kStages is free again
    fetch(c + kStages);
  }
  cp_async_wait<0>();
}

// out[m][n] = sum over the ksplit partials, in order. ws rows: `ws_rows` per
// split (tm, or 1 for the probes: every row of out the same).
__global__ void lab_reduce(const float* __restrict__ ws, float* __restrict__ out, int tm,
                           int N, int ws_rows, int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)tm * N) return;
  const size_t per = (size_t)ws_rows * N;
  const size_t j = ws_rows == 1 ? i % N : i;
  float a = 0.f;
  for (int y = 0; y < ksplit; ++y) a += ws[(size_t)y * per + j];
  out[i] = a;
}

void reduce(const float* ws, float* out, int tm, int N, int ws_rows, int ksplit,
            cudaStream_t st) {
  const size_t mn = (size_t)tm * N;
  lab_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, out, tm, N, ws_rows, ksplit);
}

bool bad_shape(int tm, int K, int N, int ksplit) {
  return tm < kTM || tm % kTM || K < 32 || K % 32 || N < 16 || N % 16 || ksplit < 1;
}

}  // namespace

// Rows L2, L3, L9 and L12. mode: 0 int4-typed nibbles, f32 (L2, L9); 1 the
// same with bf16 weights (L9); 2 Q4_0 to bf16 in one rounding (L3 bf16dot); 3
// Q4_0 with the FMA in bf16, x as the halves x, x_hi (L3 split_bf16_h); 4 raw
// bf16 weights (L12; q is bf16 [K, N], s is not read). x bf16, s bf16, out f32
// [tm, N], ws f32 [ksplit, tm, N]; ceil(K/32 / ksplit) <= 16.
extern "C" int llamago_lab_fmatmul(const void* x, const void* x_hi, const void* q,
                                   const void* s, void* out, void* ws, int tm, int K, int N,
                                   int mode, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(tm, K, N, ksplit)) return (int)cudaErrorInvalidValue;
  const int upb = (K / 32 + ksplit - 1) / ksplit;
  if (upb > kMaxUnits || mode < 0 || mode > 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, ksplit, tm / kTM);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* xh = static_cast<const __nv_bfloat16*>(x_hi);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  float* w = static_cast<float*>(ws);
  switch (mode) {
    case kFI4: lab_fgemv<kFI4><<<grid, kThreads, 0, st>>>(xp, xh, qp, sp, w, tm, K, N, upb); break;
    case kFI4Bf16:
      lab_fgemv<kFI4Bf16><<<grid, kThreads, 0, st>>>(xp, xh, qp, sp, w, tm, K, N, upb);
      break;
    case kFQ4Bf16:
      lab_fgemv<kFQ4Bf16><<<grid, kThreads, 0, st>>>(xp, xh, qp, sp, w, tm, K, N, upb);
      break;
    case kFQ4Bf16Fma:
      lab_fgemv<kFQ4Bf16Fma><<<grid, kThreads, 0, st>>>(xp, xh, qp, sp, w, tm, K, N, upb);
      break;
    default: lab_fgemv<kFW16><<<grid, kThreads, 0, st>>>(xp, xh, qp, sp, w, tm, K, N, upb); break;
  }
  reduce(w, static_cast<float*>(out), tm, N, tm, ksplit, st);
  return (int)cudaGetLastError();
}

// Rows L6, L7, L8 and L10. wfmt: 0 Q8_0, 1 Q4_0 (centered), 2 the Q4_0 bytes
// as two's-complement nibbles. xlayout: 0 xq [tm, K]; 1 xq [K/32, tm, 32]; 2
// the halves xq, xq_hi [tm, K/2] (wfmt 1 only). sx f32 [K/(32*sg_units), tm]
// or null. Other arguments as llamago_lab_fmatmul.
extern "C" int llamago_lab_imatmul(const void* xq, const void* xq_hi, const void* sx,
                                   const void* q, const void* s, void* out, void* ws, int tm,
                                   int K, int N, int wfmt, int xlayout, int sg_units,
                                   int tile_units, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(tm, K, N, ksplit)) return (int)cudaErrorInvalidValue;
  const int upb = (K / 32 + ksplit - 1) / ksplit;
  if (upb > kMaxUnits || wfmt < 0 || wfmt > 2 || xlayout < 0 || xlayout > 2 || sg_units < 1 ||
      tile_units < sg_units || tile_units % sg_units || (xlayout == kXHalves && wfmt != kWQ4) ||
      (wfmt == kWI4 && xlayout != kXRows))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, ksplit, tm / kTM);
  const auto* xp = static_cast<const int8_t*>(xq);
  const auto* xh = static_cast<const int8_t*>(xq_hi);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  float* w = static_cast<float*>(ws);
  if (wfmt == kWQ8)
    lab_igemv<kWQ8><<<grid, kThreads, 0, st>>>(xp, xh, sxp, qp, sp, w, tm, K, N, upb, xlayout,
                                               sg_units, tile_units);
  else if (wfmt == kWQ4)
    lab_igemv<kWQ4><<<grid, kThreads, 0, st>>>(xp, xh, sxp, qp, sp, w, tm, K, N, upb, xlayout,
                                               sg_units, tile_units);
  else
    lab_igemv<kWI4><<<grid, kThreads, 0, st>>>(xp, xh, sxp, qp, sp, w, tm, K, N, upb, xlayout,
                                               sg_units, tile_units);
  reduce(w, static_cast<float*>(out), tm, N, tm, ksplit, st);
  return (int)cudaGetLastError();
}

// x bf16 [tm, K] -> xq int8 [tm, K], sx f32 [K/32, tm], per (row, 32-block).
extern "C" int llamago_lab_quantize_x(const void* x, void* xq, void* sx, int tm, int K,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tm < 1 || K < 32 || K % 32) return (int)cudaErrorInvalidValue;
  const int items = tm * (K / 32);
  lab_quantize_x<<<(items + 3) / 4, 128, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<int8_t*>(xq),
                                                  static_cast<float*>(sx), tm, K);
  return (int)cudaGetLastError();
}

// Row L11. mode: 0 decode_only, 1 decode_bitcast, 2 dma_only, 3 dma_pure. q
// Q4_0 bytes [K/2, N], s bf16 [K/32, N], out f32 [tm, N] (every row the same),
// ws f32 [ksplit, N]; a block covers `rows` rows of K (dma_pure: its span tk),
// ksplit = ceil(K / rows).
extern "C" int llamago_lab_probe(const void* q, const void* s, void* out, void* ws, int tm,
                                 int K, int N, int mode, int rows, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tm < 1 || K < 32 || K % 32 || N < 16 || N % 16 || rows < 32 || rows % 32 ||
      ksplit != (K + rows - 1) / rows || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  float* w = static_cast<float*>(ws);
  const int upb = rows / 32;
  if (mode == kPDecode)
    lab_probe<kPDecode><<<grid, kThreads, 0, st>>>(qp, sp, w, K, N, upb);
  else if (mode == kPDecodeBitcast)
    lab_probe<kPDecodeBitcast><<<grid, kThreads, 0, st>>>(qp, sp, w, K, N, upb);
  else if (mode == kPDmaOnly)
    lab_probe<kPDmaOnly><<<grid, kThreads, 0, st>>>(qp, sp, w, K, N, upb);
  else if (mode == kPDmaPure && K % rows == 0)
    lab_probe_dma_pure<<<grid, kThreads, 0, st>>>(qp, w, N, rows / 2);
  else
    return (int)cudaErrorInvalidValue;
  reduce(w, static_cast<float*>(out), tm, N, 1, ksplit, st);
  return (int)cudaGetLastError();
}
