// K5 and K6: the w4x8 int4 matmuls for Hopper (sm_90a).
//
// Weight format (llamago_tpu_torch/ops/quant.py quantize_w4x8): centered
// int4 values -8..7, packed uint8 [K/2, N] row-major with byte r of a column
// holding rows 2r (low nibble) and 2r+1 (high nibble); one bf16 scale per
// 128-row group and column, stored as [K/64, N] with rows 2g and 2g+1 equal.
// These kernels read row 2g only.
//
// K5, W4A8 decode matmul (replaces llamago_tpu/ops/kernels.py
// _w4x8_decode_kernel and the activation quantization of its launcher
// _w4x8_matmul_2d):
//   per (row m, group g): sx = amax|x| * fl(1/127) (1 where amax is 0),
//                         xq = clip(rint(x / sx), -127, 127)     (int8)
//   out[m, n] = sum_g f32(sum_{k in g} xq[m, k] * w[k, n]) * sx[m, g] * s[g, n]
// with an exact int32 dot per group and the sum over groups in f32.
//
// K6, stream matmul for more rows (replaces _w4x8_stream_kernel):
//   out[m, n] = sum_k f32(x[m, k]) * (f32(w[k, n]) * f32(s[k / 128, n]))
// in f32 throughout, no activation quantization.
//
// x: f32 or bf16 [M, K] row-major; out: x's dtype [M, N]. K % 128 == 0,
// N % 16 == 0.
//
// What bounds them: K5 runs every decode step at M = number of slots
// (<= 16): 4*M integer operations per weight byte, far below the card's
// ridge, so its bound is the packed weight stream (K*N/2 bytes) plus the
// scales over device-memory bandwidth. K6 runs prefill windows (M > 16): the
// same bytes with M times the work, done in f32 outside the tensor cores,
// so it is bound by f32 operations.
//
// What the design does about it:
//  * K5 is three launches from one entry point. w4x8_quant_x quantizes x
//    with one warp per (row, group): the rounding decisions (rintf, IEEE
//    division, the product by fl(1/127)) are the plain version's bit for
//    bit. w4x8_a8 streams the weights: a thread owns CT neighbouring columns
//    (8 up to 8 rows, 4 above, so that the int32 and f32 sums of every row
//    stay in registers), a warp owns one 128-row group at a time and reads
//    whole packed rows, eight rows in flight per thread. The interleaved
//    nibbles of two packed rows are turned into __dp4a operands (four
//    consecutive k of one column in one register) with two masks and
//    __byte_perm: a nibble moved to the high half of its byte is 16 times
//    its signed value, so the int32 dot comes out 16 times too large and is
//    shifted back exactly. A lane holds one int8x4 word of the group's xq and
//    broadcasts it by warp shuffle. The four warps of a block take different
//    groups, the grid splits K at whole groups so that enough blocks are in
//    flight, and w4x8_reduce adds the partial sums in a fixed order (no
//    atomics: the same result from run to run).
//  * K6 is a plain shared-memory tiled f32 kernel (64x64 output tile, 32
//    rows of K per step, 4x4 outputs per thread); each packed byte is read
//    once and gives two rows of the tile. Tensor cores are later work.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry points return cudaGetLastError() after their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------- K5: x -> int8

// One warp per (row, group); a lane takes 4 consecutive values.
template <typename XT>
__global__ void __launch_bounds__(128) w4x8_quant_x(const XT* __restrict__ x,
                                                    int8_t* __restrict__ xq,
                                                    float* __restrict__ sx, int M,
                                                    int K) {
  const int lane = threadIdx.x & 31;
  const int G = K / kGroup;
  const int item = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (item >= M * G) return;
  const int m = item / G, g = item % G;
  const size_t off = (size_t)m * K + (size_t)g * kGroup + lane * 4;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = to_f(x[off + i]);
  float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, d));
  const float inv127 = 1.0f / 127.0f;  // rounded to f32 once, as the reference's product
  const float s = amax > 0.f ? __fmul_rn(amax, inv127) : 1.0f;
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
    packed |= ((uint32_t)(uint8_t)(int8_t)(int)r) << (8 * i);
  }
  *reinterpret_cast<uint32_t*>(xq + off) = packed;
  if (lane == 0) sx[(size_t)m * G + g] = s;
}

// ------------------------------------------------------------- K5: the matmul

constexpr int kA8Warps = 4;

template <int W> __device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&o)[W]);
template <> __device__ __forceinline__ void load_words<1>(const uint8_t* p, uint32_t (&o)[1]) {
  o[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
}
template <> __device__ __forceinline__ void load_words<2>(const uint8_t* p, uint32_t (&o)[2]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  o[0] = v.x;
  o[1] = v.y;
}

// grid = (ceil(N / (32*CT)), ksplit), block = 128 threads. Block y covers
// groups [y*gpb, (y+1)*gpb). M <= MT rows; ws is [ksplit][rows of the whole
// call][N] with `mn` elements per split.
template <int MT, int CT>
__global__ void __launch_bounds__(128) w4x8_a8(const int8_t* __restrict__ xq,
                                               const float* __restrict__ sx,
                                               const uint8_t* __restrict__ q,
                                               const __nv_bfloat16* __restrict__ s,
                                               float* __restrict__ ws, int M, int K,
                                               int N, int gpb, size_t mn) {
  constexpr int W = CT / 4;  // 32-bit words of a packed row per thread
  constexpr int kCols = 32 * CT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane * CT;
  const bool valid = n < N;
  const int G = K / kGroup;
  const int g0 = blockIdx.y * gpb;
  const int g1 = min(g0 + gpb, G);

  float facc[MT][CT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CT; ++c) facc[m][c] = 0.f;

  for (int g = g0 + warp; g < g1; g += kA8Warps) {
    int xr[MT];  // lane l: the int8x4 word of k = 128g + 4l .. 4l+3
    float sxv[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xr[m] = 0;
      sxv[m] = 0.f;
      if (m < M) {
        xr[m] = reinterpret_cast<const int*>(xq + (size_t)m * K + (size_t)g * kGroup)[lane];
        sxv[m] = sx[(size_t)m * G + g];
      }
    }
    int iacc[MT][CT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CT; ++c) iacc[m][c] = 0;

    const uint8_t* qg = q + (size_t)g * (kGroup / 2) * N + n;
    for (int t0 = 0; t0 < 32; t0 += 4) {  // 4 words of xq = 8 packed rows
      uint32_t wb[8][W];
      if (valid) {
#pragma unroll
        for (int r = 0; r < 8; ++r) load_words<W>(qg + (size_t)(2 * t0 + r) * N, wb[r]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int xw[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) xw[m] = __shfl_sync(kFull, xr[m], t0 + j);
        if (valid) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            // rows 2r, 2r+1 in a; 2r+2, 2r+3 in b; each byte one column
            const uint32_t a = wb[2 * j][w], b = wb[2 * j + 1][w];
            const uint32_t alo = (a << 4) & 0xF0F0F0F0u, ahi = a & 0xF0F0F0F0u;
            const uint32_t blo = (b << 4) & 0xF0F0F0F0u, bhi = b & 0xF0F0F0F0u;
            const uint32_t ta = __byte_perm(alo, ahi, 0x5140), tb = __byte_perm(alo, ahi, 0x7362);
            const uint32_t ua = __byte_perm(blo, bhi, 0x5140), ub = __byte_perm(blo, bhi, 0x7362);
            uint32_t col[4];  // 16 x (w[4t], w[4t+1], w[4t+2], w[4t+3]) of one column
            col[0] = __byte_perm(ta, ua, 0x5410);
            col[1] = __byte_perm(ta, ua, 0x7632);
            col[2] = __byte_perm(tb, ub, 0x5410);
            col[3] = __byte_perm(tb, ub, 0x7632);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                iacc[m][4 * w + i] = __dp4a((int)col[i], xw[m], iacc[m][4 * w + i]);
          }
        }
      }
    }
    if (valid) {
      float sc[CT];
      const __nv_bfloat16* sp = s + (size_t)(2 * g) * N + n;
#pragma unroll
      for (int c = 0; c < CT; ++c) sc[c] = __bfloat162float(sp[c]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CT; ++c)
          facc[m][c] += (float)(iacc[m][c] >> 4) * sxv[m] * sc[c];
    }
  }

  // Reduce the warps' partial sums in a fixed order. Layout [m][c][lane]
  // keeps the stores free of bank conflicts.
  __shared__ float red[MT * CT * 32];
  for (int w = 0; w < kA8Warps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int i = (m * CT + c) * 32 + lane;
          red[i] = (w == 0 ? 0.f : red[i]) + facc[m][c];
        }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < MT * kCols; i += blockDim.x) {
    const int m = i / kCols;
    const int c = i % kCols;
    const int nn = blockIdx.x * kCols + c;
    if (m < M && nn < N)
      ws[blockIdx.y * mn + (size_t)m * N + nn] = red[(m * CT + (c % CT)) * 32 + c / CT];
  }
}

// out[i] = sum over the ksplit partials, in order.
template <typename OT>
__global__ void w4x8_reduce(const float* __restrict__ ws, OT* __restrict__ out, size_t mn,
                            int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float a = 0.f;
  for (int y = 0; y < ksplit; ++y) a += ws[(size_t)y * mn + i];
  out[i] = from_f<OT>(a);
}

template <int MT, int CT>
void launch_a8(const int8_t* xq, const float* sx, const uint8_t* q, const __nv_bfloat16* s,
               float* ws, int M, int K, int N, int ksplit, int gpb, size_t mn,
               cudaStream_t st) {
  dim3 grid((N + 32 * CT - 1) / (32 * CT), ksplit);
  w4x8_a8<MT, CT><<<grid, 32 * kA8Warps, 0, st>>>(xq, sx, q, s, ws, M, K, N, gpb, mn);
}

template <typename XT>
void quant_x(const void* x, int8_t* xq, float* sx, int M, int K, cudaStream_t st) {
  const int items = M * (K / kGroup);
  w4x8_quant_x<XT><<<(items + 3) / 4, 128, 0, st>>>(static_cast<const XT*>(x), xq, sx, M, K);
}

// ------------------------------------------------------------------------ K6

constexpr int kTM = 64, kTN = 64, kTK = 32;

// grid = (ceil(N/64), ceil(M/64)), block = 256 threads (16 x 16), 4 x 4
// outputs each.
template <typename XT>
__global__ void __launch_bounds__(256) w4x8_stream(const XT* __restrict__ x,
                                                   const uint8_t* __restrict__ q,
                                                   const __nv_bfloat16* __restrict__ s,
                                                   XT* __restrict__ out, int M, int K,
                                                   int N) {
  __shared__ float xs[kTK][kTM + 4];
  __shared__ float wsh[kTK][kTN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < (kTM * kTK) / 256; ++i) {
      const int idx = tid + 256 * i;
      const int r = idx / kTK, c = idx % kTK;
      const int m = m0 + r;
      xs[c][r] = (m < M) ? to_f(x[(size_t)m * K + k0 + c]) : 0.f;
    }
    const size_t srow = (size_t)(2 * (k0 / kGroup)) * N;  // a tile lies in one group
#pragma unroll
    for (int i = 0; i < (kTK / 2 * kTN) / 256; ++i) {
      const int idx = tid + 256 * i;
      const int pr = idx / kTN, c = idx % kTN;
      const int n = n0 + c;
      float lo = 0.f, hi = 0.f;
      if (n < N) {
        const uint32_t byte = q[(size_t)(k0 / 2 + pr) * N + n];
        const float sc = __bfloat162float(s[srow + n]);
        lo = (float)((int)((byte & 0xFu) ^ 8u) - 8) * sc;
        hi = (float)((int)((byte >> 4) ^ 8u) - 8) * sc;
      }
      wsh[2 * pr][c] = lo;
      wsh[2 * pr + 1][c] = hi;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wsh[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = from_f<XT>(acc[i][j]);
    }
  }
}

}  // namespace

// K5's activation quantization alone: xq int8 [M, K], sx f32 [M, K/128].
extern "C" int llamago_w4x8_quantize_x(const void* x, void* xq, void* sx, int M, int K,
                                       int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    quant_x<__nv_bfloat16>(x, static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, st);
  else
    quant_x<float>(x, static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, st);
  return (int)cudaGetLastError();
}

// K5. xq (int8 [M, K]), sx (f32 [M, K/128]) and ws (f32 [ksplit, M, N]) are
// scratch. `gpb` groups per K-split, ksplit * gpb >= K/128. Rows are taken
// 16 at a time. x_bf16: 1 for bfloat16, 0 for float32.
extern "C" int llamago_w4x8_matmul_a8(const void* x, const void* q, const void* s, void* out,
                                      void* xq, void* sx, void* ws, int M, int K, int N,
                                      int x_bf16, int ksplit, int gpb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* xq8 = static_cast<int8_t*>(xq);
  float* sxf = static_cast<float*>(sx);
  float* wsf = static_cast<float*>(ws);
  const uint8_t* qq = static_cast<const uint8_t*>(q);
  const __nv_bfloat16* ss = static_cast<const __nv_bfloat16*>(s);
  const size_t mn = (size_t)M * N;
  const int G = K / kGroup;
  if (x_bf16)
    quant_x<__nv_bfloat16>(x, xq8, sxf, M, K, st);
  else
    quant_x<float>(x, xq8, sxf, M, K, st);
  for (int m0 = 0; m0 < M; m0 += 16) {
    const int mc = (M - m0 < 16) ? M - m0 : 16;
    const int8_t* xq0 = xq8 + (size_t)m0 * K;
    const float* sx0 = sxf + (size_t)m0 * G;
    float* ws0 = wsf + (size_t)m0 * N;
    if (mc <= 1)
      launch_a8<1, 8>(xq0, sx0, qq, ss, ws0, mc, K, N, ksplit, gpb, mn, st);
    else if (mc <= 2)
      launch_a8<2, 8>(xq0, sx0, qq, ss, ws0, mc, K, N, ksplit, gpb, mn, st);
    else if (mc <= 4)
      launch_a8<4, 8>(xq0, sx0, qq, ss, ws0, mc, K, N, ksplit, gpb, mn, st);
    else if (mc <= 8)
      launch_a8<8, 8>(xq0, sx0, qq, ss, ws0, mc, K, N, ksplit, gpb, mn, st);
    else
      launch_a8<16, 4>(xq0, sx0, qq, ss, ws0, mc, K, N, ksplit, gpb, mn, st);
  }
  const unsigned blocks = (unsigned)((mn + 255) / 256);
  if (x_bf16)
    w4x8_reduce<__nv_bfloat16><<<blocks, 256, 0, st>>>(wsf, static_cast<__nv_bfloat16*>(out),
                                                       mn, ksplit);
  else
    w4x8_reduce<float><<<blocks, 256, 0, st>>>(wsf, static_cast<float*>(out), mn, ksplit);
  return (int)cudaGetLastError();
}

// K6. x_bf16: 1 for bfloat16, 0 for float32.
extern "C" int llamago_w4x8_matmul_stream(const void* x, const void* q, const void* s,
                                          void* out, int M, int K, int N, int x_bf16,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  const uint8_t* qq = static_cast<const uint8_t*>(q);
  const __nv_bfloat16* ss = static_cast<const __nv_bfloat16*>(s);
  if (x_bf16)
    w4x8_stream<__nv_bfloat16><<<grid, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x), qq,
                                                     ss, static_cast<__nv_bfloat16*>(out), M,
                                                     K, N);
  else
    w4x8_stream<float><<<grid, 256, 0, st>>>(static_cast<const float*>(x), qq, ss,
                                             static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}
