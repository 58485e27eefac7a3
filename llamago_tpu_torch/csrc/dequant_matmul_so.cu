// K9: scale-on-output Q8_0 / Q4_0 matmul for Hopper (sm_90a).
//
//   out[m, n] = sum_b s[b, n] * ( sum_{k in block b} x[m, k] * raw[k, n]
//                                 - (bits == 4 ? 8 * sum_{k in block b} x[m, k] : 0) )
//
// over the 32-row quant blocks b: the raw integers (int8 for Q8_0, the
// nibbles 0..15 for Q4_0) are dotted with the block's x in f32, the Q4_0
// offset of 8 is taken off through the block's sum of x, and the block's
// scale is applied once to the partial product instead of to every weight.
// x: f32 or bf16 [M, K] row-major; q: int8 [K, N] (bits=8) or uint8 [K/2, N]
// (bits=4, byte j of a block holds rows j and j+16); s: f32 or bf16
// [K/32, N]; out: x's dtype [M, N].
//
// Replaces llamago_tpu/ops/kernels.py _dequant_mm_kernel_so, reached through
// _dequant_matmul_2d when max(8, m) <= SCALE_ON_OUTPUT_MAX_M (off by
// default there and here).
//
// What bounds it: it runs at decode row counts only, so like K1's GEMV it is
// bound by the weight stream (K*N or K*N/2 bytes) plus the scales over
// device-memory bandwidth.
//
// What the design does about it: the GEMV of csrc/dequant_matmul.cu with the
// scale moved out of the inner loop. A thread owns 16 neighbouring columns
// and reads one 16-byte vector of a weight row per step; a warp takes one
// quant block at a time, holds the block's x in its lanes and broadcasts it
// by shuffles; the block's partial products wait in registers for the
// scale, which is why a launch takes at most 4 rows (the entry point walks
// more rows 4 at a time, reading the weights again). Eight warps split the
// blocks of the grid's K range, the grid splits K, and so_reduce adds the
// partial sums in a fixed order.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kCols = 32 * 16;  // columns per block: 32 lanes x 16
constexpr int kRows = 4;        // rows per launch

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

union Q16 {
  int4 v;
  int8_t b[16];
};

// grid = (ceil(N/512), ksplit), block = 256 threads. Block y covers quant
// blocks [y*bpb, (y+1)*bpb). ws is [ksplit][rows of the whole call][N] with
// `mn` elements per split.
template <typename XT, typename ST, int MT, int BITS>
__global__ void __launch_bounds__(256) so_gemv(const XT* __restrict__ x,
                                               const int8_t* __restrict__ q,
                                               const ST* __restrict__ s,
                                               float* __restrict__ ws, int M, int K,
                                               int N, int bpb, size_t mn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane * 16;
  const bool valid = n < N;
  const int nb = K / 32;
  const int kb0 = blockIdx.y * bpb;
  const int kb1 = min(kb0 + bpb, nb);

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  for (int kb = kb0 + warp; kb < kb1; kb += kWarps) {
    float xr[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      xr[m] = (m < M) ? to_f(x[(size_t)m * K + kb * 32 + lane]) : 0.f;
    float part[MT][16];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) part[m][j] = 0.f;

    if constexpr (BITS == 8) {
      const int8_t* qrow = q + (size_t)kb * 32 * N + n;
#pragma unroll 8
      for (int r = 0; r < 32; ++r) {
        float xv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) xv[m] = __shfl_sync(kFull, xr[m], r);
        if (valid) {
          Q16 w;
          w.v = __ldg(reinterpret_cast<const int4*>(qrow + (size_t)r * N));
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float wj = (float)w.b[j];
#pragma unroll
            for (int m = 0; m < MT; ++m) part[m][j] = fmaf(xv[m], wj, part[m][j]);
          }
        }
      }
    } else {
      const int8_t* qrow = q + (size_t)kb * 16 * N + n;
#pragma unroll 8
      for (int r = 0; r < 16; ++r) {
        float xlo[MT], xhi[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          xlo[m] = __shfl_sync(kFull, xr[m], r);
          xhi[m] = __shfl_sync(kFull, xr[m], r + 16);
        }
        if (valid) {
          Q16 w;
          w.v = __ldg(reinterpret_cast<const int4*>(qrow + (size_t)r * N));
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int byte = (uint8_t)w.b[j];
            const float wlo = (float)(byte & 0xF), whi = (float)(byte >> 4);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              part[m][j] = fmaf(xhi[m], whi, fmaf(xlo[m], wlo, part[m][j]));
          }
        }
      }
      // the Q4_0 offset: (nibble - 8) * s needs -8 * s * sum(x)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float xsum = xr[m];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) xsum += __shfl_xor_sync(kFull, xsum, d);
#pragma unroll
        for (int j = 0; j < 16; ++j) part[m][j] -= 8.0f * xsum;
      }
    }
    if (valid) {
      const ST* sp = s + (size_t)kb * N + n;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float sc = to_f(sp[j]);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][j] = fmaf(part[m][j], sc, acc[m][j]);
      }
    }
  }

  // Reduce the eight warps' partial sums in a fixed order. Layout
  // [m][j][lane] keeps the stores free of bank conflicts.
  __shared__ float red[MT * 16 * 32];
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = (m * 16 + j) * 32 + lane;
          red[i] = (w == 0 ? 0.f : red[i]) + acc[m][j];
        }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < MT * kCols; i += blockDim.x) {
    const int m = i / kCols;
    const int c = i % kCols;
    const int nn = blockIdx.x * kCols + c;
    if (m < M && nn < N)
      ws[blockIdx.y * mn + (size_t)m * N + nn] = red[(m * 16 + (c % 16)) * 32 + c / 16];
  }
}

// out[i] = sum over the ksplit partials, in order.
template <typename OT>
__global__ void so_reduce(const float* __restrict__ ws, OT* __restrict__ out, size_t mn,
                          int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float a = 0.f;
  for (int y = 0; y < ksplit; ++y) a += ws[(size_t)y * mn + i];
  out[i] = from_f<OT>(a);
}

template <typename XT, typename ST, int BITS>
void launch_bits(const void* x, const void* q, const void* s, void* out, float* ws, int M,
                 int K, int N, int ksplit, cudaStream_t st) {
  const int nb = K / 32;
  const int bpb = (nb + ksplit - 1) / ksplit;
  const size_t mn = (size_t)M * N;
  dim3 grid((N + kCols - 1) / kCols, ksplit);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const ST* ss = static_cast<const ST*>(s);
  for (int m0 = 0; m0 < M; m0 += kRows) {
    const int mc = (M - m0 < kRows) ? M - m0 : kRows;
    const XT* x0 = static_cast<const XT*>(x) + (size_t)m0 * K;
    float* ws0 = ws + (size_t)m0 * N;
    if (mc <= 1)
      so_gemv<XT, ST, 1, BITS><<<grid, 256, 0, st>>>(x0, qq, ss, ws0, mc, K, N, bpb, mn);
    else if (mc <= 2)
      so_gemv<XT, ST, 2, BITS><<<grid, 256, 0, st>>>(x0, qq, ss, ws0, mc, K, N, bpb, mn);
    else
      so_gemv<XT, ST, 4, BITS><<<grid, 256, 0, st>>>(x0, qq, ss, ws0, mc, K, N, bpb, mn);
  }
  so_reduce<XT><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, static_cast<XT*>(out), mn,
                                                              ksplit);
}

template <typename XT, typename ST>
void launch(const void* x, const void* q, const void* s, void* out, float* ws, int M,
            int K, int N, int bits, int ksplit, cudaStream_t st) {
  if (bits == 8)
    launch_bits<XT, ST, 8>(x, q, s, out, ws, M, K, N, ksplit, st);
  else
    launch_bits<XT, ST, 4>(x, q, s, out, ws, M, K, N, ksplit, st);
}

}  // namespace

// bits: 8 (q int8 [K, N]) or 4 (q uint8 [K/2, N]). x_bf16 / s_bf16: 1 for
// bfloat16, 0 for float32. `ws` is an f32 workspace of ksplit*M*N elements.
// Returns cudaGetLastError() after the launches.
extern "C" int llamago_dequant_matmul_so(const void* x, const void* q, const void* s,
                                         void* out, void* ws, int M, int K, int N, int bits,
                                         int x_bf16, int s_bf16, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (x_bf16 && s_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, w, M, K, N, bits, ksplit, st);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, q, s, out, w, M, K, N, bits, ksplit, st);
  else if (s_bf16)
    launch<float, __nv_bfloat16>(x, q, s, out, w, M, K, N, bits, ksplit, st);
  else
    launch<float, float>(x, q, s, out, w, M, K, N, bits, ksplit, st);
  return (int)cudaGetLastError();
}
