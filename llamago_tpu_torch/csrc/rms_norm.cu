// K10: fused RMSNorm over the rows of x, for Hopper (sm_90a).
//
// x: [rows, d] in bf16 or f32, w: [d] in bf16 or f32, out: x's shape and
// dtype. Per row, all in f32: ms = mean(x^2), y = x * (1 / sqrt(ms + eps))
// * w, rounded once to the output dtype. (The unfused rms_norm of
// ops/basic.py rounds the normalized row to x's dtype before it multiplies
// by the rounded weight: in bf16 that is another function.)
//
// Replaces llamago_tpu/ops/kernels.py _rms_norm_kernel, reached through
// _rms_norm_2d and fused_rms_norm. Its row tiles and its rule that d be a
// multiple of 128 are the TPU's block shapes and are not carried over: any
// d and any row count.
//
// What bounds it: the bytes, (2 * rows + 1) * d elements: 2.1 MB at 256
// rows of 4096 bf16 values, under a microsecond at 3.35 TB/s, and 40 KB at
// the 4 rows of a decode step. A launch costs more, so launch latency
// bounds it; fusing the pass keeps it to one launch where the unfused
// version takes several.
//
// What the design does about it: one block of 256 threads per row. Each
// thread keeps up to 16 of the row's values in registers (d <= 4096; a
// longer row is read again from L1/L2), so x is read from device memory
// once; the sum of squares is a warp-shuffle reduction and one pass over
// the warps' sums in shared memory.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeep = 16;  // values of the row a thread keeps in registers

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (rows): thread i owns the columns i, i + 256, ...
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) rms_norm_rows(const TX* __restrict__ x,
                                                          const TW* __restrict__ w,
                                                          TX* __restrict__ out, int d,
                                                          float eps) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  const TX* xr = x + (size_t)blockIdx.x * d;
  TX* outr = out + (size_t)blockIdx.x * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float keep[kKeep];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    const int c = threadIdx.x + k * kThreads;
    keep[k] = c < d ? to_f(xr[c]) : 0.f;
    ss = fmaf(keep[k], keep[k], ss);
  }
  for (int c = threadIdx.x + kKeep * kThreads; c < d; c += kThreads) {
    const float v = to_f(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = warp_sum(lane < kThreads / 32 ? warp_sums[lane] : 0.f);
    if (lane == 0) inv_rms = 1.0f / sqrtf(ss / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < d) outr[c] = from_f<TX>(keep[k] * r * to_f(w[c]));
  }
  for (int c = threadIdx.x + kKeep * kThreads; c < d; c += kThreads)
    outr[c] = from_f<TX>(to_f(xr[c]) * r * to_f(w[c]));
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps,
           cudaStream_t st) {
  rms_norm_rows<TX, TW><<<rows, kThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int llamago_rms_norm(const void* x, const void* w, void* out, int rows, int d,
                                float eps, int x_bf16, int w_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, st);
  if (x_bf16) return launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, st);
  if (w_bf16) return launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, st);
  return launch<float, float>(x, w, out, rows, d, eps, st);
}
