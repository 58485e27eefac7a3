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
// the 4 rows of a decode step. A launch costs more, so the chain of one
// launch bounds it: the launch, the trips to memory, the reduction, the
// stores.
//
// What the design does about it: one trip to memory. One block a row; its
// threads (`tpr`, a multiple of 32) each issue all their loads of x and of
// w before the reduction, as vectors of V values (16 bytes of x where d and
// the pointers allow), and keep up to kKeep vectors of each in registers:
// at d = 4096 in bf16 a row is 512 vectors of x and 512 of w. The sum of
// squares runs in f32 over a thread's registers, then through
// __shfl_xor_sync; one barrier follows, after which every warp reads the
// block's warp sums and reduces them itself, so no second barrier and no
// broadcast through shared memory. Several rows a block of 128 threads
// measured slower at 256 rows on an H100 (PERF.md's K10 row). The output is stored as the same vectors. A row longer than the
// registers hold (more than kKeep * tpr vectors) reads the rest of x and w
// again from L1/L2.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // threads a row, one row a block
constexpr int kKeep = 4;          // vectors of x (and of w) a thread keeps in registers

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V values of T as aligned vector loads of at most 16 bytes each
template <typename T, int V>
struct alignas(V * sizeof(T) < 16 ? V * sizeof(T) : 16) Pack {
  T v[V];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (rows), block tpr threads: block `row` takes that row; thread t owns
// its vectors t, t + tpr, ...
template <typename TX, typename TW, int V>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_onepass(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                     int d, float eps) {
  __shared__ float warp_sums[kMaxThreads / 32];
  using PX = Pack<TX, V>;
  using PW = Pack<TW, V>;
  const int t = threadIdx.x, tpr = blockDim.x, row = blockIdx.x;
  const int nvec = d / V;
  const PX* xr = reinterpret_cast<const PX*>(x + (size_t)row * d);
  const PW* wv = reinterpret_cast<const PW*>(w);
  PX* outr = reinterpret_cast<PX*>(out + (size_t)row * d);

  PX xk[kKeep];
  PW wk[kKeep];
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    const int j = t + k * tpr;
    if (j < nvec) {
      xk[k] = xr[j];
      wk[k] = wv[j];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kKeep; ++k)
    if (t + k * tpr < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = to_f(xk[k].v[e]);
        ss = fmaf(v, v, ss);
      }
    }
  for (int j = t + kKeep * tpr; j < nvec; j += tpr) {
    const PX p = xr[j];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = to_f(p.v[e]);
      ss = fmaf(v, v, ss);
    }
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  const float total = warp_sum(lane < (tpr >> 5) ? warp_sums[lane] : 0.f);
  const float r = 1.0f / sqrtf(total / (float)d + eps);

#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    const int j = t + k * tpr;
    if (j < nvec) {
      PX o;
#pragma unroll
      for (int e = 0; e < V; ++e)
        o.v[e] = from_f<TX>(to_f(xk[k].v[e]) * r * to_f(wk[k].v[e]));
      outr[j] = o;
    }
  }
  for (int j = t + kKeep * tpr; j < nvec; j += tpr) {
    const PX p = xr[j];
    const PW q = wv[j];
    PX o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.v[e] = from_f<TX>(to_f(p.v[e]) * r * to_f(q.v[e]));
    outr[j] = o;
  }
}

template <typename TX, typename TW, int V>
int launch_v(const void* x, const void* w, void* out, int rows, int d, float eps, int tpr,
             cudaStream_t st) {
  rms_norm_onepass<TX, TW, V><<<rows, tpr, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), d, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps, int vec,
           int tpr, cudaStream_t st) {
  switch (vec) {
    case 1: return launch_v<TX, TW, 1>(x, w, out, rows, d, eps, tpr, st);
    case 2: return launch_v<TX, TW, 2>(x, w, out, rows, d, eps, tpr, st);
    case 4: return launch_v<TX, TW, 4>(x, w, out, rows, d, eps, tpr, st);
    case 8:  // 16 bytes of bf16 x; f32 x loads at most 4 values
      if constexpr (sizeof(TX) == 2)
        return launch_v<TX, TW, 8>(x, w, out, rows, d, eps, tpr, st);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// `vec` values a vector (dividing d; x, w and out aligned to it), `tpr`
// threads a row (a multiple of 32, at most 512), one row a block: the
// wrapper's norm_plan. Returns cudaGetLastError() after the launch.
extern "C" int llamago_rms_norm(const void* x, const void* w, void* out, int rows, int d,
                                float eps, int x_bf16, int w_bf16, int vec, int tpr, void* stream) {
  if (rows < 1 || d < 1 || vec < 1 || d % vec || tpr < 32 || tpr % 32 || tpr > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, vec, tpr, st);
  if (x_bf16) return launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, vec, tpr, st);
  if (w_bf16) return launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, vec, tpr, st);
  return launch<float, float>(x, w, out, rows, d, eps, vec, tpr, st);
}
