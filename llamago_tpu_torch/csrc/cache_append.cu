// K3: quantize-and-append of one new K row and one new V row per (batch,
// kv head) into the int8 KV cache, for Hopper (sm_90a).
//
// k_new / v_new: [B, 1, KV, hd] in bf16 or f32; k8 / v8: [B, KV, S, hd]
// int8; ks / vs: [B, KV, S] row scales, f32 or bf16 planes; pos: int32 [B].
// For each row x of hd values: a = max|x|, s = a * fl(1/127) (1 when
// a == 0), q = clamp(rint(x / s), -127, 127): an IEEE division and round
// half to even, as runtime/kv_cache.py quantize_kv_rows computes it on the
// CPU, so the two agree bit for bit. The row is quantized against the f32
// scale; a bf16 plane stores that scale rounded to bf16, as the TPU kernel
// casts it on the write. The row and its scale land at slot pos[b]
// (pos[b] + S when negative), clamped to [0, S - 1]: the placement of
// runtime/kv_cache.py write_rows. Every other row is left as it was.
//
// Replaces llamago_tpu/ops/cache_write.py _append_kernel, reached through
// cache_append_quant.
//
// What bounds it: the bytes it touches, 2 * B * KV * hd new values read,
// as many int8 bytes and 2 * B * KV scales written: about 200 KB per
// layer at 7B batch 8 in bf16, some 60 ns at 3.35 TB/s. A launch costs
// microseconds, so launch latency bounds it; the design keeps it to one
// launch per layer.
//
// What the design does about it: one launch writes both K and V of a
// layer, grid (B * KV, 2), one block of hd threads per row, one element per
// thread; the absmax is a warp-shuffle reduction and one pass over the
// warps' maxima in shared memory. The TPU kernel's 8-row read-modify-write
// is a TPU block rule and is not carried over: each thread writes its own
// byte, and thread 0 the row's scale.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (B * KV, 2): blockIdx.y 0 writes K, 1 writes V; blockDim.x == hd.
template <typename T, typename TS>
__global__ void append_quant(const T* __restrict__ k_new, const T* __restrict__ v_new,
                             int8_t* __restrict__ k8, int8_t* __restrict__ v8,
                             TS* __restrict__ ks, TS* __restrict__ vs,
                             const int* __restrict__ pos, int KV, int S, int hd) {
  __shared__ float warp_amax[32];
  __shared__ float amax;
  const int bh = blockIdx.x;  // b * KV + head; also the row of [B, 1, KV, hd]
  const bool is_v = blockIdx.y == 1;
  const int d = threadIdx.x, warp = d >> 5, lane = d & 31;

  const float x = to_f((is_v ? v_new : k_new)[(size_t)bh * hd + d]);
  float a = warp_max(fabsf(x));
  if (lane == 0) warp_amax[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = warp_max(lane < (int)(blockDim.x >> 5) ? warp_amax[lane] : 0.f);
    if (lane == 0) amax = a;
  }
  __syncthreads();
  a = amax;
  const float s = a > 0.f ? a * kInv127 : 1.f;
  const float r = fminf(fmaxf(rintf(x / s), -127.f), 127.f);

  int p = pos[bh / KV];
  if (p < 0) p += S;
  p = min(max(p, 0), S - 1);
  const size_t row = (size_t)bh * S + p;
  (is_v ? v8 : k8)[row * hd + d] = (int8_t)__float2int_rn(r);
  if (d == 0) (is_v ? vs : ks)[row] = from_f<TS>(s);
}

template <typename T, typename TS>
int launch(const void* k_new, const void* v_new, void* k8, void* v8, void* ks, void* vs,
           const void* pos, int B, int KV, int S, int hd, cudaStream_t st) {
  const dim3 grid(B * KV, 2);
  append_quant<T, TS><<<grid, hd, 0, st>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), static_cast<int8_t*>(k8),
      static_cast<int8_t*>(v8), static_cast<TS*>(ks), static_cast<TS*>(vs),
      static_cast<const int*>(pos), KV, S, hd);
  return (int)cudaGetLastError();
}

}  // namespace

// Writes the new K and V rows of one layer in place. hd must be a
// multiple of 32, at most 1024 (the wrapper checks). scale_bf16 says which
// type the scale planes hold. Returns cudaGetLastError() after the launch.
extern "C" int llamago_cache_append_quant(const void* k_new, const void* v_new, void* k8,
                                          void* v8, void* ks, void* vs, const void* pos,
                                          int B, int KV, int S, int hd, int is_bf16,
                                          int scale_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && scale_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(k_new, v_new, k8, v8, ks, vs, pos, B, KV, S,
                                                hd, st);
  if (is_bf16)
    return launch<__nv_bfloat16, float>(k_new, v_new, k8, v8, ks, vs, pos, B, KV, S, hd, st);
  if (scale_bf16)
    return launch<float, __nv_bfloat16>(k_new, v_new, k8, v8, ks, vs, pos, B, KV, S, hd, st);
  return launch<float, float>(k_new, v_new, k8, v8, ks, vs, pos, B, KV, S, hd, st);
}
