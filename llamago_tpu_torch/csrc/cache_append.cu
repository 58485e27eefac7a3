// K3: quantize-and-append of one new K row and one new V row per (batch,
// kv head) into the int8 KV cache, for Hopper (sm_90a).
//
// k_new / v_new: [B, 1, KV, hd] in bf16 or f32, each with its own batch
// and head strides in elements and its last dimension contiguous (on the
// serving path v_new is a strided view of the fused wqkv output); k8 / v8:
// [B, KV, S, hd] int8; ks / vs: [B, KV, S] row scales, f32 or bf16 planes;
// pos: [B], int64 or int32. For each row x of hd values: a = max|x|, s = a
// * fl(1/127) (1 when a == 0), q = clamp(rint(x / s), -127, 127): an IEEE
// division and round half to even, as runtime/kv_cache.py
// quantize_kv_rows computes it on the CPU, so the two agree bit for bit.
// The row is quantized against the f32 scale; a bf16 plane stores that
// scale rounded to bf16, as the TPU kernel casts it on the write. The row
// and its scale land at slot pos[b] (pos[b] + S when negative), clamped to
// [0, S - 1]: the placement of runtime/kv_cache.py write_rows. Every other
// row is left as it was.
//
// Replaces llamago_tpu/ops/cache_write.py _append_kernel, reached through
// cache_append_quant.
//
// What bounds it: the bytes it touches, 2 * B * KV * hd new values read,
// as many int8 bytes and 2 * B * KV scales written: about 200 KB per
// layer at 7B batch 8 in bf16, some 60 ns at 3.35 TB/s. A launch costs
// microseconds, so the chain of one launch bounds it: the launch, one
// round trip to memory for the row, the reduction, the stores.
//
// What the design does about it: one launch a layer, and nothing else on
// the device. The kernel reads the new rows where the projection left them
// (their strides are arguments) and the positions in the caller's dtype,
// so the wrapper issues no copy and no cast. One warp takes one (b, head,
// K or V) row: each lane loads its hd / 32 values with the widest aligned
// vector loads (8 bytes at hd = 128 in bf16) and its position at once, the
// absmax is a butterfly of __shfl_xor_sync (no shared memory, no barrier),
// the quotient is __fdiv_rn, each lane packs its int8 values into one
// store (4 bytes at hd = 128) and lane 0 writes the scale. The TPU
// kernel's 8-row read-modify-write is a TPU block rule and is not carried
// over.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv127 = 1.0f / 127.0f;
constexpr int kMaxVals = 32;  // values a lane holds: hd <= 1024

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// V values of T as one aligned vector load (at most 16 bytes)
template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T v[V];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct AppendArgs {
  const void* k_new;
  const void* v_new;
  long long k_sb, k_sh, v_sb, v_sh;  // batch and head strides of the new rows, in elements
  int8_t* k8;
  int8_t* v8;
  void* ks;
  void* vs;
  const void* pos;
  int B, KV, S, hd;
  int scale_bf16, pos_i64;
};

// Warp w of the grid takes row w: rows 0 .. B*KV - 1 are K's, the next
// B*KV V's. Lane l owns the row's values [l * vpl, (l + 1) * vpl), vpl =
// hd / 32, read as vpl / V loads of V values; NV, the smallest power of two
// that many loads fit, sizes every loop, so at hd = 128 a lane runs one
// load, four divisions and one store and nothing held off by a predicate.
template <typename T, int V, int NV>
__global__ void append_warp(const AppendArgs a) {
  const int row = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const int bkv = a.B * a.KV;
  if (row >= 2 * bkv) return;  // a whole warp leaves together
  const bool is_v = row >= bkv;
  const int bh = is_v ? row - bkv : row;  // b * KV + head
  const int b = bh / a.KV, h = bh - b * a.KV;
  const int vpl = a.hd >> 5, nv = vpl / V;

  const T* src = static_cast<const T*>(is_v ? a.v_new : a.k_new) +
                 b * (is_v ? a.v_sb : a.k_sb) + h * (is_v ? a.v_sh : a.k_sh) + lane * vpl;
  long long p = a.pos_i64 ? static_cast<const long long*>(a.pos)[b]
                          : (long long)static_cast<const int*>(a.pos)[b];
  Pack<T, V> raw[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c)
    if (c < nv) raw[c] = reinterpret_cast<const Pack<T, V>*>(src)[c];

  float x[NV * V];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < NV; ++c)
    if (c < nv) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        x[c * V + e] = to_f(raw[c].v[e]);
        amax = fmaxf(amax, fabsf(x[c * V + e]));
      }
    }
  amax = warp_max(amax);
  const float s = amax > 0.f ? amax * kInv127 : 1.f;

  // the lane's int8 values, four to a word, the lowest address in the lowest byte
  constexpr int kVals = NV * V, kWords = (kVals + 3) / 4;
  uint32_t w[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) w[j] = 0u;
#pragma unroll
  for (int i = 0; i < kVals; ++i)
    if (i < vpl) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(x[i], s)), -127.f), 127.f);
      w[i >> 2] |= ((uint32_t)__float2int_rn(r) & 0xffu) << (8 * (i & 3));
    }

  if (p < 0) p += a.S;
  p = p < 0 ? 0 : (p > a.S - 1 ? a.S - 1 : p);
  const size_t slot = (size_t)bh * a.S + (size_t)p;
  int8_t* dst = (is_v ? a.v8 : a.k8) + slot * a.hd + lane * vpl;
  // the widest store vpl allows: dst is aligned to it (hd is a multiple of 32)
  if (vpl % 16 == 0) {
#pragma unroll
    for (int j = 0; j < kVals / 16; ++j)
      if (j < vpl / 16)
        reinterpret_cast<uint4*>(dst)[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2],
                                                      w[4 * j + 3]);
  } else if (vpl % 8 == 0) {
#pragma unroll
    for (int j = 0; j < kVals / 8; ++j)
      if (j < vpl / 8) reinterpret_cast<uint2*>(dst)[j] = make_uint2(w[2 * j], w[2 * j + 1]);
  } else if (vpl % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kVals / 4; ++j)
      if (j < vpl / 4) reinterpret_cast<uint32_t*>(dst)[j] = w[j];
  } else if (vpl % 2 == 0) {
#pragma unroll
    for (int j = 0; j < kVals / 2; ++j)
      if (j < vpl / 2)
        reinterpret_cast<uint16_t*>(dst)[j] = (uint16_t)(w[j >> 1] >> (16 * (j & 1)));
  } else {
#pragma unroll
    for (int j = 0; j < kVals; ++j)
      if (j < vpl) dst[j] = (int8_t)(w[j >> 2] >> (8 * (j & 3)));
  }
  if (lane == 0) {
    if (a.scale_bf16)
      static_cast<__nv_bfloat16*>(is_v ? a.vs : a.ks)[slot] = __float2bfloat16(s);
    else
      static_cast<float*>(is_v ? a.vs : a.ks)[slot] = s;
  }
}

// the kernel whose NV (a power of two) is the fewest that hold nv loads
template <typename T, int V, int NV>
int launch_nv(const AppendArgs& a, int nv, dim3 grid, dim3 block, cudaStream_t st) {
  if constexpr (NV * V < kMaxVals) {
    if (nv > NV) return launch_nv<T, V, 2 * NV>(a, nv, grid, block, st);
  }
  append_warp<T, V, NV><<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const AppendArgs& a, int vec, int warps, cudaStream_t st) {
  const int rows = 2 * a.B * a.KV, nv = (a.hd / 32) / vec;
  const dim3 grid((rows + warps - 1) / warps), block(32 * warps);
  switch (vec) {
    case 1: return launch_nv<T, 1, 1>(a, nv, grid, block, st);
    case 2: return launch_nv<T, 2, 1>(a, nv, grid, block, st);
    case 4: return launch_nv<T, 4, 1>(a, nv, grid, block, st);
    case 8:  // 16 bytes of bf16; f32 loads at most 4 values
      if constexpr (sizeof(T) == 2) return launch_nv<T, 8, 1>(a, nv, grid, block, st);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Writes the new K and V rows of one layer in place, one warp a row in
// blocks of `warps` warps; `vec` values a load (1, 2, 4, or 8 for bf16;
// the wrapper's append_plan). hd must be a multiple of 32, at most 1024,
// and `vec` must divide hd / 32 and the strides, the new rows aligned to
// vec values (the wrapper checks). scale_bf16 says which type the scale
// planes hold, pos_i64 the positions'. Returns cudaGetLastError() after
// the launch.
extern "C" int llamago_cache_append_quant(const void* k_new, const void* v_new,
                                          long long k_sb, long long k_sh, long long v_sb,
                                          long long v_sh, void* k8, void* v8, void* ks,
                                          void* vs, const void* pos, int B, int KV, int S,
                                          int hd, int is_bf16, int scale_bf16, int pos_i64,
                                          int vec, int warps, void* stream) {
  if (hd % 32 || hd > 32 * kMaxVals || vec < 1 || (hd / 32) % vec || warps < 1 ||
      warps > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AppendArgs a{k_new, v_new, k_sb, k_sh, v_sb, v_sh, static_cast<int8_t*>(k8),
                     static_cast<int8_t*>(v8), ks, vs, pos, B, KV, S, hd, scale_bf16 != 0,
                     pos_i64 != 0};
  return is_bf16 ? launch<__nv_bfloat16>(a, vec, warps, st) : launch<float>(a, vec, warps, st);
}
