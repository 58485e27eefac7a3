// K2: length-aware causal decode attention over a dense KV cache, for
// Hopper (sm_90a).
//
// q: [B, t, KV, g, hd] (roped; t <= 32, g <= 8, hd in {64, 128}),
// k/v cache: [B, KV, S, hd], pos0: int32 [B] (absolute position of query
// row t=0), out: same shape as q. All of q, k, v and out share one dtype,
// bf16 or f32. Rows are laid out t-major then g; row r sees cache slot j
// iff j <= pos0 + r / g. Masked scores are the finite -1e9, softmax is in
// f32, and the probabilities are rounded to the V dtype before the PV
// product, as in the TPU kernel.
//
// Replaces llamago_tpu/ops/attention.py _attn_decode_kernel, reached
// through _flash_attention_lenaware and flash_attention.
//
// What bounds it: per (batch, kv head) the kernel reads the visible
// prefix of K and V once (2 * fill * hd elements) and does 4 * rows * fill
// * hd flops on it — at most 8 flops per cache byte at decode (rows = g),
// so device-memory bandwidth over the cache bytes that hold visible slots
// is the bound.
//
// What the design does about it (flash-decoding in two passes):
//  * pass 1, grid (B*KV, S-blocks): each block owns one S-block of SB rows
//    (256 for bf16, 128 for f32) of one (batch, kv head). Blocks past the
//    last visible slot return at once, so cache traffic follows the fill,
//    not S; within the last block only the visible rows are read. The
//    block stages its K and V rows in shared memory (K rows padded by one
//    word against bank conflicts), computes the masked scores of up to 32
//    query rows at a time, takes the block-local softmax statistics (max,
//    sum) and the unnormalized P.V, and writes them to an f32 workspace.
//  * pass 2, grid (B*KV): merges the S-blocks' partials with the usual
//    max-rescaled sum and writes the output in the input dtype.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMask = -1e9f;
constexpr int kRowChunk = 32;  // query rows per score/PV pass
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Elements of padding per K row in shared memory: one 32-bit word.
template <typename T> constexpr int kPad = 4 / sizeof(T);
// S-block rows: 256 for bf16, 128 for f32 (keeps the staged tiles inside
// shared memory).
template <typename T> constexpr int kSB = 512 / sizeof(T);

__device__ __forceinline__ float dot_row(const float* qr, const float* kr, int hd) {
  float a = 0.f;
  for (int d = 0; d < hd; ++d) a = fmaf(qr[d], kr[d], a);
  return a;
}

__device__ __forceinline__ float dot_row(const float* qr, const __nv_bfloat16* kr, int hd) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(kr);
  float a = 0.f;
  for (int w = 0; w < hd / 2; ++w) {
    const float2 f = __bfloat1622float2(k2[w]);
    a = fmaf(qr[2 * w], f.x, a);
    a = fmaf(qr[2 * w + 1], f.y, a);
  }
  return a;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
size_t smem_bytes(int hd) {
  const int sb = kSB<T>;
  return (size_t)sb * hd * sizeof(T)                 // V tile
         + (size_t)sb * (hd + kPad<T>) * sizeof(T)   // K tile, padded rows
         + (size_t)kRowChunk * hd * sizeof(float)    // q rows
         + (size_t)kRowChunk * sb * sizeof(float);   // scores / probs
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_partial(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int* __restrict__ pos0, float* __restrict__ pacc, float* __restrict__ pm,
    float* __restrict__ pl, int t, int KV, int g, int hd, int S, float scale, int nsb) {
  constexpr int SB = kSB<T>;
  constexpr int PAD = kPad<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x;
  const int b = bh / KV, kvh = bh % KV;
  const int si = blockIdx.y;
  const int p0 = pos0[b];
  const int last = p0 + t - 1;  // last query position (slot index)
  const int last_blk = min(last / SB, nsb - 1);
  if (si > last_blk) return;
  const int j0 = si * SB;
  const int nvis = min(SB, min(last, S - 1) - j0 + 1);  // >= 1
  const int R = t * g;
  const int kst = hd + PAD;  // padded K row stride (elements)

  T* Vs = reinterpret_cast<T*>(smem);
  T* Ks = Vs + SB * hd;
  float* qs = reinterpret_cast<float*>(Ks + SB * kst);
  float* Ss = qs + kRowChunk * hd;

  // Stage the visible K/V rows of this S-block; zero the rest.
  const size_t cbase = ((size_t)bh * S + j0) * hd;
  const int vpr = hd * (int)sizeof(T) / 16;  // 16-byte vectors per row
  const uint4* kg = reinterpret_cast<const uint4*>(kc + cbase);
  const uint4* vg = reinterpret_cast<const uint4*>(vc + cbase);
  uint4* vsv = reinterpret_cast<uint4*>(Vs);
  uint32_t* ksw = reinterpret_cast<uint32_t*>(Ks);
  const int kstw = kst * (int)sizeof(T) / 4;  // padded row stride in words
  for (int i = threadIdx.x; i < SB * vpr; i += kThreads) {
    const int row = i / vpr, c = i % vpr;
    uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
    if (row < nvis) {
      kv4 = __ldg(kg + i);
      vv4 = __ldg(vg + i);
    }
    vsv[i] = vv4;
    uint32_t* dst = ksw + row * kstw + c * 4;
    dst[0] = kv4.x;
    dst[1] = kv4.y;
    dst[2] = kv4.z;
    dst[3] = kv4.w;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < R; r0 += kRowChunk) {
    const int rc = min(kRowChunk, R - r0);
    for (int i = threadIdx.x; i < rc * hd; i += kThreads) {
      const int r = r0 + i / hd, d = i % hd;
      const int ti = r / g, gi = r % g;
      qs[i] = to_f(q[((((size_t)b * t + ti) * KV + kvh) * g + gi) * hd + d]);
    }
    __syncthreads();  // also orders the tile staging before first use

    for (int i = threadIdx.x; i < rc * SB; i += kThreads) {
      const int r = i / SB, j = i % SB;
      const int qp = p0 + (r0 + r) / g;
      float sc = kMask;
      if (j < nvis && j0 + j <= qp)
        sc = dot_row(qs + r * hd, Ks + j * kst, hd) * scale;
      Ss[i] = sc;
    }
    __syncthreads();

    for (int r = warp; r < rc; r += kThreads / 32) {
      float* srow = Ss + r * SB;
      float m = kMask;
      for (int j = lane; j < SB; j += 32) m = fmaxf(m, srow[j]);
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < SB; j += 32) {
        const float p = expf(srow[j] - m);
        l += p;
        srow[j] = to_f(from_f<T>(p));  // p in the V dtype for the PV product
      }
      l = warp_sum(l);
      if (lane == 0) {
        const size_t pi = ((size_t)bh * nsb + si) * R + r0 + r;
        pm[pi] = m;
        pl[pi] = l;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < rc * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const float* prow = Ss + r * SB;
      float a = 0.f;
      for (int j = 0; j < nvis; ++j) a = fmaf(prow[j], to_f(Vs[j * hd + d]), a);
      pacc[(((size_t)bh * nsb + si) * R + r0 + r) * hd + d] = a;
    }
    __syncthreads();  // qs / Ss are rewritten by the next row chunk
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_combine(
    const float* __restrict__ pacc, const float* __restrict__ pm,
    const float* __restrict__ pl, const int* __restrict__ pos0, T* __restrict__ out,
    int t, int KV, int g, int hd, int nsb) {
  constexpr int SB = kSB<T>;
  const int bh = blockIdx.x;
  const int b = bh / KV, kvh = bh % KV;
  const int R = t * g;
  const int last_blk = min((pos0[b] + t - 1) / SB, nsb - 1);
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    float mx = kMask;
    for (int s = 0; s <= last_blk; ++s) mx = fmaxf(mx, pm[((size_t)bh * nsb + s) * R + r]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s <= last_blk; ++s) {
      const size_t pi = ((size_t)bh * nsb + s) * R + r;
      const float w = expf(pm[pi] - mx);
      num = fmaf(w, pacc[pi * hd + d], num);
      den = fmaf(w, pl[pi], den);
    }
    const int ti = r / g, gi = r % g;
    out[((((size_t)b * t + ti) * KV + kvh) * g + gi) * hd + d] = from_f<T>(num / den);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos0, void* out,
           float* pacc, float* pm, float* pl, int B, int t, int KV, int g, int hd,
           int S, float scale, cudaStream_t st) {
  const int nsb = (S + kSB<T> - 1) / kSB<T>;
  const size_t smem = smem_bytes<T>(hd);
  cudaError_t e = cudaFuncSetAttribute(attn_partial<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * KV, nsb);
  attn_partial<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos0,
      pacc, pm, pl, t, KV, g, hd, S, scale, nsb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_combine<T><<<B * KV, kThreads, 0, st>>>(pacc, pm, pl, pos0, static_cast<T*>(out),
                                              t, KV, g, hd, nsb);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of one S-block for the given dtype (the workspace has
// ceil(S / rows) blocks per (batch, kv head)).
extern "C" int llamago_attn_decode_block_rows(int is_bf16) {
  return is_bf16 ? kSB<__nv_bfloat16> : kSB<float>;
}

// Workspaces: pacc [B*KV, nsb, t*g, hd], pm / pl [B*KV, nsb, t*g], f32.
// Returns cudaGetLastError() after the launches.
extern "C" int llamago_attn_decode(const void* q, const void* k, const void* v,
                                   const void* pos0, void* out, void* pacc, void* pm,
                                   void* pl, int B, int t, int KV, int g, int hd, int S,
                                   float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos0);
  float* a = static_cast<float*>(pacc);
  float* m = static_cast<float*>(pm);
  float* l = static_cast<float*>(pl);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, p, out, a, m, l, B, t, KV, g, hd, S, scale, st);
  return launch<float>(q, k, v, p, out, a, m, l, B, t, KV, g, hd, S, scale, st);
}
