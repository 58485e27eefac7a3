// K4 and K8: length-aware causal decode attention over the int8 KV cache,
// for Hopper (sm_90a).
//
// q: [B, t, KV, g, hd] (roped; t <= 32, g <= 8, hd in {64, 128}) in bf16
// or f32; k8 / v8: [B, KV, S, hd] int8; ks / vs: [B, KV, S] row scales,
// f32 or bf16 planes, widened to f32 as they are staged; pos0: int32 [B]
// (absolute position of query row t=0); out: q's shape and dtype. Rows are laid out t-major then g; row r sees cache slot
// j iff j <= pos0 + r / g. The scales fold per score column,
// q.(k8*sk) = (q.k8)*sk and p.(v8*sv) = (p*sv).v8, so the cache is never
// dequantized element by element. Masked scores are the finite -1e9.
//
//  * K4 (i8dot) replaces llamago_tpu/ops/attention.py
//    _attn_decode_kernel_quant_i8dot: each q row is quantized to int8
//    against its absmax (sq = absmax * fl(1/127)); scores are exact int32
//    dot products (__dp4a) times (scale * sq), times sk; p*sv is
//    requantized to int8 per row against its maximum over the S-block
//    (sp), the PV product is exact in int32 and is scaled back by sp.
//  * K8 (widening) replaces llamago_tpu/ops/attention.py
//    _attn_decode_kernel_quant: scores are f32 dot products of q with the
//    widened int8 K rows, times scale, times sk; p*sv is rounded to bf16
//    (whatever q's dtype) before an f32 PV product with the widened V.
//
// The S-block is part of K4's arithmetic (p*sv is requantized per block),
// so SB is the TPU kernel's own block: 256, halved until it divides S. The
// wrapper passes it, and the plain versions in ops/attention.py use it too.
//
// What bounds it: per (batch, kv head) the kernel reads the visible int8
// rows of K and V and their scales once, 2 * fill * (hd + 4) bytes with f32
// scales, and
// does 4 * rows * fill * hd operations on them: at most 8 per cache byte at
// decode (rows = g), far under the card's int8 or bf16 rate per byte of
// device memory. Bandwidth over the visible cache bytes is the bound, half
// of K2's bf16 bytes.
//
// What the design does about it (flash-decoding in two passes, as K2 in
// csrc/attn_decode.cu):
//  * pass 1, grid (B*KV, S/SB): each block owns one S-block of one (batch,
//    kv head). Blocks past the last visible slot return at once, so cache
//    traffic follows the fill, not S; within the last block only the
//    visible rows are read. The block stages its int8 K rows (padded by one
//    word against bank conflicts), V rows and scales in shared memory (an
//    int8 256x128 block is 32 KB, half of K2's), takes up to 32 query rows
//    at a time, and writes the block-local softmax statistics (max, sum of
//    p) and the unnormalized PV in f32. Splitting S is legal for K4: the
//    block-local p differs from the TPU kernel's running-max p by the factor
//    exp(m_block - m_running), which the per-block requantization divides
//    out again.
//  * pass 2, grid (B*KV): merges the S-blocks' partials with the usual
//    max-rescaled sum and writes the output in q's dtype.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMask = -1e9f;
constexpr float kInv127 = 1.0f / 127.0f;
constexpr int kRowChunk = 32;  // query rows per score/PV pass
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKPad = 4;  // bytes of padding per staged K row

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// round(x / s) clipped to +-127, half to even (jnp.round / torch.round)
__device__ __forceinline__ float quant(float x, float s) {
  return fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

// Shared memory of pass 1: V tile, padded K tile, K and V scales, the
// query rows (f32), their int8 copies and scales, the p scales, and the
// scores / probabilities of one row chunk.
size_t smem_bytes(int SB, int hd, int rch) {
  return (size_t)SB * hd + (size_t)SB * (hd + kKPad) + 2 * (size_t)SB * sizeof(float) +
         (size_t)rch * hd * sizeof(float) + 2 * (size_t)rch * sizeof(float) +
         (size_t)rch * SB * sizeof(float) + (size_t)rch * hd;
}

template <typename T, typename TS, bool I8DOT>
__global__ void __launch_bounds__(kThreads) quant_partial(
    const T* __restrict__ q, const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
    const TS* __restrict__ ks, const TS* __restrict__ vs,
    const int* __restrict__ pos0, float* __restrict__ pacc, float* __restrict__ pm,
    float* __restrict__ pl, int t, int KV, int g, int hd, int S, int SB, int rch,
    float scale, int nsb) {
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
  const int kst = hd + kKPad;  // padded K row stride (bytes)

  int8_t* Vs = reinterpret_cast<int8_t*>(smem);
  int8_t* Ks = Vs + SB * hd;
  float* sk = reinterpret_cast<float*>(Ks + SB * kst);
  float* sv = sk + SB;
  float* qs = sv + SB;       // [rch, hd] query rows in f32
  float* sq = qs + rch * hd; // [rch] q row scales (K4)
  float* sp = sq + rch;      // [rch] p*sv row scales (K4)
  float* Ss = sp + rch;      // [rch, SB] scores, then p (K8: p*sv in bf16; K4: int8 p8)
  int8_t* q8s = reinterpret_cast<int8_t*>(Ss + rch * SB);  // [rch, hd] int8 q (K4)

  // Stage the visible K/V rows and scales of this S-block; zero the rest.
  const size_t cbase = ((size_t)bh * S + j0) * hd;
  const int vpr = hd / 16;  // 16-byte vectors per row
  const uint4* kg = reinterpret_cast<const uint4*>(kc + cbase);
  const uint4* vg = reinterpret_cast<const uint4*>(vc + cbase);
  uint4* vsv = reinterpret_cast<uint4*>(Vs);
  uint32_t* ksw = reinterpret_cast<uint32_t*>(Ks);
  const int kstw = kst / 4;  // padded row stride in words
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
  for (int j = threadIdx.x; j < SB; j += kThreads) {
    const bool in = j < nvis;
    sk[j] = in ? to_f(ks[(size_t)bh * S + j0 + j]) : 0.f;
    sv[j] = in ? to_f(vs[(size_t)bh * S + j0 + j]) : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = hd / 4;  // 32-bit words per int8 row
  for (int r0 = 0; r0 < R; r0 += rch) {
    const int rc = min(rch, R - r0);
    for (int i = threadIdx.x; i < rc * hd; i += kThreads) {
      const int r = r0 + i / hd, d = i % hd;
      const int ti = r / g, gi = r % g;
      qs[i] = to_f(q[((((size_t)b * t + ti) * KV + kvh) * g + gi) * hd + d]);
    }
    __syncthreads();  // also orders the tile staging before first use

    if (I8DOT) {  // quantize the query rows, one warp per row
      for (int r = warp; r < rc; r += kWarps) {
        float a = 0.f;
        for (int d = lane; d < hd; d += 32) a = fmaxf(a, fabsf(qs[r * hd + d]));
        a = warp_max(a);
        const float s = a > 0.f ? a * kInv127 : 1.f;
        for (int d = lane; d < hd; d += 32)
          q8s[r * hd + d] = (int8_t)__float2int_rn(quant(qs[r * hd + d], s));
        if (lane == 0) sq[r] = s;
      }
      __syncthreads();
    }

    for (int i = threadIdx.x; i < rc * SB; i += kThreads) {
      const int r = i / SB, j = i % SB;
      const int qp = p0 + (r0 + r) / g;
      float sc = kMask;
      if (j < nvis && j0 + j <= qp) {
        const int* kw = reinterpret_cast<const int*>(Ks + j * kst);
        if (I8DOT) {
          const int* qw = reinterpret_cast<const int*>(q8s + r * hd);
          int acc = 0;
          for (int w = 0; w < hw; ++w) acc = __dp4a(qw[w], kw[w], acc);
          sc = ((float)acc * (scale * sq[r])) * sk[j];
        } else {
          const float* qr = qs + r * hd;
          float acc = 0.f;
          for (int w = 0; w < hw; ++w) {
            const int kword = kw[w];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc = fmaf(qr[4 * w + e], (float)(int8_t)(kword >> (8 * e)), acc);
          }
          sc = (acc * scale) * sk[j];
        }
      }
      Ss[i] = sc;
    }
    __syncthreads();

    for (int r = warp; r < rc; r += kWarps) {  // block-local softmax, one warp per row
      float* srow = Ss + r * SB;
      float m = kMask;
      for (int j = lane; j < SB; j += 32) m = fmaxf(m, srow[j]);
      m = warp_max(m);
      float l = 0.f, pmax = 0.f;
      for (int j = lane; j < SB; j += 32) {
        const float p = expf(srow[j] - m);
        l += p;
        const float psv = p * sv[j];
        if (I8DOT) {
          srow[j] = psv;
          pmax = fmaxf(pmax, psv);
        } else {
          srow[j] = __bfloat162float(__float2bfloat16(psv));
        }
      }
      l = warp_sum(l);
      if (I8DOT) {
        pmax = warp_max(pmax);
        const float s = pmax > 0.f ? pmax * kInv127 : 1.f;
        for (int j = lane; j < SB; j += 32) srow[j] = quant(srow[j], s);
        if (lane == 0) sp[r] = s;
      }
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
      float a;
      if (I8DOT) {
        int ai = 0;  // exact: |sum| <= 127 * 127 * 256
        for (int j = 0; j < nvis; ++j) ai += __float2int_rn(prow[j]) * (int)Vs[j * hd + d];
        a = (float)ai * sp[r];
      } else {
        a = 0.f;
        for (int j = 0; j < nvis; ++j) a = fmaf(prow[j], (float)Vs[j * hd + d], a);
      }
      pacc[(((size_t)bh * nsb + si) * R + r0 + r) * hd + d] = a;
    }
    __syncthreads();  // qs / Ss are rewritten by the next row chunk
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) quant_combine(
    const float* __restrict__ pacc, const float* __restrict__ pm,
    const float* __restrict__ pl, const int* __restrict__ pos0, T* __restrict__ out,
    int t, int KV, int g, int hd, int SB, int nsb) {
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
      const float w = expf(pm[pi] - mx);  // 0 for a block where the row sees nothing
      num = fmaf(w, pacc[pi * hd + d], num);
      den = fmaf(w, pl[pi], den);
    }
    const int ti = r / g, gi = r % g;
    out[((((size_t)b * t + ti) * KV + kvh) * g + gi) * hd + d] = from_f<T>(num / den);
  }
}

template <typename T, typename TS, bool I8DOT>
int launch(const void* q, const int8_t* k, const int8_t* v, const void* ks,
           const void* vs, const int* pos0, void* out, float* pacc, float* pm, float* pl,
           int B, int t, int KV, int g, int hd, int S, int SB, float scale,
           cudaStream_t st) {
  const int nsb = S / SB;
  const int rch = min(t * g, kRowChunk);
  const size_t smem = smem_bytes(SB, hd, rch);
  cudaError_t e = cudaFuncSetAttribute(quant_partial<T, TS, I8DOT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * KV, nsb);
  quant_partial<T, TS, I8DOT><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), k, v, static_cast<const TS*>(ks), static_cast<const TS*>(vs),
      pos0, pacc, pm, pl, t, KV, g, hd, S, SB, rch, scale, nsb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quant_combine<T><<<B * KV, kThreads, 0, st>>>(pacc, pm, pl, pos0, static_cast<T*>(out),
                                               t, KV, g, hd, SB, nsb);
  return (int)cudaGetLastError();
}

template <typename T, typename TS>
int launch_variant(bool i8dot, const void* q, const int8_t* k, const int8_t* v,
                   const void* ks, const void* vs, const int* pos0, void* out, float* pacc,
                   float* pm, float* pl, int B, int t, int KV, int g, int hd, int S, int SB,
                   float scale, cudaStream_t st) {
  if (i8dot)
    return launch<T, TS, true>(q, k, v, ks, vs, pos0, out, pacc, pm, pl, B, t, KV, g, hd, S,
                               SB, scale, st);
  return launch<T, TS, false>(q, k, v, ks, vs, pos0, out, pacc, pm, pl, B, t, KV, g, hd, S,
                              SB, scale, st);
}

}  // namespace

// SB (the S-block rows) must divide S. Workspaces: pacc [B*KV, S/SB, t*g,
// hd], pm / pl [B*KV, S/SB, t*g], f32. i8dot selects K4 (1) or K8 (0);
// scale_bf16 says which type the scale planes ks / vs hold. Returns
// cudaGetLastError() after the launches.
extern "C" int llamago_attn_decode_quant(const void* q, const void* k8, const void* v8,
                                         const void* ks, const void* vs, const void* pos0,
                                         void* out, void* pacc, void* pm, void* pl, int B,
                                         int t, int KV, int g, int hd, int S, int SB,
                                         float scale, int is_bf16, int i8dot, int scale_bf16,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* k = static_cast<const int8_t*>(k8);
  const int8_t* v = static_cast<const int8_t*>(v8);
  const int* p = static_cast<const int*>(pos0);
  float* a = static_cast<float*>(pacc);
  float* m = static_cast<float*>(pm);
  float* l = static_cast<float*>(pl);
  using bf16 = __nv_bfloat16;
  if (is_bf16 && scale_bf16)
    return launch_variant<bf16, bf16>(i8dot, q, k, v, ks, vs, p, out, a, m, l, B, t, KV, g,
                                      hd, S, SB, scale, st);
  if (is_bf16)
    return launch_variant<bf16, float>(i8dot, q, k, v, ks, vs, p, out, a, m, l, B, t, KV, g,
                                       hd, S, SB, scale, st);
  if (scale_bf16)
    return launch_variant<float, bf16>(i8dot, q, k, v, ks, vs, p, out, a, m, l, B, t, KV, g,
                                       hd, S, SB, scale, st);
  return launch_variant<float, float>(i8dot, q, k, v, ks, vs, p, out, a, m, l, B, t, KV, g,
                                      hd, S, SB, scale, st);
}
