// K7: causal flash attention of a prefill window over a dense KV cache, for
// Hopper (sm_90a).
//
// q: [B, t, KV, g, hd] (roped; any t >= 1, g <= 8, hd in {64, 128}),
// k/v cache: [B, KV, S, hd], pos0: int32 [B] (absolute position of query
// row t=0), out: same shape as q. All of q, k, v and out share one dtype,
// bf16 or f32. Rows are laid out t-major then g; row r sees cache slot j
// iff j <= pos0 + r / g. Scores are f32 dot products times 1/sqrt(hd),
// masked scores are -inf, the softmax is in f32, the probabilities are
// rounded to the V dtype before the PV product, which accumulates in f32. A
// row that sees no slot gives NaN (0 / 0), as the TPU kernel does.
//
// Replaces llamago_tpu/ops/attention.py _attn_kernel, reached through
// _flash_attention and flash_attention.
//
// What bounds it: per (batch, kv head) the kernel must read the visible
// prefix of K and V once, 2 * (pos0 + t) * hd elements, and does
// 4 * g * hd * (t * pos0 + t * (t + 1) / 2) operations on it: at t = 256
// over a few hundred slots that is some 200 operations per cache byte, near
// the card's bf16 balance point, and both bounds are a few microseconds per
// layer at 7B. The launch and the tile loop's latency show first.
//
// What the design does about it: the TPU kernel holds the whole S plane of
// a head in VMEM and takes one softmax over it. Here one block owns one
// (batch, kv head, tile of 64 query rows; the g rows of a GQA group are
// folded into the rows as K2 does) and streams K and V through shared memory
// in tiles of 64 slots with an online softmax, so the scores never reach
// device memory and shared memory does not grow with S. The loop stops at
// the last slot the tile's rows can see (masked columns contribute exactly
// 0, so that is the same function): cache traffic follows pos0 + t, not S,
// and the tiles above the diagonal are never read.
//  * bf16: four warps of 16 rows each. Q K^T and P V are
//    mma.sync.m16n8k16 (bf16 in, f32 out); Q stays in registers as A
//    fragments, K's B fragments are 32-bit loads of its row-major tile, V's
//    are ldmatrix.trans of its row-major tile, the score accumulators are
//    repacked in registers as the A fragments of P V. Tile rows are padded
//    by 16 bytes against bank conflicts.
//  * f32: plain FMA. 256 threads, 32 query rows; scores and probabilities
//    of a tile go through shared memory, the output accumulators live in
//    registers.
// wgmma, TMA and a pipelined tile loop are left to a later change.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kBN = 64;  // cache slots per tile

// Slots a q-tile whose last row is `last_row` must read: up to that row's
// own position, inside the cache.
__device__ __forceinline__ int visible_slots(int p0, int last_row, int g, int S) {
  return max(0, min(S, p0 + last_row / g + 1));
}

// --------------------------------------------------------------- bf16, mma

constexpr int kMmaThreads = 128;
constexpr int kMmaBM = 64;  // query rows per block: 16 per warp
constexpr int kPadB = 8;    // bf16 elements of padding per tile row (16 bytes)

size_t mma_smem_bytes(int hd) {
  return (size_t)(kMmaBM + 2 * kBN) * (hd + kPadB) * sizeof(__nv_bfloat16);
}

// grid (ceil(t*g / 64), B*KV). Fragment layouts of mma.m16n8k16 with
// gid = lane / 4, tig = lane % 4: A regs hold (row gid | gid+8, k 2*tig+{0,1}
// | +8); B regs hold (k 2*tig+{0,1} | +8, n gid); C holds (row gid, n
// 2*tig+{0,1}) in c0, c1 and (row gid+8, the same n) in c2, c3.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) attn_prefill_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ pos0,
    __nv_bfloat16* __restrict__ out, int t, int KV, int g, int S, float scale) {
  constexpr int LD = HD + kPadB;  // padded row stride (elements)
  constexpr int KK = HD / 16;     // k-steps of Q K^T
  constexpr int DT = HD / 8;      // n-tiles of the output
  constexpr int NT = kBN / 8;     // n-tiles of the scores
  constexpr int VPR = HD / 8;     // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kMmaBM * LD;
  __nv_bfloat16* Vs = Ks + kBN * LD;

  const int bh = blockIdx.y;
  const int b = bh / KV, kvh = bh % KV;
  const int R = t * g;
  const int r0 = blockIdx.x * kMmaBM;
  const int p0 = pos0[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // Stage the q-tile (rows past R as zeros), then take this warp's A
  // fragments into registers.
  for (int i = threadIdx.x; i < kMmaBM * VPR; i += kMmaThreads) {
    const int row = i / VPR, c = i % VPR;
    const int r = r0 + row;
    uint4 v4 = make_uint4(0, 0, 0, 0);
    if (r < R) {
      const int ti = r / g, gi = r % g;
      v4 = __ldg(reinterpret_cast<const uint4*>(
                     q + ((((size_t)b * t + ti) * KV + kvh) * g + gi) * HD) + c);
    }
    *reinterpret_cast<uint4*>(Qs + row * LD + c * 8) = v4;
  }
  __syncthreads();
  uint32_t qf[KK][4];
  {
    const __nv_bfloat16* qlo = Qs + (warp * 16 + gid) * LD + tig * 2;
    const __nv_bfloat16* qhi = qlo + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(qlo + kk * 16);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(qhi + kk * 16);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(qlo + kk * 16 + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(qhi + kk * 16 + 8);
    }
  }

  // This thread's two rows (gid and gid + 8 of the warp's 16) and their
  // query positions.
  const int row_lo = r0 + warp * 16 + gid, row_hi = row_lo + 8;
  const int qp_lo = p0 + row_lo / g, qp_hi = p0 + row_hi / g;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int nvis = visible_slots(p0, min(r0 + kMmaBM, R) - 1, g, S);
  const size_t cbase = (size_t)bh * S * HD;
  for (int j0 = 0; j0 < nvis; j0 += kBN) {
    __syncthreads();  // every warp is done with the previous tiles
    for (int i = threadIdx.x; i < kBN * VPR; i += kMmaThreads) {
      const int row = i / VPR, c = i % VPR;
      uint4 k4 = make_uint4(0, 0, 0, 0), v4 = make_uint4(0, 0, 0, 0);
      if (j0 + row < nvis) {
        const size_t off = cbase + (size_t)(j0 + row) * HD;
        k4 = __ldg(reinterpret_cast<const uint4*>(kc + off) + c);
        v4 = __ldg(reinterpret_cast<const uint4*>(vc + off) + c);
      }
      *reinterpret_cast<uint4*>(Ks + row * LD + c * 8) = k4;
      *reinterpret_cast<uint4*>(Vs + row * LD + c * 8) = v4;
    }
    __syncthreads();

    // scores of 16 rows x 64 slots
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kr = Ks + (n * 8 + gid) * LD + kk * 16 + tig * 2;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, running maximum
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int slot = j0 + n * 8 + tig * 2 + e;
        const bool in = slot < S;
        s[n][e] = (in && slot <= qp_lo) ? s[n][e] * scale : -INFINITY;
        s[n][2 + e] = (in && slot <= qp_hi) ? s[n][2 + e] * scale : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[n][e]);
        mx_hi = fmaxf(mx_hi, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the four lanes that share a row
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // a row that has seen nothing yet keeps m = -inf: exponentials are taken
    // against 0 there, so that -inf - -inf never forms
    const float ms_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float ms_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float a_lo = expf(m_lo - ms_lo), a_hi = expf(m_hi - ms_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= a_lo;
      o[n][1] *= a_lo;
      o[n][2] *= a_hi;
      o[n][3] *= a_hi;
    }

    // p = exp(s - m), summed in f32 and rounded to bf16 for P V
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0_ = expf(s[n][0] - ms_lo), p1_ = expf(s[n][1] - ms_lo);
      const float p2_ = expf(s[n][2] - ms_hi), p3_ = expf(s[n][3] - ms_hi);
      l_lo += p0_ + p1_;
      l_hi += p2_ + p3_;
      pf[n / 2][(n & 1) * 2] = pack_bf16(p0_, p1_);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2_, p3_);
    }

    // O += P V: per 16 slots, ldmatrix.trans brings the B fragments of two
    // output n-tiles (16 columns of V) at once
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      const int mat = lane >> 3, mr = lane & 7;
      const __nv_bfloat16* vrow = Vs + (ks * 16 + (mat & 1) * 8 + mr) * LD + (mat >> 1) * 8;
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + n * 8);
        mma_bf16(o[n], pf[ks], vb[0], vb[1]);
        mma_bf16(o[n + 1], pf[ks], vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? row_hi : row_lo;
    if (r >= R) continue;
    const float l = half ? l_hi : l_lo;
    const int ti = r / g, gi = r % g;
    __nv_bfloat16* orow = out + ((((size_t)b * t + ti) * KV + kvh) * g + gi) * HD;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(o[n][half * 2] / l, o[n][half * 2 + 1] / l);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tig * 2) = v;
    }
  }
}

// --------------------------------------------------------------- f32, FMA

constexpr int kFmaThreads = 256;
constexpr int kFmaBM = 32;  // query rows per block

size_t fma_smem_bytes(int hd) {
  return ((size_t)kFmaBM * hd + (size_t)kBN * (hd + 1) + (size_t)kBN * hd +
          (size_t)kFmaBM * kBN + 3 * kFmaBM) * sizeof(float);
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

// grid (ceil(t*g / 32), B*KV)
template <int HD>
__global__ void __launch_bounds__(kFmaThreads) attn_prefill_fma(
    const float* __restrict__ q, const float* __restrict__ kc, const float* __restrict__ vc,
    const int* __restrict__ pos0, float* __restrict__ out, int t, int KV, int g, int S,
    float scale) {
  constexpr int KST = HD + 1;                           // padded K row stride
  constexpr int NACC = kFmaBM * HD / kFmaThreads;       // outputs per thread
  constexpr int RSTEP = kFmaThreads / HD;               // rows between a thread's outputs
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BM, HD]
  float* Ks = Qs + kFmaBM * HD;                // [BN, HD + 1]
  float* Vs = Ks + kBN * KST;                  // [BN, HD]
  float* Ps = Vs + kBN * HD;                   // [BM, BN] scores, then p
  float* ms = Ps + kFmaBM * kBN;               // [BM] running maximum
  float* ls = ms + kFmaBM;                     // [BM] running sum
  float* as = ls + kFmaBM;                     // [BM] this tile's rescale

  const int bh = blockIdx.y;
  const int b = bh / KV, kvh = bh % KV;
  const int R = t * g;
  const int r0 = blockIdx.x * kFmaBM;
  const int p0 = pos0[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d_own = threadIdx.x % HD, r_own = threadIdx.x / HD;  // outputs (r_own + k*RSTEP, d_own)

  for (int i = threadIdx.x; i < kFmaBM * HD; i += kFmaThreads) {
    const int r = r0 + i / HD, d = i % HD;
    float v = 0.f;
    if (r < R) {
      const int ti = r / g, gi = r % g;
      v = q[((((size_t)b * t + ti) * KV + kvh) * g + gi) * HD + d];
    }
    Qs[i] = v;
  }
  if (threadIdx.x < kFmaBM) {
    ms[threadIdx.x] = -INFINITY;
    ls[threadIdx.x] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;

  const int nvis = visible_slots(p0, min(r0 + kFmaBM, R) - 1, g, S);
  const size_t cbase = (size_t)bh * S * HD;
  for (int j0 = 0; j0 < nvis; j0 += kBN) {
    __syncthreads();  // the previous tile is consumed; Qs / ms / ls are written
    for (int i = threadIdx.x; i < kBN * HD; i += kFmaThreads) {
      const int row = i / HD, d = i % HD;
      float kvv = 0.f, vv = 0.f;
      if (j0 + row < nvis) {
        const size_t off = cbase + (size_t)(j0 + row) * HD + d;
        kvv = kc[off];
        vv = vc[off];
      }
      Ks[row * KST + d] = kvv;
      Vs[i] = vv;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < kFmaBM * kBN; i += kFmaThreads) {
      const int r = i / kBN, j = i % kBN;
      const int slot = j0 + j;
      float sc = -INFINITY;
      if (slot < S && slot <= p0 + (r0 + r) / g) {
        const float* qr = Qs + r * HD;
        const float* kr = Ks + j * KST;
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a * scale;
      }
      Ps[i] = sc;
    }
    __syncthreads();

    for (int r = warp; r < kFmaBM; r += kFmaThreads / 32) {  // one warp per row
      float* prow = Ps + r * kBN;
      float mx = -INFINITY;
      for (int j = lane; j < kBN; j += 32) mx = fmaxf(mx, prow[j]);
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      // a row that has seen nothing yet keeps m = -inf: exponentials are
      // taken against 0 there, so that -inf - -inf never forms
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float l = 0.f;
      for (int j = lane; j < kBN; j += 32) {
        const float p = expf(prow[j] - m_use);
        l += p;
        prow[j] = p;
      }
      l = warp_sum(l);
      if (lane == 0) {
        const float a = expf(m_old - m_use);
        as[r] = a;
        ms[r] = m_new;
        ls[r] = ls[r] * a + l;
      }
    }
    __syncthreads();

    const int nrow = min(kBN, nvis - j0);
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      const int r = r_own + k * RSTEP;
      const float* prow = Ps + r * kBN;
      float a = acc[k] * as[r];
      for (int j = 0; j < nrow; ++j) a = fmaf(prow[j], Vs[j * HD + d_own], a);
      acc[k] = a;
    }
  }
  __syncthreads();  // ls is final (and written at all when no tile ran)
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    const int r = r0 + r_own + k * RSTEP;
    if (r >= R) continue;
    const int ti = r / g, gi = r % g;
    out[((((size_t)b * t + ti) * KV + kvh) * g + gi) * HD + d_own] =
        acc[k] / ls[r_own + k * RSTEP];
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const int* pos0, void* out, int B,
           int t, int KV, int g, int S, float scale, int is_bf16, cudaStream_t st) {
  const int R = t * g;
  if (is_bf16) {
    const size_t smem = mma_smem_bytes(HD);
    const int e = set_smem(attn_prefill_mma<HD>, smem);
    if (e != 0) return e;
    const dim3 grid((R + kMmaBM - 1) / kMmaBM, B * KV);
    attn_prefill_mma<HD><<<grid, kMmaThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), pos0, static_cast<__nv_bfloat16*>(out), t, KV,
        g, S, scale);
  } else {
    const size_t smem = fma_smem_bytes(HD);
    const int e = set_smem(attn_prefill_fma<HD>, smem);
    if (e != 0) return e;
    const dim3 grid((R + kFmaBM - 1) / kFmaBM, B * KV);
    attn_prefill_fma<HD><<<grid, kFmaThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), pos0, static_cast<float*>(out), t, KV, g, S, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// hd must be 64 or 128 (the wrapper checks; anything else returns
// cudaErrorInvalidValue). Returns cudaGetLastError() after the launch.
extern "C" int llamago_attn_prefill(const void* q, const void* k, const void* v,
                                    const void* pos0, void* out, int B, int t, int KV, int g,
                                    int hd, int S, float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos0);
  if (hd == 128) return launch<128>(q, k, v, p, out, B, t, KV, g, S, scale, is_bf16, st);
  if (hd == 64) return launch<64>(q, k, v, p, out, B, t, KV, g, S, scale, is_bf16, st);
  return (int)cudaErrorInvalidValue;
}
