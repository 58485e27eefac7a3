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
//    dot products (int8 mma.sync, or __dp4a) times (scale * sq), times sk;
//    p*sv is
//    requantized to int8 per row against its maximum over the S-block (sp),
//    the PV product is exact in int32 and is scaled back by sp.
//  * K8 (widening) replaces llamago_tpu/ops/attention.py
//    _attn_decode_kernel_quant: scores are f32 dot products of q with the
//    widened int8 K rows, times scale, times sk; p*sv is rounded to bf16
//    (whatever q's dtype) before an f32 PV product with the widened V.
//
// The S-block is part of K4's arithmetic (p*sv is requantized per block),
// so K4's SB is the TPU kernel's own block: 256, halved until it divides S.
// The wrapper passes it, and the plain versions in ops/attention.py use it
// too. K8 requantizes nothing, so its tensor-core form splits S as it
// likes (ops/attention.py k8_split); its CUDA-core form keeps the S-block.
//
// What bounds it: per (batch, kv head) the kernel reads the visible int8
// rows of K and V and their scales once, 2 * fill * (hd + 4) bytes with f32
// scales, and
// does 4 * rows * fill * hd operations on them: at most 8 per cache byte at
// decode (rows = g), far under the card's int8 or bf16 rate per byte of
// device memory. Bandwidth over the visible cache bytes is the bound, half
// of K2's bf16 bytes.
//
// Both are flash-decoding in two passes: pass 1, grid (B*KV, S/SB), one
// block per S-block (or split) of one (batch, kv head), writes the block-local softmax
// statistics (max, sum of p) and the unnormalized PV in f32; blocks past the
// last visible slot return at once, so cache traffic follows the fill, and
// within the last block only the visible rows are read. Splitting S is legal
// for K4: the block-local p differs from the TPU kernel's running-max p by
// the factor exp(m_block - m_running), which the per-block requantization
// divides out again. Pass 2 (quant_merge, the same for every form) merges
// the S-blocks' partials in S-block order with the usual max-rescaled sum
// (a call run twice gives the same bits) and writes the output in q's
// dtype. Pass 1 has four forms (the entry
// point's `form`, ops/attention.py quant_plan):
//
//  * i8dot_tc (K4 for S-blocks of 64 slots or more, every S that is a
//    multiple of 256), quant_partial_tc, 128 threads:
//    - The S-block's K and V rows arrive by TMA bulk copies on mbarriers
//      (one a K or V tile of 64 slots), L2 evict_first, all issued when the
//      block starts: a copy moves 8 consecutive visible rows, and each group
//      of 8 rows lands 16 bytes after the last, so that the 8 slots of an
//      mma n-tile (one from each group) and the 8 rows of an ldmatrix fall on
//      distinct banks. Each warp waits for its own K tile only: scores of
//      one tile run while the next is in flight, and V lands meanwhile.
//    - Q K^T on mma.m16n8k32 with int8 operands, exact in int32 (the
//      parent's __dp4a sums): q, quantized once a block (a warp a row) into
//      shared memory, is the A operand in m16 tiles of rows; K is B as it
//      lands (n-tile (tile, i) holds slots 8n + i of the tile). The four
//      warps split the S-block's
//      slots, 2 * SB / 64 n-tiles each, and share each row's maximum, sum of
//      p and maximum of p*sv through shared memory.
//    - Softmax and requantization with the same f32 operations per element
//      as the CUDA-core form, so p8 is the same bit for bit: max, expf(s -
//      m), p*sv, its row maximum, sp, rint. p8 goes to shared memory in the
//      order of the PV product's k (16 rows x SB bytes).
//    - P V on mma.m16n8k32, exact in int32: p8 is A (ldmatrix); V is B, a
//      column's four consecutive k built from ldmatrix.trans pairs of two
//      slots by byte permutes (k 4*tig..+3 are slots 16*tig + i0 + {0, 8,
//      1, 9}, the order the A side stores). The warps split the columns.
//      The int32 sum times sp is the parent's PV bit for bit; only the row
//      sum of p (and the merge) add in another order.
//  * widening_tc (K8 with bf16 q, every S that is a multiple of 64),
//    widening_tc, 128 threads:
//    - The split's 64-slot K and V tiles arrive as quant_partial_tc's do
//      (TMA bulk copies of 8 rows into groups padded by 16 bytes, L2
//      evict_first), with the tile's scales, into a ring of two stages,
//      both filled when the block starts.
//    - Both products on bf16 mma.sync.m16n8k16 with f32 accumulation, the
//      TPU kernel's products exactly: the int8 values are widened to bf16
//      in registers (exact), bf16 q is taken as it is, and p * sv is
//      rounded to bf16 before P V, as there. K's B pairs are two bytes of
//      one row (hd 16 kk + 4 tig .. +3 a word, q's A registers read at the
//      same hd); V's B pairs are one byte of two rows (slots 8 apart), the
//      pairing i8_pair makes of K1's weight rows, a lane's word giving four
//      columns, each of its own n-tile. sk multiplies each score column
//      after the dot, sv each p before its rounding.
//    - The rows are the M side in m16 tiles, up to four a block (a group of
//      64 rows; more rows take more blocks). The four warps split each
//      tile's slots for Q K^T and its columns for P V, so each cache byte
//      is widened once a block: the warps share each row's maximum through
//      shared memory, and P goes through shared memory (16 rows x 64 slots
//      of bf16 each m16 tile). An online softmax runs over the split's
//      tiles; the split writes its partials and quant_merge merges them.
//    - Slots past the visible ones contribute an exact 0: their scores are
//      selected away, their p * sv is 0 (never a product with a scale that
//      was not written), and the V bytes there, stale or not, are finite.
//  * i8dot (K4 for the S-blocks of 8 to 32 slots, e.g. S = 520 or 2000) and
//    widening (K8 with f32 q, or an S that is no multiple of 64),
//    quant_partial, 256 threads: the block stages its K rows
//    (padded by one word against bank conflicts), V rows and scales in
//    shared memory, takes up to 32 query rows at a time and computes scores
//    and P V on the CUDA cores, one (row, slot) or (row, column) a thread.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

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

// Pass 2 of every form: grid (B*KV, blocks of 256 threads), a thread four
// consecutive columns of one row. For each column it takes the maximum of
// the row maxima of the S-blocks (or splits: SB slots each, the last may
// be shorter) up to the last one that the row sees, then sums w * acc and
// w * l over them in order with fmaf (w = expf(m_s - max)), and divides.
// Every pass-1 form writes those partials for every row (a block that
// stops at its own last visible slot, as widening_tc's row groups do,
// holds no row that sees a later split; K4's later S-blocks, which a row
// does not see, would add w = 0). The partials of the first kPrefetch
// S-blocks load beside pos0, before the fill says which of them were
// written (the others are read and never used), so a decode step's merge
// waits for one trip to memory instead of three. hd is a multiple of 4.
constexpr int kPrefetch = 4;

dim3 merge_grid(int B, int t, int KV, int g, int hd) {
  return dim3(B * KV, (t * g * hd / 4 + kThreads - 1) / kThreads);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) quant_merge(
    const float* __restrict__ pacc, const float* __restrict__ pm,
    const float* __restrict__ pl, const int* __restrict__ pos0, T* __restrict__ out,
    int t, int KV, int g, int hd, int SB, int nsb) {
  const int bh = blockIdx.x;
  const int b = bh / KV, kvh = bh % KV;
  const int R = t * g;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= R * hd / 4) return;
  const int r = i * 4 / hd, d = i * 4 % hd;
  const size_t p_row = (size_t)bh * nsb * R + r;  // + s * R: S-block s's row r
  float pmv[kPrefetch], plv[kPrefetch];
  float4 av[kPrefetch];
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s) {
    if (s >= nsb) break;
    const size_t pi = p_row + (size_t)s * R;
    pmv[s] = pm[pi], plv[s] = pl[pi];
    av[s] = *reinterpret_cast<const float4*>(pacc + pi * hd + d);
  }
  const int last_blk = min((pos0[b] + r / g) / SB, nsb - 1);  // the last this row sees
  float mx = kMask;
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s)
    if (s <= last_blk) mx = fmaxf(mx, pmv[s]);
  for (int s = kPrefetch; s <= last_blk; ++s) mx = fmaxf(mx, pm[p_row + (size_t)s * R]);
  float num[4] = {0.f, 0.f, 0.f, 0.f}, den = 0.f;
  for (int s = 0; s <= last_blk; ++s) {
    float m_s, l_s;
    float4 a;
    if (s < kPrefetch) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u)  // registers, not local memory
        if (u == s) m_s = pmv[u], l_s = plv[u], a = av[u];
    } else {
      const size_t pi = p_row + (size_t)s * R;
      m_s = pm[pi], l_s = pl[pi];
      a = *reinterpret_cast<const float4*>(pacc + pi * hd + d);
    }
    const float w = expf(m_s - mx);  // 0 for a block where the row sees nothing
    num[0] = fmaf(w, a.x, num[0]);
    num[1] = fmaf(w, a.y, num[1]);
    num[2] = fmaf(w, a.z, num[2]);
    num[3] = fmaf(w, a.w, num[3]);
    den = fmaf(w, l_s, den);
  }
  T* o = out + ((((size_t)b * t + r / g) * KV + kvh) * g + r % g) * hd + d;
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = from_f<T>(num[e] / den);
}

// ------------------------------------------ K4 on the tensor cores (i8dot_tc)

constexpr int kTcThreads = 128;  // four warps
constexpr int kTile = 64;        // slots of a K or V tile, one mbarrier each
constexpr int kGrp = 8;          // slots (rows) of one bulk copy
constexpr int kGrpPad = 16;      // bytes after each group of 8 rows in shared memory
constexpr int kPPad = 16;        // bytes after each row of p8 in shared memory

template <int HD> __host__ __device__ constexpr int grp_bytes() { return kGrp * HD + kGrpPad; }
template <int HD> __host__ __device__ constexpr int tile_bytes() {
  return kTile / kGrp * grp_bytes<HD>();
}
// Dynamic shared memory: the S-block's K tiles, its V tiles, its K and V
// scales as stored (f32 or bf16), p8 of one m16 tile of rows, and the
// mbarriers (K tiles, then V tiles).
template <int HD, int TILES, typename TS> __host__ __device__ constexpr int tc_smem_bytes() {
  return 2 * TILES * tile_bytes<HD>() + 2 * TILES * kTile * (int)sizeof(TS) +
         16 * (TILES * kTile + kPPad) + 2 * TILES * 8;
}

// N (2 or 4) consecutive values of q in f32.
template <int N> __device__ __forceinline__ void loadv(const float* p, float* x) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}
template <int N> __device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* x) {
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    x[0] = v.x, x[1] = v.y;
  }
}

// 1 / s in f64 within about 2^-52 (relative): the f64 reciprocal's
// approximation refined by three Newton steps (each squares the error).
__device__ __forceinline__ double rcp_d(float s) {
  const double d = s;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = fma(r, fma(-d, r, 1.0), r);
  return r;
}

// quant(x, s) as an int, exactly, without a division: rs = rcp_d(s). x *
// rs in f64 is within 2^-51 (relative) of x / s, and an f32 quotient is
// never an f32 midpoint and lies at least 2^-49 from the nearest one, so
// rounding it to f32 gives the IEEE f32 quotient. (The IEEE division's
// slow-path call keeps the compiler from overlapping divisions, and they
// were most of a block's time.)
__device__ __forceinline__ int quant_r(float x, double rs) {
  return __float2int_rn(fminf(fmaxf(rintf((float)((double)x * rs)), -127.f), 127.f));
}

// Four int8 values, the first in the low byte.
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | (uint32_t)(b & 0xff) << 8 | (uint32_t)(c & 0xff) << 16 |
         (uint32_t)d << 24;
}

// grid (B*KV, S / SB), 128 threads, tc_smem_bytes<HD, TILES, TS>() of dynamic
// shared memory; SB = 64 * TILES. Block (x, y) is (batch, kv head) x and
// the S-block of slots [y * SB, (y + 1) * SB). Warp w scores n-tiles
// w * NT .. w * NT + NT - 1 of the S-block (n-tile v: tile v / 8, slots
// 8n + v % 8 of it) and multiplies columns w * HD / 4 .. of P V. The rows
// go through in m16 tiles; per m16 tile four block barriers: q8 in shared
// memory, the warps' row maxima, their sums of p and maxima of p*sv, and p8
// in shared memory. Three blocks an SM (shared memory: 75 KB a block at HD
// = 128, SB = 256).
template <typename T, typename TS, int HD, int TILES>
__global__ void __launch_bounds__(kTcThreads, 3) quant_partial_tc(
    const T* __restrict__ q, const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
    const TS* __restrict__ ks, const TS* __restrict__ vs, const int* __restrict__ pos0,
    float* __restrict__ pacc, float* __restrict__ pm, float* __restrict__ pl, int t, int KV,
    int g, int S, float scale, int nsb) {
  constexpr int SB = TILES * kTile;
  constexpr int GB = grp_bytes<HD>();
  constexpr int TB = tile_bytes<HD>();
  constexpr int NT = 2 * TILES;    // n-tiles of 8 slots a warp scores
  constexpr int KK = HD / 32;      // k-steps of Q K^T
  constexpr int PLD = SB + kPPad;  // row stride of p8 (bytes)
  constexpr int CH = HD / 64;      // 16-column chunks of P V a warp owns
  constexpr int QV = HD / 32;      // values of a q row a lane quantizes
  constexpr int QLD = HD + 16;     // row stride of Q8 (bytes)
  static_assert(GB % 16 == 0 && PLD % 16 == 0, "copies, ldmatrix rows and barriers aligned");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_max[4][16], red_sum[4][16], red_pmax[4][16];
  __shared__ __align__(16) int8_t Q8[16 * QLD];  // q8 of an m16 tile of rows
  __shared__ float qsc_s[16];                     // their scale * sq

  const int bh = blockIdx.x, si = blockIdx.y;
  const int b = bh / KV, kvh = bh % KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int R = t * g;

  int8_t* Ks = reinterpret_cast<int8_t*>(smem);
  int8_t* Vs = Ks + TILES * TB;
  TS* sk = reinterpret_cast<TS*>(Vs + TILES * TB);  // the S-block's scales as stored
  TS* sv = sk + SB;
  int8_t* P = reinterpret_cast<int8_t*>(sv + SB);  // [16][PLD] p8 in the k order of P V
  uint64_t* bars = reinterpret_cast<uint64_t*>(P + 16 * PLD);

  // Warp w loads q rows rb + qr0 .. rb + qr0 + 3 of an m16 tile in f32 (a
  // lane QV consecutive values of each; zeros past R) and quantizes them,
  // once for the block, into Q8 and their scale * sq into qsc_s. Warps 2
  // and 3 take the first eight rows: warps 0 and 1 issue the copies.
  const int qr0 = 4 * ((warp + 2) & 3);
  float x[4][QV];
  auto load_q = [&](int rb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rb + qr0 + i;
      if (row < R) {
        loadv<QV>(q + ((((size_t)b * t + row / g) * KV + kvh) * g + row % g) * HD + QV * lane,
                  x[i]);
      } else {
#pragma unroll
        for (int e = 0; e < QV; ++e) x[i][e] = 0.f;
      }
    }
  };
  // The first rows of q load beside pos0, before the block knows whether it
  // has work; the barriers are set up meanwhile.
  const int p0 = pos0[b];
  load_q(0);
  if (tid < 2 * TILES) mbar_init(bars + tid);
  mbar_init_fence();
  __syncthreads();
  const int last = p0 + t - 1;  // last query position (slot index)
  if (si > min(last / SB, nsb - 1)) return;
  const int j0 = si * SB;
  const int nvis = min(SB, min(last, S - 1) - j0 + 1);  // >= 1

  // Thread c < 16 * TILES copies group c % 8 of tile c / 16, of K or (bit 3
  // of c) of V; the thread of K's group 0 also copies the tile's 64 K and V
  // scales and arms the K barrier, V's group 0 arms the V barrier, each with
  // the bytes it will see. K and V rows past the visible slots are not
  // copied: their scores are masked and their p8 is 0, whatever they hold.
  if (tid < 16 * TILES) {
    const int tile = tid >> 4, is_v = (tid >> 3) & 1, grp = tid & 7;
    const int n_tile = min(kTile, nvis - tile * kTile);
    const int rows = min(kGrp, n_tile - grp * kGrp);
    uint64_t* bar = bars + is_v * TILES + tile;
    const uint64_t once = l2_evict_first();
    if (grp == 0 && n_tile > 0) {
      const uint32_t scales = is_v ? 0u : 2u * kTile * sizeof(TS);
      mbar_expect(bar, (uint32_t)(n_tile * HD) + scales);
      if (!is_v) {
        const size_t so = (size_t)bh * S + j0 + tile * kTile;
        bulk_copy(sk + tile * kTile, ks + so, kTile * sizeof(TS), bar, once);
        bulk_copy(sv + tile * kTile, vs + so, kTile * sizeof(TS), bar, once);
      }
    }
    if (rows > 0)
      bulk_copy((is_v ? Vs : Ks) + tile * TB + grp * GB,
                (is_v ? vc : kc) + ((size_t)bh * S + j0 + tile * kTile + grp * kGrp) * HD,
                (uint32_t)(rows * HD), bar, once);
  }

  const int tile_w = warp * NT / 8;  // the K tile of this warp's slots
  const bool has_k = tile_w * kTile < nvis;
  for (int rb = 0; rb < R; rb += 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = qr0 + i;
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < QV; ++e) a = fmaxf(a, fabsf(x[i][e]));
      a = warp_max(a);
      const float sq = a > 0.f ? a * kInv127 : 1.f;
      const double rs = rcp_d(sq);
      int v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < QV; ++e) v[e] = quant_r(x[i][e], rs);
      if constexpr (QV == 4)
        *reinterpret_cast<uint32_t*>(Q8 + r * QLD + 4 * lane) = pack_s8(v[0], v[1], v[2], v[3]);
      else
        *reinterpret_cast<uint16_t*>(Q8 + r * QLD + 2 * lane) = (uint16_t)pack_s8(v[0], v[1], 0, 0);
      if (lane == 0) qsc_s[r] = scale * sq;
    }
    __syncthreads();  // Q8 and qsc_s are staged; the last m16 tile is done with P
    if (rb + 16 < R) load_q(rb + 16);  // the next m16 tile's rows, in flight meanwhile

    // rows rb + gid and rb + gid + 8 as A fragments, and their scale * sq
    uint32_t qf[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int8_t* lo = Q8 + gid * QLD + kk * 32 + 4 * tig;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(lo);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(lo + 8 * QLD);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(lo + 16);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(lo + 8 * QLD + 16);
    }
    const float qsc[2] = {qsc_s[gid], qsc_s[gid + 8]};

    // exact int32 scores of this warp's n-tiles, scaled, masked, row maxima
    int acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
    if (has_k) {
      mbar_wait(bars + tile_w, 0);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int v = warp * NT + n;
          const int8_t* kr = Ks + (v >> 3) * TB + gid * GB + (v & 7) * HD + kk * 32 + 4 * tig;
          mma_s8(acc[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 16));
        }
      }
    }
    float s[NT][4];
    float mx[2] = {kMask, kMask};
    const int qp[2] = {p0 + (rb + gid) / g, p0 + (rb + gid + 8) / g};  // rows' positions
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int v = warp * NT + n;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int slot = (v >> 3) * kTile + 16 * tig + 8 * e + (v & 7);
          const bool in = has_k && slot < nvis && j0 + slot <= qp[h];
          s[n][2 * h + e] = in ? ((float)acc[n][2 * h + e] * qsc[h]) * to_f(sk[slot]) : kMask;
          mx[h] = fmaxf(mx[h], s[n][2 * h + e]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (tig == 0) red_max[warp][gid + 8 * h] = mx[h];
    }
    __syncthreads();

    // p = exp(s - m) over the S-block, its sum, p * sv and its maximum
    float m[2], ls[2] = {0.f, 0.f}, pmx[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      m[h] = fmaxf(fmaxf(red_max[0][gid + 8 * h], red_max[1][gid + 8 * h]),
                   fmaxf(red_max[2][gid + 8 * h], red_max[3][gid + 8 * h]));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int v = warp * NT + n;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[n][2 * h + e] - m[h]);
          ls[h] += p;
          const int slot = (v >> 3) * kTile + 16 * tig + 8 * e + (v & 7);
          const float psv = slot < nvis ? p * to_f(sv[slot]) : 0.f;  // V rows there are stale
          pmx[h] = fmaxf(pmx[h], psv);
          s[n][2 * h + e] = psv;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
      ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
      pmx[h] = fmaxf(pmx[h], __shfl_xor_sync(0xffffffffu, pmx[h], 1));
      pmx[h] = fmaxf(pmx[h], __shfl_xor_sync(0xffffffffu, pmx[h], 2));
      if (tig == 0) red_sum[warp][gid + 8 * h] = ls[h], red_pmax[warp][gid + 8 * h] = pmx[h];
    }
    __syncthreads();

    // sp, p8 into shared memory (a word: n-tiles n, n + 1, slots 16 * tig +
    // {0, 8} of each), and the block's statistics of the valid rows
    float sp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gid + 8 * h;
      const float pmax = fmaxf(fmaxf(red_pmax[0][r], red_pmax[1][r]),
                               fmaxf(red_pmax[2][r], red_pmax[3][r]));
      sp[h] = pmax > 0.f ? pmax * kInv127 : 1.f;
      const double rs = rcp_d(sp[h]);
      const bool valid = rb + r < R;  // rows past R: zeros
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        const int v = warp * NT + n;
        *reinterpret_cast<uint32_t*>(P + r * PLD + (v >> 2) * 32 + (v & 2) * 8 + 4 * tig) =
            valid ? pack_s8(quant_r(s[n][2 * h], rs), quant_r(s[n][2 * h + 1], rs),
                            quant_r(s[n + 1][2 * h], rs), quant_r(s[n + 1][2 * h + 1], rs))
                  : 0u;
      }
      if (warp == 0 && tig == 0 && rb + r < R) {
        const size_t pi = ((size_t)bh * nsb + si) * R + rb + r;
        pm[pi] = m[h];
        pl[pi] = ((red_sum[0][r] + red_sum[1][r]) + red_sum[2][r]) + red_sum[3][r];
      }
    }
    __syncthreads();

    // P V over the visible tiles, this warp's columns: per k-step of 32
    // slots (tile ks / 2, slots 8n + i0 .. i0 + 3 of it), ldmatrix brings
    // p8 as A and ldmatrix.trans V's slot pairs of 16 columns, which byte
    // permutes turn into the B registers of the even and the odd columns
    int o[CH][2][4];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) o[c][e][0] = o[c][e][1] = o[c][e][2] = o[c][e][3] = 0;
#pragma unroll
    for (int kst = 0; kst < 2 * TILES; ++kst) {
      const int tile = kst >> 1, i0 = (kst & 1) * 4;
      if (tile * kTile >= nvis) break;
      mbar_wait(bars + TILES + tile, 0);
      uint32_t a[4];
      ldmatrix_x4(a, P + ((lane & 7) + 8 * ((lane >> 3) & 1)) * PLD + kst * 32 + 16 * (lane >> 4));
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Vs + tile * TB + (lane & 7) * GB + (i0 + (lane >> 3)) * HD +
                                 (warp * CH + c) * 16);
        mma_s8(o[c][0], a, __byte_perm(r[0], r[1], 0x6420), __byte_perm(r[2], r[3], 0x6420));
        mma_s8(o[c][1], a, __byte_perm(r[0], r[1], 0x7531), __byte_perm(r[2], r[3], 0x7531));
      }
    }
    // the lane's columns 16 * chunk + 4 * tig .. + 3 of rows gid, gid + 8:
    // even, odd, even, odd
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rb + gid + 8 * h;
      if (row >= R) continue;
      float* dst = pacc + (((size_t)bh * nsb + si) * R + row) * HD + 4 * tig;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        *reinterpret_cast<float4*>(dst + (warp * CH + c) * 16) = make_float4(
            (float)o[c][0][2 * h] * sp[h], (float)o[c][1][2 * h] * sp[h],
            (float)o[c][0][2 * h + 1] * sp[h], (float)o[c][1][2 * h + 1] * sp[h]);
    }
  }
}

// The workspace: partials [B*KV, nsb, t*g, hd], then the row maxima and
// sums [B*KV, nsb, t*g] each.
struct Ws {
  float *pacc, *pm, *pl;
  Ws(float* ws, int B, int t, int KV, int g, int hd, int nsb) {
    const size_t n_part = (size_t)B * KV * nsb * t * g;
    pacc = ws;
    pm = ws + n_part * hd;
    pl = pm + n_part;
  }
};

template <typename T, typename TS, int HD, int TILES>
int launch_tc(const void* q, const int8_t* k, const int8_t* v, const void* ks, const void* vs,
              const int* pos0, void* out, const Ws& w, int B, int t, int KV, int g, int S,
              float scale, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes<HD, TILES, TS>();
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      quant_partial_tc<T, TS, HD, TILES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int nsb = S / (TILES * kTile);
  quant_partial_tc<T, TS, HD, TILES><<<dim3(B * KV, nsb), kTcThreads, smem, st>>>(
      static_cast<const T*>(q), k, v, static_cast<const TS*>(ks), static_cast<const TS*>(vs),
      pos0, w.pacc, w.pm, w.pl, t, KV, g, S, scale, nsb);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quant_merge<T><<<merge_grid(B, t, KV, g, HD), kThreads, 0, st>>>(
      w.pacc, w.pm, w.pl, pos0, static_cast<T*>(out), t, KV, g, HD, TILES * kTile, nsb);
  return (int)cudaGetLastError();
}

template <typename T, typename TS, int HD>
int launch_tc_sb(const void* q, const int8_t* k, const int8_t* v, const void* ks,
                 const void* vs, const int* pos0, void* out, const Ws& w, int B, int t, int KV,
                 int g, int S, int SB, float scale, cudaStream_t st) {
  switch (SB) {
    case 256:
      return launch_tc<T, TS, HD, 4>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, S, scale, st);
    case 128:
      return launch_tc<T, TS, HD, 2>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, S, scale, st);
    case 64:
      return launch_tc<T, TS, HD, 1>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, S, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------- K8 on the bf16 tensor cores (widening_tc)

constexpr int kWtStages = 2;  // ring stages, when the split has that many tiles

// One ring stage: a K tile and a V tile in groups of 8 rows (as
// quant_partial_tc's), then the tile's 64 K and 64 V scales as stored.
template <int HD, typename TS> __host__ __device__ constexpr int wt_stage_bytes() {
  return 2 * tile_bytes<HD>() + 2 * kTile * (int)sizeof(TS);
}
// bf16 elements of a staged q row: 8 words more than a multiple of 32, so
// that the lanes' 8-byte reads of rows gid fall on distinct banks.
template <int HD> __host__ __device__ constexpr int wt_qld() { return HD + 16; }
constexpr int kWtPLd = kTile + 8;  // bf16 elements of a row of P
// Dynamic shared memory of a block with `ring` stages: q of its 16 * MT
// rows, P of those rows over one tile, the stages, and their mbarriers.
template <int HD, int MT, typename TS> __host__ __device__ constexpr int wt_smem_bytes(int ring) {
  return MT * 16 * wt_qld<HD>() * 2 + MT * 16 * kWtPLd * 2 + ring * wt_stage_bytes<HD, TS>() +
         kWtStages * 8;
}

// Two bytes of a word (each already XORed with 0x80, so a byte holds q +
// 128), B0 in the low half, as an exact bf16 pair (i8_pair's arithmetic).
template <int B0> __device__ __forceinline__ uint32_t i8_pair_of_word(uint32_t w) {
  const float a = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | B0)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | (B0 + 1))) - 8388736.f;
  return pack_bf16(a, b);
}

// A lane's 2 * HD / 64 neighbouring bytes of a V row (4 at HD = 128, 2 at
// 64), XORed with 0x80 each.
template <int HD> __device__ __forceinline__ uint32_t v_word(const int8_t* p) {
  if constexpr (HD == 128)
    return *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  else
    return (uint32_t)*reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
}

// grid (B*KV * n_groups, n_split), 128 threads, wt_smem_bytes(ring). Block
// x is (batch, kv head) x / n_groups and its rows 16 * MT * (x % n_groups)
// .. (MT m16 tiles), block y the split of slots [y * sps, (y + 1) * sps).
// Per 64-slot tile of the split: warp w scores n-tiles 2w, 2w + 1 (n-tile
// v: slots 8i + v of the tile, i the n column, as quant_partial_tc's) for
// every m16 tile, the warps share each row's maximum through shared memory
// and put p * sv in bf16 into P, and warp w multiplies P by V's columns
// w * HD / 4 .. for every m16 tile. Each row's running maximum is the same
// in every warp; each warp keeps its own running sum of p, and the four are
// added at the end. Every split with work writes its partials for
// quant_merge. Blocks an SM: four of MT = 1 (every decode step), fewer of
// the others.
template <typename TS, int HD, int MT>
__global__ void __launch_bounds__(kTcThreads, MT == 1 ? 4 : MT == 2 ? 3 : 2) widening_tc(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kc,
    const int8_t* __restrict__ vc, const TS* __restrict__ ks, const TS* __restrict__ vs,
    const int* __restrict__ pos0, float* __restrict__ pacc, float* __restrict__ pm,
    float* __restrict__ pl, int t, int KV, int g, int S, float scale, int sps, int n_groups) {
  constexpr int GB = grp_bytes<HD>(), TB = tile_bytes<HD>();
  constexpr int STAGE = wt_stage_bytes<HD, TS>();
  constexpr int QLD = wt_qld<HD>();
  constexpr int KK = HD / 16;   // k-steps of Q K^T
  constexpr int CPL = HD / 32;  // V columns of a lane's word: n-tiles of a warp's P V
  constexpr int Q_BYTES = MT * 16 * QLD * 2, P_BYTES = MT * 16 * kWtPLd * 2;
  static_assert(STAGE % 16 == 0 && Q_BYTES % 16 == 0 && P_BYTES % 16 == 0,
                "copies, rows and barriers aligned");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[4][MT * 16];  // the warps' row maxima, at the end their sums

  const int grp = blockIdx.x % n_groups, bh = blockIdx.x / n_groups;
  const int b = bh / KV, kvh = bh % KV;
  const int sp = blockIdx.y, nsb = gridDim.y;
  const int R = t * g;
  const int r0 = grp * 16 * MT;
  const int rows = min(16 * MT, R - r0);
  const int p0 = pos0[b];
  // slots the group's last row sees, inside the cache
  const int vis = min(S, p0 + (r0 + rows - 1) / g + 1);
  const int j_begin = sp * sps;
  if (j_begin >= vis) return;
  const int j_end = min(j_begin + sps, vis);
  const int n_it = (j_end - j_begin + kTile - 1) / kTile;
  const int ring = min(sps / kTile, kWtStages);

  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + Q_BYTES);
  unsigned char* stages = smem + Q_BYTES + P_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + ring * STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (tid < ring) mbar_init(bars + tid);
  mbar_init_fence();
  __syncthreads();

  // Tile `it` of the split into stage `st`: thread c < 16 copies group c % 8
  // of the K (c < 8) or V tile's visible rows, threads 16 and 17 the tile's
  // 64 K and V scales, all by bulk copies (L2 evict_first: a call reads its
  // cache once) that count their bytes off the stage's barrier. Rows past
  // the visible slots are not copied: their scores are masked and their p *
  // sv is 0, whatever the stage holds there (int8, so always finite); their
  // scales are copied (S is a multiple of 64) and never multiplied in.
  const uint64_t once = l2_evict_first();
  const size_t cbase = (size_t)bh * S;
  auto load = [&](int st, int it) {
    const int j0 = j_begin + it * kTile;
    const int n = min(kTile, j_end - j0);
    unsigned char* sb = stages + st * STAGE;
    if (tid == 0) mbar_expect(bars + st, (uint32_t)(2 * n * HD + 2 * kTile * sizeof(TS)));
    if (tid < 16) {
      const int is_v = tid >> 3, g8 = tid & 7;
      const int rows8 = min(kGrp, n - g8 * kGrp);
      if (rows8 > 0)
        bulk_copy(sb + is_v * TB + g8 * GB, (is_v ? vc : kc) + (cbase + j0 + g8 * kGrp) * HD,
                  (uint32_t)(rows8 * HD), bars + st, once);
    } else if (tid < 18) {
      const int is_v = tid - 16;
      bulk_copy(sb + 2 * TB + is_v * kTile * sizeof(TS), (is_v ? vs : ks) + cbase + j0,
                kTile * sizeof(TS), bars + st, once);
    }
  };
#pragma unroll
  for (int i = 0; i < kWtStages; ++i)
    if (i < ring && i < n_it) load(i, i);

  // The group's q rows into Qs (zeros past R), 16 bytes a thread at a time.
  constexpr int QV = HD / 8;
  for (int i = tid; i < MT * 16 * QV; i += kTcThreads) {
    const int rr = i / QV, c = i % QV;
    const int row = r0 + rr;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (rr < rows)
      v = *reinterpret_cast<const uint4*>(
          q + ((((size_t)b * t + row / g) * KV + kvh) * g + row % g) * HD + 8 * c);
    *reinterpret_cast<uint4*>(Qs + rr * QLD + 8 * c) = v;
  }

  float m_r[MT][2], l_r[MT][2], o[MT][CPL][4];
  int qp[MT][2];  // the rows' positions
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_r[mt][h] = kMask, l_r[mt][h] = 0.f;
      qp[mt][h] = p0 + (r0 + mt * 16 + gid + 8 * h) / g;
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    const int st = it % ring;
    mbar_wait(bars + st, (it / ring) & 1);
    __syncthreads();  // tile `it` has landed (and Qs, at the first); every warp is done with
                      // the last tile's stage, P and row maxima
    if (it > 0 && it - 1 + ring < n_it) load((it - 1) % ring, it - 1 + ring);
    const int8_t* Kt = reinterpret_cast<const int8_t*>(stages + st * STAGE);
    const int8_t* Vt = Kt + TB;
    const TS* skt = reinterpret_cast<const TS*>(Kt + 2 * TB);
    const TS* svt = skt + kTile;
    const int j0 = j_begin + it * kTile;

    // Q K^T of n-tiles 2w and 2w + 1 for every m16 tile: per k-step a
    // lane's word of K row (group gid, row v) holds hd 16 kk + 4 tig .. +3,
    // widened into the B pair of k 2 tig, 2 tig + 1 and that of k 2 tig +
    // 8, + 9, and q's A registers are the rows' 8-byte reads at the same hd
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) s[mt][nn][0] = s[mt][nn][1] = s[mt][nn][2] = s[mt][nn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t kb[2][2];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
                               Kt + gid * GB + (2 * warp + nn) * HD + kk * 16 + 4 * tig) ^
                           0x80808080u;
        kb[nn][0] = i8_pair_of_word<0>(w);
        kb[nn][1] = i8_pair_of_word<2>(w);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* qr = Qs + (mt * 16 + gid) * QLD + kk * 16 + 4 * tig;
        const uint2 lo = *reinterpret_cast<const uint2*>(qr);
        const uint2 hi = *reinterpret_cast<const uint2*>(qr + 8 * QLD);
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
        mma_bf16(s[mt][0], a, kb[0][0], kb[0][1]);
        mma_bf16(s[mt][1], a, kb[1][0], kb[1][1]);
      }
    }

    // scaled (times 1/sqrt(hd), then sk), masked (a select: an unread K row
    // or scale may give any score), and the warp's row maxima
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kMask;
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int slot = 16 * tig + 8 * e + 2 * warp + nn;
            const bool in = j0 + slot < j_end && j0 + slot <= qp[mt][h];
            float& v = s[mt][nn][2 * h + e];
            v = in ? (v * scale) * to_f(skt[slot]) : kMask;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (tig == 0) red[warp][mt * 16 + gid + 8 * h] = mx;
      }
    }
    __syncthreads();

    // the running maxima, p = exp(s - m), this warp's sums of p, and p * sv
    // rounded to bf16 into P: row gid (+ 8) of m16 tile mt, at k 8 nn + 2
    // tig + e of P V's k-step w (slot 16 tig + 8 e + 2 w + nn)
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + gid + 8 * h;
        const float mn = fmaxf(m_r[mt][h], fmaxf(fmaxf(red[0][r], red[1][r]),
                                                 fmaxf(red[2][r], red[3][r])));
        alpha[mt][h] = expf(m_r[mt][h] - mn);
        m_r[mt][h] = mn;
        float ps = 0.f;
        uint32_t pw[2];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          float psv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int slot = 16 * tig + 8 * e + 2 * warp + nn;
            const float p = expf(s[mt][nn][2 * h + e] - mn);
            ps += p;
            psv[e] = j0 + slot < j_end ? p * to_f(svt[slot]) : 0.f;
          }
          pw[nn] = pack_bf16(psv[0], psv[1]);
        }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        l_r[mt][h] = fmaf(l_r[mt][h], alpha[mt][h], ps);
        __nv_bfloat16* prow = Ps + r * kWtPLd + 16 * warp + 2 * tig;
        *reinterpret_cast<uint32_t*>(prow) = pw[0];
        *reinterpret_cast<uint32_t*>(prow + 8) = pw[1];
      }
    }
    __syncthreads();  // P is complete

    // O = O * alpha + P V over the tile's 64 slots, this warp's columns:
    // per k-step ks (n-tiles 2 ks, 2 ks + 1 of the scores), ldmatrix brings
    // P's A fragment of each m16 tile, and a lane's words of the four V
    // rows 16 tig + 8 e + 2 ks + {0, 1} (groups 2 tig + e) become, byte J
    // by byte, the B pairs of n-tile J: column w * HD / 4 + CPL * gid + J
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        o[mt][j][0] *= alpha[mt][0], o[mt][j][1] *= alpha[mt][0];
        o[mt][j][2] *= alpha[mt][1], o[mt][j][3] *= alpha[mt][1];
      }
    const int8_t* vcol = Vt + 2 * tig * GB + warp * (HD / 4) + CPL * gid;
#pragma unroll
    for (int kst = 0; kst < kTile / 16; ++kst) {
      const int8_t* v0 = vcol + 2 * kst * HD;
      const uint32_t wa = v_word<HD>(v0), wb = v_word<HD>(v0 + GB);
      const uint32_t wc = v_word<HD>(v0 + HD), wd = v_word<HD>(v0 + GB + HD);
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], Ps + (mt * 16 + (lane & 15)) * kWtPLd + kst * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        uint32_t b0, b1;
        if (j == 0) b0 = i8_pair<0>(wa, wb), b1 = i8_pair<0>(wc, wd);
        if (j == 1) b0 = i8_pair<1>(wa, wb), b1 = i8_pair<1>(wc, wd);
        if (j == 2) b0 = i8_pair<2>(wa, wb), b1 = i8_pair<2>(wc, wd);
        if (j == 3) b0 = i8_pair<3>(wa, wb), b1 = i8_pair<3>(wc, wd);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(o[mt][j], a[mt], b0, b1);
      }
    }
  }

  // The row sums over the warps (every warp has read the last tile's
  // maxima), then this warp's columns of the partials: a lane's 2 * CPL
  // neighbouring columns w * HD / 4 + 2 * CPL * tig .. of rows gid, gid + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (tig == 0) red[warp][mt * 16 + gid + 8 * h] = l_r[mt][h];
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + gid + 8 * h;
      if (r >= rows) continue;
      const size_t pi = ((size_t)bh * nsb + sp) * R + r0 + r;
      float v[2 * CPL];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < CPL; ++j) v[CPL * e + j] = o[mt][j][2 * h + e];
      float4* dst = reinterpret_cast<float4*>(pacc + pi * HD + warp * (HD / 4) + 2 * CPL * tig);
#pragma unroll
      for (int i = 0; i < CPL / 2; ++i)
        dst[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      if (warp == 0 && tig == 0) {
        pm[pi] = m_r[mt][h];
        pl[pi] = ((red[0][r] + red[1][r]) + red[2][r]) + red[3][r];
      }
    }
  }
}

// Query rows of a block's m16 tiles: one tile up to 16 rows, two up to
// 32, else four (groups of 64 rows).
int wt_tiles(int R) { return R <= 16 ? 1 : R <= 32 ? 2 : 4; }

template <typename TS, int HD, int MT>
int launch_wt(const void* q, const int8_t* k, const int8_t* v, const void* ks, const void* vs,
              const int* pos0, void* out, const Ws& w, int B, int t, int KV, int g, int S,
              int sps, int n_split, float scale, cudaStream_t st) {
  constexpr int max_smem = wt_smem_bytes<HD, MT, TS>(kWtStages);
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      widening_tc<TS, HD, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int ring = sps / kTile < kWtStages ? sps / kTile : kWtStages;
  const int n_groups = (t * g + 16 * MT - 1) / (16 * MT);
  widening_tc<TS, HD, MT><<<dim3(B * KV * n_groups, n_split), kTcThreads,
                            wt_smem_bytes<HD, MT, TS>(ring), st>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const TS*>(ks),
      static_cast<const TS*>(vs), pos0, w.pacc, w.pm, w.pl, t, KV, g, S, scale, sps, n_groups);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  using bf16 = __nv_bfloat16;
  quant_merge<bf16><<<merge_grid(B, t, KV, g, HD), kThreads, 0, st>>>(
      w.pacc, w.pm, w.pl, pos0, static_cast<bf16*>(out), t, KV, g, HD, sps, n_split);
  return (int)cudaGetLastError();
}

template <typename TS, int HD>
int launch_wt_rows(const void* q, const int8_t* k, const int8_t* v, const void* ks,
                   const void* vs, const int* pos0, void* out, const Ws& w, int B, int t, int KV,
                   int g, int S, int sps, int n_split, float scale, cudaStream_t st) {
  switch (wt_tiles(t * g)) {
    case 1:
      return launch_wt<TS, HD, 1>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, S, sps, n_split,
                                  scale, st);
    case 2:
      return launch_wt<TS, HD, 2>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, S, sps, n_split,
                                  scale, st);
    default:
      return launch_wt<TS, HD, 4>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, S, sps, n_split,
                                  scale, st);
  }
}

// ---------------------------------------------------------------- launch

template <typename T, typename TS, bool I8DOT>
int launch(const void* q, const int8_t* k, const int8_t* v, const void* ks,
           const void* vs, const int* pos0, void* out, const Ws& w,
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
      pos0, w.pacc, w.pm, w.pl, t, KV, g, hd, S, SB, rch, scale, nsb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quant_merge<T><<<merge_grid(B, t, KV, g, hd), kThreads, 0, st>>>(
      w.pacc, w.pm, w.pl, pos0, static_cast<T*>(out), t, KV, g, hd, SB, nsb);
  return (int)cudaGetLastError();
}

// The forms, as ops/attention.py's QUANT_FORMS numbers them.
enum Form { kWidening = 0, kI8dot = 1, kI8dotTc = 2, kWideningTc = 3 };

template <typename T, typename TS>
int launch_form(int form, const void* q, const int8_t* k, const int8_t* v, const void* ks,
                const void* vs, const int* pos0, void* out, const Ws& w, int B, int t, int KV,
                int g, int hd, int S, int SB, float scale, cudaStream_t st) {
  if (form == kWidening)
    return launch<T, TS, false>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, hd, S, SB, scale,
                                st);
  if (form == kI8dot)
    return launch<T, TS, true>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, hd, S, SB, scale,
                               st);
  if (form == kWideningTc) {
    const int n_split = (S + SB - 1) / SB;
    if (hd == 128)
      return launch_wt_rows<TS, 128>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, S, SB, n_split,
                                     scale, st);
    return launch_wt_rows<TS, 64>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, S, SB, n_split,
                                  scale, st);
  }
  if (hd == 128)
    return launch_tc_sb<T, TS, 128>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, S, SB, scale,
                                    st);
  return launch_tc_sb<T, TS, 64>(q, k, v, ks, vs, pos0, out, w, B, t, KV, g, S, SB, scale, st);
}

}  // namespace

// SB: the S-block rows, which must divide S (kWidening, kI8dot, kI8dotTc:
// 64, 128 or 256 there), or kWideningTc's slots per split, a multiple of
// 64 (S a multiple of 64, the last split may be shorter); hd a multiple of
// 4, and 64 or 128 for the tensor-core forms. ws: one f32 workspace of
// B*KV * ceil(S/SB) * t*g * (hd + 2) values (see Ws). form picks K8
// (kWidening, kWideningTc: bf16 q only) or K4 (kI8dot, kI8dotTc);
// scale_bf16 says which type the scale planes ks / vs hold. Returns
// cudaErrorInvalidValue for arguments the form does not take, else
// cudaGetLastError() after the launches.
extern "C" int llamago_attn_decode_quant(const void* q, const void* k8, const void* v8,
                                         const void* ks, const void* vs, const void* pos0,
                                         void* out, void* ws, int B, int t, int KV, int g,
                                         int hd, int S, int SB, float scale, int is_bf16,
                                         int form, int scale_bf16, void* stream) {
  const bool tc = form == kI8dotTc || form == kWideningTc;
  if (B < 1 || t < 1 || KV < 1 || g < 1 || SB < 1 || S < SB || hd % 4 || ws == nullptr ||
      form < kWidening || form > kWideningTc || (form != kWideningTc && S % SB) ||
      (tc && (SB % kTile || (hd != 64 && hd != 128))) ||
      (form == kWideningTc && (!is_bf16 || S % kTile)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* k = static_cast<const int8_t*>(k8);
  const int8_t* v = static_cast<const int8_t*>(v8);
  const int* p = static_cast<const int*>(pos0);
  const Ws w(static_cast<float*>(ws), B, t, KV, g, hd, (S + SB - 1) / SB);
  using bf16 = __nv_bfloat16;
  if (is_bf16 && scale_bf16)
    return launch_form<bf16, bf16>(form, q, k, v, ks, vs, p, out, w, B, t, KV, g, hd, S, SB,
                                   scale, st);
  if (is_bf16)
    return launch_form<bf16, float>(form, q, k, v, ks, vs, p, out, w, B, t, KV, g, hd, S, SB,
                                    scale, st);
  if (scale_bf16)
    return launch_form<float, bf16>(form, q, k, v, ks, vs, p, out, w, B, t, KV, g, hd, S, SB,
                                    scale, st);
  return launch_form<float, float>(form, q, k, v, ks, vs, p, out, w, B, t, KV, g, hd, S, SB,
                                   scale, st);
}
