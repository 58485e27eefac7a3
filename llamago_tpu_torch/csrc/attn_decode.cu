// K2: length-aware causal decode attention over a dense KV cache, for
// Hopper (sm_90a).
//
// q: [B, t, KV, g, hd] (roped; t <= 32, g <= 8, hd in {64, 128}),
// k/v cache: [B, KV, S, hd], pos0: int32 [B] (absolute position of query
// row t=0), out: same shape as q. All of q, k, v and out share one dtype,
// bf16 or f32. Rows are laid out t-major then g; row r sees cache slot j
// iff j <= pos0 + r / g. Masked scores are the finite -1e9, softmax is in
// f32, and the probabilities are rounded to the V dtype before the PV
// product (not at all for f32), as in the TPU kernel. Slots past the last
// visible one are never read.
//
// Replaces llamago_tpu/ops/attention.py _attn_decode_kernel, reached
// through _flash_attention_lenaware and flash_attention.
//
// What bounds it: per (batch, kv head) the kernel reads the visible
// prefix of K and V once (2 * fill * hd elements) and does 4 * rows * fill
// * hd flops on it — at most 8 flops per cache byte at decode (rows = g),
// so device-memory bandwidth over the cache bytes that hold visible slots
// is the bound. A decode step's call is small (67 MB at 7B, b = 4, full
// fill: 20 us at 3.35 TB/s), so what shows on the card is how many tile
// loads are in flight, and each block's fixed latency: the start, the
// tile's trip from memory, the merge.
//
// Two forms (ops/attention.py k2_form names them, the entry point takes the
// code), both ending in the same merge pass, attn_combine:
//
//  * bf16: attn_decode_tc, then attn_combine when the plan has more than
//    one split (every decode step's plan has). The grid is (B*KV * row
//    groups of 64 query rows, splits); the host plans the split
//    (decode_attn_plan: slots per split, a multiple of the 64-slot tile, and
//    the number of splits; one tile a split at decode), and a split past
//    its (batch, kv head)'s last visible slot returns at once, so cache
//    traffic follows the fill.
//    - Both products on the tensor cores: bf16 mma.sync.m16n8k16 with f32
//      accumulation, K7's fragments (q as A fragments in registers, K's B
//      fragments by 32-bit reads of its row-major tile, V's by
//      ldmatrix.trans). The rows are the M side in m16 tiles. With one m16
//      tile (every decode step: t * g <= 16) the four warps split each
//      tile's 64 slots for Q K^T, 16 each, and its columns for P V, 32 each
//      at hd = 128: the warps share each tile's row maxima and sums through
//      shared memory, and P in bf16 goes through the stage's K rows, which
//      no warp needs once every warp has its scores. An m16 tile's
//      accumulators are then a quarter of a warp's registers (96 a thread,
//      five blocks an SM, against 128 and four when each warp kept all the
//      columns of its slots). With two m16 tiles two warps share a tile the
//      same way; with more, each warp takes a tile's rows, all 64 slots and
//      all columns, P repacked in registers as its A fragments.
//    - A ring of 64-slot K/V tiles in shared memory, rows padded by 16
//      bytes against bank conflicts, filled by the TMA unit: one bulk copy
//      per K or V row (one per thread), completing on the stage's mbarrier,
//      with the L2 policy evict_first (a step reads its cache once). With
//      two tiles or more a split has the next tile's copies in flight while
//      the current one is computed; a decode step's one-tile splits keep
//      five tiles in flight an SM, one a block. V rows past the visible
//      slots are zeroed, so p * V stays finite. When warps pass P through a
//      stage's K rows, they fence those generic accesses against the async
//      proxy before the barrier after which a later copy refills the stage.
//    - Each split writes its f32 partials (row max, sum, unnormalized P.V)
//      to the workspace, and attn_combine, a second launch, merges them in
//      split order, so a call run twice gives the same bits. With one
//      split the block writes the output itself.
//  * f32: attn_decode_f32tc, then attn_combine<float> when the plan has
//    more than one split. Both products on the tensor cores as three TF32
//    products (3xTF32, tc_common.cuh: mma.sync.m16n8k8 on tf32, each f32
//    operand split as big + small and a b taken as big big + big small +
//    small big, about 2^-20 of a product off; wgmma takes tf32 only with
//    K-major B operands and V is MN-major in P V).
//    - The plan (decode_attn_plan for f32) fills the card once: as many
//      splits as give every SM a block, no more (one split, no merge pass,
//      at b = 4, KV = 32): the split's fixed costs (q's planes, the warps'
//      merge, the partials and the merge launch) weigh more in f32, and
//      the bf16 form's 64-slot splits measured up to 1.7x slower; the
//      two-pass CUDA-core form this replaced was 1.1-5.5x slower (PERF.md).
//    - The split's 32-slot K/V tiles (64-slot tiles of f32 would leave one
//      block an SM) stream through a ring of two stages by the TMA unit,
//      one bulk copy per group of 4 slots, evict_first; groups padded by 16
//      bytes and a fragment's rows one slot of each group, so that the K
//      and the permuted V reads fall on 32 distinct banks. V rows past the
//      visible slots are zeroed; masked scores are selected.
//    - q is split once into big and small planes in shared memory, K and V
//      as a fragment is read, P once a k-step from the score registers,
//      repacked in place by permuting the reduction index (c_to_a).
//    - With one m16 tile of rows (every decode step) the four warps take a
//      quarter of every tile's slots each, for both products, each with its
//      own running max, sum and P V over all columns, merged in warp order
//      after the last tile (no exchange per tile); with two m16 tiles two
//      warps share a tile the same way, with more each warp takes all the
//      slots.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr float kMask = -1e9f;
constexpr int kThreads = 256;  // threads of a merge block

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The merge pass of both forms: merges the splits of sps slots that row r sees,
// 0 .. (pos0 + r / g) / sps, in split order (a call run twice gives the
// same bits). Every split up to the last that any row of the (batch, kv
// head) sees has partials for all its rows (a row's later ones are all
// masked, weight 0). Grid (B*KV, blocks of 256 (row, column) pairs): a
// thread's work is one chain of loads over the splits (t * g * hd / 256
// chains in a row were latency-bound at t = 32).
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_combine(
    const float* __restrict__ pacc, const float* __restrict__ pm,
    const float* __restrict__ pl, const int* __restrict__ pos0, T* __restrict__ out,
    int t, int KV, int g, int hd, int sps, int nsb) {
  const int bh = blockIdx.x;
  const int b = bh / KV, kvh = bh % KV;
  const int R = t * g;
  for (int i = blockIdx.y * kThreads + threadIdx.x; i < R * hd; i += gridDim.y * kThreads) {
    const int r = i / hd, d = i % hd;
    const int last = min((pos0[b] + r / g) / sps, nsb - 1);
    float mx = kMask;
#pragma unroll 4
    for (int s = 0; s <= last; ++s) mx = fmaxf(mx, pm[((size_t)bh * nsb + s) * R + r]);
    float num = 0.f, den = 0.f;
#pragma unroll 4
    for (int s = 0; s <= last; ++s) {
      const size_t pi = ((size_t)bh * nsb + s) * R + r;
      const float w = expf(pm[pi] - mx);
      num = fmaf(w, pacc[pi * hd + d], num);
      den = fmaf(w, pl[pi], den);
    }
    const int ti = r / g, gi = r % g;
    out[((((size_t)b * t + ti) * KV + kvh) * g + gi) * hd + d] = from_f<T>(num / den);
  }
}

// The workspace of both forms: partials [B*KV, nsb, t*g, hd], then the row
// maxima and sums [B*KV, nsb, t*g] each.
template <typename T>
int launch_combine(const float* ws, const int* pos0, void* out, int B, int t, int KV, int g,
                   int hd, int sps, int nsb, cudaStream_t st) {
  const size_t n_part = (size_t)B * KV * nsb * t * g;
  const float* pm = ws + n_part * hd;
  const dim3 grid(B * KV, (t * g * hd + kThreads - 1) / kThreads);
  attn_combine<T><<<grid, kThreads, 0, st>>>(ws, pm, pm + n_part, pos0, static_cast<T*>(out), t,
                                             KV, g, hd, sps, nsb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------- bf16, tensor cores (decode_tc)

constexpr int kTcThreads = 128;  // four warps
constexpr int kTile = 64;        // cache slots per ring stage
constexpr int kGroupRows = 64;   // query rows per block: four m16 tiles
constexpr int kPadB = 8;         // bf16 elements of padding per tile row (16 bytes)
constexpr int kStages = 2;       // ring stages, when the split has that many tiles

template <int HD> __host__ __device__ constexpr int tc_ld() { return HD + kPadB; }
// One stage: the K tile, then the V tile, each [kTile][HD + kPadB] bf16.
template <int HD> __host__ __device__ constexpr int tc_stage_bytes() {
  return 2 * kTile * tc_ld<HD>() * 2;
}
// Row stride of P in shared memory (bf16 elements): 64 slots and 16 bytes
// of padding, so that the lanes' 32-bit writes and ldmatrix rows fall on
// distinct banks.
constexpr int kPLd = kTile + 8;

// Warps that share one m16 tile of rows, each on its own part of every
// tile's slots (Q K^T) and of the columns (P V): 4 for one m16 tile, 2 for
// two, 1 for more.
int tc_slot_parts(int R) {
  const int mt = ((R < kGroupRows ? R : kGroupRows) + 15) / 16;
  return mt == 1 ? 4 : mt == 2 ? 2 : 1;
}

// Ring stages a block holds: no more than the tiles of its split.
__host__ __device__ __forceinline__ int tc_ring(int sps) {
  return sps / kTile < kStages ? sps / kTile : kStages;
}

// Offset of query row r of batch b, kv head kvh in q and out.
__device__ __forceinline__ size_t q_off(int b, int r, int t, int KV, int kvh, int g, int hd) {
  return ((((size_t)b * t + r / g) * KV + kvh) * g + r % g) * hd;
}

// grid (B*KV * n_groups, n_split), 128 threads, dynamic shared memory
// tc_ring(sps) * tc_stage_bytes + 8 per stage for the mbarriers. Block x
// is (batch, kv head) x / n_groups and row group x % n_groups (rows 64 *
// group ..), block y the split of slots [y * sps, (y + 1) * sps). Warp w
// takes m16 tile w / WS of the group: part w % WS of every tile's slots
// for Q K^T and part w % WS of the columns for P V. With one split the
// block writes the output; with more, every split with work writes its
// partials to ws, and attn_combine merges them.
// Blocks an SM holds: five of the four-part instance (a decode step's;
// six spill at hd = 128), fewer of the others.
template <int HD, int WS>
__global__ void __launch_bounds__(kTcThreads, WS == 4 ? 5 : WS == 2 ? 3 : 2) attn_decode_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ pos0,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int t, int KV, int g, int S,
    float scale, int sps, int n_groups) {
  constexpr int LD = tc_ld<HD>();
  constexpr int KK = HD / 16;        // k-steps of Q K^T
  constexpr int PART = kTile / WS;   // slots of a tile per warp in Q K^T
  constexpr int NT = PART / 8;       // n-tiles of a warp's scores
  constexpr int COLS = HD / WS;      // columns of the output per warp in P V
  constexpr int DT = COLS / 8;       // n-tiles of a warp's output
  constexpr int STAGE = tc_stage_bytes<HD>();
  static_assert(STAGE % 16 == 0, "stages and barriers stay aligned");
  static_assert(DT % 2 == 0, "ldmatrix.trans brings two n-tiles of V");
  static_assert(2 * 16 * kPLd <= kTile * LD, "P of two m16 tiles fits where the stage's K was");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_max[4][16], red_sum[4][16];  // a tile's row maxima and sums, per warp

  const int grp = blockIdx.x % n_groups;
  const int bh = blockIdx.x / n_groups;
  const int b = bh / KV, kvh = bh % KV;
  const int sp = blockIdx.y, n_split = gridDim.y;
  const int R = t * g;
  const int r0 = grp * kGroupRows;
  const int rows = min(kGroupRows, R - r0);
  const int p0 = pos0[b];
  // slots the group's last row sees, inside the cache
  const int vis = min(S, p0 + (r0 + rows - 1) / g + 1);
  const int j_begin = sp * sps;
  if (j_begin >= vis) return;
  const int j_end = min(j_begin + sps, vis);
  const int n_it = (j_end - j_begin + kTile - 1) / kTile;
  const int ring = tc_ring(sps);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring * STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp / WS, part = warp % WS;
  const bool active = mt * 16 < rows;

  const uint64_t once = l2_evict_first();
  if (tid < ring) mbar_init(bars + tid);
  mbar_init_fence();
  __syncthreads();

  // Tile `it` of the split into ring stage `st`: thread r < 64 copies K row
  // r, thread 64 + r V row r, each by one bulk copy. V rows past the
  // visible slots are zeroed instead (their scores are masked, and p * V
  // must stay finite); K rows there keep what they held, since the mask
  // selects -1e9 over whatever score they give.
  const size_t cbase = (size_t)bh * S * HD;
  auto load = [&](int st, int it) {
    const int j0 = j_begin + it * kTile;
    const int n = min(kTile, j_end - j0);
    if (tid == 0) mbar_expect(bars + st, 2u * n * HD * 2);
    const int r = tid & (kTile - 1);
    const bool is_v = tid >= kTile;
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem + st * STAGE) +
                         (is_v ? kTile * LD : 0) + r * LD;
    if (r < n) {
      bulk_copy(dst, (is_v ? vc : kc) + cbase + (size_t)(j0 + r) * HD, HD * 2, bars + st, once);
    } else if (is_v) {
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) reinterpret_cast<uint4*>(dst)[c] = make_uint4(0, 0, 0, 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    if (i < n_it) load(i, i);

  // This warp's q rows (gid and gid + 8 of its m16 tile; zeros past R) as A
  // fragments, and their query positions.
  const int row_lo = r0 + mt * 16 + gid, row_hi = row_lo + 8;
  const int qp_lo = p0 + row_lo / g, qp_hi = p0 + row_hi / g;
  uint32_t qf[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) qf[kk][0] = qf[kk][1] = qf[kk][2] = qf[kk][3] = 0u;
  if (active && row_lo < R) {
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + q_off(b, row_lo, t, KV, kvh, g, HD));
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) qf[kk][0] = qw[kk * 8 + tig], qf[kk][2] = qw[kk * 8 + 4 + tig];
  }
  if (active && row_hi < R) {
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + q_off(b, row_hi, t, KV, kvh, g, HD));
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) qf[kk][1] = qw[kk * 8 + tig], qf[kk][3] = qw[kk * 8 + 4 + tig];
  }

  // The running max and sum of rows gid and gid + 8 (the same in the WS
  // warps of an m16 tile) and this warp's columns of their P V.
  float m_lo = kMask, m_hi = kMask, l_lo = 0.f, l_hi = 0.f;
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    mbar_wait(bars + st, (it / kStages) & 1);
    __syncthreads();  // tile `it` has landed; every warp is done with stage (it - 1) % kStages
    if (it + kStages - 1 < n_it) load((it + kStages - 1) % kStages, it + kStages - 1);
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + st * STAGE);
    const __nv_bfloat16* Vs = Ks + kTile * LD;
    const int j0 = j_begin + it * kTile + part * PART;

    // scores of 16 rows x PART slots, scaled and masked (a select: an
    // unread K row may give any score), and their row maxima
    float s[NT][4];
    float mx_lo = kMask, mx_hi = kMask;
    if (active) {
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const __nv_bfloat16* kr = Ks + (part * PART + n * 8 + gid) * LD + kk * 16 + tig * 2;
          mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int slot = j0 + n * 8 + tig * 2 + e;
          const bool in = slot < j_end;
          s[n][e] = (in && slot <= qp_lo) ? s[n][e] * scale : kMask;
          s[n][2 + e] = (in && slot <= qp_hi) ? s[n][2 + e] * scale : kMask;
          mx_lo = fmaxf(mx_lo, s[n][e]);
          mx_hi = fmaxf(mx_hi, s[n][2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {  // the four lanes that share a row
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
    }
    if constexpr (WS > 1) {  // the tile's row maxima over the WS warps of the m16 tile
      if (active && tig == 0) red_max[warp][gid] = mx_lo, red_max[warp][gid + 8] = mx_hi;
      __syncthreads();  // also: every warp is done with the stage's K rows
#pragma unroll
      for (int p = 0; p < WS; ++p) {
        mx_lo = fmaxf(mx_lo, red_max[mt * WS + p][gid]);
        mx_hi = fmaxf(mx_hi, red_max[mt * WS + p][gid + 8]);
      }
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    // p = exp(s - m), summed in f32 and rounded to bf16 for P V: as A
    // fragments in registers (WS = 1), or through the stage's K rows,
    // where the m16 tile's WS warps put their slots side by side
    uint32_t pf[kTile / 16][4];
    float ps_lo = 0.f, ps_hi = 0.f;
    __nv_bfloat16* Ps = Ks + mt * 16 * kPLd;  // [16][kPLd]: rows gid, gid + 8
    if (active) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0_ = expf(s[n][0] - mn_lo), p1_ = expf(s[n][1] - mn_lo);
        const float p2_ = expf(s[n][2] - mn_hi), p3_ = expf(s[n][3] - mn_hi);
        ps_lo += p0_ + p1_;
        ps_hi += p2_ + p3_;
        if constexpr (WS == 1) {
          pf[n / 2][(n & 1) * 2] = pack_bf16(p0_, p1_);
          pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2_, p3_);
        } else {
          const int c = part * PART + n * 8 + tig * 2;
          *reinterpret_cast<uint32_t*>(Ps + gid * kPLd + c) = pack_bf16(p0_, p1_);
          *reinterpret_cast<uint32_t*>(Ps + (gid + 8) * kPLd + c) = pack_bf16(p2_, p3_);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        ps_lo += __shfl_xor_sync(0xffffffffu, ps_lo, off);
        ps_hi += __shfl_xor_sync(0xffffffffu, ps_hi, off);
      }
    }
    if constexpr (WS > 1) {  // the tile's row sums over the WS warps, and all of P
      if (active && tig == 0) red_sum[warp][gid] = ps_lo, red_sum[warp][gid + 8] = ps_hi;
      __syncthreads();
      ps_lo = ps_hi = 0.f;
#pragma unroll
      for (int p = 0; p < WS; ++p) {
        ps_lo += red_sum[mt * WS + p][gid];
        ps_hi += red_sum[mt * WS + p][gid + 8];
      }
    }
    if (!active) continue;
    l_lo = fmaf(l_lo, a_lo, ps_lo);
    l_hi = fmaf(l_hi, a_hi, ps_hi);
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= a_lo;
      o[n][1] *= a_lo;
      o[n][2] *= a_hi;
      o[n][3] *= a_hi;
    }

    // O += P V over the tile's 64 slots, this warp's columns: per 16 slots,
    // ldmatrix brings P's A fragment (WS > 1) and ldmatrix.trans the B
    // fragments of two output n-tiles (16 columns of V) at once
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      if constexpr (WS > 1)
        ldmatrix_x4(pf[ks], Ps + (lane & 15) * kPLd + ks * 16 + (lane >> 4) * 8);
      const int mat = lane >> 3, mr = lane & 7;
      const __nv_bfloat16* vrow =
          Vs + (ks * 16 + (mat & 1) * 8 + mr) * LD + part * COLS + (mat >> 1) * 8;
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + n * 8);
        mma_bf16(o[n], pf[ks], vb[0], vb[1]);
        mma_bf16(o[n + 1], pf[ks], vb[2], vb[3]);
      }
    }
    // P's generic writes and reads of the stage's K rows, ordered before
    // the bulk copy that refills the stage (issued after the barrier at the
    // top of a later tile)
    if constexpr (WS > 1) fence_proxy_async();
  }

  // This warp's rows and columns: the output when there is one split, else
  // the split's partials (the first warp of the m16 tile writes the row
  // maxima and sums).
  if (!active) return;
  const size_t n_part = (size_t)(gridDim.x / n_groups) * n_split * R;
  const size_t p_base = ((size_t)bh * n_split + sp) * R;  // + row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row_hi : row_lo;
    if (row - r0 >= rows) continue;
    const float l = h ? l_hi : l_lo;
    const int c0 = part * COLS + tig * 2;
    if (n_split == 1) {
      __nv_bfloat16* orow = out + q_off(b, row, t, KV, kvh, g, HD) + c0;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(o[n][2 * h] / l, o[n][2 * h + 1] / l);
    } else {
      float* wrow = ws + (p_base + row) * HD + c0;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(wrow + n * 8) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (part == 0 && tig == 0) {
        ws[n_part * HD + p_base + row] = h ? m_hi : m_lo;
        ws[n_part * (HD + 1) + p_base + row] = l;
      }
    }
  }
}

template <int HD, int WS>
int launch_tc(const void* q, const void* k, const void* v, const int* pos0, void* out,
              float* ws, int B, int t, int KV, int g, int S, float scale, int sps, int n_split,
              cudaStream_t st) {
  constexpr int kMaxSmem = kStages * (tc_stage_bytes<HD>() + 8);
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      attn_decode_tc<HD, WS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int ring = tc_ring(sps);
  const int smem = ring * (tc_stage_bytes<HD>() + 8);
  const int n_groups = (t * g + kGroupRows - 1) / kGroupRows;
  dim3 grid(B * KV * n_groups, n_split);
  attn_decode_tc<HD, WS><<<grid, kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos0, static_cast<__nv_bfloat16*>(out), ws, t,
      KV, g, S, scale, sps, n_groups);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  return launch_combine<__nv_bfloat16>(ws, pos0, out, B, t, KV, g, HD, sps, n_split, st);
}

template <int HD>
int launch_tc_hd(const void* q, const void* k, const void* v, const int* pos0, void* out,
                 float* ws, int B, int t, int KV, int g, int S, float scale, int sps,
                 int n_split, cudaStream_t st) {
  switch (tc_slot_parts(t * g)) {
    case 4:
      return launch_tc<HD, 4>(q, k, v, pos0, out, ws, B, t, KV, g, S, scale, sps, n_split, st);
    case 2:
      return launch_tc<HD, 2>(q, k, v, pos0, out, ws, B, t, KV, g, S, scale, sps, n_split, st);
    default:
      return launch_tc<HD, 1>(q, k, v, pos0, out, ws, B, t, KV, g, S, scale, sps, n_split, st);
  }
}

// ------------------------------------------- f32, tensor cores (decode_f32tc)

constexpr int kF32Stages = 2;  // ring stages, when the split has that many 32-slot tiles
// One stage: the K tile, then the V tile, each 8 groups of f32_gld floats.
template <int HD> __host__ __device__ constexpr int f32_stage_bytes() {
  return 2 * (kF32Tile / kF32Group) * f32_gld<HD>() * 4;
}
static_assert(f32_stage_bytes<64>() % 16 == 0 && f32_stage_bytes<128>() % 16 == 0,
              "stages and barriers stay aligned");

// Ring stages a block of the f32 form holds: no more than its split's tiles.
__host__ __device__ __forceinline__ int f32_ring(int sps) {
  return sps / kF32Tile < kF32Stages ? sps / kF32Tile : kF32Stages;
}
// Query rows of a block's group that q's planes in shared memory hold: the
// group's m16 tiles.
__host__ __device__ __forceinline__ int f32_q_rows(int R) {
  return ((R < kGroupRows ? R : kGroupRows) + 15) / 16 * 16;
}
// Dynamic shared memory of a block: the ring, q's big and small planes,
// the ring's mbarriers.
template <int HD> int f32_smem_bytes(int ring, int R) {
  return ring * f32_stage_bytes<HD>() + 2 * f32_q_rows(R) * f32_qld<HD>() * 4 + ring * 8;
}
// Bytes the merge of the WS parts takes in the ring: every warp's P V, then
// its row maxima and sums.
template <int HD> __host__ __device__ constexpr int f32_merge_bytes() {
  return 4 * (HD / 8) * 4 * 32 * 4 + 4 * 4 * 32 * 4;
}
static_assert(f32_merge_bytes<64>() <= 2 * f32_stage_bytes<64>() &&
                  f32_merge_bytes<128>() <= 2 * f32_stage_bytes<128>(),
              "the merge fits the ring of two stages that a split of whole 64-slot tiles has");

// K2 on f32 q, cache and out, in 3xTF32 (qk_f32tc, pv_f32tc), on the f32
// plan of decode_attn_plan: grid (B*KV * n_groups, n_split), 128 threads,
// dynamic shared
// memory f32_smem_bytes. Warp w takes m16 tile w / WS of the 64-row group
// and part w % WS of every 32-slot tile (its 32 / WS slots), for both
// products, with its own running max, sum and P V over all columns; the WS
// parts of an m16 tile merge in part order after the last tile. q is split
// once into big and small planes in shared memory, K and V as read, P in
// the score registers. The split's tiles stream through a ring of `ring`
// stages filled by the TMA unit (one bulk copy per group of 4 slots,
// evict_first); all stages are filled at the start and a stage is refilled
// once every warp is done with it. Scores times 1/sqrt(hd), the finite mask
// -1e9, expf. With one split the block writes the output; with more, every
// split with work writes its partials to ws (maxima in natural units), and
// attn_combine merges them.
template <int HD, int WS>
__global__ void __launch_bounds__(kTcThreads, WS == 4 ? 3 : 2) attn_decode_f32tc(
    const float* __restrict__ q, const float* __restrict__ kc, const float* __restrict__ vc,
    const int* __restrict__ pos0, float* __restrict__ out, float* __restrict__ ws, int t,
    int KV, int g, int S, float scale, int sps, int n_groups, int ring) {
  constexpr int GLD = f32_gld<HD>();
  constexpr int QLD = f32_qld<HD>();
  constexpr int NG = kF32Tile / kF32Group;  // groups of a tile
  constexpr int NT = 4 / WS;                // n-tiles of a tile a warp takes
  constexpr int DT = HD / 8;                // n-tiles of the output
  constexpr int STAGE = f32_stage_bytes<HD>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int grp = blockIdx.x % n_groups;
  const int bh = blockIdx.x / n_groups;
  const int b = bh / KV, kvh = bh % KV;
  const int sp = blockIdx.y, n_split = gridDim.y;
  const int R = t * g;
  const int r0 = grp * kGroupRows;
  const int rows = min(kGroupRows, R - r0);
  const int p0 = pos0[b];
  // slots the group's last row sees, inside the cache
  const int vis = min(S, p0 + (r0 + rows - 1) / g + 1);
  const int j_begin = sp * sps;
  if (j_begin >= vis) return;
  const int j_end = min(j_begin + sps, vis);
  const int n_it = (j_end - j_begin + kF32Tile - 1) / kF32Tile;
  const int q_rows = f32_q_rows(R);
  uint32_t* qbig = reinterpret_cast<uint32_t*>(smem + ring * STAGE);  // [q_rows][QLD]
  uint32_t* qsmall = qbig + q_rows * QLD;
  uint64_t* bars = reinterpret_cast<uint64_t*>(qsmall + q_rows * QLD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp / WS, part = warp % WS;
  const bool active = mt * 16 < rows;

  const uint64_t once = l2_evict_first();
  if (tid < ring) mbar_init(bars + tid);
  mbar_init_fence();
  __syncthreads();

  // Tile `it` of the split into ring stage `st`: thread G < 8 copies K's
  // group G of 4 slots, thread 8 + G V's, each by one bulk copy (of the
  // group's visible slots). Threads 64 .. 95 zero the V rows past the
  // visible slots (their scores are masked, and p * V must stay finite); K
  // rows there keep what they held, since the mask selects -1e9 over
  // whatever score they give. Only a split's last tile is short, and no
  // later copy refills its stage.
  const size_t cbase = (size_t)bh * S * HD;
  auto load = [&](int st, int it) {
    const int j0 = j_begin + it * kF32Tile;
    const int n = min(kF32Tile, j_end - j0);
    float* stage = reinterpret_cast<float*>(smem + st * STAGE);
    if (tid == 0) mbar_expect(bars + st, 2u * n * HD * 4);
    if (tid < 2 * NG) {
      const int gi = tid % NG, cnt = min(kF32Group, n - kF32Group * gi);
      const bool is_v = tid >= NG;
      if (cnt > 0)
        bulk_copy(stage + (is_v ? NG * GLD : 0) + gi * GLD,
                  (is_v ? vc : kc) + cbase + (size_t)(j0 + kF32Group * gi) * HD, cnt * HD * 4,
                  bars + st, once);
    } else if (tid >= 64 && tid - 64 < kF32Tile && tid - 64 >= n) {
      const int r = tid - 64;
      float4* dst = reinterpret_cast<float4*>(stage + NG * GLD + (r / kF32Group) * GLD +
                                              (r % kF32Group) * HD);
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) dst[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  for (int i = 0; i < ring && i < n_it; ++i) load(i, i);

  // q's big and small planes (zeros past R), split once.
  for (int i = tid; i < q_rows * (HD / 4); i += kTcThreads) {
    const int r = i / (HD / 4), c = i % (HD / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = reinterpret_cast<const float4*>(q + q_off(b, r0 + r, t, KV, kvh, g, HD))[c];
    const Tf32Pair x = split_tf32(v.x), y = split_tf32(v.y), z = split_tf32(v.z),
                   w = split_tf32(v.w);
    reinterpret_cast<uint4*>(qbig + r * QLD)[c] = make_uint4(x.big, y.big, z.big, w.big);
    reinterpret_cast<uint4*>(qsmall + r * QLD)[c] = make_uint4(x.small, y.small, z.small, w.small);
  }
  const int row_lo = r0 + mt * 16 + gid, row_hi = row_lo + 8;
  const int qp_lo = p0 + row_lo / g, qp_hi = p0 + row_hi / g;
  // this warp's A fragment of q at k-step kk, as its tf32 parts, by one
  // ldmatrix.x4 a plane (lane l gives row l % 8, + 8 for matrices 1 and 3,
  // of matrix l / 8, dims + 4 for matrices 2 and 3)
  const int qa = (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QLD + ((lane >> 4) & 1) * 4;
  auto qfrag = [&](int kk, uint32_t(&ab)[4], uint32_t(&as)[4]) {
    ldmatrix_x4(ab, qbig + qa + kk * 8);
    ldmatrix_x4(as, qsmall + qa + kk * 8);
  };

  __syncthreads();  // q's planes, and the V rows zeroed past the visible slots, are written
  float m_lo = kMask, m_hi = kMask, l_lo = 0.f, l_hi = 0.f;
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % ring;
    mbar_wait(bars + st, (it / ring) & 1);
    // a short tile (the split's last) refilled in the loop: its V zeros too
    if (it >= ring && j_begin + (it + 1) * kF32Tile > j_end) __syncthreads();
    const float* Ks = reinterpret_cast<const float*>(smem + st * STAGE);
    const float* Vs = Ks + NG * GLD;
    const int j0 = j_begin + it * kF32Tile;
    if (active) {
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      qk_f32tc<HD, NT>(s, qfrag, Ks, part * NT, lane);
      // scale and mask (a select: an unread K row may give any score)
      float mx_lo = kMask, mx_hi = kMask;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int slot = j0 + kF32Group * (2 * tig + e) + part * NT + n;  // column 2 tig + e
          const bool in = slot < j_end;
          s[n][e] = (in && slot <= qp_lo) ? s[n][e] * scale : kMask;
          s[n][2 + e] = (in && slot <= qp_hi) ? s[n][2 + e] * scale : kMask;
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
      const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= a_lo;
      l_hi *= a_hi;
      if (__any_sync(0xffffffffu, a_lo != 1.f || a_hi != 1.f)) {  // a maximum moved
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          o[n][0] *= a_lo;
          o[n][1] *= a_lo;
          o[n][2] *= a_hi;
          o[n][3] *= a_hi;
        }
      }
      // p = exp(s - m) in place of the scores, summed in f32, not rounded
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = expf(s[n][0] - mn_lo);
        s[n][1] = expf(s[n][1] - mn_lo);
        s[n][2] = expf(s[n][2] - mn_hi);
        s[n][3] = expf(s[n][3] - mn_hi);
        l_lo += s[n][0] + s[n][1];
        l_hi += s[n][2] + s[n][3];
      }
      pv_f32tc<HD, NT>(o, s, Vs, part * NT, lane);
    }
    if (it + ring < n_it) {
      __syncthreads();  // every warp is done with stage `st`
      load(st, it + ring);
    }
  }

  if (active) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
  }
  if constexpr (WS > 1) {
    // The WS parts of each m16 tile, merged in part order by its first warp
    // through the ring (every tile has landed and been read):
    // red[warp][n][e][lane], then stats[warp][m_lo, m_hi, l_lo, l_hi][lane].
    float* red = reinterpret_cast<float*>(smem);
    float* stats = red + 4 * DT * 4 * 32;
    __syncthreads();
    if (active && part > 0) {
#pragma unroll
      for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((warp * DT + n) * 4 + e) * 32 + lane] = o[n][e];
      stats[(warp * 4 + 0) * 32 + lane] = m_lo;
      stats[(warp * 4 + 1) * 32 + lane] = m_hi;
      stats[(warp * 4 + 2) * 32 + lane] = l_lo;
      stats[(warp * 4 + 3) * 32 + lane] = l_hi;
    }
    __syncthreads();
    if (!active || part > 0) return;
#pragma unroll
    for (int pp = 1; pp < WS; ++pp) {
      const int w2 = warp + pp;
      const float m2_lo = stats[(w2 * 4 + 0) * 32 + lane], m2_hi = stats[(w2 * 4 + 1) * 32 + lane];
      const float mn_lo = fmaxf(m_lo, m2_lo), mn_hi = fmaxf(m_hi, m2_hi);
      const float a_lo = expf(m_lo - mn_lo), b_lo = expf(m2_lo - mn_lo);
      const float a_hi = expf(m_hi - mn_hi), b_hi = expf(m2_hi - mn_hi);
      l_lo = l_lo * a_lo + stats[(w2 * 4 + 2) * 32 + lane] * b_lo;
      l_hi = l_hi * a_hi + stats[(w2 * 4 + 3) * 32 + lane] * b_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const float* r2 = red + ((w2 * DT + n) * 4) * 32 + lane;
        o[n][0] = o[n][0] * a_lo + r2[0] * b_lo;
        o[n][1] = o[n][1] * a_lo + r2[32] * b_lo;
        o[n][2] = o[n][2] * a_hi + r2[64] * b_hi;
        o[n][3] = o[n][3] * a_hi + r2[96] * b_hi;
      }
    }
  }
  if (!active) return;
  const size_t n_part = (size_t)(gridDim.x / n_groups) * n_split * R;
  const size_t p_base = ((size_t)bh * n_split + sp) * R;  // + row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row_hi : row_lo;
    if (row >= R) continue;
    const float l = h ? l_hi : l_lo;
    float* dst = n_split == 1 ? out + q_off(b, row, t, KV, kvh, g, HD) : ws + (p_base + row) * HD;
    const float d = n_split == 1 ? l : 1.f;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + tig * 2) =
          make_float2(o[n][2 * h] / d, o[n][2 * h + 1] / d);
    if (n_split > 1 && tig == 0) {
      ws[n_part * HD + p_base + row] = h ? m_hi : m_lo;
      ws[n_part * (HD + 1) + p_base + row] = l;
    }
  }
}

template <int HD, int WS>
int launch_f32tc(const void* q, const void* k, const void* v, const int* pos0, void* out,
                 float* ws, int B, int t, int KV, int g, int S, float scale, int sps,
                 int n_split, cudaStream_t st) {
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(attn_decode_f32tc<HD, WS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           f32_smem_bytes<HD>(kF32Stages, kGroupRows));
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int ring = f32_ring(sps);
  const int n_groups = (t * g + kGroupRows - 1) / kGroupRows;
  dim3 grid(B * KV * n_groups, n_split);
  attn_decode_f32tc<HD, WS><<<grid, kTcThreads, f32_smem_bytes<HD>(ring, t * g), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      pos0, static_cast<float*>(out), ws, t, KV, g, S, scale, sps, n_groups, ring);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  return launch_combine<float>(ws, pos0, out, B, t, KV, g, HD, sps, n_split, st);
}

template <int HD>
int launch_f32tc_hd(const void* q, const void* k, const void* v, const int* pos0, void* out,
                    float* ws, int B, int t, int KV, int g, int S, float scale, int sps,
                    int n_split, cudaStream_t st) {
  switch (tc_slot_parts(t * g)) {
    case 4:
      return launch_f32tc<HD, 4>(q, k, v, pos0, out, ws, B, t, KV, g, S, scale, sps, n_split, st);
    case 2:
      return launch_f32tc<HD, 2>(q, k, v, pos0, out, ws, B, t, KV, g, S, scale, sps, n_split, st);
    default:
      return launch_f32tc<HD, 1>(q, k, v, pos0, out, ws, B, t, KV, g, S, scale, sps, n_split, st);
  }
}

// The forms, as ops/attention.py's K2_FORMS numbers them.
enum Form { kDecodeTc = 0, kDecodeF32Tc = 1 };

}  // namespace

// forms kDecodeTc (bf16 q, cache and out) and kDecodeF32Tc (f32): the plan
// of ops/attention.py decode_attn_plan for the dtype, slots_per_split a
// multiple of 64 and n_split ceil(S / slots_per_split). ws holds [B*KV,
// n_split, t*g] rows of hd + 2 f32 values (see launch_combine), and is not
// read with one split. Returns cudaErrorInvalidValue for arguments the form
// does not take, else cudaGetLastError() after the launches.
extern "C" int llamago_attn_decode(const void* q, const void* k, const void* v,
                                   const void* pos0, void* out, void* ws, int B, int t,
                                   int KV, int g, int hd, int S, float scale, int form,
                                   int slots_per_split, int n_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos0);
  float* w = static_cast<float*>(ws);
  if (B < 1 || t < 1 || KV < 1 || g < 1 || S < 1 || slots_per_split < 1 ||
      n_split != (S + slots_per_split - 1) / slots_per_split)
    return (int)cudaErrorInvalidValue;
  if ((form != kDecodeTc && form != kDecodeF32Tc) || slots_per_split % kTile ||
      (n_split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (form == kDecodeF32Tc) {
    if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
    return hd == 128 ? launch_f32tc_hd<128>(q, k, v, p, out, w, B, t, KV, g, S, scale,
                                            slots_per_split, n_split, st)
                     : launch_f32tc_hd<64>(q, k, v, p, out, w, B, t, KV, g, S, scale,
                                           slots_per_split, n_split, st);
  }
  if (hd == 128)
    return launch_tc_hd<128>(q, k, v, p, out, w, B, t, KV, g, S, scale, slots_per_split,
                             n_split, st);
  if (hd == 64)
    return launch_tc_hd<64>(q, k, v, p, out, w, B, t, KV, g, S, scale, slots_per_split,
                            n_split, st);
  return (int)cudaErrorInvalidValue;
}
