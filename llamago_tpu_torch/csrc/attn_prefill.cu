// K7: causal flash attention of a prefill window over a dense KV cache, for
// Hopper (sm_90a).
//
// q: [B, t, KV, g, hd] (roped; any t >= 1, g <= 8, hd in {64, 128}),
// k/v cache: [B, KV, S, hd], pos0: int32 [B] (absolute position of query
// row t=0), out: same shape as q. All of q, k, v and out share one dtype,
// bf16 or f32. Rows are laid out t-major then g; row r sees cache slot j
// iff j <= pos0 + r / g. Scores are f32 dot products times 1/sqrt(hd),
// masked scores are -inf, the softmax is in f32, the probabilities are
// rounded to the V dtype before the PV product (not at all for f32), which
// accumulates in f32. A row that sees no slot gives NaN (0 / 0), as the TPU
// kernel does.
//
// Replaces llamago_tpu/ops/attention.py _attn_kernel, reached through
// _flash_attention and flash_attention.
//
// What bounds it: per (batch, kv head) the kernel must read the visible
// prefix of K and V once, 2 * (pos0 + t) * hd elements, and does
// 4 * g * hd * (t * pos0 + t * (t + 1) / 2) operations on it: at t = 256
// over a few hundred slots that is some 200 operations per cache byte, near
// the card's bf16 balance point, and both bounds are a few microseconds per
// layer at 7B. The launch and the tile loop's latency show first. In f32
// the bytes double and the operations run at a third of the TF32 rate
// (three products each, below): a window of 256 rows at 512 needs 16 us of
// tensor-core time at 7B against a byte bound of 10.
//
// What the design does about it: the TPU kernel holds the whole S plane of
// a head in VMEM and takes one softmax over it. Here a block owns one
// (batch, kv head, tile of 64 query rows; the g rows of a GQA group are
// folded into the rows as K2 does) and streams K and V through shared memory
// in tiles of 64 slots with an online softmax, so the scores never reach
// device memory and shared memory does not grow with S. A block reads only
// the slots its rows can see (masked columns contribute exactly 0): cache
// traffic follows pos0 + t, not S, and the tiles above the diagonal are
// never read. Two forms (ops/attention.py k7_form; the entry point takes the
// code):
//  * bf16: attn_prefill_tc, then attn_prefill_merge when the plan splits
//    the slots into chunks.
//    - Both products on the tensor cores: bf16 mma.sync.m16n8k16 with f32
//      accumulation, four warps of one m16 tile of rows each (two blocks an
//      SM; two m16 tiles a warp spilled at 255 registers and ran slower);
//      q stays in registers as A
//      fragments, K's B fragments are ldmatrix of its tile, V's
//      ldmatrix.trans, and the scores are repacked in registers as the A
//      fragments of P V. Scores carry log2(e) / sqrt(hd), so the softmax
//      takes exp2; only the tile that crosses a warp's diagonal (or the end
//      of its slots) is masked.
//    - A ring of three stages of K and V tiles filled by the TMA unit: one
//      bulk copy per 8 neighbouring slots of K or V (2 KB at hd = 128; with
//      one copy a row the copies took as long as the mma), completing on the
//      stage's mbarrier. The groups are padded by 16 bytes and a fragment
//      takes one slot of each group, so that its rows fall on distinct
//      banks; the slots are permuted within a tile alike for K, the
//      scores, P and V (only the order of the f32 sums sees it). All
//      stages are filled at the start, and a stage is refilled as soon as
//      every warp is done with it (one block barrier a refill; the
//      mbarrier alone says a tile has landed), so the next tiles' copies run
//      under this tile's mma. V rows past the visible slots are zeroed, so
//      p * V stays finite.
//    - Enough blocks to fill the card (both forms): where the q-tiles of a call give
//      fewer than 96 blocks, the plan (ops/attention.py
//      prefill_plan, a function of the shapes only, never of pos0) cuts the
//      slots into chunks of equal length, a multiple of 64, and the grid
//      takes one block per (q-tile, chunk). That also balances the causal
//      triangle: no block reads more than a chunk, however far down the
//      diagonal its rows are. A chunk past its q-tile's visible end returns
//      at once; the others write f32 partials (unnormalized P V, the row's
//      maximum and sum) to a workspace, and attn_prefill_merge, a second
//      launch, merges each row's chunks in order, up to the last it sees
//      (a call run twice gives the same bits; no arrival counters). With
//      one chunk the block writes the output itself.
//  * f32: attn_prefill_f32tc, then attn_prefill_merge<HD, float> when the
//    plan chunks the slots: the bf16 form's plan, blocks of 64 rows, four
//    warps of one m16 tile each, the chunks and the merge.
//    - Both products on the tensor cores as three TF32 products (3xTF32,
//      tc_common.cuh): mma.sync.m16n8k8 on tf32 with f32 accumulation, each
//      f32 operand split as big + small tf32 values and a b taken as big
//      big + big small + small big, about 2^-21 of a product off (the bf16
//      tensor cores would need six products of three-part operands).
//      wgmma takes tf32 only with K-major B operands and V is MN-major in
//      P V, so the form stays on mma.sync. q lies in shared memory and is
//      split at each k-step, K and V as a fragment is read, P once a
//      k-step from the score registers, repacked in place by permuting the
//      reduction index (c_to_a): the probabilities are not rounded.
//    - A ring of two stages of 32-slot K and V tiles by the TMA unit, one
//      bulk copy per group of 4 slots (2 KB at hd = 128), groups padded by
//      16 bytes and a fragment's rows one slot of each group, so that the K
//      and the permuted V reads fall on 32 distinct banks; 64-slot tiles of
//      f32 would leave one block an SM. V rows past the visible slots are
//      zeroed; masked scores are selected, never added.
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

constexpr int kBN = 64;  // cache slots per tile

// ------------------------------------------------------ bf16, tensor cores

constexpr int kTcThreads = 128;  // four warps
constexpr int kTcRows = 64;      // query rows per block: one m16 tile a warp
constexpr int kStages = 3;       // ring stages of K and V tiles
constexpr int kGroup = 8;        // slots of a tile that one bulk copy brings
constexpr int kPadB = 8;         // bf16 elements of padding after each group (16 bytes)
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (2^-inf = 0): relative error about 2^-22, far inside the
// bf16 rounding of p that follows.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A tile's slots lie in shared memory as 8 groups of 8 neighbouring slots,
// each group one bulk copy of 8 rows, groups tc_gld bf16 elements apart (16
// bytes of padding). A fragment's 8 rows are one slot of each group (the
// slot of position q of a tile's scores, P and V rows is 8 (q & 7) + (q >>
// 3)), so that they fall on distinct banks.
template <int HD> __host__ __device__ constexpr int tc_gld() { return kGroup * HD + kPadB; }
// One stage: the K tile, then the V tile, each 8 groups of tc_gld bf16.
template <int HD> __host__ __device__ constexpr int tc_stage_bytes() {
  return 2 * (kBN / kGroup) * tc_gld<HD>() * 2;
}
// Dynamic shared memory of a block: the ring and its mbarriers.
template <int HD> __host__ __device__ constexpr int tc_smem_bytes() {
  return kStages * (tc_stage_bytes<HD>() + 8);
}
static_assert(tc_stage_bytes<64>() % 16 == 0 && tc_stage_bytes<128>() % 16 == 0,
              "stages and barriers stay aligned");
static_assert(2 * (tc_smem_bytes<128>() + 1024) <= 233472,
              "two blocks an SM fit its shared memory");

// Offset of query row r of batch b, kv head kvh in q and out.
__device__ __forceinline__ size_t q_off(int b, int r, int t, int KV, int kvh, int g, int hd) {
  return ((((size_t)b * t + r / g) * KV + kvh) * g + r % g) * hd;
}

// grid (B*KV * n_qt, n_chunks), 128 threads, dynamic shared memory
// tc_smem_bytes. Block x is (batch, kv head) x / n_qt and q-tile x % n_qt
// (rows 64 * q-tile ..), block y the chunk of slots [y * cps, (y + 1) *
// cps). Warp w takes rows 16 w .. 16 w + 15 of the q-tile. scale2 is
// log2(e) / sqrt(hd). With one chunk the block writes the output; with
// more, every chunk with work writes its partials to ws (rows [B*KV,
// n_chunks, t*g] of hd values, then the maxima and the sums of the rows,
// the maxima in log2 units), and attn_prefill_merge merges them.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2) attn_prefill_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ pos0,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int t, int KV, int g, int S,
    float scale2, int cps, int n_qt) {
  constexpr int GLD = tc_gld<HD>();
  constexpr int KK = HD / 16;  // k-steps of Q K^T
  constexpr int DT = HD / 8;   // n-tiles of the output
  constexpr int NT = kBN / 8;  // n-tiles of the scores
  constexpr int STAGE = tc_stage_bytes<HD>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / KV, kvh = bh % KV;
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int R = t * g;
  const int r0 = qt * kTcRows;
  const int rows = min(kTcRows, R - r0);
  const int p0 = pos0[b];
  // slots the q-tile's last row sees, inside the cache
  const int vis = min(S, max(0, p0 + (r0 + rows - 1) / g + 1));
  const int j_begin = chunk * cps;
  // a chunk past the visible end has no work (its rows' merge gives it no
  // weight); with one chunk the block runs on, so that a q-tile that sees
  // nothing writes its NaN
  if (j_begin >= vis && n_chunks > 1) return;
  const int j_end = max(j_begin, min(j_begin + cps, vis));
  const int n_it = (j_end - j_begin + kBN - 1) / kBN;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool active = warp * 16 < rows;

  if (tid < kStages) mbar_init(bars + tid);
  mbar_init_fence();
  __syncthreads();

  // Tile `it` of the chunk into ring stage `st`: thread G < 8 copies K's
  // group G of 8 slots, thread 8 + G V's, each by one bulk copy (of the
  // group's visible slots). V rows past the visible slots are zeroed
  // instead, by threads 64 .. 127 (their p is 0, and p * V must stay
  // finite); K rows there keep what they held, since the mask selects -inf
  // over whatever score they give. Only a chunk's last tile is short, and
  // no later copy refills its stage.
  const size_t cbase = (size_t)bh * S * HD;
  auto load = [&](int st, int it) {
    const int j0 = j_begin + it * kBN;
    const int n = min(kBN, j_end - j0);
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem + st * STAGE);
    if (tid == 0) mbar_expect(bars + st, 2u * n * HD * 2);
    if (tid < 2 * kGroup) {
      const int grp = tid & (kGroup - 1), rows = min(kGroup, n - kGroup * grp);
      const bool is_v = tid >= kGroup;
      if (rows > 0)
        bulk_copy(stage + (is_v ? kGroup * GLD : 0) + grp * GLD,
                  (is_v ? vc : kc) + cbase + (size_t)(j0 + kGroup * grp) * HD, rows * HD * 2,
                  bars + st);
    } else if (tid >= kBN && tid - kBN >= n) {
      const int r = tid - kBN;
      uint4* dst = reinterpret_cast<uint4*>(stage + kGroup * GLD + (r >> 3) * GLD + (r & 7) * HD);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) dst[c] = make_uint4(0, 0, 0, 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i)
    if (i < n_it) load(i, i);

  // This warp's q rows (gid and gid + 8 of its m16 tile; zeros past R) as A
  // fragments, and their query positions.
  const int row_lo = r0 + warp * 16 + gid, row_hi = row_lo + 8;
  const int qp_lo = p0 + row_lo / g, qp_hi = p0 + row_hi / g;
  const int qp_first = p0 + (r0 + warp * 16) / g;  // the warp's first row sees the fewest
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

  __syncthreads();  // the V rows zeroed past the visible slots are written
  // The running maximum (log2 units) and sum of rows gid and gid + 8, and
  // their unnormalized P V.
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    mbar_wait(bars + st, (it / kStages) & 1);
    // a short tile (the chunk's last) refilled in the loop: its V zeros too
    if (it >= kStages && j_begin + (it + 1) * kBN > j_end) __syncthreads();
    const __nv_bfloat16* Ks = reinterpret_cast<const __nv_bfloat16*>(smem + st * STAGE);
    const __nv_bfloat16* Vs = Ks + kGroup * GLD;
    const int j0 = j_begin + it * kBN;
    if (active) {
      // scores of 16 rows x 64 slots
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      // K's B fragments of two n-tiles (score positions 8n .. 8n+15) at a
      // k-step by one ldmatrix: lanes 8i .. 8i+7 give the rows of slots 8j
      // + n + (i >> 1), j = 0 .. 7, at columns kk*16 + 8 (i & 1)
      const __nv_bfloat16* krow =
          Ks + (lane & 7) * GLD + (lane >> 4) * HD + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, krow + n * HD + kk * 16);
          mma_bf16(s[n], qf[kk], kb[0], kb[1]);
          mma_bf16(s[n + 1], qf[kk], kb[2], kb[3]);
        }
      }

      // scale; mask (a select: an unread K row may give any score) only the
      // tile that crosses the warp's diagonal or the end of its slots; the
      // running maximum
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
      if (j0 + kBN <= j_end && j0 + kBN - 1 <= qp_first) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
          mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
          mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int slot = j0 + 16 * tig + 8 * e + n;  // of position 8n + 2 tig + e
            const bool in = slot < j_end;
            s[n][e] = (in && slot <= qp_lo) ? s[n][e] * scale2 : -INFINITY;
            s[n][2 + e] = (in && slot <= qp_hi) ? s[n][2 + e] * scale2 : -INFINITY;
            mx_lo = fmaxf(mx_lo, s[n][e]);
            mx_hi = fmaxf(mx_hi, s[n][2 + e]);
          }
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {  // the four lanes that share a row
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      // a row that has seen nothing yet keeps m = -inf: exponentials are
      // taken against 0 there, so that -inf - -inf never forms
      const float ms_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float ms_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float a_lo = exp2_approx(m_lo - ms_lo), a_hi = exp2_approx(m_hi - ms_hi);
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

      // p = 2^(s - m), summed in f32 and rounded to bf16 for P V
      uint32_t pf[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0_ = exp2_approx(s[n][0] - ms_lo), p1_ = exp2_approx(s[n][1] - ms_lo);
        const float p2_ = exp2_approx(s[n][2] - ms_hi), p3_ = exp2_approx(s[n][3] - ms_hi);
        l_lo += p0_ + p1_;
        l_hi += p2_ + p3_;
        pf[n / 2][(n & 1) * 2] = pack_bf16(p0_, p1_);
        pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2_, p3_);
      }

      // O += P V: per 16 slots, ldmatrix.trans brings the B fragments of
      // two output n-tiles (16 columns of V) at once
#pragma unroll
      for (int ks = 0; ks < kBN / 16; ++ks) {
        const int mat = lane >> 3, mr = lane & 7;
        const __nv_bfloat16* vrow = Vs + mr * GLD + (2 * ks + (mat & 1)) * HD + (mat >> 1) * 8;
#pragma unroll
        for (int n = 0; n < DT; n += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + n * 8);
          mma_bf16(o[n], pf[ks], vb[0], vb[1]);
          mma_bf16(o[n + 1], pf[ks], vb[2], vb[3]);
        }
      }
    }
    if (it + kStages < n_it) {
      __syncthreads();  // every warp is done with stage `st`
      load(st, it + kStages);
    }
  }
  if (!active) return;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const size_t n_part = (size_t)(gridDim.x / n_qt) * n_chunks * R;
  const size_t p_base = ((size_t)bh * n_chunks + chunk) * R;  // + row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row_hi : row_lo;
    if (row >= R) continue;
    const float l = h ? l_hi : l_lo;
    if (n_chunks == 1) {  // a row that sees nothing: 0 / 0
      __nv_bfloat16* orow = out + q_off(b, row, t, KV, kvh, g, HD) + tig * 2;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(o[n][2 * h] / l, o[n][2 * h + 1] / l);
    } else {
      float* wrow = ws + (p_base + row) * HD + tig * 2;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(wrow + n * 8) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (tig == 0) {
        ws[n_part * HD + p_base + row] = h ? m_hi : m_lo;
        ws[n_part * (HD + 1) + p_base + row] = l;
      }
    }
  }
}

// The merge of attn_prefill_tc's chunks of cps slots: row r, at position
// qp = pos0 + r / g, takes chunks 0 .. qp / cps in order (every one of them
// ran, and the row sees slots in each), each weighed by 2^(m_c - max) with
// the running maximum; a row that sees nothing (qp < 0) gives NaN, as the
// kernel of one chunk does. Grid (B*KV, ceil(t*g / 8)), 256 threads: a warp
// a row, a lane HD / 32 neighbouring columns, so that a row's maxima and
// sums are one load a chunk for the warp and its partials one coalesced
// read.
template <int HD, typename T>
__global__ void __launch_bounds__(256) attn_prefill_merge(
    const float* __restrict__ ws, const int* __restrict__ pos0, T* __restrict__ out, int t,
    int KV, int g, int cps, int n_chunks) {
  constexpr int C = HD / 32;  // columns a lane
  const int bh = blockIdx.x;
  const int b = bh / KV, kvh = bh % KV;
  const int R = t * g;
  const int r = blockIdx.y * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= R) return;
  const size_t n_part = (size_t)gridDim.x * n_chunks * R;
  const float* pm = ws + n_part * HD;
  const float* pl = pm + n_part;
  const int qp = pos0[b] + r / g;
  float v[C];
  if (qp < 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = __int_as_float(0x7fc00000);  // NaN
  } else {
    const int last = min(qp / cps, n_chunks - 1);
    float mx = -INFINITY, den = 0.f, num[C];
#pragma unroll
    for (int j = 0; j < C; ++j) num[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c <= last; ++c) {
      const size_t pi = ((size_t)bh * n_chunks + c) * R + r;
      const float m = pm[pi], l = pl[pi];
      float p[C];
      if constexpr (C == 4) {
        const float4 f = *reinterpret_cast<const float4*>(ws + pi * HD + 4 * lane);
        p[0] = f.x, p[1] = f.y, p[2] = f.z, p[3] = f.w;
      } else {
        const float2 f = *reinterpret_cast<const float2*>(ws + pi * HD + 2 * lane);
        p[0] = f.x, p[1] = f.y;
      }
      const float mn = fmaxf(mx, m);  // finite: the row sees slots in chunk c
      const float a = exp2_approx(mx - mn), w = exp2_approx(m - mn);
      mx = mn;
      den = fmaf(den, a, w * l);
#pragma unroll
      for (int j = 0; j < C; ++j) num[j] = fmaf(num[j], a, w * p[j]);
    }
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = num[j] / den;
  }
  T* orow = out + q_off(b, r, t, KV, kvh, g, HD) + C * lane;
  if constexpr (sizeof(T) == 4 && C == 4) {
    *reinterpret_cast<float4*>(orow) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(orow) = make_float2(v[0], v[1]);
  } else if constexpr (C == 4) {
    *reinterpret_cast<uint2*>(orow) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
    *reinterpret_cast<uint32_t*>(orow) = pack_bf16(v[0], v[1]);
  }
}

// ------------------------------------------------ f32, tensor cores (3xTF32)

constexpr int kF32Stages = 2;  // ring stages of 32-slot K and V tiles
// One stage: the K tile, then the V tile, each 8 groups of f32_gld floats.
template <int HD> __host__ __device__ constexpr int f32_stage_bytes() {
  return 2 * (kF32Tile / kF32Group) * f32_gld<HD>() * 4;
}
// Dynamic shared memory of a block: the ring, the q-tile's rows, the
// ring's mbarriers.
template <int HD> __host__ __device__ constexpr int f32_smem_bytes() {
  return kF32Stages * f32_stage_bytes<HD>() + kTcRows * f32_qld<HD>() * 4 + kF32Stages * 8;
}
static_assert(f32_stage_bytes<64>() % 16 == 0 && f32_stage_bytes<128>() % 16 == 0 &&
                  (f32_qld<64>() * 4) % 16 == 0 && (f32_qld<128>() * 4) % 16 == 0,
              "stages, q rows and barriers stay aligned");
static_assert(2 * (f32_smem_bytes<128>() + 1024) <= 233472,
              "two blocks an SM fit its shared memory");

// attn_prefill_tc's plan and ring on f32 q, cache and out: grid (B*KV *
// n_qt, n_chunks), 128 threads, dynamic shared memory f32_smem_bytes; warp w
// takes rows 16 w .. 16 w + 15 of the 64-row q-tile, all slots and all
// columns. Both products in 3xTF32 (qk_f32tc, pv_f32tc): q from shared
// memory, split at each k-step; P stays in the score registers. Partials
// (maxima in log2 units) as attn_prefill_tc's, merged by
// attn_prefill_merge<HD, float>.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2) attn_prefill_f32tc(
    const float* __restrict__ q, const float* __restrict__ kc, const float* __restrict__ vc,
    const int* __restrict__ pos0, float* __restrict__ out, float* __restrict__ ws, int t,
    int KV, int g, int S, float scale2, int cps, int n_qt) {
  constexpr int GLD = f32_gld<HD>();
  constexpr int QLD = f32_qld<HD>();
  constexpr int NG = kF32Tile / kF32Group;  // groups of a tile
  constexpr int DT = HD / 8;                // n-tiles of the output
  constexpr int STAGE = f32_stage_bytes<HD>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / KV, kvh = bh % KV;
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int R = t * g;
  const int r0 = qt * kTcRows;
  const int rows = min(kTcRows, R - r0);
  const int p0 = pos0[b];
  const int vis = min(S, max(0, p0 + (r0 + rows - 1) / g + 1));
  const int j_begin = chunk * cps;
  // as attn_prefill_tc: with one chunk a q-tile that sees nothing writes NaN
  if (j_begin >= vis && n_chunks > 1) return;
  const int j_end = max(j_begin, min(j_begin + cps, vis));
  const int n_it = (j_end - j_begin + kF32Tile - 1) / kF32Tile;
  float* qs = reinterpret_cast<float*>(smem + kF32Stages * STAGE);  // [64][QLD]
  uint64_t* bars = reinterpret_cast<uint64_t*>(qs + kTcRows * QLD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool active = warp * 16 < rows;

  if (tid < kF32Stages) mbar_init(bars + tid);
  mbar_init_fence();
  __syncthreads();

  // Tile `it` of the chunk into ring stage `st`: thread G < 8 copies K's
  // group G of 4 slots, thread 8 + G V's, each by one bulk copy (of the
  // group's visible slots). Threads 64 .. 95 zero the V rows past the
  // visible slots (p * V must stay finite); K rows there keep what they
  // held, since the mask selects -inf over whatever score they give. Only a
  // chunk's last tile is short, and no later copy refills its stage.
  const size_t cbase = (size_t)bh * S * HD;
  auto load = [&](int st, int it) {
    const int j0 = j_begin + it * kF32Tile;
    const int n = min(kF32Tile, j_end - j0);
    float* stage = reinterpret_cast<float*>(smem + st * STAGE);
    if (tid == 0) mbar_expect(bars + st, 2u * n * HD * 4);
    if (tid < 2 * NG) {
      const int grp = tid % NG, cnt = min(kF32Group, n - kF32Group * grp);
      const bool is_v = tid >= NG;
      if (cnt > 0)
        bulk_copy(stage + (is_v ? NG * GLD : 0) + grp * GLD,
                  (is_v ? vc : kc) + cbase + (size_t)(j0 + kF32Group * grp) * HD, cnt * HD * 4,
                  bars + st);
    } else if (tid >= 64 && tid - 64 < kF32Tile && tid - 64 >= n) {
      const int r = tid - 64;
      float4* dst = reinterpret_cast<float4*>(stage + NG * GLD + (r / kF32Group) * GLD +
                                              (r % kF32Group) * HD);
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) dst[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
#pragma unroll
  for (int i = 0; i < kF32Stages; ++i)
    if (i < n_it) load(i, i);

  // The q-tile's rows into shared memory (zeros past R), 16 bytes a load.
  for (int i = tid; i < kTcRows * (HD / 4); i += kTcThreads) {
    const int r = i / (HD / 4), c = i % (HD / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < R) v = reinterpret_cast<const float4*>(q + q_off(b, r0 + r, t, KV, kvh, g, HD))[c];
    reinterpret_cast<float4*>(qs + r * QLD)[c] = v;
  }
  const int row_lo = r0 + warp * 16 + gid, row_hi = row_lo + 8;
  const int qp_lo = p0 + row_lo / g, qp_hi = p0 + row_hi / g;
  const int qp_first = p0 + (r0 + warp * 16) / g;  // the warp's first row sees the fewest
  // this warp's A fragment of q at k-step kk, split
  // this warp's A fragment of q at k-step kk, split: ldmatrix.x4 moves the
  // words of rows gid | gid + 8, dims tig | tig + 4 (lane l gives row l % 8
  // (+ 8 for matrices 1 and 3) of matrix l / 8, dims + 4 for matrices 2, 3)
  const float* qa = qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QLD +
                    ((lane >> 4) & 1) * 4;
  auto qfrag = [&](int kk, uint32_t(&ab)[4], uint32_t(&as)[4]) {
    uint32_t r[4];
    ldmatrix_x4(r, qa + kk * 8);
    const float a[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                        __uint_as_float(r[3])};
    split_a(a, ab, as);
  };

  __syncthreads();  // q, and the V rows zeroed past the visible slots, are written
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kF32Stages;
    mbar_wait(bars + st, (it / kF32Stages) & 1);
    // a short tile (the chunk's last) refilled in the loop: its V zeros too
    if (it >= kF32Stages && j_begin + (it + 1) * kF32Tile > j_end) __syncthreads();
    const float* Ks = reinterpret_cast<const float*>(smem + st * STAGE);
    const float* Vs = Ks + NG * GLD;
    const int j0 = j_begin + it * kF32Tile;
    if (active) {
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      qk_f32tc<HD, 4>(s, qfrag, Ks, 0, lane);

      // scale; mask (a select) only the tile that crosses the warp's
      // diagonal or the end of its slots; the running maximum
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
      if (j0 + kF32Tile <= j_end && j0 + kF32Tile - 1 <= qp_first) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
          mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
          mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
        }
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int slot = j0 + kF32Group * (2 * tig + e) + n;  // column 2 tig + e
            const bool in = slot < j_end;
            s[n][e] = (in && slot <= qp_lo) ? s[n][e] * scale2 : -INFINITY;
            s[n][2 + e] = (in && slot <= qp_hi) ? s[n][2 + e] * scale2 : -INFINITY;
            mx_lo = fmaxf(mx_lo, s[n][e]);
            mx_hi = fmaxf(mx_hi, s[n][2 + e]);
          }
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {  // the four lanes that share a row
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      // a row that has seen nothing yet keeps m = -inf: exponentials are
      // taken against 0 there, so that -inf - -inf never forms
      const float ms_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float ms_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float a_lo = exp2_approx(m_lo - ms_lo), a_hi = exp2_approx(m_hi - ms_hi);
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

      // p = 2^(s - m) in place of the scores, summed in f32, not rounded
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        s[n][0] = exp2_approx(s[n][0] - ms_lo);
        s[n][1] = exp2_approx(s[n][1] - ms_lo);
        s[n][2] = exp2_approx(s[n][2] - ms_hi);
        s[n][3] = exp2_approx(s[n][3] - ms_hi);
        l_lo += s[n][0] + s[n][1];
        l_hi += s[n][2] + s[n][3];
      }
      pv_f32tc<HD, 4>(o, s, Vs, 0, lane);
    }
    if (it + kF32Stages < n_it) {
      __syncthreads();  // every warp is done with stage `st`
      load(st, it + kF32Stages);
    }
  }
  if (!active) return;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const size_t n_part = (size_t)(gridDim.x / n_qt) * n_chunks * R;
  const size_t p_base = ((size_t)bh * n_chunks + chunk) * R;  // + row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row_hi : row_lo;
    if (row >= R) continue;
    const float l = h ? l_hi : l_lo;
    float* dst = n_chunks == 1 ? out + q_off(b, row, t, KV, kvh, g, HD)
                               : ws + (p_base + row) * HD;
    const float d = n_chunks == 1 ? l : 1.f;  // a row that sees nothing: 0 / 0
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + tig * 2) =
          make_float2(o[n][2 * h] / d, o[n][2 * h + 1] / d);
    if (n_chunks > 1 && tig == 0) {
      ws[n_part * HD + p_base + row] = h ? m_hi : m_lo;
      ws[n_part * (HD + 1) + p_base + row] = l;
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const int* pos0, void* out,
              float* ws, int B, int t, int KV, int g, int S, float scale, int cps,
              int n_chunks, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes<HD>();
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const int opt_in = set_smem(attn_prefill_tc<HD>, smem);
  if (opt_in != 0) return opt_in;
  const int n_qt = (t * g + kTcRows - 1) / kTcRows;
  const dim3 grid(B * KV * n_qt, n_chunks);
  attn_prefill_tc<HD><<<grid, kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos0, static_cast<__nv_bfloat16*>(out), ws, t, KV,
      g, S, scale * kLog2e, cps, n_qt);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  const dim3 mgrid(B * KV, (t * g + 7) / 8);
  attn_prefill_merge<HD, __nv_bfloat16><<<mgrid, 256, 0, st>>>(
      ws, pos0, static_cast<__nv_bfloat16*>(out), t, KV, g, cps, n_chunks);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32tc(const void* q, const void* k, const void* v, const int* pos0, void* out,
                 float* ws, int B, int t, int KV, int g, int S, float scale, int cps,
                 int n_chunks, cudaStream_t st) {
  constexpr int smem = f32_smem_bytes<HD>();
  static const int opt_in = set_smem(attn_prefill_f32tc<HD>, smem);
  if (opt_in != 0) return opt_in;
  const int n_qt = (t * g + kTcRows - 1) / kTcRows;
  const dim3 grid(B * KV * n_qt, n_chunks);
  attn_prefill_f32tc<HD><<<grid, kTcThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      pos0, static_cast<float*>(out), ws, t, KV, g, S, scale * kLog2e, cps, n_qt);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  const dim3 mgrid(B * KV, (t * g + 7) / 8);
  attn_prefill_merge<HD, float><<<mgrid, 256, 0, st>>>(ws, pos0, static_cast<float*>(out), t, KV,
                                                       g, cps, n_chunks);
  return (int)cudaGetLastError();
}

// The forms, as ops/attention.py's K7_FORMS numbers them.
enum Form { kPrefillTc = 0, kPrefillF32Tc = 1 };

}  // namespace

// forms kPrefillTc (bf16 q, cache and out) and kPrefillF32Tc (f32): the
// plan of ops/attention.py prefill_plan, slots_per_chunk a multiple of 64
// and n_chunks ceil(S / slots_per_chunk); ws holds [B*KV, n_chunks, t*g]
// rows of hd + 2 f32 values (partials, then maxima and sums) and is not
// read with one chunk. hd must be 64 or 128. Returns cudaErrorInvalidValue
// for arguments the form does not take, else cudaGetLastError() after the
// launches.
extern "C" int llamago_attn_prefill(const void* q, const void* k, const void* v,
                                    const void* pos0, void* out, void* ws, int B, int t, int KV,
                                    int g, int hd, int S, float scale, int form,
                                    int slots_per_chunk, int n_chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos0);
  float* w = static_cast<float*>(ws);
  if (B < 1 || t < 1 || KV < 1 || g < 1 || S < 1 || (hd != 64 && hd != 128) ||
      slots_per_chunk < 1 || n_chunks != (S + slots_per_chunk - 1) / slots_per_chunk)
    return (int)cudaErrorInvalidValue;
  if ((form != kPrefillTc && form != kPrefillF32Tc) || slots_per_chunk % kBN ||
      (n_chunks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (form == kPrefillF32Tc)
    return hd == 128
               ? launch_f32tc<128>(q, k, v, p, out, w, B, t, KV, g, S, scale, slots_per_chunk,
                                   n_chunks, st)
               : launch_f32tc<64>(q, k, v, p, out, w, B, t, KV, g, S, scale, slots_per_chunk,
                                  n_chunks, st);
  return hd == 128
             ? launch_tc<128>(q, k, v, p, out, w, B, t, KV, g, S, scale, slots_per_chunk,
                              n_chunks, st)
             : launch_tc<64>(q, k, v, p, out, w, B, t, KV, g, S, scale, slots_per_chunk,
                             n_chunks, st);
}
