// The tensor-core decode form of a Q8_0 / Q4_0 matmul over at most 8 rows
// of x, shared by K1 (dq_decode_tc and dq_decode_f32tc, dequant_matmul.cu)
// and K9 (so_decode_tc and so_decode_f32tc, dequant_matmul_so.cu): per
// 32-row quant block b the block sum x_b . w_b on bf16 mma.sync.m16n8k16,
// times s_b, into the f32 output sum. The two differ in Q4_0 only (RAW):
// K1's weights are the nibbles - 8; K9's are the raw nibbles 0..15, and 8 *
// sum(x_b) comes off the block sum before the scale, as the TPU's
// scale-on-output kernel computes it. Q8_0 is the same function in both.
//
// x is bf16 (out bf16) or f32 (out f32, the --dtype float32 route's decode
// steps). f32 x arrives whole by the same bulk copies (128 bytes a slot row
// and quant block) and each lane cuts the 8 values of its B fragment into
// three exact bf16 parts, x = hi + mid + lo (tc_common.cuh split3), in
// registers: every part times an integer weight is exact in f32, and each
// A fragment, decoded once, feeds three mma (lo, mid, hi) into the same
// zeroed block sum. No pre-pass and no planes in memory: a call is one
// launch, plus the reduce where K is split, as with bf16 x.
//
// The weights are the A operand (16 output columns by 16 rows of K) and x
// is B (16 rows of K by 8 columns: the M <= 8 slots, zeros past M), so the
// work per weight is the same from M = 1 to 8: about 2.5 integer and f32
// instructions build each exact bf16 pair (int8 by the f32 0x4B0000uu, a
// Q4_0 nibble by the bf16 0x43nn), and a lane needs only the scales of its
// own 16 columns (C rows are output columns). The weight rows arrive by
// bulk copies of the TMA unit, one 512-byte row of the block's columns
// each, with the L2 policy evict_first (read once, so x, the scales and
// the partials stay). A block is four warps on 512 neighbouring columns
// (128 a warp) and a ring of three quant blocks (59 KB for Q8_0 with f32
// scales: three blocks an SM), one mbarrier and one block barrier per quant
// block. K is split (ops/kernels.py, decode_tc_split_for) as far as one
// wave of blocks holds; the caller adds the splits' f32 partials in a
// fixed order (no atomics).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kDtWarps = 4;                      // warps per block
constexpr int kDtThreads = 32 * kDtWarps;
constexpr int kDtCols = 128;                     // columns per warp: 8 lane groups x 16
constexpr int kDtBlockCols = kDtWarps * kDtCols;  // 512: one bulk copy per weight row
constexpr int kDtStages = 3;                     // quant blocks in the ring
// Row strides in a stage: weight rows 528 bytes apart and x rows 80 apart,
// so that the lanes' reads (rows 2*tig + {0, 1}, 16 bytes at 16*gid; x
// words at 4*tig) fall on distinct banks.
constexpr int kDtRowLd = kDtBlockCols + 16, kDtXLd = 80;
// f32 x rows 160 bytes (40 floats) apart: a lane's 8-byte reads at k =
// 2*tig + {0, 1} + 8j fall on distinct banks in each half-warp.
constexpr int kDtXLdF32 = 160;
template <typename XT> __host__ __device__ constexpr int dt_x_ld() {
  return sizeof(XT) == 4 ? kDtXLdF32 : kDtXLd;
}

// Weight rows of one quant block: 32 int8 rows, or 16 packed Q4_0 rows.
template <int BITS> __host__ __device__ constexpr int dt_rows() { return BITS == 8 ? 32 : 16; }
// 16-byte weight reads of a lane per quant block: 8 int8 rows, 4 packed rows.
template <int BITS> __host__ __device__ constexpr int dt_w_rows() { return BITS == 8 ? 8 : 4; }

// One ring stage: the block's weight rows, x (8 slot rows of 32 values of
// XT), then the block's 512 scales.
template <typename ST, int BITS, typename XT = __nv_bfloat16>
__host__ __device__ constexpr int dt_stage_bytes() {
  return dt_rows<BITS>() * kDtRowLd + 8 * dt_x_ld<XT>() + kDtBlockCols * (int)sizeof(ST);
}
// Dynamic shared memory of a block: the ring and its mbarriers.
template <typename ST, int BITS, typename XT = __nv_bfloat16>
__host__ __device__ constexpr int dt_smem_bytes() {
  return kDtStages * (dt_stage_bytes<ST, BITS, XT>() + 8);
}
static_assert(dt_stage_bytes<float, 8>() % 16 == 0 && dt_stage_bytes<float, 4>() % 16 == 0 &&
                  dt_stage_bytes<__nv_bfloat16, 8>() % 16 == 0 &&
                  dt_stage_bytes<__nv_bfloat16, 4>() % 16 == 0 &&
                  dt_stage_bytes<float, 8, float>() % 16 == 0 &&
                  dt_stage_bytes<float, 4, float>() % 16 == 0 &&
                  dt_stage_bytes<__nv_bfloat16, 8, float>() % 16 == 0 &&
                  dt_stage_bytes<__nv_bfloat16, 4, float>() % 16 == 0,
              "stages and barriers stay aligned");
// Three blocks an SM (the launch bounds ask for them): the largest ring,
// Q8_0 with f32 scales and f32 x (59.3 KB), and 1 KB the card keeps a block.
static_assert(3 * (dt_smem_bytes<float, 8, float>() + 1024) <= 233472,
              "three blocks an SM fit with f32 x");

// The A fragment of m16 tile T at k16 step STEP from a lane's weight reads
// w[r]: a[0], a[2] column n+T (row gid) at the lo and hi k pairs, a[1],
// a[3] column n+8+T (row gid+8). int8: w[4*STEP + 2h + e] is row 16*STEP +
// 8h + 2*tig + e, each word already XORed with 0x80808080. Q4_0: w[2h + e]
// is packed row 8h + 2*tig + e, whose low nibbles are rows 8h + 2*tig + e
// (step 0) and high nibbles rows 16 more (step 1); RAW keeps the nibbles
// as they are, else they are centred (- 8).
template <int BITS, bool RAW, int T, int STEP>
__device__ __forceinline__ void dt_a_frag(const uint4 (&w)[dt_w_rows<BITS>()], uint32_t (&a)[4]) {
  constexpr int I = T >> 2, J = T & 3;
  if constexpr (BITS == 8) {
    constexpr int R = 4 * STEP;
    a[0] = i8_pair<J>(word_of<I>(w[R]), word_of<I>(w[R + 1]));
    a[1] = i8_pair<J>(word_of<I + 2>(w[R]), word_of<I + 2>(w[R + 1]));
    a[2] = i8_pair<J>(word_of<I>(w[R + 2]), word_of<I>(w[R + 3]));
    a[3] = i8_pair<J>(word_of<I + 2>(w[R + 2]), word_of<I + 2>(w[R + 3]));
  } else {
    constexpr int SH = 4 * STEP;
    a[0] = q4_pair<J, SH, RAW>(word_of<I>(w[0]), word_of<I>(w[1]));
    a[1] = q4_pair<J, SH, RAW>(word_of<I + 2>(w[0]), word_of<I + 2>(w[1]));
    a[2] = q4_pair<J, SH, RAW>(word_of<I>(w[2]), word_of<I>(w[3]));
    a[3] = q4_pair<J, SH, RAW>(word_of<I + 2>(w[2]), word_of<I + 2>(w[3]));
  }
}

// Tile T of a lane's quant block: two k16 steps into a zeroed block sum,
// each one A fragment against the P bf16 parts of x (B: slot gid, xb[p][2 *
// STEP] the lo k pair, xb[p][2 * STEP + 1] the hi pair; P = 1 for bf16 x,
// 3 for f32 x, run lo, mid, hi), with RAW Q4_0 minus 8 * sum(x_b) of its
// slot (xs8: 8 * the sums of slots 2*tig, 2*tig+1), then the sum times
// each column's scale into acc (c0, c1: column n+T, slots 2*tig and
// 2*tig+1; c2, c3: column n+8+T).
template <int BITS, bool RAW, int T, int P>
__device__ __forceinline__ void dt_tile(const uint4 (&w)[dt_w_rows<BITS>()],
                                        const uint32_t (&xb)[P][4], const float (&xs8)[2],
                                        const float (&sc)[2][8], float (&acc)[4]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t a[4];
  dt_a_frag<BITS, RAW, T, 0>(w, a);
#pragma unroll
  for (int p = P - 1; p >= 0; --p) mma_bf16(part, a, xb[p][0], xb[p][1]);
  dt_a_frag<BITS, RAW, T, 1>(w, a);
#pragma unroll
  for (int p = P - 1; p >= 0; --p) mma_bf16(part, a, xb[p][2], xb[p][3]);
  if constexpr (RAW && BITS == 4) {
    part[0] -= xs8[0], part[1] -= xs8[1];
    part[2] -= xs8[0], part[3] -= xs8[1];
  }
  acc[0] = fmaf(sc[0][T], part[0], acc[0]);
  acc[1] = fmaf(sc[0][T], part[1], acc[1]);
  acc[2] = fmaf(sc[1][T], part[2], acc[2]);
  acc[3] = fmaf(sc[1][T], part[3], acc[3]);
}

// The body of the form's kernel: grid = (ceil(N/512), ksplit), block =
// kDtThreads, dynamic shared memory dt_smem_bytes. Block x covers columns
// 512x .. 512x+511 and block y the quant blocks [y*per, (y+1)*per), one per
// ring stage: thread r < 32 (16 for Q4_0) copies weight row r of the
// block's 512 columns, threads 32 .. 32+M-1 the x rows, thread 64 the
// scales, each by one bulk copy. Warp w owns columns 512x + 128w .. +127,
// lane (gid, tig) columns n = 512x + 128w + 16*gid .. +15: column n+T (T <
// 8) is row gid of m16 tile T, n+8+T its row gid+8, and the 8 slots are
// the n8 columns of B. XT is x's type and out's: bf16, or f32 (x as three
// bf16 parts, split in registers). Writes out, or f32 partials to ws[y]
// when ws is set.
template <typename ST, int BITS, bool RAW, typename XT = __nv_bfloat16>
__device__ __forceinline__ void decode_tc_body(const XT* __restrict__ x,
                                               const uint8_t* __restrict__ q,
                                               const ST* __restrict__ s, XT* __restrict__ out,
                                               float* __restrict__ ws, int M, int K, int N,
                                               int per) {
  constexpr bool F32 = sizeof(XT) == 4;
  constexpr int P = F32 ? 3 : 1;  // bf16 parts of x
  constexpr int WR = dt_w_rows<BITS>();
  constexpr int ROWS = dt_rows<BITS>();
  constexpr int STAGE = dt_stage_bytes<ST, BITS, XT>();
  constexpr int XLD = dt_x_ld<XT>();
  constexpr int X_OFF = ROWS * kDtRowLd, S_OFF = X_OFF + 8 * XLD;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb0 = blockIdx.x * kDtBlockCols;
  const int cw = warp * kDtCols + 16 * gid;  // this lane's columns, in the block
  const bool row_ok = gid < M;
  const int kb0 = blockIdx.y * per;
  const int n_it = min(per, K / 32 - kb0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kDtStages * STAGE);
  // bytes of a weight row of the block: N is a multiple of 16
  const uint32_t width = min(kDtBlockCols, N - nb0);
  // a slot row of x: 32 values of XT (64 bytes bf16, 128 f32)
  const uint32_t stage_tx = ROWS * width + M * 32 * (int)sizeof(XT) + width * (int)sizeof(ST);
  const uint64_t once = l2_evict_first();  // the weights are read once
  if (tid < kDtStages) mbar_init(bars + tid);
  mbar_init_fence();
  __syncthreads();

  // Quant block kb0 + it into ring slot `slot`.
  auto load = [&](int slot, int it) {
    const int kb = kb0 + it;
    unsigned char* st = smem + slot * STAGE;
    if (tid == 0) mbar_expect(bars + slot, stage_tx);
    if (tid < ROWS)
      bulk_copy(st + tid * kDtRowLd, q + (size_t)(kb * ROWS + tid) * N + nb0, width, bars + slot,
                once);
    else if (tid >= 32 && tid < 32 + M)
      bulk_copy(st + X_OFF + (tid - 32) * XLD, x + (size_t)(tid - 32) * K + kb * 32,
                32 * (int)sizeof(XT), bars + slot);
    else if (tid == 64)
      bulk_copy(st + S_OFF, s + (size_t)kb * N + nb0, width * (int)sizeof(ST), bars + slot);
  };

  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kDtStages - 1; ++i)
    if (i < n_it) load(i, i);
  for (int it = 0; it < n_it; ++it) {
    mbar_wait(bars + it % kDtStages, (it / kDtStages) & 1);
    __syncthreads();  // quant block `it` has landed; every warp is done with slot (it-1) % stages
    if (it + kDtStages - 1 < n_it) load((it + kDtStages - 1) % kDtStages, it + kDtStages - 1);

    const unsigned char* st = smem + (it % kDtStages) * STAGE;
    uint4 w[WR];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int row = 16 * (r >> 2) + 8 * ((r >> 1) & 1) + 2 * tig + (r & 1);
      w[r] = *reinterpret_cast<const uint4*>(st + row * kDtRowLd + cw);
    }
    if constexpr (BITS == 8) {
#pragma unroll
      for (int r = 0; r < WR; ++r) {
        w[r].x ^= 0x80808080u, w[r].y ^= 0x80808080u;
        w[r].z ^= 0x80808080u, w[r].w ^= 0x80808080u;
      }
    }
    // part p of slot gid at k = 2*tig + {0, 8, 16, 24} (bf16 x: x itself;
    // f32 x: p = 0 hi, 1 mid, 2 lo); 0 past M
    uint32_t xb[P][4] = {};
    const unsigned char* xrow = st + X_OFF + gid * XLD;
    if (row_ok) {
      if constexpr (F32) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 v = *reinterpret_cast<const float2*>(xrow + 8 * tig + 32 * j);
          const uint3 a = split3(v.x), b = split3(v.y);
          xb[0][j] = a.x | (b.x << 16);
          xb[1][j] = a.y | (b.y << 16);
          xb[2][j] = a.z | (b.z << 16);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xb[0][j] = *reinterpret_cast<const uint32_t*>(xrow + 4 * tig + 16 * j);
      }
    }
    float xs8[2] = {0.f, 0.f};
    if constexpr (RAW && BITS == 4) {
      // 8 * sum(x_b) of slots 2*tig and 2*tig+1 in f32, of x's own values
      // (not its parts): lane (gid, tig) adds x[gid][8*tig .. +7] in order,
      // the four lanes of slot gid add theirs (two xor shuffles), and each
      // lane takes the sums of its C columns
      float sum = 0.f;
      if constexpr (F32) {
        const float4* v = reinterpret_cast<const float4*>(xrow + 32 * tig);
        const float4 lo = v[0], hi = v[1];
        sum += lo.x, sum += lo.y, sum += lo.z, sum += lo.w;
        sum += hi.x, sum += hi.y, sum += hi.z, sum += hi.w;
      } else {
        const uint4 v = *reinterpret_cast<const uint4*>(xrow + 16 * tig);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          sum += f.x;
          sum += f.y;
        }
      }
      sum = row_ok ? sum : 0.f;  // x rows past M are never copied
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      xs8[0] = 8.f * __shfl_sync(0xffffffffu, sum, 8 * tig);
      xs8[1] = 8.f * __shfl_sync(0xffffffffu, sum, 8 * tig + 4);
    }
    float sc[2][8];  // columns n .. n+7, n+8 .. n+15
    const ST* sp = reinterpret_cast<const ST*>(st + S_OFF) + cw;
    smem_scales8(sp, sc[0]);
    smem_scales8(sp + 8, sc[1]);

    dt_tile<BITS, RAW, 0, P>(w, xb, xs8, sc, acc[0]);
    dt_tile<BITS, RAW, 1, P>(w, xb, xs8, sc, acc[1]);
    dt_tile<BITS, RAW, 2, P>(w, xb, xs8, sc, acc[2]);
    dt_tile<BITS, RAW, 3, P>(w, xb, xs8, sc, acc[3]);
    dt_tile<BITS, RAW, 4, P>(w, xb, xs8, sc, acc[4]);
    dt_tile<BITS, RAW, 5, P>(w, xb, xs8, sc, acc[5]);
    dt_tile<BITS, RAW, 6, P>(w, xb, xs8, sc, acc[6]);
    dt_tile<BITS, RAW, 7, P>(w, xb, xs8, sc, acc[7]);
  }

  // The warp's 8 slots x 128 columns through shared memory, then 4
  // neighbouring columns a lane to device memory.
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem) + warp * 8 * kDtCols;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4* p = reinterpret_cast<float4*>(red + (2 * tig + h) * kDtCols + 16 * gid);
    p[0] = make_float4(acc[0][h], acc[1][h], acc[2][h], acc[3][h]);
    p[1] = make_float4(acc[4][h], acc[5][h], acc[6][h], acc[7][h]);
    p[2] = make_float4(acc[0][2 + h], acc[1][2 + h], acc[2][2 + h], acc[3][2 + h]);
    p[3] = make_float4(acc[4][2 + h], acc[5][2 + h], acc[6][2 + h], acc[7][2 + h]);
  }
  __syncwarp();
  const int c = nb0 + warp * kDtCols + 4 * lane;
  if (c >= N) return;
  for (int m = 0; m < M; ++m) {
    const float4 v = *reinterpret_cast<const float4*>(red + m * kDtCols + 4 * lane);
    if (ws != nullptr)
      *reinterpret_cast<float4*>(ws + (size_t)blockIdx.y * M * N + (size_t)m * N + c) = v;
    else if constexpr (F32)
      *reinterpret_cast<float4*>(out + (size_t)m * N + c) = v;
    else
      *reinterpret_cast<uint2*>(out + (size_t)m * N + c) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

static_assert(dt_smem_bytes<float, 4>() >= kDtWarps * 8 * kDtCols * 4 &&
                  dt_smem_bytes<__nv_bfloat16, 4>() >= kDtWarps * 8 * kDtCols * 4,
              "the warps' sums fit in the ring");

}  // namespace
