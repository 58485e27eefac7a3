// The int8 tensor-core decode form of a matmul whose activations are int8,
// shared by K5 (w4x8_a8_tc, w4x8_matmul.cu) and the kernel lab's integer rows
// L6, L7, L8 and L10 (lab_decode_i8tc, lab_matmul.cu). For at most 8 * NT
// rows (slots) of int8 xq, quantized per (slot, scale group), and integer
// weights w (int8 or int4), it computes
//
//   out[m, n] = sum_g f32(sum_{k in g} xq[m, k] * w[k, n]) * sx[m, g] * s[g, n]
//
// with the dot of a scale group g exact in int32 and the sum over the groups
// in f32. A group is `sg` steps of 32 rows of K (a Q8_0 / Q4_0 block: 1; a
// w4x8 or g128 group: 4; a k-tile of the lab: tk / 32); its scale row is
// (u / tile) * tile_rows + (u % tile) / sg for step u (the lab's k-tiles of
// `tile` steps, `tile_rows` scale rows each; K5: row 2g of the duplicated
// rows). Without sx (L8's split form) the activation scale is 1.
//
// Weight formats (FMT):
//  * kItQ8, int8 [K, N] row-major (Q8_0 integers);
//  * kItQ4Raw, Q4_0 bytes [K/2, N]: byte j of a 32-row block (packed rows
//    16b .. 16b+15) holds row 32b+j in its low nibble and row 32b+j+16 in
//    its high nibble; the value is the nibble less 8;
//  * kItI4, int4 pairs [K/2, N]: byte r holds rows 2r (low nibble) and 2r+1
//    (high) as two's-complement nibbles (w4x8; the lab's bitcast of the Q4_0
//    bytes).
//
// What bounds it: at M <= 16 a weight byte meets at most 4 * M int8
// operations (64 at M = 16), far below the card's int8 ridge (~590 an
// HBM byte), so the weight stream over device-memory bandwidth bounds it.
// The CUDA-core form this replaces ran every product and every unpacking
// step on the INT32 pipe (__dp4a, four products an instruction) and reached
// about a third of that bound.
//
// What the design does about it: the products run on mma.sync.m16n8k32
// (int8 in, exact int32 sums; tc_common.cuh mma_s8), with the weights as the
// A operand (16 output columns by 32 rows of K) and xq as B (the slots the
// n8 columns: one n8 tile up to 8 slots, two up to 16, so the weight bytes
// are read once at M = 16). A block is four warps on 512 neighbouring
// columns, lane (gid, tig) on columns n = 512x + 128w + 16 gid .. +15 (column
// n+T is row gid of m16 tile T, n+8+T its row gid+8, as in decode_tc.cuh).
// Every 32 rows of K (a step) arrive by bulk copies of the TMA unit into a
// ring stage: the block's 512 columns of each weight row (L2 evict_first:
// read once), the slots' 32 bytes of xq, and where a group ends its scale
// row and its slots' sx, all on one mbarrier. An A register holds four k of
// one column:
//  * kItQ8: the lane reads rows 16H + 8(e>>1) + 2 tig + (e&1), e = 0..3, of
//    half H (16 bytes each: conflict-free with 528-byte rows), and a 4x4
//    byte transpose of four rows' words gives four columns' registers (8
//    PRMT). A register's k = 16H + 4 tig + e is that row: a permutation of
//    the step's 32 rows. The int32 dot of a group is exact in any order of
//    its k, so the B register takes xq in the same permutation (two 16-bit
//    reads: bytes 2 tig, 2 tig + 1 and 2 tig + 8, 2 tig + 9 of the slot).
//  * kItQ4Raw: the packed rows of the same permutation; the low nibbles of
//    the transposed words are k of half 0 and the high nibbles half 1 (rows
//    16 more). The raw nibbles 0..15 enter the product and 8 * sum(xq) of
//    each slot comes off the group's int32 sum: the same integers.
//  * kItI4: packed rows 2 tig, 2 tig + 1 (half 0) and 8 + 2 tig, 9 + 2 tig
//    (half 1) hold rows 4 tig .. 4 tig + 3 (+16) in order, so xq takes no
//    permutation. A nibble moved to the high half of its byte ((b << 4) &
//    0xF0, b & 0xF0) is 16 times its value as an int8; the int32 sum comes
//    out 16 times too large and is shifted back exactly (a multiple of 16;
//    |16 v xq| * 1024 < 2^31).
// At a group's end (or the split's) the int32 sums are converted once and
// folded: acc += f32(d) * sx * s, in f32, group after group. K is split
// (ops/kernels.py i8tc_split) as far as one wave of blocks holds; a split of
// at least a group holds whole groups, and a shorter one (the lab's 1024-row
// k-tiles) folds the exact sum of its part of a group, which changes the
// order of the f32 products and sums only. The caller adds the splits' f32
// partials in a fixed order (no atomics).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kItQ8 = 0, kItQ4Raw = 1, kItI4 = 2;            // weight formats
constexpr int kItXRows = 0, kItXBlocks = 1, kItXHalves = 2;  // layouts of xq

constexpr int kItWarps = 4;                      // warps per block
constexpr int kItThreads = 32 * kItWarps;
constexpr int kItCols = 128;                     // columns per warp: 8 lane groups x 16
constexpr int kItBlockCols = kItWarps * kItCols;  // 512: one bulk copy per weight row
constexpr int kItSlots = 16;                     // slots a block takes at most (two n8 tiles)
// Row strides in a stage: weight rows 528 bytes apart (the lanes' 16-byte
// reads of rows 2 tig + c fall on distinct banks) and the slots' xq 48 apart
// (the lanes' words at 4 tig of slots gid fall on distinct banks).
constexpr int kItRowLd = kItBlockCols + 16, kItXLd = 48;

// Stored weight rows of a step (32 int8 rows or 16 packed rows), the lane's
// 16-byte reads of them, the ring's depth and the blocks an SM holds (NT n8
// tiles of slots; two tiles carry twice the sums in registers).
template <int FMT> __host__ __device__ constexpr int it_rows() { return FMT == kItQ8 ? 32 : 16; }
template <int FMT> __host__ __device__ constexpr int it_w_rows() { return FMT == kItQ8 ? 8 : 4; }
template <int FMT> __host__ __device__ constexpr int it_stages() { return FMT == kItQ8 ? 4 : 6; }
template <int NT> __host__ __device__ constexpr int it_blocks_per_sm() { return NT == 1 ? 3 : 2; }

// One ring stage: the step's weight rows, the slots' xq, the slots' sx, the
// 512 bf16 scales of the block's columns.
template <int FMT> __host__ __device__ constexpr int it_stage_bytes() {
  return it_rows<FMT>() * kItRowLd + kItSlots * kItXLd + kItSlots * 4 + kItBlockCols * 2;
}
// Dynamic shared memory of a block: the ring and its mbarriers.
template <int FMT> __host__ __device__ constexpr int it_smem_bytes() {
  return it_stages<FMT>() * (it_stage_bytes<FMT>() + 8);
}
static_assert(it_stage_bytes<kItQ8>() % 16 == 0 && it_stage_bytes<kItI4>() % 16 == 0,
              "stages and barriers stay aligned");
static_assert(it_smem_bytes<kItQ8>() >= kItWarps * kItSlots * kItCols * 4 &&
                  it_smem_bytes<kItI4>() >= kItWarps * kItSlots * kItCols * 4,
              "the warps' sums fit in the ring");
static_assert(3 * (it_smem_bytes<kItQ8>() + 1024) <= 233472 &&
                  3 * (it_smem_bytes<kItI4>() + 1024) <= 233472,
              "three blocks an SM fit its shared memory");

// The operands of one launch. Block z takes slots 8 NT z .. +8 NT - 1 of
// the tm rows of xq, and writes f32 to dst[y * dst_split + (row) * N + n].
struct ItArgs {
  const int8_t* xq;        // kItXRows [tm, K]; kItXBlocks [K/32, tm, 32]; kItXHalves [tm, K/2]
  const int8_t* xq_hi;     // kItXHalves: the second 16 of every 32-block, [tm, K/2]
  const float* sx;         // sx of group g, row m: sx[g * sx_ld + m]; null: 1
  const uint8_t* q;        // the weights in FMT
  const __nv_bfloat16* s;  // scale rows [*, N]
  float* dst;
  size_t dst_split;        // floats between two splits' partials in dst
  int xlayout, tm, sx_ld;
  int K, N, per;           // per: steps of 32 rows of K a split
  int sg, tile, tile_rows;
};

// Four words of four rows, each byte a column -> four words of four columns,
// each byte a row (byte i of col[c] is byte c of w[i]).
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// Two words of int4 pairs (packed rows p and p', four columns each) -> the
// four columns' registers of rows 2p, 2p+1, 2p', 2p'+1, each nibble as 16
// times its value (int8).
__device__ __forceinline__ void i4_cols(uint32_t a, uint32_t b, uint32_t (&col)[4]) {
  const uint32_t alo = (a << 4) & 0xF0F0F0F0u, ahi = a & 0xF0F0F0F0u;
  const uint32_t blo = (b << 4) & 0xF0F0F0F0u, bhi = b & 0xF0F0F0F0u;
  const uint32_t ta = __byte_perm(alo, ahi, 0x5140), tb = __byte_perm(alo, ahi, 0x7362);
  const uint32_t ua = __byte_perm(blo, bhi, 0x5140), ub = __byte_perm(blo, bhi, 0x7362);
  col[0] = __byte_perm(ta, ua, 0x5410);
  col[1] = __byte_perm(ta, ua, 0x7632);
  col[2] = __byte_perm(tb, ub, 0x5410);
  col[3] = __byte_perm(tb, ub, 0x7632);
}

// The A registers of half H (k 16H + 4 tig .. +3) of columns n+4I .. n+4I+3
// from the lane's weight reads w.
template <int FMT, int I, int H>
__device__ __forceinline__ void it_cols(const uint4 (&w)[it_w_rows<FMT>()], uint32_t (&c)[4]) {
  if constexpr (FMT == kItQ8) {
    const uint32_t r[4] = {word_of<I>(w[4 * H]), word_of<I>(w[4 * H + 1]),
                           word_of<I>(w[4 * H + 2]), word_of<I>(w[4 * H + 3])};
    transpose4x4(r, c);
  } else if constexpr (FMT == kItQ4Raw) {
    const uint32_t r[4] = {word_of<I>(w[0]), word_of<I>(w[1]), word_of<I>(w[2]),
                           word_of<I>(w[3])};
    transpose4x4(r, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = (H == 0 ? c[j] : c[j] >> 4) & 0x0F0F0F0Fu;
  } else {
    i4_cols(word_of<I>(w[2 * H]), word_of<I>(w[2 * H + 1]), c);
  }
}

// Tiles 4I .. 4I+3 of a step: a[0] column n+T at half 0, a[1] column
// n+8+T at half 0, a[2], a[3] the same at half 1; one mma per n8 tile of
// slots into the group's int32 sums.
template <int FMT, int NT, int I>
__device__ __forceinline__ void it_tiles(const uint4 (&w)[it_w_rows<FMT>()],
                                         const uint32_t (&b)[NT][2], int (&dot)[8][NT][4]) {
  uint32_t c00[4], c01[4], c10[4], c11[4];
  it_cols<FMT, I, 0>(w, c00);
  it_cols<FMT, I + 2, 0>(w, c01);
  it_cols<FMT, I, 1>(w, c10);
  it_cols<FMT, I + 2, 1>(w, c11);
#pragma unroll
  for (int J = 0; J < 4; ++J) {
    const uint32_t a[4] = {c00[J], c01[J], c10[J], c11[J]};
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_s8(dot[4 * I + J][j], a, b[j][0], b[j][1]);
  }
}

// The body of the form's kernel: grid = (ceil(N/512), ksplit, row groups),
// block = kItThreads, dynamic shared memory it_smem_bytes<FMT>; `a` is the
// kernel's __grid_constant__ parameter. Block y covers the steps [y*per,
// (y+1)*per), one per ring stage: thread r < it_rows copies weight row r of
// the block's 512 columns, threads 32 .. 32+M-1 the slots' xq, and at a
// fold step thread 64 the scale row and thread 65 the slots' sx, each by
// bulk copies.
template <int FMT, int NT>
__device__ __forceinline__ void decode_i8tc_body(const ItArgs& a) {
  constexpr int ROWS = it_rows<FMT>(), WR = it_w_rows<FMT>(), STAGES = it_stages<FMT>();
  constexpr int STAGE = it_stage_bytes<FMT>();
  constexpr int X_OFF = ROWS * kItRowLd, SX_OFF = X_OFF + kItSlots * kItXLd;
  constexpr int S_OFF = SX_OFF + kItSlots * 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb0 = blockIdx.x * kItBlockCols;
  const int cw = warp * kItCols + 16 * gid;  // this lane's columns, in the block
  const int row0 = blockIdx.z * 8 * NT;
  const int M = min(8 * NT, a.tm - row0);  // the block's slots
  const int u0 = blockIdx.y * a.per;
  const int n_it = min(a.per, a.K / 32 - u0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  // bytes of a weight row of the block: N is a multiple of 16
  const uint32_t width = min(kItBlockCols, a.N - nb0);
  const uint32_t fold_tx = 2 * width + (a.sx != nullptr ? 32 * NT : 0);
  const uint64_t once = l2_evict_first();  // the weights are read once
  if (tid < STAGES) mbar_init(bars + tid);
  mbar_init_fence();
  __syncthreads();

  // whether step `it` of the block ends a group, or the split
  auto folds = [&](int it) { return (u0 + it + 1) % a.sg == 0 || it + 1 == n_it; };

  // Step u0 + it into ring slot `slot`.
  auto load = [&](int slot, int it) {
    const int u = u0 + it;
    const bool fold = folds(it);
    unsigned char* st = smem + slot * STAGE;
    if (tid == 0) mbar_expect(bars + slot, ROWS * width + 32 * M + (fold ? fold_tx : 0));
    if (tid < ROWS) {
      bulk_copy(st + tid * kItRowLd, a.q + (size_t)(u * ROWS + tid) * a.N + nb0, width,
                bars + slot, once);
    } else if (tid >= 32 && tid < 32 + M) {
      const int m = row0 + tid - 32;
      unsigned char* xd = st + X_OFF + (tid - 32) * kItXLd;
      if (a.xlayout == kItXHalves) {
        const size_t off = (size_t)m * (a.K / 2) + (size_t)u * 16;
        bulk_copy(xd, a.xq + off, 16, bars + slot);
        bulk_copy(xd + 16, a.xq_hi + off, 16, bars + slot);
      } else {
        const size_t off = a.xlayout == kItXRows ? (size_t)m * a.K + (size_t)u * 32
                                                 : ((size_t)u * a.tm + m) * 32;
        bulk_copy(xd, a.xq + off, 32, bars + slot);
      }
    } else if (fold && tid == 64) {
      const int srow = (u / a.tile) * a.tile_rows + (u % a.tile) / a.sg;
      bulk_copy(st + S_OFF, a.s + (size_t)srow * a.N + nb0, 2 * width, bars + slot);
    } else if (fold && tid == 65 && a.sx != nullptr) {
      bulk_copy(st + SX_OFF, a.sx + (size_t)(u / a.sg) * a.sx_ld + row0, 32 * NT, bars + slot);
    }
  };

  float acc[8][NT][4];
  int dot[8][NT][4];  // the group's exact sums
  int xs[NT][2];      // kItQ4Raw: the group's sum of xq, slots 8j + 2 tig + h
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f, dot[t][j][e] = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) xs[j][0] = xs[j][1] = 0;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < n_it) load(i, i);
  for (int it = 0; it < n_it; ++it) {
    mbar_wait(bars + it % STAGES, (it / STAGES) & 1);
    __syncthreads();  // step `it` has landed; every warp is done with slot (it-1) % stages
    if (it + STAGES - 1 < n_it) load((it + STAGES - 1) % STAGES, it + STAGES - 1);

    const unsigned char* st = smem + (it % STAGES) * STAGE;
    // B: slot 8j + gid at k 4 tig .. +3 (b[j][0]) and 16 + 4 tig .. (b[j][1]),
    // permuted as the A registers are; 0 past the block's slots (never copied)
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b[j][0] = b[j][1] = 0u;
      if (8 * j + gid < M) {
        const unsigned char* xr = st + X_OFF + (8 * j + gid) * kItXLd;
        if constexpr (FMT == kItI4) {
          b[j][0] = *reinterpret_cast<const uint32_t*>(xr + 4 * tig);
          b[j][1] = *reinterpret_cast<const uint32_t*>(xr + 16 + 4 * tig);
        } else {
          const uint16_t* h = reinterpret_cast<const uint16_t*>(xr);
          b[j][0] = (uint32_t)h[tig] | ((uint32_t)h[tig + 4] << 16);
          b[j][1] = (uint32_t)h[tig + 8] | ((uint32_t)h[tig + 12] << 16);
        }
      }
    }
    if constexpr (FMT == kItQ4Raw) {
      // sum(xq) of the step for the lane's C columns: lane (gid, tig) adds
      // its 8 values of slot 8j + gid, the four lanes of the slot add theirs
      // (two xor shuffles), and each lane takes slots 8j + 2 tig + {0, 1}
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        int v = __dp4a((int)b[j][0], 0x01010101, __dp4a((int)b[j][1], 0x01010101, 0));
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        xs[j][0] += __shfl_sync(0xffffffffu, v, 8 * tig);
        xs[j][1] += __shfl_sync(0xffffffffu, v, 8 * tig + 4);
      }
    }
    uint4 w[WR];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int row = FMT == kItQ8 ? 16 * (r >> 2) + 8 * ((r >> 1) & 1) + 2 * tig + (r & 1)
                                   : 8 * (r >> 1) + 2 * tig + (r & 1);
      w[r] = *reinterpret_cast<const uint4*>(st + row * kItRowLd + cw);
    }
    it_tiles<FMT, NT, 0>(w, b, dot);
    it_tiles<FMT, NT, 1>(w, b, dot);

    if (folds(it)) {
      float sxv[NT][2];  // slots 8j + 2 tig, 8j + 2 tig + 1
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sxv[j][0] = sxv[j][1] = 1.f;
        if (a.sx != nullptr) {
          const float2 v = *reinterpret_cast<const float2*>(st + SX_OFF + 4 * (8 * j + 2 * tig));
          sxv[j][0] = v.x, sxv[j][1] = v.y;
        }
      }
      float sc[2][8];  // columns n .. n+7, n+8 .. n+15
      const __nv_bfloat16* sp = reinterpret_cast<const __nv_bfloat16*>(st + S_OFF) + cw;
      smem_scales8(sp, sc[0]);
      smem_scales8(sp + 8, sc[1]);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int d = dot[t][j][e];
            if constexpr (FMT == kItQ4Raw) d -= 8 * xs[j][e & 1];
            if constexpr (FMT == kItI4) d >>= 4;  // exact: a multiple of 16
            acc[t][j][e] = fmaf(__int2float_rn(d) * sxv[j][e & 1], sc[e >> 1][t], acc[t][j][e]);
            dot[t][j][e] = 0;
          }
#pragma unroll
      for (int j = 0; j < NT; ++j) xs[j][0] = xs[j][1] = 0;
    }
  }

  // The warp's slots x 128 columns through shared memory, then 4
  // neighbouring columns a lane to device memory.
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem) + warp * 8 * NT * kItCols;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4* p = reinterpret_cast<float4*>(red + (8 * j + 2 * tig + h) * kItCols + 16 * gid);
      p[0] = make_float4(acc[0][j][h], acc[1][j][h], acc[2][j][h], acc[3][j][h]);
      p[1] = make_float4(acc[4][j][h], acc[5][j][h], acc[6][j][h], acc[7][j][h]);
      p[2] = make_float4(acc[0][j][2 + h], acc[1][j][2 + h], acc[2][j][2 + h], acc[3][j][2 + h]);
      p[3] = make_float4(acc[4][j][2 + h], acc[5][j][2 + h], acc[6][j][2 + h], acc[7][j][2 + h]);
    }
  __syncwarp();
  const int c = nb0 + warp * kItCols + 4 * lane;
  if (c >= a.N) return;
  for (int m = 0; m < M; ++m)
    *reinterpret_cast<float4*>(a.dst + blockIdx.y * a.dst_split + (size_t)(row0 + m) * a.N + c) =
        *reinterpret_cast<const float4*>(red + m * kItCols + 4 * lane);
}

}  // namespace
