// The bf16 tensor-core tile of a Q8_0 / Q4_0 matmul over more than 8 rows
// of x, shared by K1 (dq_tc, dequant_matmul.cu) and K9 (so_tc,
// dequant_matmul_so.cu): per 32-row quant block b the block sum x_b . w_b
// on bf16 mma.sync.m16n8k16, times s_b, into the f32 output sum. The two
// differ in Q4_0 only (RAW): K1's weights are the nibbles - 8; K9's are
// the raw nibbles 0..15, and 8 * sum(x_b) of each row comes off the block
// sum before the scale, as the TPU's scale-on-output kernel computes it.
// Q8_0 is the same function in both.
//
// A block owns 16*MT rows by 128 columns and a split of K by whole quant
// blocks: raw weight bytes, scales and x go from device memory to shared
// memory by 16-byte cp.async in a ring of quant blocks (four for bf16 x,
// three for f32 x's three planes), so the next ones load while this one is
// multiplied. The B fragments are built in registers from 32-bit
// shared-memory reads of the raw bytes (int8 by the f32 0x4B0000uu, a Q4_0
// nibble by the bf16 0x43nn: exact bf16 integers); a thread's word holds 4
// neighbouring columns of one row, which become column gid of 4 n8 tiles,
// so a thread owns 8 neighbouring output columns and their 8 scales. x is
// the A operand by ldmatrix: bf16 x itself (PARTS 1), or f32 x's three
// exact bf16 planes hi, mid, lo (PARTS 3, written by split_x3), each
// against the same B fragments into the same zeroed block sum: every part
// times an integer weight is exact in f32. Where the output tiles give too
// few blocks, K is split and the splits write f32 partials that the
// caller's reduce adds in a fixed order (no atomics).
//
// RAW Q4_0's row sums sum(x_b), rows m0 + 16i + gid + 8h of the thread's C
// fragments: with bf16 x one more mma a k16 step and row tile, the x
// fragment against a B of bf16 ones into a zeroed f32 sum (the products are
// x exactly), read from the staged plane; with f32 x the sums of x's own
// f32 values, which the split pass wrote to `xsum` [K/32, M rounded up to
// 4] beside the planes and the ring stages with the quant block (read from
// shared memory at the fold, so that no register holds them across the
// mma). Either way 8 * sum(x_b) leaves the block sum before the column's
// scale folds it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kTcThreads = 128;       // four warps, 32 columns each
constexpr int kTcCols = 128;          // columns per block
constexpr int kTcWLd = kTcCols + 16;  // weight row stride (bytes): conflict-free 32-bit reads
constexpr int kTcXLd = 32 + 8;        // x row stride (bf16, 80 bytes): conflict-free ldmatrix

// Quant blocks in the cp.async ring: four for bf16 x (40 KB at 64 rows),
// three for f32 x's three bf16 planes (60 KB at 64 rows, three blocks an SM).
template <int PARTS> __host__ __device__ constexpr int tc_stages() { return PARTS == 1 ? 4 : 3; }

// Shared-memory rows of one quant block's weights: 32 int8 rows, or 16
// packed Q4_0 rows.
template <int BITS> __host__ __device__ constexpr int tc_w_rows() { return BITS == 8 ? 32 : 16; }

// One ring stage: weights, scales, then x's PARTS planes of 16 * MT rows.
template <typename ST, int MT, int BITS, int PARTS>
__host__ __device__ constexpr int tc_stage_bytes() {
  return tc_w_rows<BITS>() * kTcWLd + kTcCols * (int)sizeof(ST) + PARTS * 16 * MT * kTcXLd * 2;
}
// ... and, where the tile takes f32 x's block sums (RAW Q4_0 on three
// parts), the 16 * MT rows' sums of the stage's quant block after them.
template <typename ST, int MT, int BITS, int PARTS, bool SUMS = false>
__host__ __device__ constexpr int tc_ring_stage_bytes() {
  return tc_stage_bytes<ST, MT, BITS, PARTS>() + (SUMS ? 16 * MT * 4 : 0);
}

// Dynamic shared memory of a block: the ring.
template <typename ST, int MT, int BITS, int PARTS, bool SUMS = false>
__host__ __device__ constexpr int tc_smem_bytes() {
  return tc_stages<PARTS>() * tc_ring_stage_bytes<ST, MT, BITS, PARTS, SUMS>();
}

// Rows of x's block sums a quant block holds in the workspace, [K/32, MP]:
// M rounded up to 4, so that a stage's 16-byte copies start aligned.
__host__ __device__ constexpr int tc_sums_ld(int M) { return (M + 3) / 4 * 4; }

// Blocks an SM the launch bounds ask for, 0 for none. f32 x in 32-row blocks
// asks for three: left to itself ptxas gave one of those instances (Q4_0,
// bf16 scales) 128 registers and a spill; asked for three it takes 130-142
// and none. Every other instance builds as without the bound.
template <int MT, int PARTS> __host__ __device__ constexpr int tc_min_blocks() {
  return PARTS == 3 && MT == 2 ? 3 : 0;
}

// The body of the tile's kernel: grid = (ceil(N/128) * m_tiles, ksplit),
// block = 128 threads, dynamic shared memory tc_smem_bytes. Block x covers
// column strip x / m_tiles and rows 16*MT*(x % m_tiles) on; block y the
// quant blocks [y*per, (y+1)*per). Warp w owns columns 32w..32w+31 of the
// strip and all 16*MT rows. x holds PARTS bf16 planes of [M, K]: bf16 x
// itself (PARTS 1, out bf16), or the parts hi, mid, lo of f32 x (PARTS 3,
// out f32). RAW: the Q4_0 nibbles as they are, 8 * sum(x_b) off each block
// sum (with PARTS 3 the sums from xsum [K/32, tc_sums_ld(M)], staged in the
// ring beside the block's planes). Writes to out, or f32 partials to ws[y]
// when ws is set.
template <typename ST, int MT, int BITS, int PARTS, bool RAW>
__device__ __forceinline__ void tile_tc_body(const __nv_bfloat16* __restrict__ x,
                                             const uint8_t* __restrict__ q,
                                             const ST* __restrict__ s, void* __restrict__ out,
                                             float* __restrict__ ws,
                                             const float* __restrict__ xsum, int M, int K, int N,
                                             int per, int m_tiles) {
  constexpr int WR = tc_w_rows<BITS>();
  constexpr int BM = 16 * MT;
  constexpr int W_BYTES = WR * kTcWLd;
  constexpr int S_BYTES = kTcCols * (int)sizeof(ST);
  constexpr bool OFFSET = RAW && BITS == 4;  // Q4_0's 8 * sum(x_b) off the block sums
  constexpr bool SUMS = OFFSET && PARTS == 3;  // ... from the split pass's sums
  constexpr int STAGE = tc_ring_stage_bytes<ST, MT, BITS, PARTS, SUMS>();
  constexpr int SUMS_OFF = tc_stage_bytes<ST, MT, BITS, PARTS>();
  constexpr int STAGES = tc_stages<PARTS>();
  constexpr int SV = 16 / (int)sizeof(ST);  // scales per 16-byte copy
  constexpr uint32_t kOnes = 0x3F803F80u;    // a bf16 pair of ones
  extern __shared__ __align__(16) unsigned char smem[];

  const int n0 = (blockIdx.x / m_tiles) * kTcCols;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int kb0 = blockIdx.y * per;
  const int n_it = min(per, K / 32 - kb0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mp = tc_sums_ld(M);

  // Quant block kb into ring slot `slot`. Columns past N are not copied
  // (their outputs are not stored); rows past M repeat row M-1 (likewise),
  // and their sums are not copied (likewise).
  auto load = [&](int slot, int kb) {
    unsigned char* st = smem + slot * STAGE;
#pragma unroll
    for (int i = 0; i < (WR * 8 + kTcThreads - 1) / kTcThreads; ++i) {
      const int c = tid + i * kTcThreads;  // 8 copies of 16 bytes per row
      const int r = c >> 3, n = n0 + (c & 7) * 16;
      if (c < WR * 8 && n < N)
        cp_async16(st + r * kTcWLd + (c & 7) * 16, q + (size_t)(kb * WR + r) * N + n);
    }
    if (tid < kTcCols / SV) {
      const int n = n0 + tid * SV;
      if (n < N) cp_async16(st + W_BYTES + tid * 16, s + (size_t)kb * N + n);
    }
#pragma unroll
    for (int i = 0; i < (PARTS * BM * 4 + kTcThreads - 1) / kTcThreads; ++i) {
      const int c = tid + i * kTcThreads;  // 4 copies of 16 bytes per row of a plane
      const int r = c >> 2, m = min(m0 + r % BM, M - 1);  // row r % BM of plane r / BM
      if (c < PARTS * BM * 4)
        cp_async16(st + W_BYTES + S_BYTES + r * (kTcXLd * 2) + (c & 3) * 16,
                   x + (size_t)(r / BM) * M * K + (size_t)m * K + kb * 32 + (c & 3) * 8);
    }
    if constexpr (SUMS) {  // 4 rows' sums a copy
      if (tid < BM / 4 && m0 + 4 * tid < mp)
        cp_async16(st + SUMS_OFF + tid * 16, xsum + (size_t)kb * mp + m0 + 4 * tid);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_it) load(i, kb0 + i);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // quant block `it` has landed; slot (it-1) % stages is free
    if (it + STAGES - 1 < n_it) load((it + STAGES - 1) % STAGES, kb0 + it + STAGES - 1);
    cp_async_commit();

    const unsigned char* st = smem + (it % STAGES) * STAGE;
    // this thread's 4 columns 32*warp + 4*gid .. +3 of the weight rows
    const unsigned char* wt = st + warp * 32 + gid * 4;
    auto row = [&](int r) { return *reinterpret_cast<const uint32_t*>(wt + r * kTcWLd); };
    // b[step][reg][j]: n8 tile j (column 4*gid + j), k16 step `step`
    uint32_t b[2][2][4];
    if constexpr (BITS == 8) {
#pragma unroll
      for (int step = 0; step < 2; ++step) {
        const int r = step * 16 + 2 * tig;
        const uint32_t w0 = row(r) ^ 0x80808080u, w1 = row(r + 1) ^ 0x80808080u;
        const uint32_t w2 = row(r + 8) ^ 0x80808080u, w3 = row(r + 9) ^ 0x80808080u;
        b[step][0][0] = i8_pair<0>(w0, w1), b[step][1][0] = i8_pair<0>(w2, w3);
        b[step][0][1] = i8_pair<1>(w0, w1), b[step][1][1] = i8_pair<1>(w2, w3);
        b[step][0][2] = i8_pair<2>(w0, w1), b[step][1][2] = i8_pair<2>(w2, w3);
        b[step][0][3] = i8_pair<3>(w0, w1), b[step][1][3] = i8_pair<3>(w2, w3);
      }
    } else {
      // packed row r holds rows r (low nibbles: step 0) and r + 16 (high: step 1)
      const uint32_t p0 = row(2 * tig), p1 = row(2 * tig + 1);
      const uint32_t p2 = row(2 * tig + 8), p3 = row(2 * tig + 9);
      b[0][0][0] = q4_pair<0, 0, RAW>(p0, p1), b[0][1][0] = q4_pair<0, 0, RAW>(p2, p3);
      b[0][0][1] = q4_pair<1, 0, RAW>(p0, p1), b[0][1][1] = q4_pair<1, 0, RAW>(p2, p3);
      b[0][0][2] = q4_pair<2, 0, RAW>(p0, p1), b[0][1][2] = q4_pair<2, 0, RAW>(p2, p3);
      b[0][0][3] = q4_pair<3, 0, RAW>(p0, p1), b[0][1][3] = q4_pair<3, 0, RAW>(p2, p3);
      b[1][0][0] = q4_pair<0, 4, RAW>(p0, p1), b[1][1][0] = q4_pair<0, 4, RAW>(p2, p3);
      b[1][0][1] = q4_pair<1, 4, RAW>(p0, p1), b[1][1][1] = q4_pair<1, 4, RAW>(p2, p3);
      b[1][0][2] = q4_pair<2, 4, RAW>(p0, p1), b[1][1][2] = q4_pair<2, 4, RAW>(p2, p3);
      b[1][0][3] = q4_pair<3, 4, RAW>(p0, p1), b[1][1][3] = q4_pair<3, 4, RAW>(p2, p3);
    }

    const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(st + W_BYTES + S_BYTES);
    float part[MT][4][4];
    float xsc[MT][4];  // bf16 x's row sums: C of x against B = ones
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) xsc[i][e] = 0.f;
    }
#pragma unroll
    for (int step = 0; step < 2; ++step) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // the planes lo, mid, hi (f32 x) against the same B fragments, into
        // the same block sum
#pragma unroll
        for (int p = PARTS - 1; p >= 0; --p) {
          uint32_t a[4];
          ldmatrix_x4(a, xt + (p * BM + i * 16 + (lane & 15)) * kTcXLd + step * 16 +
                             (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], a, b[step][0][j], b[step][1][j]);
          if constexpr (OFFSET && PARTS == 1) mma_bf16(xsc[i], a, kOnes, kOnes);
        }
      }
    }
    // the row sums of rows m0 + 16i + gid + 8h
    float xs[MT][2];
    if constexpr (OFFSET && PARTS == 1) {
#pragma unroll
      for (int i = 0; i < MT; ++i) xs[i][0] = xsc[i][0], xs[i][1] = xsc[i][2];
    } else if constexpr (SUMS) {
      const float* sums = reinterpret_cast<const float*>(st + SUMS_OFF);
#pragma unroll
      for (int i = 0; i < MT; ++i)
        xs[i][0] = sums[16 * i + gid], xs[i][1] = sums[16 * i + gid + 8];
    }
    if constexpr (OFFSET) {
      // c0, c1 are row gid, c2, c3 row gid + 8
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float o0 = 8.f * xs[i][0], o1 = 8.f * xs[i][1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part[i][j][0] -= o0, part[i][j][1] -= o0;
          part[i][j][2] -= o1, part[i][j][3] -= o1;
        }
      }
    }

    // c0 / c2 of tile j are column 8*tig + j, c1 / c3 column 8*tig + 4 + j
    float sc[8];
    smem_scales8(reinterpret_cast<const ST*>(st + W_BYTES) + warp * 32 + tig * 8, sc);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j][0] = fmaf(sc[j], part[i][j][0], acc[i][j][0]);
        acc[i][j][1] = fmaf(sc[4 + j], part[i][j][1], acc[i][j][1]);
        acc[i][j][2] = fmaf(sc[j], part[i][j][2], acc[i][j][2]);
        acc[i][j][3] = fmaf(sc[4 + j], part[i][j][3], acc[i][j][3]);
      }
  }

  const int n = n0 + warp * 32 + tig * 8;  // N is a multiple of 16: all 8 in or out
  if (n >= N) return;
  float* const f32_out = ws != nullptr ? ws + (size_t)blockIdx.y * M * N
                         : PARTS == 3  ? static_cast<float*>(out)
                                       : nullptr;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + i * 16 + gid + 8 * h;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][j][2 * h];
        v[4 + j] = acc[i][j][2 * h + 1];
      }
      if (f32_out != nullptr) {
        float4* p = reinterpret_cast<float4*>(f32_out + (size_t)m * N + n);
        p[0] = make_float4(v[0], v[1], v[2], v[3]);
        p[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + (size_t)m * N + n) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                       pack_bf16(v[6], v[7]));
      }
    }
}

// The launch of a tile kernel (dq_tc or so_tc: the body above, with its
// arguments) at 16 * MT rows a block, after the caller's shared-memory
// opt-in where the ring needs more than 48 KB.
template <typename ST, int MT, int BITS, int PARTS, bool SUMS, typename Kernel>
void tile_launch(Kernel kernel, const void* x, const void* q, const void* s, void* out,
                 float* ws, const float* xsum, int M, int K, int N, int ksplit,
                 cudaStream_t st) {
  constexpr int smem = tc_smem_bytes<ST, MT, BITS, PARTS, SUMS>();
  static_assert(PARTS == 3 || smem <= 48 * 1024, "bf16 x's ring fits the default 48 KB");
  const int m_tiles = (M + 16 * MT - 1) / (16 * MT);
  const int nb = K / 32;
  const int per = (nb + ksplit - 1) / ksplit;
  dim3 grid(((N + kTcCols - 1) / kTcCols) * m_tiles, ksplit);
  kernel<<<grid, kTcThreads, smem, st>>>(static_cast<const __nv_bfloat16*>(x),
                                         static_cast<const uint8_t*>(q), static_cast<const ST*>(s),
                                         out, ksplit > 1 ? ws : nullptr, xsum, M, K, N, per,
                                         m_tiles);
}

}  // namespace
