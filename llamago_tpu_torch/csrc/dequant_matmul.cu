// K1: Q8_0 / Q4_0 dequant-matmul for Hopper (sm_90a).
//
//   out[m, n] = sum_k x[m, k] * (w[k, n] * s[k / 32, n])
//
// x: f32 or bf16 [M, K] row-major; s: f32 or bf16 [K/32, N]; out: x's dtype
// [M, N]. bits=8: q int8 [K, N] row-major, w = q. bits=4: q uint8 [K/2, N],
// where byte j of a 32-row block (packed rows 16b .. 16b+15) holds row
// 32b+j in its low nibble and row 32b+j+16 in its high nibble, w = nibble
// - 8. Every product is exact in f32 and accumulated in f32: the
// tensor-core forms (bf16 x, or f32 x as three exact bf16 parts) sum x * w
// per quant block and multiply each block's sum by s.
//
// Replaces llamago_tpu/ops/kernels.py _dequant_mm_kernel (bits 8 and 4),
// reached through _dequant_matmul_2d and dequant_matmul.
//
// What bounds it: at decode (M = number of slots, <= 8) the work is about
// 2*M flops per weight element, far below the card's ~295 flops/byte ridge,
// so the bound is the weight stream (K*N bytes, or K*N/2) plus its scales
// over device-memory bandwidth. Prefill (M >= 16) moves the same weight
// bytes with M times the flops.
//
// What the design does about it:
//  * M <= 8 with bf16 x (every decode step of the serving path) takes the
//    tensor-core decode form (dq_decode_tc, its body in decode_tc.cuh,
//    shared with K9). A CUDA-core GEMV spends a convert, a scale multiply
//    and M FMAs on each weight, so its time grows with M for the same
//    bytes (on an H100 one took 4.5 ms a 7B step at M = 1 and 14.3 at M =
//    8 with f32 x, PERF.md's K1 rows); here the weights are the A
//    operand of bf16 mma.sync.m16n8k16 (16 output columns by 16 rows of K)
//    and x is B (16 rows of K by 8 columns: the M <= 8 slots, zeros past
//    M), so the work per weight is the same from M = 1 to 8: about 2.5
//    integer and f32 instructions build each exact bf16 pair (int8 by the
//    f32 0x4B0000uu, a Q4_0 nibble by the bf16 0x43nn, as dq_tc builds its
//    B pairs), and a lane needs only the scales of its own 16 columns (C
//    rows are output columns). Per 32-row quant block two k16 mma go into
//    a zeroed block sum that the column's scale folds into the f32 output
//    sum: dq_tc's function. That leaves the weight stream, and how it is
//    fetched bounds the kernel. On an H100, 16-byte cp.async copies of
//    128-byte row pieces, lane by lane, held a 7B step near 4.5 ms at
//    every ring depth, occupancy and layout tried (about 1.6 TB/s); the TMA
//    unit's bulk copies, one 512-byte row of the block's columns each,
//    with the L2 policy evict_first on the weights (read once, so x, the
//    scales and the partials stay), took it to about 3.15 ms (PERF.md,
//    the decode form's tuning round). A block is four warps
//    on 512 neighbouring columns (128 a warp) and a ring of three quant
//    blocks (59 KB for Q8_0 with f32 scales: three blocks an SM), one
//    mbarrier and one block barrier per quant block. K is split
//    (ops/kernels.py, decode_tc_split_for) as far as one wave of blocks
//    holds, and the splits' f32 partials are added in a fixed order by
//    dq_reduce (no atomics).
//  * M <= 8 with f32 x (every decode step of the --dtype float32 route)
//    takes the same decode form on x's three exact bf16 parts
//    (dq_decode_f32tc, form f32_decode_tc): rounding x to bf16 would change
//    the function, but x = hi + mid + lo (tc_common.cuh split3) and each
//    part times an integer weight is exact in f32. x arrives whole by the
//    same bulk copies (128 bytes a slot row; rows 160 bytes apart, so a
//    lane's 8-byte reads fall on distinct banks), each lane splits the 8
//    values of its B fragment in registers (no pre-pass, no planes: one
//    launch a call, and dq_reduce where K is split), and each A fragment,
//    decoded once, feeds three mma, lo, mid, hi, into the same zeroed block
//    sum. The output is f32. The bytes bound it as they bound the bf16
//    form: 3.6-3.8 ms a 7B step for Q8_0 (the bf16 form 3.1), 2.8-2.9 for
//    Q4_0, at 155-161 registers (PERF.md).
//  * M > 8 with bf16 x takes the tensor-core tile (dq_tc). At a prefill
//    chunk (M = 64) the work is still bound by the weight stream (128
//    operations per weight byte, under the card's bf16 ridge of ~295), at
//    M = 256 by the bf16 operations; f32 FMA (67 TFLOP/s) would bound it at
//    five times either. So the block's dot runs on mma.sync.m16n8k16 (bf16
//    in, f32 accumulate). The weights are exact in bf16 (int8, or a nibble
//    - 8) and so is x; every product is exact in f32. Per 32-row quant block
//    two k16 mma steps go into a zeroed block sum, which is then multiplied
//    by the block's scale and added to the output sum: out = sum_b s_b *
//    (x_b . q_b), the TPU kernel's function with its f32 sums in another
//    order, and no q * s product is rounded to bf16. A block owns 64 rows
//    (fewer for M <= 32) by 128 columns and a split of K by whole quant
//    blocks: raw weight bytes, scales and x go from device memory to shared
//    memory by 16-byte cp.async in a ring of four quant blocks, so the next
//    ones load while this one is multiplied. The B fragments are built in
//    registers from 32-bit shared-memory reads of the raw bytes (no bf16
//    copy of the tile, no second pass through shared memory): a thread's
//    word holds 4 neighbouring columns of one row, which become column gid
//    of 4 n8 tiles, so a thread owns 8 neighbouring output columns and
//    their 8 scales. Where the output tiles give fewer than two blocks per
//    SM, K is split (ops/kernels.py, tc_split_for) and the splits write f32
//    partials that dq_reduce adds in a fixed order (no atomics), as the
//    decode form does. The M tiles of one column strip have neighbouring block
//    indices, so for M > 64 the strip comes from device memory once and
//    from L2 after that. wgmma and TMA are later work.
//  * M > 8 with f32 x (the --dtype float32 route) takes the same tile on x's
//    three exact bf16 parts (form f32_tc; it replaces the TPU kernel above
//    for f32 x). Rounding x to bf16 would change the function, and f32 FMA
//    (67 TFLOP/s) would bound a 7B pass at 12.6 ms at M = 64. But the weights
//    are exact in bf16, so x is cut into hi + mid + lo (tc_common.cuh split3:
//    two truncations and one exact rounding; the sum is x bit for bit for
//    every normal x whose low part stays in bf16's range) and each part times
//    a weight is an exact product in f32. What bounds it: three bf16 passes,
//    6*M operations per weight at 989 TFLOP/s (2.57 ms a 7B pass at M = 64,
//    10.26 at M = 256), or the weight bytes where they are larger (Q8_0 under
//    about 52 rows). What the design does: one small launch (split_x3) writes
//    x's three planes into the front of the workspace; dq_tc stages the three
//    planes beside the weights in its ring (three stages of 20 KB at 64 rows;
//    at 64 rows a block three blocks an SM with f32 scales at 168 registers,
//    two with bf16 scales at 224) and runs three mma against each
//    B fragment it builds from the raw bytes, lo, then mid, then hi, into the
//    same zeroed block sum: a weight is decoded once for three products,
//    where the decode is what holds the bf16 tile back (about 290
//    instructions per 32 mma). The scale folds once per quant block, the
//    split of K and its fixed-order reduce are the bf16 tile's, and the
//    output is f32: sum_b s_b * (x_b . q_b), the TPU kernel's function with
//    its f32 sums in another order (and the tensor core's own accumulation).
//
// The caller (llamago_tpu_torch/ops/kernels.py, k1_form) picks the form and
// passes it in; the entry point refuses a form the shapes or dtypes do not
// allow.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_tc.cuh"
#include "tc_common.cuh"

namespace {

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// out[i] = sum over the ksplit partials, in order.
template <typename OT>
__global__ void dq_reduce(const float* __restrict__ ws, OT* __restrict__ out,
                          size_t mn, int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float a = 0.f;
  for (int y = 0; y < ksplit; ++y) a += ws[(size_t)y * mn + i];
  out[i] = from_f<OT>(a);
}

// --------------------------------------------------- tensor cores (dq_tc)

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

// grid = (ceil(N/128) * m_tiles, ksplit), block = 128 threads, dynamic
// shared memory tc_stages * tc_stage_bytes. Block x covers column strip
// x / m_tiles and rows 16*MT*(x % m_tiles) on; block y the quant blocks
// [y*per, (y+1)*per). Warp w owns columns 32w..32w+31 of the strip and all
// 16*MT rows. x holds PARTS bf16 planes of [M, K]: bf16 x itself (PARTS 1,
// out bf16), or the parts hi, mid, lo of f32 x (PARTS 3, out f32). Writes
// to out, or f32 partials to ws[y] when ws is set.
// Blocks an SM the launch bounds ask for, 0 for none. f32 x in 32-row blocks
// asks for three: left to itself ptxas gave one of those instances (Q4_0,
// bf16 scales) 128 registers and a spill; asked for three it takes 130-142
// and none. Every other instance builds as without the bound.
template <int MT, int PARTS> __host__ __device__ constexpr int tc_min_blocks() {
  return PARTS == 3 && MT == 2 ? 3 : 0;
}

template <typename ST, int MT, int BITS, int PARTS>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<MT, PARTS>())
    dq_tc(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
          const ST* __restrict__ s, void* __restrict__ out, float* __restrict__ ws, int M, int K,
          int N, int per, int m_tiles) {
  constexpr int WR = tc_w_rows<BITS>();
  constexpr int BM = 16 * MT;
  constexpr int W_BYTES = WR * kTcWLd;
  constexpr int S_BYTES = kTcCols * (int)sizeof(ST);
  constexpr int STAGE = tc_stage_bytes<ST, MT, BITS, PARTS>();
  constexpr int STAGES = tc_stages<PARTS>();
  constexpr int SV = 16 / (int)sizeof(ST);  // scales per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];

  const int n0 = (blockIdx.x / m_tiles) * kTcCols;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int kb0 = blockIdx.y * per;
  const int n_it = min(per, K / 32 - kb0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // Quant block kb into ring slot `slot`. Columns past N are not copied
  // (their outputs are not stored); rows past M repeat row M-1 (likewise).
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
      b[0][0][0] = q4_pair<0, 0>(p0, p1), b[0][1][0] = q4_pair<0, 0>(p2, p3);
      b[0][0][1] = q4_pair<1, 0>(p0, p1), b[0][1][1] = q4_pair<1, 0>(p2, p3);
      b[0][0][2] = q4_pair<2, 0>(p0, p1), b[0][1][2] = q4_pair<2, 0>(p2, p3);
      b[0][0][3] = q4_pair<3, 0>(p0, p1), b[0][1][3] = q4_pair<3, 0>(p2, p3);
      b[1][0][0] = q4_pair<0, 4>(p0, p1), b[1][1][0] = q4_pair<0, 4>(p2, p3);
      b[1][0][1] = q4_pair<1, 4>(p0, p1), b[1][1][1] = q4_pair<1, 4>(p2, p3);
      b[1][0][2] = q4_pair<2, 4>(p0, p1), b[1][1][2] = q4_pair<2, 4>(p2, p3);
      b[1][0][3] = q4_pair<3, 4>(p0, p1), b[1][1][3] = q4_pair<3, 4>(p2, p3);
    }

    const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(st + W_BYTES + S_BYTES);
    float part[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
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

template <typename ST, int MT, int BITS, int PARTS>
cudaError_t launch_tc_rows(const void* x, const void* q, const void* s, void* out, float* ws,
                           int M, int K, int N, int ksplit, cudaStream_t st) {
  constexpr int smem = tc_stages<PARTS>() * tc_stage_bytes<ST, MT, BITS, PARTS>();
  static_assert(PARTS == 3 || smem <= 48 * 1024, "bf16 x's ring fits the default 48 KB");
  if constexpr (smem > 48 * 1024) {
    // more than 48 KB of dynamic shared memory only after this opt-in, once
    // per template instance
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        dq_tc<ST, MT, BITS, PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (opt_in != cudaSuccess) return opt_in;
  }
  const int m_tiles = (M + 16 * MT - 1) / (16 * MT);
  const int nb = K / 32;
  const int per = (nb + ksplit - 1) / ksplit;
  dim3 grid(((N + kTcCols - 1) / kTcCols) * m_tiles, ksplit);
  dq_tc<ST, MT, BITS, PARTS><<<grid, kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const ST*>(s), out, ksplit > 1 ? ws : nullptr, M, K, N, per, m_tiles);
  if (ksplit > 1) {
    const size_t mn = (size_t)M * N;
    const unsigned blocks = (unsigned)((mn + 255) / 256);
    if constexpr (PARTS == 3)
      dq_reduce<float><<<blocks, 256, 0, st>>>(ws, static_cast<float*>(out), mn, ksplit);
    else
      dq_reduce<__nv_bfloat16><<<blocks, 256, 0, st>>>(ws, static_cast<__nv_bfloat16*>(out),
                                                       mn, ksplit);
  }
  return cudaSuccess;
}

// 16 rows per block up to M = 16, 32 up to 32, else 64 (several M tiles).
template <typename ST, int BITS, int PARTS>
cudaError_t launch_tc(const void* x, const void* q, const void* s, void* out, float* ws, int M,
                      int K, int N, int ksplit, cudaStream_t st) {
  if (M <= 16) return launch_tc_rows<ST, 1, BITS, PARTS>(x, q, s, out, ws, M, K, N, ksplit, st);
  if (M <= 32) return launch_tc_rows<ST, 2, BITS, PARTS>(x, q, s, out, ws, M, K, N, ksplit, st);
  return launch_tc_rows<ST, 4, BITS, PARTS>(x, q, s, out, ws, M, K, N, ksplit, st);
}

// ------------------------------------- tensor cores at decode (dq_decode_tc)

// The form's kernels (decode_tc.cuh): the nibbles of Q4_0 centred, - 8;
// bf16 x (dq_decode_tc, out bf16) or f32 x as three bf16 parts split in
// registers (dq_decode_f32tc, out f32).
template <typename ST, int BITS>
__global__ void __launch_bounds__(kDtThreads, 3) dq_decode_tc(const __nv_bfloat16* __restrict__ x,
                                                              const uint8_t* __restrict__ q,
                                                              const ST* __restrict__ s,
                                                              __nv_bfloat16* __restrict__ out,
                                                              float* __restrict__ ws, int M,
                                                              int K, int N, int per) {
  decode_tc_body<ST, BITS, false>(x, q, s, out, ws, M, K, N, per);
}

template <typename ST, int BITS>
__global__ void __launch_bounds__(kDtThreads, 3) dq_decode_f32tc(const float* __restrict__ x,
                                                                 const uint8_t* __restrict__ q,
                                                                 const ST* __restrict__ s,
                                                                 float* __restrict__ out,
                                                                 float* __restrict__ ws, int M,
                                                                 int K, int N, int per) {
  decode_tc_body<ST, BITS, false, float>(x, q, s, out, ws, M, K, N, per);
}

// The decode form's kernel for x (and out) of type XT.
template <typename XT, typename ST, int BITS> constexpr auto dt_kernel() {
  if constexpr (sizeof(XT) == 4)
    return dq_decode_f32tc<ST, BITS>;
  else
    return dq_decode_tc<ST, BITS>;
}

template <typename XT, typename ST, int BITS>
cudaError_t launch_decode_tc(const void* x, const void* q, const void* s, void* out, float* ws,
                             int M, int K, int N, int ksplit, cudaStream_t st) {
  constexpr int smem = dt_smem_bytes<ST, BITS, XT>();
  constexpr auto kernel = dt_kernel<XT, ST, BITS>();
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const int nb = K / 32;
  const int per = (nb + ksplit - 1) / ksplit;
  dim3 grid((N + kDtBlockCols - 1) / kDtBlockCols, ksplit);
  kernel<<<grid, kDtThreads, smem, st>>>(static_cast<const XT*>(x),
                                         static_cast<const uint8_t*>(q),
                                         static_cast<const ST*>(s), static_cast<XT*>(out),
                                         ksplit > 1 ? ws : nullptr, M, K, N, per);
  if (ksplit > 1) {
    const size_t mn = (size_t)M * N;
    dq_reduce<XT><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, static_cast<XT*>(out), mn,
                                                                ksplit);
  }
  return cudaSuccess;
}

// The forms, as ops/kernels.py's K1_FORMS numbers them; code 0 is K9's
// GEMV (dequant_matmul_so.cu), which K1 no longer has.
enum Form { kGemv = 0, kF32Tc = 1, kTensorCore = 2, kDecodeTc = 3, kF32DecodeTc = 4 };

template <typename XT, typename ST, int BITS>
cudaError_t launch_bits(const void* x, const void* q, const void* s, void* out, float* ws, int M,
                        int K, int N, int form, int ksplit, cudaStream_t st) {
  if constexpr (sizeof(XT) == 2) {  // bf16 x: the bf16 tensor-core forms
    if (form == kDecodeTc)
      return launch_decode_tc<XT, ST, BITS>(x, q, s, out, ws, M, K, N, ksplit, st);
    return launch_tc<ST, BITS, 1>(x, q, s, out, ws, M, K, N, ksplit, st);
  } else if (form == kF32DecodeTc) {  // f32 x up to 8 rows: the decode form on its parts
    return launch_decode_tc<XT, ST, BITS>(x, q, s, out, ws, M, K, N, ksplit, st);
  } else {  // f32 x on the tensor cores: its three bf16 planes first, into ws
    const size_t mk = (size_t)M * K;
    uint16_t* planes = reinterpret_cast<uint16_t*>(ws);
    split_x3<<<(unsigned)((mk / 4 + 255) / 256), 256, 0, st>>>(static_cast<const float*>(x),
                                                               planes, mk);
    return launch_tc<ST, BITS, 3>(planes, q, s, out, ws + mk * 3 / 2, M, K, N, ksplit, st);
  }
}

template <typename XT, typename ST>
cudaError_t launch(const void* x, const void* q, const void* s, void* out, float* ws, int M,
                   int K, int N, int bits, int form, int ksplit, cudaStream_t st) {
  if (bits == 8) return launch_bits<XT, ST, 8>(x, q, s, out, ws, M, K, N, form, ksplit, st);
  return launch_bits<XT, ST, 4>(x, q, s, out, ws, M, K, N, form, ksplit, st);
}

}  // namespace

// bits: 8 (q int8 [K, N]) or 4 (q uint8 [K/2, N]). x_bf16 / s_bf16: 1 for
// bfloat16, 0 for float32. form: with f32 x 1 the tensor-core tile on x's
// three bf16 parts or 4 the tensor-core decode form on them (M <= 8); with
// bf16 x 2 the tensor-core tile or 3 the tensor-core decode form (M <= 8);
// 0 (K9's GEMV) is refused. `ws` is an f32 workspace: of ksplit*M*N
// elements for the tensor-core tile with bf16 x and both decode forms when
// ksplit > 1; for form 1 the three planes (3*M*K bf16, 1.5*M*K f32
// elements) and then, when ksplit > 1, ksplit*M*N elements. A split holds
// ceil(K/32 / ksplit) quant blocks. Returns cudaGetLastError() after the
// launches, the error of a refused shared-memory opt-in, or
// cudaErrorInvalidValue for a form the arguments do not allow.
extern "C" int llamago_dequant_matmul(const void* x, const void* q, const void* s,
                                      void* out, void* ws, int M, int K, int N, int bits,
                                      int x_bf16, int s_bf16, int form, int ksplit,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const bool bf16_form = form == kTensorCore || form == kDecodeTc;
  if ((bits != 8 && bits != 4) || form < kF32Tc || form > kF32DecodeTc ||
      ((form == kDecodeTc || form == kF32DecodeTc) && M > 8) || bf16_form != (x_bf16 != 0) ||
      ksplit < 1 || ((ksplit > 1 || form == kF32Tc) && w == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (x_bf16 && s_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, w, M, K, N, bits, form, ksplit, st);
  else if (x_bf16)
    err = launch<__nv_bfloat16, float>(x, q, s, out, w, M, K, N, bits, form, ksplit, st);
  else if (s_bf16)
    err = launch<float, __nv_bfloat16>(x, q, s, out, w, M, K, N, bits, form, ksplit, st);
  else
    err = launch<float, float>(x, q, s, out, w, M, K, N, bits, form, ksplit, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
