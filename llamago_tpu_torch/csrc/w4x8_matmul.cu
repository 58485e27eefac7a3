// K5 and K6: the w4x8 int4 matmuls for Hopper (sm_90a).
//
// Weight format (llamago_tpu_torch/ops/quant.py quantize_w4x8): centered
// int4 values -8..7, packed uint8 [K/2, N] row-major with byte r of a column
// holding rows 2r (low nibble) and 2r+1 (high nibble); one bf16 scale per
// 128-row group and column, stored as [K/64, N] with rows 2g and 2g+1 equal.
// These kernels read row 2g only.
//
// K5, W4A8 decode matmul (replaces llamago_tpu/ops/kernels.py
// _w4x8_decode_kernel and the activation quantization of its launcher
// _w4x8_matmul_2d):
//   per (row m, group g): sx = amax|x| * fl(1/127) (1 where amax is 0),
//                         xq = clip(rint(x / sx), -127, 127)     (int8)
//   out[m, n] = sum_g f32(sum_{k in g} xq[m, k] * w[k, n]) * sx[m, g] * s[g, n]
// with an exact int32 dot per group and the sum over groups in f32.
//
// K6, stream matmul for more rows (replaces _w4x8_stream_kernel, launched
// at llamago_tpu/ops/kernels.py:465-479):
//   out[m, n] = sum_k f32(x[m, k]) * (f32(w[k, n]) * f32(s[k / 128, n]))
// in f32, no activation quantization. Both forms are the tensor-core tile
// (w4x8_tc), which computes
//   out[m, n] = sum_g s[g, n] * f32(x_g[m, :] . w_g[:, n])
// over the 128-row groups g: bf16 x and the int4 values are exact in bf16,
// every product is exact in f32 and each group's dot is summed in f32, so
// this is the function above with its f32 sums in another order; no w * s
// is rounded to bf16, and the output is rounded to bf16 once. f32 x (form
// f32_tc) goes in as its three exact bf16 parts, hi + mid + lo == x
// (tc_common.cuh split3), each dotted with the same weights into the same
// group sum, and the output stays f32. The caller (ops/kernels.py,
// w4x8_form) picks the form and passes it in; the entry point refuses a
// form the dtype does not allow.
//
// x: f32 or bf16 [M, K] row-major; out: x's dtype [M, N]. K % 128 == 0,
// N % 16 == 0.
//
// What bounds them: K5 runs every decode step at M = number of slots
// (<= 16): 4*M integer operations per weight byte, far below the card's
// ridge, so its bound is the packed weight stream (K*N/2 bytes) plus the
// scales over device-memory bandwidth. K6 runs prefill windows (M > 16):
// the same bytes with 4*M bf16 operations per byte, 256 at a 64-token
// chunk, under the card's bf16 ridge of ~295, so bytes bound it there; at
// M = 256 the bf16 operations do. On f32 FMA (67 TFLOP/s) the operations
// would bound it at fifteen times the bf16 time.
//
// What the design does about it:
//  * K5 is three launches from one entry point. w4x8_quant_x quantizes x
//    with one warp per (row, group): the rounding decisions (rintf, IEEE
//    division, the product by fl(1/127)) are the plain version's bit for
//    bit; for the matmul it lays sx out as [groups, slots]. w4x8_a8_tc is
//    the int8 tensor-core decode form (decode_i8_tc.cuh, its int4 format):
//    the packed weight rows stream in by TMA bulk copies (L2 evict_first)
//    into a ring, the weights are the A operand of mma.sync.m16n8k32 on
//    int8 (a nibble moved to the high half of its byte is 16 times its
//    value, so a packed byte needs one shift or mask to reach the tensor
//    core, and the exact int32 sum is shifted back), the slots are the n8
//    columns of B (one n8 tile up to 8 rows, two up to 16: the weights are
//    read once), and each 128-row group's int32 sum is folded with sx * s
//    into the f32 output sum. K is split at whole groups into one wave of
//    blocks (ops/kernels.py a8_split_for), and w4x8_reduce adds the splits'
//    partials in a fixed order (no atomics: the same result from run to
//    run).
//  * K6's tensor-core tile is K1's dq_tc skeleton (dequant_matmul.cu; the
//    PTX wrappers in tc_common.cuh) on the w4x8 layout, its dot on
//    mma.sync.m16n8k16 (bf16 in, f32 accumulate). 128 threads own 128
//    columns and 16, 32 or 64 rows; a two-deep cp.async ring stages whole
//    128-row groups (64 packed rows, the scale row 2g, x's 128 columns of
//    the block's rows), and A fragments come by ldmatrix from padded x
//    rows. A byte holds rows 2r and 2r+1 of one column, the (k, k+1) pair
//    of one mma B register: at k16 step t of a group a thread's b0 is
//    packed row 8t + tig and its b1 packed row 8t + tig + 4, and one 32-bit
//    shared-memory read gives 4 neighbouring columns, each column gid of
//    one n8 tile (output columns permuted as in dq_tc, so a thread owns 8
//    neighbours and their 8 scales). A byte becomes its bf16 pair exactly
//    in one PRMT, one LOP3 and one HSUB2. The group's 8 k16 steps sum into
//    a zeroed f32 group sum, which is then multiplied by the group's scale
//    and added to the output sum: one fold and one barrier per 128 rows of
//    K, where dq_tc has them per 32. A stage at 64 rows is 27.9 KB, so the
//    ring (55.8 KB) is more than the default 48 KB of dynamic shared memory
//    and the kernel opts in once per template instance
//    (cudaFuncAttributeMaxDynamicSharedMemorySize); stages of half a group
//    would fit under 48 KB but bring back a barrier every 64 rows. Two
//    stages, not three, let three blocks share an SM (its registers hold
//    three of 167 a thread): on the card that took 7% off a 7B pass at
//    M = 64 and 11% at M = 256. Where the output tiles give fewer than two
//    blocks per SM, K is split at whole groups for one wave of three
//    blocks per SM (ops/kernels.py, tc_split_for) and w4x8_reduce adds the
//    partials in a fixed order. wgmma and TMA are later work.
//  * K6 with f32 x (the --dtype float32 route; it replaces the TPU kernel
//    above for f32 x) runs the same tile on x's three bf16 parts: the bf16
//    tensor cores cannot take f32 x without rounding it, and f32 FMA (67
//    TFLOP/s) would bound a 7B pass at 12.6 ms at M = 64. What bounds it:
//    three bf16 passes, 6*M operations per weight at 989 TFLOP/s (2.57 ms a
//    7B pass at M = 64, 10.26 at M = 256; the packed bytes only under about
//    26 rows). What the design does: one small launch (split_x3) writes the
//    three planes into the front of the workspace, the ring stages all
//    three beside the group's weights, and each pair of B fragments built
//    from the packed bytes feeds three mma an m16 tile, lo, then mid, then
//    hi, into the same zeroed group sum: a nibble is decoded once for three
//    products. Three planes of 64 rows would make a stage 61 KB (one block
//    an SM), so blocks take 32 rows (36 KB a stage, three blocks an SM).
//    The split of K (ops/kernels.py, tc_split_for with 32-row tiles) and its
//    fixed-order reduce are the bf16 tile's.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry points return cudaGetLastError() after their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_i8_tc.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kGroup = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------- K5: x -> int8

// One warp per (row, group); a lane takes 4 consecutive values. sx of row
// m, group g goes to sx[m * sx_m + g * sx_g].
template <typename XT>
__global__ void __launch_bounds__(128) w4x8_quant_x(const XT* __restrict__ x,
                                                    int8_t* __restrict__ xq,
                                                    float* __restrict__ sx, int M, int K,
                                                    int sx_m, int sx_g) {
  const int lane = threadIdx.x & 31;
  const int G = K / kGroup;
  const int item = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (item >= M * G) return;
  const int m = item / G, g = item % G;
  const size_t off = (size_t)m * K + (size_t)g * kGroup + lane * 4;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = to_f(x[off + i]);
  float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, d));
  const float inv127 = 1.0f / 127.0f;  // rounded to f32 once, as the reference's product
  const float s = amax > 0.f ? __fmul_rn(amax, inv127) : 1.0f;
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
    packed |= ((uint32_t)(uint8_t)(int8_t)(int)r) << (8 * i);
  }
  *reinterpret_cast<uint32_t*>(xq + off) = packed;
  if (lane == 0) sx[(size_t)m * sx_m + (size_t)g * sx_g] = s;
}

// ------------------------------------------------------------- K5: the matmul

// The int8 tensor-core decode form on the w4x8 layout: grid = (ceil(N/512),
// ksplit, ceil(M / (8 NT))), f32 partials [ksplit, M, N] to a.dst.
template <int NT>
__global__ void __launch_bounds__(kItThreads, it_blocks_per_sm<NT>())
    w4x8_a8_tc(const __grid_constant__ ItArgs a) {
  decode_i8tc_body<kItI4, NT>(a);
}

// out[i] = sum over the ksplit partials, in order.
template <typename OT>
__global__ void w4x8_reduce(const float* __restrict__ ws, OT* __restrict__ out, size_t mn,
                            int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float a = 0.f;
  for (int y = 0; y < ksplit; ++y) a += ws[(size_t)y * mn + i];
  out[i] = from_f<OT>(a);
}

template <int NT>
cudaError_t launch_a8_tc(const ItArgs& a, int M, int ksplit, cudaStream_t st) {
  constexpr int smem = it_smem_bytes<kItI4>();
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(w4x8_a8_tc<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((a.N + kItBlockCols - 1) / kItBlockCols, ksplit, (M + 8 * NT - 1) / (8 * NT));
  w4x8_a8_tc<NT><<<grid, kItThreads, smem, st>>>(a);
  return cudaSuccess;
}

template <typename XT>
void quant_x(const void* x, int8_t* xq, float* sx, int M, int K, int sx_m, int sx_g,
             cudaStream_t st) {
  const int items = M * (K / kGroup);
  w4x8_quant_x<XT><<<(items + 3) / 4, 128, 0, st>>>(static_cast<const XT*>(x), xq, sx, M, K,
                                                    sx_m, sx_g);
}

// ------------------------------------------------ K6: tensor cores (w4x8_tc)

constexpr int kTcThreads = 128;       // four warps, 32 columns each
constexpr int kTcCols = 128;          // columns per block
constexpr int kTcStages = 2;          // 128-row groups in the cp.async ring
constexpr int kTcWRows = kGroup / 2;  // packed weight rows of a group
// weight row stride (bytes): the packed rows 8t + tig (tig = 0..3) a warp
// reads at once fall in disjoint 8-bank windows, so its 32-bit reads are
// free of bank conflicts
constexpr int kTcWLd = kTcCols + 32;
constexpr int kTcXLd = kGroup + 8;  // x row stride (bf16, 272 bytes): conflict-free ldmatrix

// One ring stage: a group's packed weights, its scale row, then x's PARTS
// planes of 16 * MT rows.
template <int MT, int PARTS> __host__ __device__ constexpr int tc_stage_bytes() {
  return kTcWRows * kTcWLd + kTcCols * 2 + PARTS * 16 * MT * kTcXLd * 2;
}

// The four bytes of a packed word (4 neighbouring columns of packed row r:
// row 2r in the low nibbles, 2r+1 in the high, two's-complement int4) as
// four bf16 pairs, pair j from byte j, row 2r in the low half: the layout of
// an mma B register. Exact: (nibble & 0xF) ^ 0x4308 is the bf16 128 + (n +
// 8) for the int4 value n, and 136 (0x4308) comes off in bf16.
__device__ __forceinline__ void w4_pairs(uint32_t w, uint32_t (&b)[4]) {
  const uint32_t h = w >> 4;  // byte j of h holds byte j's high nibble in its low bits
  const uint32_t c = 0x43084308u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t t = __byte_perm(w, h, j | ((4 + j) << 8));  // bytes 0 and 2
    const uint32_t v = (t & 0x000F000Fu) ^ 0x43084308u;
    const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                     *reinterpret_cast<const __nv_bfloat162*>(&c));
    b[j] = *reinterpret_cast<const uint32_t*>(&r);
  }
}

// grid = (ceil(N/128) * m_tiles, ksplit), block = 128 threads, dynamic
// shared memory kTcStages * tc_stage_bytes<MT, PARTS>. Block x covers
// column strip x / m_tiles and rows 16*MT*(x % m_tiles) on; block y the
// groups [y*per, (y+1)*per). Warp w owns columns 32w..32w+31 of the strip
// and all 16*MT rows. x holds PARTS bf16 planes of [M, K]: bf16 x itself
// (PARTS 1, out bf16), or the parts hi, mid, lo of f32 x (PARTS 3, out
// f32). Writes to out, or f32 partials to ws[y] when ws is set.
template <int MT, int PARTS>
__global__ void __launch_bounds__(kTcThreads) w4x8_tc(const __nv_bfloat16* __restrict__ x,
                                                      const uint8_t* __restrict__ q,
                                                      const __nv_bfloat16* __restrict__ s,
                                                      void* __restrict__ out,
                                                      float* __restrict__ ws, int M, int K,
                                                      int N, int per, int m_tiles) {
  constexpr int BM = 16 * MT;
  constexpr int W_BYTES = kTcWRows * kTcWLd;
  constexpr int S_BYTES = kTcCols * 2;
  constexpr int STAGE = tc_stage_bytes<MT, PARTS>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int n0 = (blockIdx.x / m_tiles) * kTcCols;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int g0 = blockIdx.y * per;
  const int n_it = min(per, K / kGroup - g0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // Group g into ring slot `slot`. Columns past N are not copied (their
  // outputs are not stored); rows past M repeat row M-1 (likewise).
  auto load = [&](int slot, int g) {
    unsigned char* st = smem + slot * STAGE;
#pragma unroll
    for (int i = 0; i < kTcWRows * 8 / kTcThreads; ++i) {
      const int c = tid + i * kTcThreads;  // 8 copies of 16 bytes per packed row
      const int r = c >> 3, n = n0 + (c & 7) * 16;
      if (n < N)
        cp_async16(st + r * kTcWLd + (c & 7) * 16, q + (size_t)(g * kTcWRows + r) * N + n);
    }
    if (tid < kTcCols / 8) {
      const int n = n0 + tid * 8;
      if (n < N) cp_async16(st + W_BYTES + tid * 16, s + (size_t)(2 * g) * N + n);
    }
#pragma unroll
    for (int i = 0; i < PARTS * BM * 16 / kTcThreads; ++i) {
      const int c = tid + i * kTcThreads;  // 16 copies of 16 bytes per row of a plane
      const int r = c >> 4, m = min(m0 + r % BM, M - 1);  // row r % BM of plane r / BM
      cp_async16(st + W_BYTES + S_BYTES + r * (kTcXLd * 2) + (c & 15) * 16,
                 x + (size_t)(r / BM) * M * K + (size_t)m * K + (size_t)g * kGroup +
                     (c & 15) * 8);
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
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (i < n_it) load(i, g0 + i);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // group `it` has landed; slot (it-1) % stages is free
    if (it + kTcStages - 1 < n_it) load((it + kTcStages - 1) % kTcStages, g0 + it + kTcStages - 1);
    cp_async_commit();

    const unsigned char* st = smem + (it % kTcStages) * STAGE;
    // this thread's 4 columns 32*warp + 4*gid .. +3 of packed row tig
    const unsigned char* wt = st + tig * kTcWLd + warp * 32 + gid * 4;
    const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(st + W_BYTES + S_BYTES);
    float part[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int t = 0; t < kGroup / 16; ++t) {
      // b0[j] / b1[j]: rows 16t + 2*tig + {0, 1} / + {8, 9} of n8 tile j
      uint32_t b0[4], b1[4];
      w4_pairs(*reinterpret_cast<const uint32_t*>(wt + 8 * t * kTcWLd), b0);
      w4_pairs(*reinterpret_cast<const uint32_t*>(wt + (8 * t + 4) * kTcWLd), b1);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // the planes lo, mid, hi (f32 x) against the same B fragments, into
        // the same group sum
#pragma unroll
        for (int p = PARTS - 1; p >= 0; --p) {
          uint32_t a[4];
          ldmatrix_x4(a, xt + (p * BM + i * 16 + (lane & 15)) * kTcXLd + t * 16 +
                             (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], a, b0[j], b1[j]);
        }
      }
    }

    // c0 / c2 of tile j are column 8*tig + j, c1 / c3 column 8*tig + 4 + j
    float sc[8];
    smem_scales8(reinterpret_cast<const __nv_bfloat16*>(st + W_BYTES) + warp * 32 + tig * 8, sc);
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

template <int MT, int PARTS>
cudaError_t launch_tc_rows(const __nv_bfloat16* x, const uint8_t* q, const __nv_bfloat16* s,
                           void* out, float* ws, int M, int K, int N, int ksplit,
                           cudaStream_t st) {
  constexpr int smem = kTcStages * tc_stage_bytes<MT, PARTS>();
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      w4x8_tc<MT, PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const int m_tiles = (M + 16 * MT - 1) / (16 * MT);
  const int G = K / kGroup;
  const int per = (G + ksplit - 1) / ksplit;
  dim3 grid(((N + kTcCols - 1) / kTcCols) * m_tiles, ksplit);
  w4x8_tc<MT, PARTS><<<grid, kTcThreads, smem, st>>>(x, q, s, out, ksplit > 1 ? ws : nullptr, M,
                                                     K, N, per, m_tiles);
  if (ksplit > 1) {
    const size_t mn = (size_t)M * N;
    const unsigned blocks = (unsigned)((mn + 255) / 256);
    if constexpr (PARTS == 3)
      w4x8_reduce<float><<<blocks, 256, 0, st>>>(ws, static_cast<float*>(out), mn, ksplit);
    else
      w4x8_reduce<__nv_bfloat16><<<blocks, 256, 0, st>>>(ws, static_cast<__nv_bfloat16*>(out),
                                                         mn, ksplit);
  }
  return cudaSuccess;
}

// bf16 x: 16 rows per block up to M = 16, 32 up to 32, else 64 (several M
// tiles). f32 x's three planes: 16 rows up to M = 16, else 32, so that a
// stage (36 KB at 32 rows) leaves three blocks an SM.
template <int PARTS>
cudaError_t launch_tc(const __nv_bfloat16* x, const void* q, const void* s, void* out, float* ws,
                      int M, int K, int N, int ksplit, cudaStream_t st) {
  const auto* qq = static_cast<const uint8_t*>(q);
  const auto* ss = static_cast<const __nv_bfloat16*>(s);
  if (M <= 16) return launch_tc_rows<1, PARTS>(x, qq, ss, out, ws, M, K, N, ksplit, st);
  if constexpr (PARTS == 3) {
    return launch_tc_rows<2, 3>(x, qq, ss, out, ws, M, K, N, ksplit, st);
  } else {
    if (M <= 32) return launch_tc_rows<2, 1>(x, qq, ss, out, ws, M, K, N, ksplit, st);
    return launch_tc_rows<4, 1>(x, qq, ss, out, ws, M, K, N, ksplit, st);
  }
}

// The forms, as ops/kernels.py's W4X8_FORMS numbers them. K5 ("a8", the
// int8 tensor-core decode form) has an entry point of its own.
enum W4x8Form { kA8 = 0, kF32Tc = 1, kTensorCore = 2 };

}  // namespace

// K5's activation quantization alone: xq int8 [M, K], sx f32 [M, K/128].
extern "C" int llamago_w4x8_quantize_x(const void* x, void* xq, void* sx, int M, int K,
                                       int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = K / kGroup;
  if (x_bf16)
    quant_x<__nv_bfloat16>(x, static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, G, 1, st);
  else
    quant_x<float>(x, static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, G, 1, st);
  return (int)cudaGetLastError();
}

// K5. xq (int8 [M, K]), sx (f32 [K/128, Mp], Mp = M rounded up to 8 for M
// <= 8, else to 16) and ws (f32 [ksplit, M, N]) are scratch. `gpb` groups
// per K-split, ksplit * gpb >= K/128 > (ksplit - 1) * gpb. x_bf16: 1 for
// bfloat16, 0 for float32. Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int llamago_w4x8_matmul_a8(const void* x, const void* q, const void* s, void* out,
                                      void* xq, void* sx, void* ws, int M, int K, int N,
                                      int x_bf16, int ksplit, int gpb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = K / kGroup;
  if (M < 1 || K < kGroup || K % kGroup || N < 16 || N % 16 || ksplit < 1 || gpb < 1 ||
      (long long)ksplit * gpb < G || (long long)(ksplit - 1) * gpb >= G)
    return (int)cudaErrorInvalidValue;
  const int nt = M > 8 ? 2 : 1;
  const int mp = (M + 8 * nt - 1) / (8 * nt) * (8 * nt);
  int8_t* xq8 = static_cast<int8_t*>(xq);
  float* sxf = static_cast<float*>(sx);
  float* wsf = static_cast<float*>(ws);
  if (x_bf16)
    quant_x<__nv_bfloat16>(x, xq8, sxf, M, K, 1, mp, st);
  else
    quant_x<float>(x, xq8, sxf, M, K, 1, mp, st);
  const size_t mn = (size_t)M * N;
  ItArgs a{};
  a.xq = xq8, a.sx = sxf, a.sx_ld = mp;
  a.q = static_cast<const uint8_t*>(q), a.s = static_cast<const __nv_bfloat16*>(s);
  a.dst = wsf, a.dst_split = mn;
  a.xlayout = kItXRows, a.tm = M, a.K = K, a.N = N, a.per = 4 * gpb;
  a.sg = 4, a.tile = 4, a.tile_rows = 2;  // group g: 4 steps, scale row 2g
  const cudaError_t e = nt == 1 ? launch_a8_tc<1>(a, M, ksplit, st)
                                : launch_a8_tc<2>(a, M, ksplit, st);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((mn + 255) / 256);
  if (x_bf16)
    w4x8_reduce<__nv_bfloat16><<<blocks, 256, 0, st>>>(wsf, static_cast<__nv_bfloat16*>(out),
                                                       mn, ksplit);
  else
    w4x8_reduce<float><<<blocks, 256, 0, st>>>(wsf, static_cast<float*>(out), mn, ksplit);
  return (int)cudaGetLastError();
}

// K6. x_bf16: 1 for bfloat16, 0 for float32. form: 1 the tensor-core tile
// on f32 x's three bf16 parts, 2 the tensor-core tile (bf16 x). `ws` is an
// f32 workspace: for form 2 of ksplit*M*N elements, used when ksplit > 1;
// for form 1 the three planes (3*M*K bf16, 1.5*M*K f32 elements) and then,
// when ksplit > 1, ksplit*M*N elements. A split holds ceil(K/128 / ksplit)
// groups. Returns cudaGetLastError() after the launches, the error of a
// refused shared-memory opt-in, or cudaErrorInvalidValue for a form the
// arguments do not allow.
extern "C" int llamago_w4x8_matmul_stream(const void* x, const void* q, const void* s,
                                          void* out, void* ws, int M, int K, int N, int x_bf16,
                                          int form, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if ((form != kF32Tc && form != kTensorCore) || (form == kTensorCore) != (x_bf16 != 0) ||
      M < 1 || ksplit < 1 || ((ksplit > 1 || form == kF32Tc) && w == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (form == kTensorCore) {
    e = launch_tc<1>(static_cast<const __nv_bfloat16*>(x), q, s, out, w, M, K, N, ksplit, st);
  } else {  // its three bf16 planes first, into ws
    const size_t mk = (size_t)M * K;
    uint16_t* planes = reinterpret_cast<uint16_t*>(w);
    split_x3<<<(unsigned)((mk / 4 + 255) / 256), 256, 0, st>>>(static_cast<const float*>(x),
                                                               planes, mk);
    e = launch_tc<3>(reinterpret_cast<const __nv_bfloat16*>(planes), q, s, out, w + mk * 3 / 2,
                     M, K, N, ksplit, st);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
