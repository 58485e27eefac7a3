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
// in f32, no activation quantization. bf16 x takes the tensor-core tile
// (w4x8_tc), which computes
//   out[m, n] = sum_g s[g, n] * f32(x_g[m, :] . w_g[:, n])
// over the 128-row groups g: bf16 x and the int4 values are exact in bf16,
// every product is exact in f32 and each group's dot is summed in f32, so
// this is the function above with its f32 sums in another order; no w * s
// is rounded to bf16, and the output is rounded to bf16 once. f32 x takes
// the f32 tile (w4x8_stream): the bf16 tensor cores cannot take it without
// rounding it. The caller (ops/kernels.py, w4x8_form) picks the form and
// passes it in; the entry point refuses a form the dtype does not allow.
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
//  * K6's f32 tile (f32 x only) is a plain shared-memory tiled f32 kernel
//    (64x64 output tile, 32 rows of K per step, 4x4 outputs per thread);
//    each packed byte is read once and gives two rows of the tile.
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

// ----------------------------------------------------- K6: the f32 tile

constexpr int kTM = 64, kTN = 64, kTK = 32;

// f32 x and out. grid = (ceil(N/64), ceil(M/64)), block = 256 threads
// (16 x 16), 4 x 4 outputs each.
__global__ void __launch_bounds__(256) w4x8_stream(const float* __restrict__ x,
                                                   const uint8_t* __restrict__ q,
                                                   const __nv_bfloat16* __restrict__ s,
                                                   float* __restrict__ out, int M, int K,
                                                   int N) {
  __shared__ float xs[kTK][kTM + 4];
  __shared__ float wsh[kTK][kTN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < (kTM * kTK) / 256; ++i) {
      const int idx = tid + 256 * i;
      const int r = idx / kTK, c = idx % kTK;
      const int m = m0 + r;
      xs[c][r] = (m < M) ? x[(size_t)m * K + k0 + c] : 0.f;
    }
    const size_t srow = (size_t)(2 * (k0 / kGroup)) * N;  // a tile lies in one group
#pragma unroll
    for (int i = 0; i < (kTK / 2 * kTN) / 256; ++i) {
      const int idx = tid + 256 * i;
      const int pr = idx / kTN, c = idx % kTN;
      const int n = n0 + c;
      float lo = 0.f, hi = 0.f;
      if (n < N) {
        const uint32_t byte = q[(size_t)(k0 / 2 + pr) * N + n];
        const float sc = __bfloat162float(s[srow + n]);
        lo = (float)((int)((byte & 0xFu) ^ 8u) - 8) * sc;
        hi = (float)((int)((byte >> 4) ^ 8u) - 8) * sc;
      }
      wsh[2 * pr][c] = lo;
      wsh[2 * pr + 1][c] = hi;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wsh[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
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

// One ring stage: a group's packed weights, its scale row, then x (16 * MT rows).
template <int MT> __host__ __device__ constexpr int tc_stage_bytes() {
  return kTcWRows * kTcWLd + kTcCols * 2 + 16 * MT * kTcXLd * 2;
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
// shared memory kTcStages * tc_stage_bytes<MT>. Block x covers column
// strip x / m_tiles and rows 16*MT*(x % m_tiles) on; block y the groups
// [y*per, (y+1)*per). Warp w owns columns 32w..32w+31 of the strip and all
// 16*MT rows. Writes bf16 to out, or f32 partials to ws[y] when ws is set.
template <int MT>
__global__ void __launch_bounds__(kTcThreads) w4x8_tc(const __nv_bfloat16* __restrict__ x,
                                                      const uint8_t* __restrict__ q,
                                                      const __nv_bfloat16* __restrict__ s,
                                                      __nv_bfloat16* __restrict__ out,
                                                      float* __restrict__ ws, int M, int K,
                                                      int N, int per, int m_tiles) {
  constexpr int BM = 16 * MT;
  constexpr int W_BYTES = kTcWRows * kTcWLd;
  constexpr int S_BYTES = kTcCols * 2;
  constexpr int STAGE = tc_stage_bytes<MT>();
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
    for (int i = 0; i < BM * 16 / kTcThreads; ++i) {
      const int c = tid + i * kTcThreads;  // 16 copies of 16 bytes per row
      const int r = c >> 4, m = min(m0 + r, M - 1);
      cp_async16(st + W_BYTES + S_BYTES + r * (kTcXLd * 2) + (c & 15) * 16,
                 x + (size_t)m * K + (size_t)g * kGroup + (c & 15) * 8);
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
        uint32_t a[4];
        ldmatrix_x4(a, xt + (i * 16 + (lane & 15)) * kTcXLd + t * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], a, b0[j], b1[j]);
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
      if (ws != nullptr) {
        float4* p = reinterpret_cast<float4*>(ws + (size_t)blockIdx.y * M * N + (size_t)m * N + n);
        p[0] = make_float4(v[0], v[1], v[2], v[3]);
        p[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        *reinterpret_cast<uint4*>(out + (size_t)m * N + n) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                       pack_bf16(v[6], v[7]));
      }
    }
}

template <int MT>
cudaError_t launch_tc_rows(const __nv_bfloat16* x, const uint8_t* q, const __nv_bfloat16* s,
                           __nv_bfloat16* out, float* ws, int M, int K, int N, int ksplit,
                           cudaStream_t st) {
  constexpr int smem = kTcStages * tc_stage_bytes<MT>();
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(w4x8_tc<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const int m_tiles = (M + 16 * MT - 1) / (16 * MT);
  const int G = K / kGroup;
  const int per = (G + ksplit - 1) / ksplit;
  dim3 grid(((N + kTcCols - 1) / kTcCols) * m_tiles, ksplit);
  w4x8_tc<MT><<<grid, kTcThreads, smem, st>>>(x, q, s, out, ksplit > 1 ? ws : nullptr, M, K, N,
                                              per, m_tiles);
  if (ksplit > 1) {
    const size_t mn = (size_t)M * N;
    w4x8_reduce<__nv_bfloat16><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, out, mn, ksplit);
  }
  return cudaSuccess;
}

// 16 rows per block up to M = 16, 32 up to 32, else 64 (several M tiles).
cudaError_t launch_tc(const void* x, const void* q, const void* s, void* out, float* ws, int M,
                      int K, int N, int ksplit, cudaStream_t st) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qq = static_cast<const uint8_t*>(q);
  const auto* ss = static_cast<const __nv_bfloat16*>(s);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (M <= 16) return launch_tc_rows<1>(xb, qq, ss, ob, ws, M, K, N, ksplit, st);
  if (M <= 32) return launch_tc_rows<2>(xb, qq, ss, ob, ws, M, K, N, ksplit, st);
  return launch_tc_rows<4>(xb, qq, ss, ob, ws, M, K, N, ksplit, st);
}

// The forms, as ops/kernels.py's W4X8_FORMS numbers them. K5 ("a8", the
// int8 tensor-core decode form) has an entry point of its own.
enum W4x8Form { kA8 = 0, kTiledF32 = 1, kTensorCore = 2 };

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

// K6. x_bf16: 1 for bfloat16, 0 for float32. form: 1 the f32 tile (f32 x,
// ksplit 1), 2 the tensor-core tile (bf16 x). `ws` is an f32 workspace of
// ksplit*M*N elements, used by the tensor-core tile when ksplit > 1; a split
// holds ceil(K/128 / ksplit) groups. Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a form the arguments do not allow.
extern "C" int llamago_w4x8_matmul_stream(const void* x, const void* q, const void* s,
                                          void* out, void* ws, int M, int K, int N, int x_bf16,
                                          int form, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if ((form != kTiledF32 && form != kTensorCore) || (form == kTensorCore) != (x_bf16 != 0) ||
      M < 1 || ksplit < 1 || (form == kTiledF32 && ksplit != 1) || (ksplit > 1 && w == nullptr))
    return (int)cudaErrorInvalidValue;
  if (form == kTensorCore) {
    const cudaError_t e = launch_tc(x, q, s, out, w, M, K, N, ksplit, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  w4x8_stream<<<grid, 256, 0, st>>>(static_cast<const float*>(x), static_cast<const uint8_t*>(q),
                                    static_cast<const __nv_bfloat16*>(s),
                                    static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}
