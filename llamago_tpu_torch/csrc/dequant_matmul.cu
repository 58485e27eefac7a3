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
//  * M > 8 with bf16 x takes the tensor-core tile (dq_tc, its body in
//    tile_tc.cuh, shared with K9). At a prefill
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
#include "tile_tc.cuh"

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

// The tile (tile_tc.cuh) with K1's weights: Q4_0's nibbles centred, - 8.
// `xsum` is not read (the centred nibbles need no row sums).
template <typename ST, int MT, int BITS, int PARTS>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<MT, PARTS>())
    dq_tc(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
          const ST* __restrict__ s, void* __restrict__ out, float* __restrict__ ws,
          const float* __restrict__ xsum, int M, int K, int N, int per, int m_tiles) {
  tile_tc_body<ST, MT, BITS, PARTS, false>(x, q, s, out, ws, xsum, M, K, N, per, m_tiles);
}

template <typename ST, int MT, int BITS, int PARTS>
cudaError_t launch_tc_rows(const void* x, const void* q, const void* s, void* out, float* ws,
                           int M, int K, int N, int ksplit, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes<ST, MT, BITS, PARTS>();
  if constexpr (smem > 48 * 1024) {
    // more than 48 KB of dynamic shared memory only after this opt-in, once
    // per template instance
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        dq_tc<ST, MT, BITS, PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (opt_in != cudaSuccess) return opt_in;
  }
  tile_launch<ST, MT, BITS, PARTS, false>(dq_tc<ST, MT, BITS, PARTS>, x, q, s, out, ws, nullptr,
                                          M, K, N, ksplit, st);
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

// The forms, as ops/kernels.py's K1_FORMS numbers them (K9's entry point
// takes the same four codes; code 0 was K9's GEMV, which is gone).
enum Form { kF32Tc = 1, kTensorCore = 2, kDecodeTc = 3, kF32DecodeTc = 4 };

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
// bf16 x 2 the tensor-core tile or 3 the tensor-core decode form (M <= 8).
// `ws` is an f32 workspace: of ksplit*M*N elements for the tensor-core tile
// with bf16 x and both decode forms when ksplit > 1; for form 1 the three
// planes (3*M*K bf16, 1.5*M*K f32 elements) and then, when ksplit > 1,
// ksplit*M*N elements. A split holds
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
