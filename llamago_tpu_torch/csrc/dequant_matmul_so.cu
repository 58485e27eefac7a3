// K9: scale-on-output Q8_0 / Q4_0 matmul for Hopper (sm_90a).
//
//   out[m, n] = sum_b s[b, n] * ( sum_{k in block b} x[m, k] * raw[k, n]
//                                 - (bits == 4 ? 8 * sum_{k in block b} x[m, k] : 0) )
//
// over the 32-row quant blocks b: the raw integers (int8 for Q8_0, the
// nibbles 0..15 for Q4_0) are dotted with the block's x in f32, the Q4_0
// offset of 8 is taken off through the block's sum of x, and the block's
// scale is applied once to the partial product instead of to every weight.
// x: f32 or bf16 [M, K] row-major; q: int8 [K, N] (bits=8) or uint8 [K/2, N]
// (bits=4, byte j of a block holds rows j and j+16); s: f32 or bf16
// [K/32, N]; out: x's dtype [M, N].
//
// Replaces llamago_tpu/ops/kernels.py _dequant_mm_kernel_so, reached through
// _dequant_matmul_2d when max(8, m) <= SCALE_ON_OUTPUT_MAX_M (off by
// default there and here).
//
// What bounds it: at decode row counts (M <= 8), like K1's decode form, the
// weight stream (K*N or K*N/2 bytes) plus the scales over device-memory
// bandwidth; above 8 rows, like K1's tile, the same bytes or, at a long
// prompt's chunk, the bf16 operations (three passes of them with f32 x).
//
// What the design does about it: four forms, K1's (ops/kernels.py k9_form
// picks one, the entry point takes its code):
//  * bf16 x at M <= 8 (every decode step when the switch is on) takes
//    so_decode_tc, K1's tensor-core decode form (decode_tc.cuh) with the
//    raw integers: the weights are the A operand of bf16 mma.sync.m16n8k16
//    as exact bf16 integers (int8, or a nibble 0..15: the bf16 0x43nn less
//    128), x is B (the M <= 8 slots are the n8 columns, zeros past M), and
//    the weight rows arrive by TMA bulk copies with L2 evict_first into a
//    ring of three quant blocks. Per quant block two k16 mma go into a
//    zeroed block sum; a Q4_0 block takes 8 * sum(x_b) off it (the block's
//    x summed in f32 by the four lanes of each slot); then the column's
//    scale folds the block sum into the f32 output sum. K is split as K1's
//    decode form splits it, and so_reduce adds the splits' partials in a
//    fixed order. So the weights are read once for all M rows, as K1's
//    decode form reads them.
//  * f32 x at M <= 8 (the --dtype float32 route's decode steps with the
//    switch on) takes so_decode_f32tc, the same form on x's three exact
//    bf16 parts (x = hi + mid + lo, tc_common.cuh split3): x arrives whole
//    by the bulk copies, each lane splits its B fragment's 8 values in
//    registers, and each A fragment feeds three mma (lo, mid, hi) into the
//    block sum; every part times an integer weight is exact in f32. Q4_0's
//    8 * sum(x_b) is summed from the f32 values themselves, as the plain
//    version sums them. The output is f32.
//  * M > 8 (only when the switch is set above 8: LLAMAGO_KERNEL_SO_MAX_M
//    = 64 or 256 sends whole prefill chunks here) takes so_tc, K1's
//    tensor-core tile (tile_tc.cuh) with the raw integers. At a prefill
//    chunk the work is bound by the weight stream (M = 64) or the bf16
//    operations (M = 256), as K1's tile is. The weights are the B operand of
//    bf16 mma.sync.m16n8k16 as exact bf16 integers (int8, or a nibble 0..15),
//    x the A operand from shared memory (bf16 x itself, or f32 x's three
//    exact bf16 planes, which split_x3_sums writes into the front of the
//    workspace), 16 to 64 rows and 128 columns a block, a ring of quant
//    blocks by cp.async, K split where the output tiles give too few blocks,
//    so_reduce adding the splits in a fixed order. Per quant block two k16
//    mma a part go into a zeroed block sum; a Q4_0 block then takes 8 *
//    sum(x_b) of its row off it (bf16 x: summed in the tensor core's f32
//    accumulator by one more mma against a B of ones, from the staged x
//    plane; f32 x: summed from x's own f32 values by split_x3_sums, which
//    already reads x, into [K/32, M] beside the planes, and staged in the
//    ring with each quant block), and the column's
//    scale folds the block sum into the f32 output sum. The weights are read
//    once for all M rows (once a column strip and row tile; the row tiles of
//    a strip follow each other, so after the first from L2), where the
//    GEMV this form replaced took 4 rows a launch and read the weights again
//    for every 4 (PERF.md's K9 row).
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

constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// out[i] = sum over the ksplit partials, in order.
template <typename OT>
__global__ void so_reduce(const float* __restrict__ ws, OT* __restrict__ out, size_t mn,
                          int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float a = 0.f;
  for (int y = 0; y < ksplit; ++y) a += ws[(size_t)y * mn + i];
  out[i] = from_f<OT>(a);
}

// split_x3 (tc_common.cuh) and the sums of x's 32-value blocks: planes as
// split_x3 writes them for x [M, K] (n = M*K values), and sums[kb * mp + m]
// = the sum of x[m, 32kb .. 32kb+31] (mp = tc_sums_ld(M), the layout the
// tile stages), each lane's four values added in order and then the
// block's eight lanes by xor shuffles, from x's own f32 values as the plain
// version sums them. K a multiple of 32, so a block's eight lanes are all in
// range or all out.
__global__ void __launch_bounds__(256) split_x3_sums(const float* __restrict__ x,
                                                     uint16_t* __restrict__ planes,
                                                     float* __restrict__ sums, size_t n, int K,
                                                     int mp) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const bool in = i < n;
  const float4 v = in ? *reinterpret_cast<const float4*>(x + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  if (in) {
    const uint3 a = split3(v.x), b = split3(v.y), c = split3(v.z), d = split3(v.w);
    uint16_t* p = planes + i;
    *reinterpret_cast<uint2*>(p) = make_uint2(a.x | (b.x << 16), c.x | (d.x << 16));
    *reinterpret_cast<uint2*>(p + n) = make_uint2(a.y | (b.y << 16), c.y | (d.y << 16));
    *reinterpret_cast<uint2*>(p + 2 * n) = make_uint2(a.z | (b.z << 16), c.z | (d.z << 16));
  }
  float t = v.x;
  t += v.y;
  t += v.z;
  t += v.w;
  t += __shfl_xor_sync(kFull, t, 1);
  t += __shfl_xor_sync(kFull, t, 2);
  t += __shfl_xor_sync(kFull, t, 4);
  if (in && (threadIdx.x & 7) == 0) sums[(i % K) / 32 * mp + i / K] = t;
}

// The tile (tile_tc.cuh) with K9's weights: the raw integers, Q4_0's 8 *
// sum(x_b) off each block sum (f32 x: the sums from xsum [M, K/32]).
template <typename ST, int MT, int BITS, int PARTS>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<MT, PARTS>())
    so_tc(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
          const ST* __restrict__ s, void* __restrict__ out, float* __restrict__ ws,
          const float* __restrict__ xsum, int M, int K, int N, int per, int m_tiles) {
  tile_tc_body<ST, MT, BITS, PARTS, true>(x, q, s, out, ws, xsum, M, K, N, per, m_tiles);
}

template <typename ST, int MT, int BITS, int PARTS>
cudaError_t launch_tc_rows(const void* x, const void* q, const void* s, void* out, float* ws,
                           const float* xsum, int M, int K, int N, int ksplit,
                           cudaStream_t st) {
  constexpr bool SUMS = BITS == 4 && PARTS == 3;  // f32 x's block sums in the ring
  constexpr int smem = tc_smem_bytes<ST, MT, BITS, PARTS, SUMS>();
  if constexpr (smem > 48 * 1024) {
    // more than 48 KB of dynamic shared memory only after this opt-in, once
    // per template instance
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        so_tc<ST, MT, BITS, PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (opt_in != cudaSuccess) return opt_in;
  }
  tile_launch<ST, MT, BITS, PARTS, SUMS>(so_tc<ST, MT, BITS, PARTS>, x, q, s, out, ws, xsum, M,
                                         K, N, ksplit, st);
  if (ksplit > 1) {
    const size_t mn = (size_t)M * N;
    const unsigned blocks = (unsigned)((mn + 255) / 256);
    if constexpr (PARTS == 3)
      so_reduce<float><<<blocks, 256, 0, st>>>(ws, static_cast<float*>(out), mn, ksplit);
    else
      so_reduce<__nv_bfloat16><<<blocks, 256, 0, st>>>(ws, static_cast<__nv_bfloat16*>(out),
                                                       mn, ksplit);
  }
  return cudaSuccess;
}

// 16 rows per block up to M = 16, 32 up to 32, else 64 (several M tiles), as
// K1's tile.
template <typename ST, int BITS, int PARTS>
cudaError_t launch_tc(const void* x, const void* q, const void* s, void* out, float* ws,
                      const float* xsum, int M, int K, int N, int ksplit, cudaStream_t st) {
  if (M <= 16)
    return launch_tc_rows<ST, 1, BITS, PARTS>(x, q, s, out, ws, xsum, M, K, N, ksplit, st);
  if (M <= 32)
    return launch_tc_rows<ST, 2, BITS, PARTS>(x, q, s, out, ws, xsum, M, K, N, ksplit, st);
  return launch_tc_rows<ST, 4, BITS, PARTS>(x, q, s, out, ws, xsum, M, K, N, ksplit, st);
}

// f32 elements of the row sums in the f32 tile's workspace: [K/32,
// tc_sums_ld(M)], a multiple of 4, so that the partials after them stay
// 16-byte aligned (ops/kernels.py k9_workspace).
size_t sums_elems(int M, int K) { return (size_t)(K / 32) * tc_sums_ld(M); }

// The tensor-core decode form's kernels (decode_tc.cuh): the raw integers,
// with Q4_0's 8 * sum(x_b) taken off each block sum; bf16 x (so_decode_tc,
// out bf16) or f32 x as three bf16 parts split in registers
// (so_decode_f32tc, out f32; the x sums of its own f32 values).
template <typename ST, int BITS>
__global__ void __launch_bounds__(kDtThreads, 3) so_decode_tc(const __nv_bfloat16* __restrict__ x,
                                                              const uint8_t* __restrict__ q,
                                                              const ST* __restrict__ s,
                                                              __nv_bfloat16* __restrict__ out,
                                                              float* __restrict__ ws, int M,
                                                              int K, int N, int per) {
  decode_tc_body<ST, BITS, true>(x, q, s, out, ws, M, K, N, per);
}

template <typename ST, int BITS>
__global__ void __launch_bounds__(kDtThreads, 3) so_decode_f32tc(const float* __restrict__ x,
                                                                 const uint8_t* __restrict__ q,
                                                                 const ST* __restrict__ s,
                                                                 float* __restrict__ out,
                                                                 float* __restrict__ ws, int M,
                                                                 int K, int N, int per) {
  decode_tc_body<ST, BITS, true, float>(x, q, s, out, ws, M, K, N, per);
}

// The decode form's kernel for x (and out) of type XT.
template <typename XT, typename ST, int BITS> constexpr auto dt_kernel() {
  if constexpr (sizeof(XT) == 4)
    return so_decode_f32tc<ST, BITS>;
  else
    return so_decode_tc<ST, BITS>;
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
    so_reduce<XT><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, static_cast<XT*>(out), mn,
                                                                ksplit);
  }
  return cudaSuccess;
}

// The forms, as ops/kernels.py's K1_FORMS numbers them (the codes of K1's
// entry point; code 0 was the GEMV, which is gone).
enum Form { kF32Tc = 1, kTensorCore = 2, kDecodeTc = 3, kF32DecodeTc = 4 };

template <typename XT, typename ST, int BITS>
cudaError_t launch_bits(const void* x, const void* q, const void* s, void* out, float* ws, int M,
                        int K, int N, int form, int ksplit, cudaStream_t st) {
  if (form == kDecodeTc || form == kF32DecodeTc)  // x's type's decode form (checked)
    return launch_decode_tc<XT, ST, BITS>(x, q, s, out, ws, M, K, N, ksplit, st);
  if constexpr (sizeof(XT) == 2) {  // bf16 x: the tile on x itself
    return launch_tc<ST, BITS, 1>(x, q, s, out, ws, nullptr, M, K, N, ksplit, st);
  } else {  // f32 x: its three bf16 planes and (Q4_0) its block sums first, into ws
    const size_t mk = (size_t)M * K;
    uint16_t* planes = reinterpret_cast<uint16_t*>(ws);
    float* sums = ws + mk * 3 / 2;
    const unsigned blocks = (unsigned)((mk / 4 + 255) / 256);
    if constexpr (BITS == 4)
      split_x3_sums<<<blocks, 256, 0, st>>>(static_cast<const float*>(x), planes, sums, mk, K,
                                            tc_sums_ld(M));
    else
      split_x3<<<blocks, 256, 0, st>>>(static_cast<const float*>(x), planes, mk);
    return launch_tc<ST, BITS, 3>(planes, q, s, out, sums + sums_elems(M, K), sums, M, K, N,
                                  ksplit, st);
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
// bfloat16, 0 for float32. form: K1's argument of the same name (the two
// entry points share one launcher): with f32 x 1 the tensor-core tile on
// x's three bf16 parts or 4 the tensor-core decode form on them (M <= 8);
// with bf16 x 2 the tensor-core tile or 3 the tensor-core decode form (M <=
// 8). `ws` is an f32 workspace: of ksplit*M*N elements for the tile with
// bf16 x and both decode forms when ksplit > 1 (a split then holds
// ceil(K/32 / ksplit) quant blocks); for form 1 the three planes (1.5*M*K
// elements), x's block sums (M*K/32 rounded up to 4) and then, when ksplit
// > 1, ksplit*M*N elements. Returns cudaGetLastError() after the launches,
// the error of a refused shared-memory opt-in, or cudaErrorInvalidValue
// for a form the arguments do not allow.
extern "C" int llamago_dequant_matmul_so(const void* x, const void* q, const void* s,
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
