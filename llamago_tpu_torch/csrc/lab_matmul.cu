// The kernel lab's small-m quantized matmuls for Hopper (sm_90a): rows L2,
// L3 and L6 to L12 of the lab's table (llamago_tpu_torch/kernel_lab.py).
//
// Replaces scripts/kernel_lab.py (the lab of the JAX package, whose production
// forms live in llamago_tpu/ops/kernels.py): kern_i4native (L2), kern_bf16dot
// and kern_split_bf16_h (L3), kern_w4a8, kern_w4a8_raw and kern_w4a8_h (L6),
// kern_w8a8 and kern_w8a8_h (L7), kern_w8a8_fulltk and kern_w4a8_split_fulltk
// (L8), kern_bitcast_i4 and kern_bitcast_i4_bf16 (L9), kern_bitcast_i4_i8dot,
// kern_bitcast_i4_i4dot, kern_bitcast_i4_i8dot_g128 and its _lazy form (L10),
// kern_decode_only, kern_decode_bitcast, kern_dma_only and kern_dma_pure
// (L11), kern_w16dot (L12), and the bitcast probe of tests/test_quant.py.
// The variants of one row differed in the TPU's unpack chain only and share
// one kernel here.
//
// Every function takes tm rows of x (tm a multiple of 8; bf16 [tm, K], or int8
// with f32 scales where the row rounds its activations), weights of K rows and
// N columns with bf16 scales s [K/32, N], and gives f32 [tm, N]. K % 32 == 0,
// N % 16 == 0.
//
// Weight layouts: Q8_0 int8 [K, N]. Q4_0 uint8 [K/2, N]: byte j of a 32-row
// block (packed rows 16b .. 16b+15) holds row 32b+j in its low nibble and row
// 32b+j+16 in its high nibble, value = nibble - 8. int4-typed (L2; and what L9
// and L10 read the Q4_0 bytes as): uint8 [K/2, N], byte r holds rows 2r (low)
// and 2r+1 (high) as two's-complement nibbles. bf16 [K, N] (L12).
//
// What bounds them: at tm = 8 a weight element meets 16 operations. Every
// row is bound by its weight bytes over device-memory bandwidth when its
// products run where their type runs fastest: K*N/2 bytes of Q4_0 or int4
// at K = 8192, N = 7168 (8.8 us at 3.35 TB/s; 10.0 with the scales), 2*K*N
// of bf16 for L12 (35.2 us). The integer rows (L6 to L8, L10) run on the
// int8 tensor cores and the float rows (L2, L3, L9, L12) on the bf16 ones,
// where their 2*8*K*N operations take 0.5 and 1 us against 14 us in f32
// FMA. The probes read the same Q4_0 bytes with no x: decode_only's sums
// run on the bf16 tensor cores, dma_only's on integer adds, and
// decode_bitcast's lossy chain on f32 CUDA cores, where its ten or so
// instructions a packed byte bound it near its bytes.
//
// What the design does about it:
//  * Floating point (lab_decode_tc): the tensor-core decode form of K1
//    (decode_tc.cuh: its layout, lanes and fragments), one instance per
//    mode. The weights are the A operand of bf16 mma.sync.m16n8k16 (16
//    output columns by 16 rows of K) and x is B (its 8 rows the n8
//    columns); the weight rows of a 32-row quant block, x and the scales
//    arrive by TMA bulk copies on one mbarrier a ring stage (the weights
//    with L2 evict_first); K is split into one wave of blocks, and lab_reduce
//    adds the splits' f32 partials in a fixed order. Each 32-bit A register
//    holds two K values of one column under one scale, made exactly in bf16
//    from the nibbles (K1's 0x43nn pairs). L2 and L9's f32 form take the
//    integer values -8..7 as they are and fold the column's scale into each
//    quant block's f32 sum, as K1 does (int4 * s is no bf16 value); the bf16
//    forms round int4 * s, (nib - 8) * s, or bf16(nib * s) + bf16(-8 s) in
//    two steps (split_bf16_h), by __hmul2_rn and __hadd2_rn on the pairs,
//    so nvcc cannot fuse the two roundings into one. L12's A fragments are
//    ldmatrix.trans of its bf16 rows. Every mode sums a quant block in a
//    zeroed accumulator and adds it to the output sum in f32, so that the
//    tensor core's own accumulation never runs long.
//  * Integer (lab_decode_i8tc): the int8 tensor-core decode form of K5
//    (decode_i8_tc.cuh), one instance per weight format: Q8_0 (L7, L8's
//    w8a8_fulltk), Q4_0's raw nibbles less 8 * sum(xq) (L6, L8's
//    w4a8_split_fulltk) and the Q4_0 bytes as two's-complement pairs (L10).
//    The weights are the A operand of mma.sync.m16n8k32 on int8 (exact int32
//    sums), the 8 rows of x a group the n8 columns of B; the weight rows of
//    32 rows of K, the slots' xq and, where a scale group ends, its scale
//    row and sx arrive by TMA bulk copies into a ring (the weights with L2
//    evict_first). A Q8_0 or Q4_0 register is a 4x4 byte transpose of four
//    rows' words in a permuted k order that xq takes too; a pair byte's
//    nibbles become int8 as 16 times their value. Each scale group's int32
//    sum (a 32-block, a 128-group, a k-tile) is folded with sx * s into the
//    f32 output sum; K is split into one wave of blocks (ops/lab_kernels.py
//    lab_i8_plan), and lab_reduce adds the parts in a fixed order.
//  * lab_quantize_x: x to int8 per (row, 32-block) with one warp each, the
//    plain version's rounding decisions bit for bit (product by fl(1/127),
//    IEEE division, rintf).
//  * Probes: column sums with no x, so that L1 - decode_only is the cost
//    of x and the products and decode_only - dma_only the cost of the
//    nibble decode. decode_only, decode_bitcast and dma_only are probe modes
//    of lab_decode_tc: the Q4_0 weight rows (and, but for dma_only, the
//    scale rows) arrive by the decode form's bulk copies into its ring, with
//    L2 evict_first, K split into one wave of blocks, one row of column sums
//    a split, lab_reduce_cols adding the splits in a fixed order into every
//    row.
//    decode_only takes the form's own A fragments (the exact nib - 8 bf16
//    pairs) against a B of bf16 ones held in registers: two k16 mma a quant
//    block into a zeroed block sum, an exact integer column sum, which the
//    column's scale folds into the f32 output sum. dma_only adds each
//    lane's staged bytes exactly, the even and odd bytes of a word in 16-bit
//    lanes of one 32-bit add (a lane adds 4 rows of at most 255 a block, so
//    the lanes are flushed to 32 bits every 64 blocks). decode_bitcast reads
//    the same 16-byte vectors of the ring and keeps every product and sum
//    of its lossy chain a rounding of its own (__fmul_rn, __fadd_rn: no
//    contraction into FMA), as the plain version does. dma_pure moves every
//    packed byte of its span from device memory into a ring of
//    shared-memory stages with cp.async (16 bytes a thread) and reads the
//    8-row corner only.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry points return cudaGetLastError() after their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_i8_tc.cuh"
#include "decode_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;     // columns per block: 32 lanes x 4
constexpr int kTM = 8;         // rows of x per block
constexpr unsigned kFull = 0xffffffffu;

// modes of lab_decode_tc (llamago_lab_fmatmul)
constexpr int kFI4 = 0, kFI4Bf16 = 1, kFQ4Bf16 = 2, kFQ4Bf16Fma = 3, kFW16 = 4;
// its probe modes (llamago_lab_probe: L11's codes 0-2 plus 5)
constexpr int kFDecodeOnly = 5, kFDecodeBitcast = 6, kFDmaOnly = 7;
// L11's codes (llamago_lab_probe)
constexpr int kPDecode = 0, kPDecodeBitcast = 1, kPDmaOnly = 2, kPDmaPure = 3;

// ------------------------------------------- floating-point rows (lab_decode_tc)

// The tensor-core decode form of rows L2, L3, L9 and L12, on the layout of
// K1's decode form (decode_tc.cuh): per block 512 columns, four warps of
// 128, lane (gid, tig) on 16 of them; per 32-row quant block of K two bf16
// mma.sync.m16n8k16 a tile of 16 columns, the weights the A operand, the 8
// rows of x the n8 columns of B. The weight rows, x and the scales of a
// quant block arrive by bulk copies of the TMA unit into a ring stage (the
// weights with L2 evict_first); one mbarrier and one block barrier a quant
// block. Per mode (lt_*): the packed rows of a block (16 nibble rows, or 32
// bf16 rows of 1,024 bytes for L12), their stride in a stage (16 bytes past
// the row, 32 for the int4 order, so that the lanes' 16-byte reads fall on
// distinct banks), the ring's depth and the blocks an SM holds.
template <int MODE> __host__ __device__ constexpr bool lt_i4() {
  return MODE == kFI4 || MODE == kFI4Bf16;
}
// The probes: no x staged, copied or counted; dma_only copies no scales.
template <int MODE> __host__ __device__ constexpr bool lt_probe() { return MODE >= kFDecodeOnly; }
template <int MODE> __host__ __device__ constexpr bool lt_scales() {
  return MODE != kFW16 && MODE != kFDmaOnly;
}
template <int MODE> __host__ __device__ constexpr int lt_rows() { return MODE == kFW16 ? 32 : 16; }
template <int MODE> __host__ __device__ constexpr int lt_col_bytes() { return MODE == kFW16 ? 2 : 1; }
template <int MODE> __host__ __device__ constexpr int lt_ld() {
  return kDtBlockCols * lt_col_bytes<MODE>() + (lt_i4<MODE>() ? 32 : 16);
}
template <int MODE> __host__ __device__ constexpr int lt_stages() { return MODE == kFW16 ? 3 : 4; }
template <int MODE> __host__ __device__ constexpr int lt_blocks_per_sm() {
  return MODE == kFW16 ? 2 : 3;
}
// One stage: the weight rows, x (8 rows of 32 bf16, 80 bytes apart; none
// for the probes), then the block's 512 bf16 scales (none for L12 and
// dma_only).
template <int MODE> __host__ __device__ constexpr int lt_x_bytes() {
  return lt_probe<MODE>() ? 0 : 8 * kDtXLd;
}
template <int MODE> __host__ __device__ constexpr int lt_stage_bytes() {
  return lt_rows<MODE>() * lt_ld<MODE>() + lt_x_bytes<MODE>() +
         (lt_scales<MODE>() ? 2 * kDtBlockCols : 0);
}
template <int MODE> __host__ __device__ constexpr int lt_smem_bytes() {
  return lt_stages<MODE>() * (lt_stage_bytes<MODE>() + 8);
}
static_assert(lt_stage_bytes<kFI4>() % 16 == 0 && lt_stage_bytes<kFQ4Bf16>() % 16 == 0 &&
                  lt_stage_bytes<kFW16>() % 16 == 0 &&
                  lt_stage_bytes<kFDecodeOnly>() % 16 == 0 &&
                  lt_stage_bytes<kFDmaOnly>() % 16 == 0,
              "stages and barriers stay aligned");
static_assert(lt_smem_bytes<kFQ4Bf16>() >= kDtWarps * 8 * kDtCols * 4 &&
                  lt_smem_bytes<kFI4>() >= kDtWarps * 8 * kDtCols * 4,
              "the warps' sums fit in the ring");
static_assert(lt_blocks_per_sm<kFW16>() * (lt_smem_bytes<kFW16>() + 1024) <= 233472 &&
                  lt_blocks_per_sm<kFI4>() * (lt_smem_bytes<kFI4>() + 1024) <= 233472,
              "the blocks an SM is to hold fit its shared memory");

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                      *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hadd2_rn(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                      *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The A fragment of tile T (columns n+T and n+8+T) at k16 step STEP from
// the lane's four 16-byte weight reads w. Q4_0 (L3): w[2h + e] is packed
// row 8h + 2 tig + e, whose low nibbles are K rows 8h + 2 tig + e and high
// nibbles 16 more (step 1); the pair is nib - 8 (bf16dot) or nib as it is
// (split_bf16_h), exact. int4 order (L2, L9): w[r] is packed row 4r + tig,
// already XORed with 0x88888888, so that one byte's low and high nibble
// are K rows 2p and 2p + 1 and (nib ^ 8) - 8 is the two's-complement value.
template <int MODE, int T, int STEP>
__device__ __forceinline__ void lt_a_frag(const uint4 (&w)[4], uint32_t (&a)[4]) {
  constexpr int I = T >> 2, J = T & 3;
  if constexpr (lt_i4<MODE>()) {
    const uint32_t c0 = word_of<I>(w[2 * STEP]), c1 = word_of<I + 2>(w[2 * STEP]);
    const uint32_t c2 = word_of<I>(w[2 * STEP + 1]), c3 = word_of<I + 2>(w[2 * STEP + 1]);
    a[0] = q4_pair<J, 0>(c0, c0 >> 4);
    a[1] = q4_pair<J, 0>(c1, c1 >> 4);
    a[2] = q4_pair<J, 0>(c2, c2 >> 4);
    a[3] = q4_pair<J, 0>(c3, c3 >> 4);
  } else {
    constexpr bool RAW = MODE == kFQ4Bf16Fma;
    a[0] = q4_pair<J, 4 * STEP, RAW>(word_of<I>(w[0]), word_of<I>(w[1]));
    a[1] = q4_pair<J, 4 * STEP, RAW>(word_of<I + 2>(w[0]), word_of<I + 2>(w[1]));
    a[2] = q4_pair<J, 4 * STEP, RAW>(word_of<I>(w[2]), word_of<I>(w[3]));
    a[3] = q4_pair<J, 4 * STEP, RAW>(word_of<I + 2>(w[2]), word_of<I + 2>(w[3]));
  }
}

// The bf16 weights of the bf16 modes from exact pairs, each a rounding of
// its own (the _rn intrinsics are never contracted): bf16(int4 * s) (L9),
// bf16((nib - 8) * s) (bf16dot), bf16(bf16(nib * s) + bf16(-8 s))
// (split_bf16_h). sp[0] pairs column n+T's scale, sp[1] column n+8+T's;
// -8 s is exact in bf16.
template <int MODE>
__device__ __forceinline__ void lt_scale(uint32_t (&a)[4], const uint32_t (&sp)[2]) {
  if constexpr (MODE == kFI4Bf16 || MODE == kFQ4Bf16 || MODE == kFQ4Bf16Fma) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = bf16x2_mul(a[e], sp[e & 1]);
    if constexpr (MODE == kFQ4Bf16Fma) {
      const uint32_t bias[2] = {bf16x2_mul(sp[0], 0xC100C100u), bf16x2_mul(sp[1], 0xC100C100u)};
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = bf16x2_add(a[e], bias[e & 1]);
    }
  }
}

// Tile T of a lane's quant block, nibble modes: two k16 mma into a zeroed
// block sum, then into acc (c0, c1: column n+T, rows 2 tig and 2 tig + 1 of
// x; c2, c3: column n+8+T) by f32 adds, or for L2 and L9's f32 form the
// block sum times the column's scale (f32), as K1's decode form folds it.
// s0, s1: the raw bf16 scales of columns n .. n+7 and n+8 .. n+15.
template <int MODE, int T>
__device__ __forceinline__ void lt_tile(const uint4 (&w)[4], const uint32_t (&xb)[4],
                                        const uint4& s0, const uint4& s1, float (&acc)[4]) {
  constexpr uint32_t SEL = (T & 1) ? 0x3232u : 0x1010u;  // scale T's bf16 in both halves
  const uint32_t sp[2] = {__byte_perm(word_of<(T >> 1)>(s0), 0u, SEL),
                          __byte_perm(word_of<(T >> 1)>(s1), 0u, SEL)};
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t a[4];
  lt_a_frag<MODE, T, 0>(w, a);
  lt_scale<MODE>(a, sp);
  mma_bf16(part, a, xb[0], xb[1]);
  lt_a_frag<MODE, T, 1>(w, a);
  lt_scale<MODE>(a, sp);
  mma_bf16(part, a, xb[2], xb[3]);
  if constexpr (MODE == kFI4 || MODE == kFDecodeOnly) {
    const float f0 = __uint_as_float(sp[0] << 16), f1 = __uint_as_float(sp[1] << 16);
    acc[0] = fmaf(f0, part[0], acc[0]);
    acc[1] = fmaf(f0, part[1], acc[1]);
    acc[2] = fmaf(f1, part[2], acc[2]);
    acc[3] = fmaf(f1, part[3], acc[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += part[e];
  }
}

// grid = (ceil(N/512), ksplit, tm/8), block = kDtThreads, dynamic shared
// memory lt_smem_bytes. Block x covers columns 512x .. 512x+511, block y
// the quant blocks [y*per, (y+1)*per), block z the rows 8z .. 8z+7 of x.
// Thread r < lt_rows copies weight row r of a quant block's 512 columns,
// threads 32 .. 39 the 8 rows of x (kFQ4Bf16Fma: from the halves x, x_hi),
// thread 64 the scales. Nibble modes: lane (gid, tig) of warp w owns
// columns n = 512x + 128w + 16 gid .. +15, column n+T (T < 8) is row gid
// of m16 tile T and n+8+T its row gid+8, as in K1's decode form. L12: the
// A fragments are ldmatrix.trans of the bf16 rows, so tile T is columns c
// = 512x + 128w + 16T .. +15, its row gid column c+gid, row gid+8 c+8+gid.
// Writes f32 to dst[(y*tm + 8z + m)*N + n]: the output when ksplit is 1,
// else the split's partials. The probe modes (grid z 1, no x) write one row
// of column sums a split, dst[y*N + n].
template <int MODE>
__global__ void __launch_bounds__(kDtThreads, lt_blocks_per_sm<MODE>()) lab_decode_tc(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ x_hi,
    const uint8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s, float* __restrict__ dst,
    int tm, int K, int N, int per) {
  constexpr bool W16 = MODE == kFW16;
  constexpr int ROWS = lt_rows<MODE>(), LD = lt_ld<MODE>(), STAGES = lt_stages<MODE>();
  constexpr int CB = lt_col_bytes<MODE>();
  constexpr int STAGE = lt_stage_bytes<MODE>();
  constexpr int X_OFF = ROWS * LD, S_OFF = X_OFF + lt_x_bytes<MODE>();
  constexpr bool PROBE = lt_probe<MODE>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nb0 = blockIdx.x * kDtBlockCols;
  const int row0 = blockIdx.z * 8;
  const int kb0 = blockIdx.y * per;
  const int n_it = min(per, K / 32 - kb0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  const uint32_t width = min(kDtBlockCols, N - nb0);  // columns: N is a multiple of 16
  const uint32_t stage_tx =
      ROWS * width * CB + (PROBE ? 0 : 8 * 64) + (lt_scales<MODE>() ? 2 * width : 0);
  const uint64_t once = l2_evict_first();  // the weights are read once
  if (tid < STAGES) mbar_init(bars + tid);
  mbar_init_fence();
  __syncthreads();

  // Quant block kb0 + it into ring slot `slot`.
  auto load = [&](int slot, int it) {
    const int kb = kb0 + it;
    unsigned char* st = smem + slot * STAGE;
    if (tid == 0) mbar_expect(bars + slot, stage_tx);
    if (tid < ROWS) {
      bulk_copy(st + tid * LD, q + ((size_t)(kb * ROWS + tid) * N + nb0) * CB, width * CB,
                bars + slot, once);
    } else if (!PROBE && tid >= 32 && tid < 40) {
      const int m = tid - 32;
      unsigned char* xd = st + X_OFF + m * kDtXLd;
      if constexpr (MODE == kFQ4Bf16Fma) {  // of every 32-block the first and last 16
        const size_t off = (size_t)(row0 + m) * (K / 2) + kb * 16;
        bulk_copy(xd, x + off, 32, bars + slot);
        bulk_copy(xd + 32, x_hi + off, 32, bars + slot);
      } else {
        bulk_copy(xd, x + (size_t)(row0 + m) * K + kb * 32, 64, bars + slot);
      }
    } else if (lt_scales<MODE>() && tid == 64) {
      bulk_copy(st + S_OFF, s + (size_t)kb * N + nb0, 2 * width, bars + slot);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  // dma_only: the byte sums of the lane's 16 columns, even and odd bytes of
  // word i (columns 4i .. 4i+3) in 16-bit lanes, flushed to 32 bits; and
  // decode_bitcast's f32 sums
  uint32_t ev[4] = {0u, 0u, 0u, 0u}, od[4] = {0u, 0u, 0u, 0u}, tot[16] = {};
  float bsum[16] = {};
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tot[4 * i] += ev[i] & 0xFFFFu, tot[4 * i + 2] += ev[i] >> 16;
      tot[4 * i + 1] += od[i] & 0xFFFFu, tot[4 * i + 3] += od[i] >> 16;
      ev[i] = od[i] = 0u;
    }
  };

  const int cw = warp * kDtCols + 16 * gid;  // nibble modes: this lane's columns, in the block
  // L12: this lane's ldmatrix row, K row 8 (mat >> 1) + mr of a k16 step,
  // columns 8 (mat & 1) .. +7 of a tile
  const int mat = lane >> 3, mr = lane & 7;
  const int w16_off = (8 * (mat >> 1) + mr) * LD + 2 * (warp * kDtCols + 8 * (mat & 1));

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < n_it) load(i, i);
  for (int it = 0; it < n_it; ++it) {
    mbar_wait(bars + it % STAGES, (it / STAGES) & 1);
    __syncthreads();  // quant block `it` has landed; every warp is done with slot (it-1) % stages
    if (it + STAGES - 1 < n_it) load((it + STAGES - 1) % STAGES, it + STAGES - 1);

    const unsigned char* st = smem + (it % STAGES) * STAGE;
    uint32_t xb[4];  // x row gid at k = 2 tig + {0, 8, 16, 24}; decode_only: bf16 ones
    if constexpr (MODE == kFDecodeOnly) {
#pragma unroll
      for (int j = 0; j < 4; ++j) xb[j] = 0x3F803F80u;
    } else if constexpr (!PROBE) {
      const unsigned char* xr = st + X_OFF + gid * kDtXLd + 4 * tig;
#pragma unroll
      for (int j = 0; j < 4; ++j) xb[j] = *reinterpret_cast<const uint32_t*>(xr + 16 * j);
    }
    if constexpr (W16) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int step = 0; step < 2; ++step) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, st + w16_off + 16 * step * LD + 32 * t);
          mma_bf16(part, a, xb[2 * step], xb[2 * step + 1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] += part[e];
      }
    } else {
      uint4 w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = lt_i4<MODE>() ? 4 * r + tig : 8 * (r >> 1) + 2 * tig + (r & 1);
        w[r] = *reinterpret_cast<const uint4*>(st + row * LD + cw);
        if constexpr (lt_i4<MODE>()) {
          w[r].x ^= 0x88888888u, w[r].y ^= 0x88888888u;
          w[r].z ^= 0x88888888u, w[r].w ^= 0x88888888u;
        }
      }
      if constexpr (MODE == kFDmaOnly) {
        // 4 rows of at most 255 a block: 16-bit lanes hold 64 blocks
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t wd[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ev[i] += wd[i] & 0x00FF00FFu;
            od[i] += (wd[i] >> 8) & 0x00FF00FFu;
          }
        }
        if ((it & 63) == 63) flush();
        continue;
      }
      const uint4 s0 = *reinterpret_cast<const uint4*>(st + S_OFF + 2 * cw);
      const uint4 s1 = *reinterpret_cast<const uint4*>(st + S_OFF + 2 * cw + 16);
      if constexpr (MODE == kFDecodeBitcast) {
        // ((f_lo * s + bias) + f_hi * s) + bias a byte, f = 2^23 + nib and
        // bias = fl(-(2^23 + 8) * s), every product and sum rounded on its
        // own (no contraction into FMA); the lane's rows in order
        // a word's low and high nibbles, then each as f = 0x4B0000nn by
        // one byte_perm
        const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        uint32_t lo[4][4], hi[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t wd[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[r][i] = wd[i] & 0x0F0F0F0Fu;
            hi[r][i] = (wd[i] >> 4) & 0x0F0F0F0Fu;
          }
        }
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float sc = __uint_as_float((c & 1) ? sw[c >> 1] & 0xFFFF0000u : sw[c >> 1] << 16);
          const float bias = __fmul_rn(-(8388608.f + 8.f), sc);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t sel = 0x7440u | (c & 3);
            const float f_lo = __uint_as_float(__byte_perm(lo[r][c >> 2], 0x4B000000u, sel));
            const float f_hi = __uint_as_float(__byte_perm(hi[r][c >> 2], 0x4B000000u, sel));
            float t = __fadd_rn(__fmul_rn(f_lo, sc), bias);
            t = __fadd_rn(t, __fmul_rn(f_hi, sc));
            t = __fadd_rn(t, bias);
            bsum[c] += t;
          }
        }
        continue;
      }
      lt_tile<MODE, 0>(w, xb, s0, s1, acc[0]);
      lt_tile<MODE, 1>(w, xb, s0, s1, acc[1]);
      lt_tile<MODE, 2>(w, xb, s0, s1, acc[2]);
      lt_tile<MODE, 3>(w, xb, s0, s1, acc[3]);
      lt_tile<MODE, 4>(w, xb, s0, s1, acc[4]);
      lt_tile<MODE, 5>(w, xb, s0, s1, acc[5]);
      lt_tile<MODE, 6>(w, xb, s0, s1, acc[6]);
      lt_tile<MODE, 7>(w, xb, s0, s1, acc[7]);
    }
  }

  if constexpr (PROBE) {
    // one row of sums [N] a split: the lane's 16 columns, its four rows of
    // each packed row pair added over the four lanes of its gid (decode_only:
    // every slot holds the same column sums, so lane tig 0 has them)
    float v[16];
    if constexpr (MODE == kFDecodeOnly) {
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = acc[t][0], v[8 + t] = acc[t][2];
    } else if constexpr (MODE == kFDmaOnly) {
      flush();
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        uint32_t a = tot[c];
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        v[c] = (float)a;  // exact: a column of a split is below 2^24
      }
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float a = bsum[c];
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        v[c] = a;
      }
    }
    const int c = nb0 + cw;
    if (tig == 0 && c < N) {
      float4* p = reinterpret_cast<float4*>(dst + (size_t)blockIdx.y * N + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
    return;
  }

  // The warp's 8 rows x 128 columns through shared memory, then 4
  // neighbouring columns a lane to device memory.
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem) + warp * 8 * kDtCols;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* p = red + (2 * tig + h) * kDtCols;
    if constexpr (W16) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        p[16 * t + gid] = acc[t][h];
        p[16 * t + 8 + gid] = acc[t][2 + h];
      }
    } else {
      float4* p4 = reinterpret_cast<float4*>(p + 16 * gid);
      p4[0] = make_float4(acc[0][h], acc[1][h], acc[2][h], acc[3][h]);
      p4[1] = make_float4(acc[4][h], acc[5][h], acc[6][h], acc[7][h]);
      p4[2] = make_float4(acc[0][2 + h], acc[1][2 + h], acc[2][2 + h], acc[3][2 + h]);
      p4[3] = make_float4(acc[4][2 + h], acc[5][2 + h], acc[6][2 + h], acc[7][2 + h]);
    }
  }
  __syncwarp();
  const int c = nb0 + warp * kDtCols + 4 * lane;
  if (c >= N) return;
  for (int m = 0; m < 8; ++m)
    *reinterpret_cast<float4*>(dst + ((size_t)blockIdx.y * tm + row0 + m) * N + c) =
        *reinterpret_cast<const float4*>(red + m * kDtCols + 4 * lane);
}

// ---------------------------------------------------------------- integer rows

// The int8 tensor-core decode form (decode_i8_tc.cuh) in weight format FMT,
// 8 rows of x a block: grid = (ceil(N/512), ksplit, tm/8), f32 to a.dst
// (the output when ksplit is 1, else the splits' partials [ksplit, tm, N]).
template <int FMT>
__global__ void __launch_bounds__(kItThreads, it_blocks_per_sm<1>())
    lab_decode_i8tc(const __grid_constant__ ItArgs a) {
  decode_i8tc_body<FMT, 1>(a);
}

// One warp per (row, 32-block), a lane per value: xq int8 [tm, K], sx f32
// [K/32, tm].
__global__ void __launch_bounds__(128) lab_quantize_x(const __nv_bfloat16* __restrict__ x,
                                                      int8_t* __restrict__ xq,
                                                      float* __restrict__ sx, int tm, int K) {
  const int lane = threadIdx.x & 31;
  const int nb = K / 32;
  const int item = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (item >= tm * nb) return;
  const int m = item / nb, b = item % nb;
  const size_t off = (size_t)m * K + (size_t)b * 32 + lane;
  const float v = __bfloat162float(x[off]);
  float amax = fabsf(v);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, d));
  const float inv127 = 1.0f / 127.0f;  // rounded to f32 once, as the plain version's product
  const float sc = amax > 0.f ? __fmul_rn(amax, inv127) : 1.0f;
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, sc)), -127.f), 127.f);
  xq[off] = (int8_t)(int)r;
  if (lane == 0) sx[(size_t)b * tm + m] = sc;
}

// ---------------------------------------------------------------------- probes

constexpr int kStages = 4;
constexpr int kStageRows = 32;  // packed rows of 128 bytes per stage: 256 x 16 bytes

// dma_pure: grid = (ceil(N/128), K/tk). The block copies its whole span of
// tk/2 packed rows by 128 columns from device memory into a ring of four
// shared-memory stages and sums the first 8 rows only.
__global__ void __launch_bounds__(kThreads) lab_probe_dma_pure(const uint8_t* __restrict__ q,
                                                               float* __restrict__ ws, int N,
                                                               int span_rows) {
  __shared__ __align__(16) uint8_t stage[kStages][kStageRows * kCols];
  const int n0 = blockIdx.x * kCols;
  const int r = threadIdx.x >> 3, cb = (threadIdx.x & 7) * 16;  // a thread's 16 bytes
  const uint8_t* base = q + (size_t)blockIdx.y * span_rows * N + n0;
  const int chunks = (span_rows + kStageRows - 1) / kStageRows;
  auto fetch = [&](int c) {
    const int row = c * kStageRows + r;
    if (c < chunks && row < span_rows && n0 + cb < N)
      cp_async16(&stage[c % kStages][r * kCols + cb], base + (size_t)row * N + cb);
    cp_async_commit();
  };
  for (int c = 0; c < kStages; ++c) fetch(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 1>();  // chunk c has landed
    __syncthreads();
    const int col = threadIdx.x;
    if (c == 0 && col < kCols && n0 + col < N) {
      int sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += stage[0][i * kCols + col];
      ws[(size_t)blockIdx.y * N + n0 + col] = (float)sum;
    }
    __syncthreads();  // stage c % kStages is free again
    fetch(c + kStages);
  }
  cp_async_wait<0>();
}

// out[m][n] = sum over the ksplit partials, in order. ws rows: `ws_rows` per
// split (tm, or 1 for the probes: every row of out the same).
__global__ void lab_reduce(const float* __restrict__ ws, float* __restrict__ out, int tm,
                           int N, int ws_rows, int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)tm * N) return;
  const size_t per = (size_t)ws_rows * N;
  const size_t j = ws_rows == 1 ? i % N : i;
  float a = 0.f;
  for (int y = 0; y < ksplit; ++y) a += ws[(size_t)y * per + j];
  out[i] = a;
}

// out[m][n] = the sum over the ksplit rows ws[y][n], for every m < tm (the
// probe modes of lab_decode_tc). A block is 32 columns by 8 warps: warp g
// adds the rows y = g, g + 8, ... in order, then every warp adds the 8
// warps' sums in order and writes rows g, g + 8, ...: a fixed order, the
// same bits every call, each partial read once and a few loads a thread
// (lab_reduce with ws_rows 1 reads every partial again for each row, one
// thread adding all ksplit of them).
__global__ void __launch_bounds__(256) lab_reduce_cols(const float* __restrict__ ws,
                                                       float* __restrict__ out, int tm, int N,
                                                       int ksplit) {
  __shared__ float part[8][32];
  const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + c;
  float a = 0.f;
  if (n < N)
    for (int y = g; y < ksplit; y += 8) a += ws[(size_t)y * N + n];
  part[g][c] = a;
  __syncthreads();
  if (n >= N) return;
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) t += part[j][c];
  for (int m = g; m < tm; m += 8) out[(size_t)m * N + n] = t;
}

void reduce(const float* ws, float* out, int tm, int N, int ws_rows, int ksplit,
            cudaStream_t st) {
  const size_t mn = (size_t)tm * N;
  lab_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, out, tm, N, ws_rows, ksplit);
}

bool bad_shape(int tm, int K, int N, int ksplit) {
  return tm < kTM || tm % kTM || K < 32 || K % 32 || N < 16 || N % 16 || ksplit < 1;
}

template <int FMT>
cudaError_t launch_decode_i8tc(const ItArgs& a, int ksplit, cudaStream_t st) {
  constexpr int smem = it_smem_bytes<FMT>();
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      lab_decode_i8tc<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((a.N + kItBlockCols - 1) / kItBlockCols, ksplit, a.tm / kTM);
  lab_decode_i8tc<FMT><<<grid, kItThreads, smem, st>>>(a);
  return cudaSuccess;
}

// A probe mode of lab_decode_tc: grid = (ceil(N/512), ksplit), one row of
// column sums a split into ws [ksplit, N], which lab_reduce_cols adds in a
// fixed order into every one of out's tm rows.
template <int MODE>
cudaError_t launch_probe_tc(const void* q, const void* s, float* out, float* ws, int tm, int K,
                            int N, int per, int ksplit, cudaStream_t st) {
  constexpr int smem = lt_smem_bytes<MODE>();
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      lab_decode_tc<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((N + kDtBlockCols - 1) / kDtBlockCols, ksplit);
  lab_decode_tc<MODE><<<grid, kDtThreads, smem, st>>>(
      nullptr, nullptr, static_cast<const uint8_t*>(q), static_cast<const __nv_bfloat16*>(s),
      ws, tm, K, N, per);
  lab_reduce_cols<<<(N + 31) / 32, 256, 0, st>>>(ws, out, tm, N, ksplit);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_decode_tc(const void* x, const void* x_hi, const void* q, const void* s,
                             float* out, float* ws, int tm, int K, int N, int ksplit,
                             cudaStream_t st) {
  constexpr int smem = lt_smem_bytes<MODE>();
  // more than 48 KB of dynamic shared memory only after this opt-in, once
  // per template instance
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      lab_decode_tc<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const int per = (K / 32 + ksplit - 1) / ksplit;
  const dim3 grid((N + kDtBlockCols - 1) / kDtBlockCols, ksplit, tm / kTM);
  lab_decode_tc<MODE><<<grid, kDtThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(x_hi),
      static_cast<const uint8_t*>(q), static_cast<const __nv_bfloat16*>(s),
      ksplit > 1 ? ws : out, tm, K, N, per);
  if (ksplit > 1) reduce(ws, out, tm, N, tm, ksplit, st);
  return cudaGetLastError();
}

}  // namespace

// Rows L2, L3, L9 and L12, each on the tensor-core decode form
// lab_decode_tc. mode: 0 int4-typed nibbles, f32 scales on the block sums
// (L2, L9); 1 the same with bf16 weights (L9); 2 Q4_0 to bf16 in one
// rounding (L3 bf16dot); 3 Q4_0 with the FMA in bf16, x as the halves x,
// x_hi (L3 split_bf16_h); 4 raw bf16 weights (L12; q is bf16 [K, N], s is
// not read). x bf16, s bf16, out f32 [tm, N]; ws f32 [ksplit, tm, N], read
// only when ksplit > 1, each split ceil(K/32 / ksplit) quant blocks (the
// plan of ops/lab_kernels.py lab_plan). Returns cudaGetLastError() after
// the launches.
extern "C" int llamago_lab_fmatmul(const void* x, const void* x_hi, const void* q,
                                   const void* s, void* out, void* ws, int tm, int K, int N,
                                   int mode, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(tm, K, N, ksplit) || ksplit > K / 32 || (ksplit > 1 && ws == nullptr) ||
      (mode == kFQ4Bf16Fma && x_hi == nullptr))
    return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  switch (mode) {
    case kFI4: return launch_decode_tc<kFI4>(x, x_hi, q, s, o, w, tm, K, N, ksplit, st);
    case kFI4Bf16: return launch_decode_tc<kFI4Bf16>(x, x_hi, q, s, o, w, tm, K, N, ksplit, st);
    case kFQ4Bf16: return launch_decode_tc<kFQ4Bf16>(x, x_hi, q, s, o, w, tm, K, N, ksplit, st);
    case kFQ4Bf16Fma:
      return launch_decode_tc<kFQ4Bf16Fma>(x, x_hi, q, s, o, w, tm, K, N, ksplit, st);
    case kFW16: return launch_decode_tc<kFW16>(x, x_hi, q, s, o, w, tm, K, N, ksplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Rows L6, L7, L8 and L10, each on the int8 tensor-core decode form
// lab_decode_i8tc. wfmt: 0 Q8_0, 1 Q4_0 (raw nibbles less 8 * sum(xq): the
// centered integers), 2 the Q4_0 bytes as two's-complement pairs. xlayout: 0
// xq [tm, K]; 1 xq [K/32, tm, 32]; 2 the halves xq, xq_hi [tm, K/2] (wfmt 1
// only). sx f32 [K/(32*sg_units), tm] or null. A scale group is sg_units
// quant blocks, a k-tile tile_units; group g of tile t takes scale row
// t*tile_units + g of s. Each split takes `per` quant blocks, ksplit * per
// >= K/32 > (ksplit - 1) * per (the plan of ops/lab_kernels.py
// lab_i8_plan); ws f32 [ksplit, tm, N], read only when ksplit > 1. Other
// arguments as llamago_lab_fmatmul.
extern "C" int llamago_lab_imatmul(const void* xq, const void* xq_hi, const void* sx,
                                   const void* q, const void* s, void* out, void* ws, int tm,
                                   int K, int N, int wfmt, int xlayout, int sg_units,
                                   int tile_units, int ksplit, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = K / 32;
  if (bad_shape(tm, K, N, ksplit) || per < 1 || (long long)ksplit * per < nb ||
      (long long)(ksplit - 1) * per >= nb || (ksplit > 1 && ws == nullptr) || wfmt < kItQ8 ||
      wfmt > kItI4 || xlayout < kItXRows || xlayout > kItXHalves || sg_units < 1 ||
      tile_units < sg_units || tile_units % sg_units || nb % tile_units ||
      (xlayout == kItXHalves && (wfmt != kItQ4Raw || xq_hi == nullptr)) ||
      (wfmt == kItI4 && xlayout != kItXRows))
    return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  ItArgs a{};
  a.xq = static_cast<const int8_t*>(xq), a.xq_hi = static_cast<const int8_t*>(xq_hi);
  a.sx = static_cast<const float*>(sx), a.sx_ld = tm;
  a.q = static_cast<const uint8_t*>(q), a.s = static_cast<const __nv_bfloat16*>(s);
  a.dst = ksplit > 1 ? w : o, a.dst_split = (size_t)tm * N;
  a.xlayout = xlayout, a.tm = tm, a.K = K, a.N = N, a.per = per;
  a.sg = sg_units, a.tile = tile_units, a.tile_rows = tile_units;
  cudaError_t e;
  if (wfmt == kItQ8)
    e = launch_decode_i8tc<kItQ8>(a, ksplit, st);
  else if (wfmt == kItQ4Raw)
    e = launch_decode_i8tc<kItQ4Raw>(a, ksplit, st);
  else
    e = launch_decode_i8tc<kItI4>(a, ksplit, st);
  if (e != cudaSuccess) return (int)e;
  if (ksplit > 1) reduce(w, o, tm, N, tm, ksplit, st);
  return (int)cudaGetLastError();
}

// x bf16 [tm, K] -> xq int8 [tm, K], sx f32 [K/32, tm], per (row, 32-block).
extern "C" int llamago_lab_quantize_x(const void* x, void* xq, void* sx, int tm, int K,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tm < 1 || K < 32 || K % 32) return (int)cudaErrorInvalidValue;
  const int items = tm * (K / 32);
  lab_quantize_x<<<(items + 3) / 4, 128, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<int8_t*>(xq),
                                                  static_cast<float*>(sx), tm, K);
  return (int)cudaGetLastError();
}

// Row L11. mode: 0 decode_only, 1 decode_bitcast, 2 dma_only (each a probe
// mode of lab_decode_tc), 3 dma_pure. q Q4_0 bytes [K/2, N], s bf16 [K/32,
// N], out f32 [tm, N] (every row the same), ws f32 [ksplit, N]; a block
// covers `rows` rows of K, ksplit = ceil(K / rows): for modes 0-2 a split of
// rows / 32 quant blocks (ops/lab_kernels.py probe_plan), for dma_pure its
// span tk.
extern "C" int llamago_lab_probe(const void* q, const void* s, void* out, void* ws, int tm,
                                 int K, int N, int mode, int rows, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tm < 1 || K < 32 || K % 32 || N < 16 || N % 16 || rows < 32 || rows % 32 ||
      ksplit != (K + rows - 1) / rows || mode < 0 || mode > 3 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto* qp = static_cast<const uint8_t*>(q);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  const int per = rows / 32;
  switch (mode) {
    case kPDecode: return launch_probe_tc<kFDecodeOnly>(q, s, o, w, tm, K, N, per, ksplit, st);
    case kPDecodeBitcast:
      return launch_probe_tc<kFDecodeBitcast>(q, s, o, w, tm, K, N, per, ksplit, st);
    case kPDmaOnly: return launch_probe_tc<kFDmaOnly>(q, s, o, w, tm, K, N, per, ksplit, st);
    default: break;
  }
  if (K % rows) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, ksplit);
  lab_probe_dma_pure<<<grid, kThreads, 0, st>>>(qp, w, N, rows / 2);
  reduce(w, o, tm, N, 1, ksplit, st);
  return (int)cudaGetLastError();
}
