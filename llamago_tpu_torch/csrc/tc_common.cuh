// PTX wrappers shared by the tensor-core kernels of K1 (dq_tc and
// dq_decode_tc, dequant_matmul.cu), K9 (so_decode_tc,
// dequant_matmul_so.cu), K5 and K6 (w4x8_a8_tc and w4x8_tc,
// w4x8_matmul.cu), K2 (attn_decode_tc, attn_decode.cu), K7
// (attn_prefill.cu), K4 and K8 (quant_partial_tc and widening_tc,
// attn_decode_quant.cu), the lab's tensor-core forms and its cp.async
// probe (lab_matmul.cu): cp.async staging, ldmatrix A fragments and
// transposed B fragments, mma.sync.m16n8k16 (bf16, f32 accumulation) and
// mma.sync.m16n8k32 (int8, exact int32 accumulation), bf16 packing and scale
// reads from shared memory, TMA bulk copies on mbarriers, the words of a
// lane's 16-byte read, the exact bf16 pairs of int8 and Q4_0 weights, f32
// x as three exact bf16 parts (split3, split_x3), and the f32 attention of
// K2's and K7's f32 forms as three TF32 products (split_tf32, mma_tf32,
// c_to_a, qk_f32tc, pv_f32tc). Each source builds into its own library,
// so the functions live in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N_> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_) : "memory");
}

// Bulk copies by the TMA unit, completing on an mbarrier in shared memory:
// one thread arms the barrier with the bytes it expects (mbar_expect, one
// arrival), any threads start copies that count their bytes off it, and
// every reader waits for the phase (mbar_wait, parity 0, 1, 0, ... as the
// barrier is reused). The copy's size is a multiple of 16, both addresses
// 16-byte aligned. `policy` (l2_evict_first) marks data read once, so that
// it leaves L2 before data read again.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a) : "memory");
}
// After mbar_init and before any thread's first use of the barriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(a), "r"(parity) : "memory");
}
// Orders this thread's generic-proxy accesses of shared memory before
// later async-proxy accesses of the same bytes: a bulk copy into them that
// any thread issues after a barrier which follows the fence.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(d), "l"(src), "r"(bytes), "r"(b), "l"(policy)
      : "memory");
}

// Fragment layouts of mma.m16n8k16 with gid = lane / 4, tig = lane % 4: A
// regs hold (row gid | gid+8, k 2*tig+{0,1} | +8); B regs hold (k
// 2*tig+{0,1} | +8, n gid), the lower k in the low half; C holds (row gid,
// n 2*tig+{0,1}) in c0, c1 and (row gid+8, the same n) in c2, c3.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.m16n8k32 on int8, summed exactly in int32. With gid = lane / 4, tig =
// lane % 4, each register holds four consecutive k, the lowest in the low
// byte: A regs (row gid | gid+8, k 4*tig..+3 | +16), B regs (k 4*tig..+3 |
// +16, n gid); C as mma.m16n8k16's.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices: lanes 8i..8i+7 give the row addresses of matrix
// i; lane l receives M_i[l / 4][2 * (l % 4) + {0, 1}] in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two 8x8 bf16 matrices: lanes 8i..8i+7 (i < 2) give the row addresses of
// matrix i; lane l receives M_i[l / 4][2 * (l % 4) + {0, 1}] in r[i].
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* smem_row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// Four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i; lane l receives M_i[2 * (l % 4) + {0, 1}][l / 4] in r[i].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte J of two words of int8 weights (each already XORed with 0x80808080,
// so a byte holds q + 128) as a bf16 pair, exactly: 0x4B0000uu is the f32
// 2^23 + uu, and 2^23 + 128 comes off in f32. `lo` gives the low half.
template <int J> __device__ __forceinline__ uint32_t i8_pair(uint32_t lo, uint32_t hi) {
  const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7440 | J)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7440 | J)) - 8388736.f;
  return pack_bf16(a, b);
}

// The nibble at SHIFT (0: low, 4: high) of byte J of two packed Q4_0 words,
// minus 8 (RAW: as it is, 0..15), as a bf16 pair, exactly: 0x43nn is the
// bf16 128 + n (n < 16), and 136 (0x4308; RAW: 128, 0x4300) comes off in
// bf16. `lo` gives the low half.
template <int J, int SHIFT, bool RAW = false>
__device__ __forceinline__ uint32_t q4_pair(uint32_t lo, uint32_t hi) {
  const uint32_t t = __byte_perm(lo, hi, J | ((4 + J) << 8));  // bytes 0 and 2
  uint32_t v = ((t >> SHIFT) & 0x000F000Fu) | 0x43004300u;
  const uint32_t c = RAW ? 0x43004300u : 0x43084308u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Word I of a lane's 16 bytes of a weight row: columns n+4I .. n+4I+3.
template <int I> __device__ __forceinline__ uint32_t word_of(const uint4& v) {
  return I == 0 ? v.x : I == 1 ? v.y : I == 2 ? v.z : v.w;
}

// f32 x as three bf16 parts (bits in the low 16 of .x hi, .y mid, .z lo)
// with hi + mid + lo == x exactly for every normal x whose low part stays
// in bf16's range: hi is x truncated to its top 16 bits, mid the same of
// x - hi, lo = bf16(x - hi - mid), which holds at most 8 significant bits
// and so rounds exactly; both differences are exact in f32. Truncation, not
// rounding, so no part overflows near f32's maximum. An inf or NaN goes
// whole into hi, mid = lo = 0; a NaN whose payload lies only in the low 16
// bits gets bf16's quiet bit, so it stays a NaN.
__device__ __forceinline__ uint3 split3(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7F800000u) == 0x7F800000u)
    return make_uint3((u >> 16) | ((u & 0xFFFFu) ? 0x40u : 0u), 0u, 0u);
  const float r = x - __uint_as_float(u & 0xFFFF0000u);
  const uint32_t ru = __float_as_uint(r);
  const float l = r - __uint_as_float(ru & 0xFFFF0000u);
  return make_uint3(u >> 16, ru >> 16, (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(l)));
}

// The three bf16 planes of f32 x [n values], for the tensor-core forms that
// take f32 x (dq_tc and w4x8_tc with three parts): planes[p * n + i] is
// part p (0 hi, 1 mid, 2 lo) of x[i]. Four values a thread; n a multiple of
// 4, both pointers 16-byte aligned.
__global__ void __launch_bounds__(256) split_x3(const float* __restrict__ x,
                                                uint16_t* __restrict__ planes, size_t n) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const float4 v = *reinterpret_cast<const float4*>(x + i);
  const uint3 a = split3(v.x), b = split3(v.y), c = split3(v.z), d = split3(v.w);
  uint16_t* p = planes + i;
  *reinterpret_cast<uint2*>(p) = make_uint2(a.x | (b.x << 16), c.x | (d.x << 16));
  *reinterpret_cast<uint2*>(p + n) = make_uint2(a.y | (b.y << 16), c.y | (d.y << 16));
  *reinterpret_cast<uint2*>(p + 2 * n) = make_uint2(a.z | (b.z << 16), c.z | (d.z << 16));
}

// ------------------------------------------ f32 attention as 3xTF32 (K2, K7)
//
// mma.m16n8k8 on tf32 with f32 accumulation. With gid = lane / 4, tig =
// lane % 4: A regs a0..a3 hold (row gid, k tig), (row gid+8, k tig), (row
// gid, k tig+4), (row gid+8, k tig+4); B regs b0, b1 hold (k tig, n gid),
// (k tig+4, n gid); C as mma.m16n8k16's: (row gid, n 2*tig+{0,1}) in c0, c1
// and (row gid+8, the same n) in c2, c3. A product of two f32 values a * b
// is taken as big_a big_b + big_a small_b + small_a big_b (3xTF32), the
// small products first; small_a small_b, under 2^-20 of the product with
// big truncated (below), is dropped.
// wgmma takes tf32 only with K-major B operands, and V is MN-major in P V,
// so these forms stay on mma.sync.

struct Tf32Pair {
  uint32_t big, small;
};

// a = big + small, as the tensor cores read the two registers (the low 13
// bits of a tf32 operand are ignored): big is a truncated to tf32 (its low
// 13 bits cleared), and small the difference a - big, exact in f32, with
// half of tf32's last place (0x1000) added to its magnitude's bits, so
// that the truncation rounds it to nearest, ties away from zero (as
// cvt.rna.tf32.f32 would). Truncating big, not rounding it, keeps three
// instructions a value, rounds no finite value up to inf, and keeps a NaN
// a NaN; |small| stays under 2^-10 |a| and its rounding 2^-22 |a|. An inf
// or NaN goes whole into big, and small reads as 0: a - big is then the
// canonical NaN 0x7FFFFFFF, which the half place carries to 0x80000FFF,
// -0 once truncated.
__device__ __forceinline__ Tf32Pair split_tf32(float a) {
  const uint32_t big = __float_as_uint(a) & 0xFFFFE000u;
  return {big, __float_as_uint(a - __uint_as_float(big)) + 0x1000u};
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment of f32 values as its big and small tf32 parts.
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32Pair p = split_tf32(a[i]);
    big[i] = p.big;
    small[i] = p.small;
  }
}

// The C fragment of an m16n8 product as the A fragment of a product over
// the same 8 columns, with no data moved between lanes: the reduction index
// is permuted, A's k = tig holding C's column 2 tig and k = tig + 4 column
// 2 tig + 1 (a0 = c0, a1 = c2, a2 = c1, a3 = c3). The B operand takes its
// rows in the same order: b0 from row 2 tig, b1 from row 2 tig + 1 of the
// 8. Only the order of the f32 sums sees the permutation.
__device__ __forceinline__ void c_to_a(const float (&c)[4], float (&a)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

// A K or V tile of the f32 forms: 32 slots in shared memory as 8 groups of
// 4 neighbouring slots (one bulk copy each), groups f32_gld floats apart
// (16 bytes of padding after each). The 8 rows of a B fragment are one slot
// of each group: column c of the scores' n-tile n is slot 4 c + n, so that
// the K reads (slot 4 gid + n, word tig) and the V reads (slots 4 (2 tig) +
// ks and 4 (2 tig + 1) + ks, word gid) fall on 32 distinct banks.
constexpr int kF32Tile = 32;  // slots of a tile
constexpr int kF32Group = 4;  // slots of a group
constexpr int kF32Pad = 4;    // floats of padding after a group (16 bytes)
template <int HD> __host__ __device__ constexpr int f32_gld() { return kF32Group * HD + kF32Pad; }
// Row stride of q in shared memory (floats): 16 bytes of padding, so that an
// A fragment's reads (rows gid and gid + 8, words tig and tig + 4) fall on
// distinct banks.
template <int HD> __host__ __device__ constexpr int f32_qld() { return HD + 4; }

// s[n] += Q K^T over n-tiles n0 .. n0 + NT - 1 of a tile (n-tile n: column
// c is slot 4 c + n) in 3xTF32. qfrag(kk, big, small) gives this warp's 16
// query rows at k-step kk (dims 8 kk ..) as the A fragment's tf32 parts; Ks
// is the K tile, split as read. A B fragment of f32 is two 8x4 matrices of
// words, which ldmatrix (b16) moves whole: lane l gets word l % 4 of row
// l / 4, (slot 4 gid + n, dim 8 kk + tig) and (.., + 4); one ldmatrix.x4
// brings two n-tiles, an x2 one. With fewer than four n-tiles the passes
// take accumulators of their own, so that independent mma chains stay in
// flight: small_q big_k, big_q small_k and big_q big_k (one n-tile), the
// two small products and big_q big_k (two), added in that order at the end.
template <int HD, int NT, typename QFrag>
__device__ __forceinline__ void qk_f32tc(float (&s)[NT][4], QFrag qfrag, const float* Ks, int n0,
                                         int lane) {
  constexpr int P = NT == 1 ? 3 : NT == 2 ? 2 : 1;  // accumulators a score
  // lane l gives row l % 8 (slot 4 (l % 8) + n) of matrix l / 8: dims + 4
  // for odd matrices, n-tile + 1 for the upper two
  const float* krow = Ks + (lane & 7) * f32_gld<HD>() + ((lane >> 3) & 1) * 4 +
                      (NT > 1 ? ((lane >> 4) & 1) * HD : 0) + n0 * HD;
  float acc[P][NT][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[p][n][0] = acc[p][n][1] = acc[p][n][2] = acc[p][n][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
    qfrag(kk, ab, as);
    uint32_t raw[NT][2];
    if constexpr (NT == 1) {
      ldmatrix_x2(raw[0], krow + kk * 8);
    } else {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, krow + n * HD + kk * 8);
        raw[n][0] = r[0], raw[n][1] = r[1], raw[n + 1][0] = r[2], raw[n + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const Tf32Pair x = split_tf32(__uint_as_float(raw[n][0]));
      const Tf32Pair y = split_tf32(__uint_as_float(raw[n][1]));
      bb[n][0] = x.big, bs[n][0] = x.small, bb[n][1] = y.big, bs[n][1] = y.small;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[0][n], as, bb[n][0], bb[n][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[P == 3 ? 1 : 0][n], ab, bs[n][0], bs[n][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[P - 1][n], ab, bb[n][0], bb[n][1]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = acc[0][n][e];
#pragma unroll
      for (int p = 1; p < P; ++p) v += acc[p][n][e];
      s[n][e] += v;
    }
}

// o[n] += P V over k-steps ks0 .. ks0 + NT - 1 of a tile (the scores'
// n-tiles of the same numbers; output n-tile n: columns 8 n ..) in 3xTF32:
// p holds the probabilities in the scores' C fragments, repacked by c_to_a
// and split once a k-step; Vs is the V tile, split as read.
template <int HD, int NT>
__device__ __forceinline__ void pv_f32tc(float (&o)[HD / 8][4], const float (&p)[NT][4],
                                         const float* Vs, int ks0, int lane) {
  constexpr int GLD = f32_gld<HD>();
  const float* vrow = Vs + 2 * (lane & 3) * GLD + (lane >> 2) + ks0 * HD;
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    float a[4];
    uint32_t ab[4], as[4];
    c_to_a(p[ks], a);
    split_a(a, ab, as);
    const float* v = vrow + ks * HD;
#pragma unroll
    for (int n0 = 0; n0 < HD / 8; n0 += 4) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Tf32Pair x = split_tf32(v[(n0 + j) * 8]);
        const Tf32Pair y = split_tf32(v[GLD + (n0 + j) * 8]);
        bb[j][0] = x.big, bs[j][0] = x.small, bb[j][1] = y.big, bs[j][1] = y.small;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(o[n0 + j], as, bb[j][0], bb[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(o[n0 + j], ab, bs[j][0], bs[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(o[n0 + j], ab, bb[j][0], bb[j][1]);
    }
  }
}

// 8 consecutive scales in shared memory (16-byte aligned) -> f32.
__device__ __forceinline__ void smem_scales8(const float* p, float (&out)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

__device__ __forceinline__ void smem_scales8(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

}  // namespace
