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
// lane's 16-byte read, the exact bf16 pairs of int8 and Q4_0 weights, and
// f32 x as three exact bf16 parts (split3, split_x3).
// Each source builds into its own library,
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
