// K1: Q8_0 / Q4_0 dequant-matmul for Hopper (sm_90a).
//
//   out[m, n] = sum_k x[m, k] * (w[k, n] * s[k / 32, n])
//
// x: f32 or bf16 [M, K] row-major; s: f32 or bf16 [K/32, N]; out: x's dtype
// [M, N]. bits=8: q int8 [K, N] row-major, w = q. bits=4: q uint8 [K/2, N],
// where byte j of a 32-row block (packed rows 16b .. 16b+15) holds row
// 32b+j in its low nibble and row 32b+j+16 in its high nibble, w = nibble
// - 8. The weight is dequantized to f32 and every product is accumulated in
// f32.
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
//  * M <= 8 takes a weight-streaming GEMV-class kernel: each thread owns 16
//    neighbouring columns and reads one 16-byte vector of a weight row per
//    step (two rows of the block in the packed Q4_0 layout), so a warp
//    reads 512 contiguous bytes of a row. Eight warps of a
//    block split the rows of the block's K range by whole 32-row quant
//    blocks (one scale per column per quant block), the x values of a quant
//    block arrive in one coalesced load and are broadcast by warp shuffles,
//    and the grid splits K further so that enough blocks are in flight to
//    fill the card. Partial sums go to an f32 workspace and a second small
//    kernel adds them in a fixed order, so results are the same from run
//    to run (no atomics).
//  * M > 8 takes a plain shared-memory tiled f32 kernel (64x64 output tile,
//    one quant block of K per step, 4x4 outputs per thread). Tensor cores,
//    TMA and wgmma are later work.
//
// Built by nvcc into a shared library with a plain C interface
// (llamago_tpu_torch/ops/_build.py); launched on the caller's stream. The
// entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 consecutive scales starting at p (16-byte aligned) -> f32.
__device__ __forceinline__ void load_scales16(const float* p, float out[16]) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 f = __ldg(v + i);
    out[4 * i + 0] = f.x;
    out[4 * i + 1] = f.y;
    out[4 * i + 2] = f.z;
    out[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load_scales16(const __nv_bfloat16* p, float out[16]) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 u = __ldg(v + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      out[8 * i + 2 * j + 0] = f.x;
      out[8 * i + 2 * j + 1] = f.y;
    }
  }
}

union Q16 {
  int4 v;
  int8_t b[16];
};

constexpr int kGemvWarps = 8;
constexpr int kGemvCols = 32 * 16;  // columns per block: 32 lanes x 16

// Split-K GEMV-class kernel for M <= MT. grid = (ceil(N/512), ksplit),
// block = 256 threads. Block y covers quant blocks [y*bpb, (y+1)*bpb).
template <typename XT, typename ST, int MT, int BITS>
__global__ void __launch_bounds__(256) dq_gemv(const XT* __restrict__ x,
                                               const int8_t* __restrict__ q,
                                               const ST* __restrict__ s,
                                               float* __restrict__ ws, int M,
                                               int K, int N, int bpb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kGemvCols + lane * 16;
  const bool valid = n < N;
  const int nb = K / 32;
  const int kb0 = blockIdx.y * bpb;
  const int kb1 = min(kb0 + bpb, nb);

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  for (int kb = kb0 + warp; kb < kb1; kb += kGemvWarps) {
    float xr[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      xr[m] = (m < M) ? to_f(x[(size_t)m * K + kb * 32 + lane]) : 0.f;
    float sc[16];
    if (valid) load_scales16(s + (size_t)kb * N + n, sc);
    if constexpr (BITS == 8) {
      const int8_t* qrow = q + (size_t)kb * 32 * N + n;
#pragma unroll 8
      for (int r = 0; r < 32; ++r) {
        float xv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) xv[m] = __shfl_sync(0xffffffffu, xr[m], r);
        if (valid) {
          Q16 w;
          w.v = __ldg(reinterpret_cast<const int4*>(qrow + (size_t)r * N));
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float wj = (float)w.b[j] * sc[j];
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[m][j] = fmaf(xv[m], wj, acc[m][j]);
          }
        }
      }
    } else {
      // packed row r of the block: rows r (low nibbles) and r+16 (high)
      const int8_t* qrow = q + (size_t)kb * 16 * N + n;
#pragma unroll 8
      for (int r = 0; r < 16; ++r) {
        float xlo[MT], xhi[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          xlo[m] = __shfl_sync(0xffffffffu, xr[m], r);
          xhi[m] = __shfl_sync(0xffffffffu, xr[m], r + 16);
        }
        if (valid) {
          Q16 w;
          w.v = __ldg(reinterpret_cast<const int4*>(qrow + (size_t)r * N));
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int byte = (uint8_t)w.b[j];
            const float wlo = (float)((byte & 0xF) - 8) * sc[j];
            const float whi = (float)((byte >> 4) - 8) * sc[j];
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][j] = fmaf(xhi[m], whi, fmaf(xlo[m], wlo, acc[m][j]));
          }
        }
      }
    }
  }

  // Reduce the eight warps' partial sums in a fixed order. Layout
  // [m][j][lane] keeps the stores free of bank conflicts.
  __shared__ float red[MT * 16 * 32];
  for (int w = 0; w < kGemvWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = (m * 16 + j) * 32 + lane;
          red[i] = (w == 0 ? 0.f : red[i]) + acc[m][j];
        }
    }
    __syncthreads();
  }
  const size_t mn = (size_t)M * N;
  for (int i = threadIdx.x; i < MT * kGemvCols; i += blockDim.x) {
    const int m = i / kGemvCols;
    const int c = i % kGemvCols;
    const int nn = blockIdx.x * kGemvCols + c;
    if (m < M && nn < N)
      ws[blockIdx.y * mn + (size_t)m * N + nn] = red[(m * 16 + (c % 16)) * 32 + c / 16];
  }
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

constexpr int kTM = 64, kTN = 64, kTK = 32;

// Shared-memory tiled f32 kernel for M > 8. grid = (ceil(N/64),
// ceil(M/64)), block = 256 threads (16 x 16), 4 x 4 outputs each.
template <typename XT, typename ST, int BITS>
__global__ void __launch_bounds__(256) dq_tiled(const XT* __restrict__ x,
                                                const int8_t* __restrict__ q,
                                                const ST* __restrict__ s,
                                                XT* __restrict__ out, int M,
                                                int K, int N) {
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

  for (int kb = 0; kb < K / kTK; ++kb) {
    const int k0 = kb * kTK;
#pragma unroll
    for (int i = 0; i < (kTM * kTK) / 256; ++i) {
      const int idx = tid + 256 * i;
      const int r = idx / kTK, c = idx % kTK;
      const int m = m0 + r;
      xs[c][r] = (m < M) ? to_f(x[(size_t)m * K + k0 + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (kTK * kTN) / 256; ++i) {
      const int idx = tid + 256 * i;
      const int r = idx / kTN, c = idx % kTN;
      const int n = n0 + c;
      float w = 0.f;
      if (n < N) {
        if constexpr (BITS == 8) {
          w = (float)q[(size_t)(k0 + r) * N + n];
        } else {
          const int byte = (uint8_t)q[(size_t)(kb * 16 + (r & 15)) * N + n];
          w = (float)((r < 16 ? byte & 0xF : byte >> 4) - 8);
        }
        w *= to_f(s[(size_t)kb * N + n]);
      }
      wsh[r][c] = w;
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
      if (n < N) out[(size_t)m * N + n] = from_f<XT>(acc[i][j]);
    }
  }
}

template <typename XT, typename ST, int MT, int BITS>
void launch_gemv(const void* x, const void* q, const void* s, void* out, float* ws,
                 int M, int K, int N, int ksplit, cudaStream_t st) {
  const int nb = K / 32;
  const int bpb = (nb + ksplit - 1) / ksplit;
  dim3 grid((N + kGemvCols - 1) / kGemvCols, ksplit);
  dq_gemv<XT, ST, MT, BITS><<<grid, 256, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(q),
      static_cast<const ST*>(s), ws, M, K, N, bpb);
  const size_t mn = (size_t)M * N;
  dq_reduce<XT><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(ws, static_cast<XT*>(out),
                                                              mn, ksplit);
}

template <typename XT, typename ST, int BITS>
void launch_bits(const void* x, const void* q, const void* s, void* out, float* ws, int M,
                 int K, int N, int ksplit, cudaStream_t st) {
  if (M <= 1) return launch_gemv<XT, ST, 1, BITS>(x, q, s, out, ws, M, K, N, ksplit, st);
  if (M <= 2) return launch_gemv<XT, ST, 2, BITS>(x, q, s, out, ws, M, K, N, ksplit, st);
  if (M <= 4) return launch_gemv<XT, ST, 4, BITS>(x, q, s, out, ws, M, K, N, ksplit, st);
  if (M <= 8) return launch_gemv<XT, ST, 8, BITS>(x, q, s, out, ws, M, K, N, ksplit, st);
  dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  dq_tiled<XT, ST, BITS><<<grid, 256, 0, st>>>(static_cast<const XT*>(x),
                                               static_cast<const int8_t*>(q),
                                               static_cast<const ST*>(s),
                                               static_cast<XT*>(out), M, K, N);
}

template <typename XT, typename ST>
void launch(const void* x, const void* q, const void* s, void* out, float* ws, int M,
            int K, int N, int bits, int ksplit, cudaStream_t st) {
  if (bits == 8)
    launch_bits<XT, ST, 8>(x, q, s, out, ws, M, K, N, ksplit, st);
  else
    launch_bits<XT, ST, 4>(x, q, s, out, ws, M, K, N, ksplit, st);
}

}  // namespace

// bits: 8 (q int8 [K, N]) or 4 (q uint8 [K/2, N]). x_bf16 / s_bf16: 1 for
// bfloat16, 0 for float32. `ws` is an f32 workspace of ksplit*M*N elements,
// used when M <= 8. Returns cudaGetLastError() after the launches.
extern "C" int llamago_dequant_matmul(const void* x, const void* q, const void* s,
                                      void* out, void* ws, int M, int K, int N, int bits,
                                      int x_bf16, int s_bf16, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (x_bf16 && s_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, w, M, K, N, bits, ksplit, st);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, q, s, out, w, M, K, N, bits, ksplit, st);
  else if (s_bf16)
    launch<float, __nv_bfloat16>(x, q, s, out, w, M, K, N, bits, ksplit, st);
  else
    launch<float, float>(x, q, s, out, w, M, K, N, bits, ksplit, st);
  return (int)cudaGetLastError();
}
