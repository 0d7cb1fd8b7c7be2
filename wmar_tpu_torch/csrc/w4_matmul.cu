// w4a16 matrix product over grouped int4 weights, for Hopper.
//
// Replaces the TPU kernel wmar_tpu/ops/w4_matmul.py:_w4_kernel (launched by
// _matmul_w4_2d). Built with nvcc for sm_90a into a shared library with a
// plain C interface, loaded through ctypes by wmar_tpu_torch/ops/w4_matmul.py.
//
//   y[m, n] = sum_g s[g, n] * sum_{i<G} x[m, g*G + i] * w[g, i, n]
//   w[g, i, n]       = (q[g, i, n] & 15) - 8        for i <  G/2
//   w[g, i + G/2, n] = (q[g, i, n] >> 4) - 8        (the group-halves layout)
//
//   x     [M, K] bf16 or f32 (row-major), out [M, N] in x's type
//   q     uint8 [K/G, G/2, N]   two nibbles per byte, N contiguous
//   s     bf16  [K/G, N]        one scale per (group, output column)
//
// Each group's float32 partial sum is scaled by its bf16 scale, as the JAX
// package's default route (wquant.matmul4_xla) does; the weights are never
// rounded to bf16 and never written to device memory.
//
// What bounds it: instruction issue, not bytes. At Taming-1.4B with 32 rows
// a decode step reads ~0.7 GB of nibbles (~0.21 ms at 3.35 TB/s) but does
// 2 x 32 x 1.4e9 ~ 90 GFLOP, at least 1.3 ms on the card's ~67 TFLOP/s of
// float32 FMAs outside the tensor cores. This first design stays on the
// CUDA cores and keeps everything else cheap:
//   - a block per (64 columns, 8 rows); each of its 8 warps takes every 8th
//     group of the K axis (a split of K inside the block, so that narrow
//     matrices still give the card enough blocks), and the warps' sums are
//     added in a fixed order through shared memory at the end;
//   - per group a warp stages its x slice [8 rows, G] in shared memory as
//     float32, transposed to [G][8], so one 16-byte broadcast load brings 4
//     rows' values of one k;
//   - a lane owns 2 neighbouring columns: neighbouring lanes read
//     neighbouring bytes of q (coalesced), and one byte gives the weights of
//     rows i and i + G/2;
//   - nibbles become floats with an OR into the mantissa of 2^23 and one
//     subtraction, not the slower integer-to-float conversion.
// Tensor cores (mma.sync on bf16, then wgmma) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;   // rows of x per block
constexpr int kCols = 64;  // output columns per block: 2 per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// nibble v in [0, 16) -> v - 8 as a float: 0x4B000000 | v is 2^23 + v exactly
__device__ __forceinline__ float nibble(uint32_t v) {
  return __int_as_float(0x4B000000u | v) - 8388616.f;
}

template <typename XT>
__global__ void __launch_bounds__(kThreads) w4_matmul_kernel(
    const XT* __restrict__ x, const uint8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
    XT* __restrict__ out, int M, int N, int K, int G) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = G >> 1;
  const int gc = K / G;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const int n = n0 + 2 * lane;
  const bool c0 = n < N;
  const bool c1 = n + 1 < N;
  float* xs = smem + warp * G * kRows;  // this warp's x slice, [G][kRows]

  float acc[kRows][2];
  float part[kRows][2];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    acc[m][0] = acc[m][1] = 0.f;
    part[m][0] = part[m][1] = 0.f;
  }

  for (int g = warp; g < gc; g += kWarps) {
    __syncwarp();  // every lane is done with the previous group's slice
    for (int idx = lane; idx < G * kRows; idx += 32) {
      const int m = idx / G;
      const int k = idx - m * G;  // lanes across k: coalesced reads of x
      xs[k * kRows + m] = m < rows ? to_float(x[(size_t)(m0 + m) * K + (size_t)g * G + k]) : 0.f;
    }
    __syncwarp();

    const uint8_t* qg = q + (size_t)g * half * N;
    for (int i0 = 0; i0 < half; i0 += 4) {  // G/2 is a multiple of 4
      uint32_t b0[4], b1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // the loads of 4 byte rows before their math
        const uint8_t* r = qg + (size_t)(i0 + u) * N;
        b0[u] = c0 ? r[n] : 0x88u;  // 0x88: both nibbles 8, a weight of 0
        b1[u] = c1 ? r[n + 1] : 0x88u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float lo0 = nibble(b0[u] & 15u), hi0 = nibble(b0[u] >> 4);
        const float lo1 = nibble(b1[u] & 15u), hi1 = nibble(b1[u] >> 4);
        const float4* xa = reinterpret_cast<const float4*>(xs + (i0 + u) * kRows);
        const float4* xb = reinterpret_cast<const float4*>(xs + (i0 + u + half) * kRows);
#pragma unroll
        for (int j = 0; j < kRows / 4; ++j) {
          const float4 a = xa[j];
          const float4 b = xb[j];
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            part[4 * j + r][0] = fmaf(bv[r], hi0, fmaf(av[r], lo0, part[4 * j + r][0]));
            part[4 * j + r][1] = fmaf(bv[r], hi1, fmaf(av[r], lo1, part[4 * j + r][1]));
          }
        }
      }
    }
    const float s0 = c0 ? __bfloat162float(s[(size_t)g * N + n]) : 0.f;
    const float s1 = c1 ? __bfloat162float(s[(size_t)g * N + n + 1]) : 0.f;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      acc[m][0] = fmaf(s0, part[m][0], acc[m][0]);
      acc[m][1] = fmaf(s1, part[m][1], acc[m][1]);
      part[m][0] = part[m][1] = 0.f;
    }
  }

  // add the warps' K slices in a fixed order (the result does not depend on
  // which block or warp finished first)
  __syncthreads();  // every warp is done with its x slice
  float* red = smem;  // [kWarps][kRows][kCols]
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    red[(warp * kRows + m) * kCols + 2 * lane] = acc[m][0];
    red[(warp * kRows + m) * kCols + 2 * lane + 1] = acc[m][1];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * kCols; idx += kThreads) {
    const int m = idx / kCols;
    const int c = idx - m * kCols;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * kRows + m) * kCols + c];
    if (m < rows && n0 + c < N) out[(size_t)(m0 + m) * N + n0 + c] = from_float<XT>(sum);
  }
}

}  // namespace

extern "C" int wmar_w4_matmul(const void* x, const void* q, const void* s, void* out, int M, int N, int K,
                              int G, int x_is_bf16, void* stream) {
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  const int xs_floats = kWarps * G * kRows;
  const int red_floats = kWarps * kRows * kCols;
  const size_t smem = (size_t)(xs_floats > red_floats ? xs_floats : red_floats) * sizeof(float);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    w4_matmul_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
        static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(out), M, N, K, G);
  } else {
    w4_matmul_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(q),
        static_cast<const __nv_bfloat16*>(s), static_cast<float*>(out), M, N, K, G);
  }
  return static_cast<int>(cudaGetLastError());
}
