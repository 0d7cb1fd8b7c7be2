// A measuring kernel, for Hopper: what one small launch costs.
//
// Replaces the TPU kernel of the JAX package's tools/bench_call_floor.py,
// make_copy.call -> kern (row_mean_probe below). Built with nvcc for sm_90a
// into the shared library of the other kernels and loaded through ctypes by
// wmar_tpu_torch/ops/flash_decode.py. The other probe, the DMA probe of the
// packed int8 decode kernel (_dma_probe_kernel), is an instantiation of that
// kernel with its math compiled out: see packed_chunked_attention.cu.
//
// row_mean_probe. x bf16 [rows, cols] -> the float32 mean of each row,
// rounded to bf16 and written to all out_cols columns of out [rows,
// out_cols]. A warp per row, 16-byte loads. At one row it moves 2 KB and its
// time is the card's per-launch floor; at 16,384 rows it is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// One warp per row; cols a multiple of 8 (16-byte loads of 8 bf16).
__global__ void __launch_bounds__(kThreads) row_mean_probe_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int rows, int cols,
    int out_cols) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * cols);
  float sum = 0.f;
#pragma unroll 4
  for (int j = lane; j < (cols >> 3); j += 32) {
    const uint4 w = __ldg(xr + j);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sum += __uint_as_float(ws[c] << 16);          // a bf16 is the high half of its float
      sum += __uint_as_float(ws[c] & 0xFFFF0000u);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const __nv_bfloat16 mean = __float2bfloat16_rn(sum / (float)cols);
  for (int j = lane; j < out_cols; j += 32) out[(size_t)row * out_cols + j] = mean;
}

}  // namespace

// cols must be a multiple of 8 and x 16-byte aligned; the Python wrapper checks both.
extern "C" int wmar_row_mean_probe(const void* x, void* out, int rows, int cols, int out_cols,
                                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int blocks = (rows + kWarps - 1) / kWarps;
  row_mean_probe_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                    static_cast<__nv_bfloat16*>(out), rows, cols,
                                                    out_cols);
  return static_cast<int>(cudaGetLastError());
}
