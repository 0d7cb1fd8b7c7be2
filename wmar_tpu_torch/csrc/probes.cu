// Two measuring kernels, for Hopper: what a decode-attention kernel over the
// packed int8 cache would cost if it only moved its bytes, and what one
// small launch costs.
//
// Replaces two TPU kernels of the JAX package:
//   ops/flash_decode.py   _packed_dma_probe -> _dma_probe_kernel   (dma_probe below)
//   tools/bench_call_floor.py   make_copy.call -> kern             (row_mean_probe below)
// Built with nvcc for sm_90a into the shared library of the other kernels
// and loaded through ctypes by wmar_tpu_torch/ops/flash_decode.py.
//
// dma_probe. On the TPU the pipeline copies every block of the grid into
// fast memory whether or not the body reads it, so a body that reads one row
// times the copies alone. A GPU reads nothing that the code does not load, so
// this kernel loads every byte: it has the grid and block of the int8 decode
// kernel (packed_decode_attention.cu: one block of four warps per (head, row),
// 16 slots per chunk, 4 slots per warp loaded before they are used, 4 bytes a
// lane), walks all T slots of the row, and loads each slot's K and V words
// and both scales exactly as that kernel does. Instead of the attention math
// it adds up the set bits of what it loaded; the count cannot reach 2^32 - 1
// (at most 32 per word, far fewer words), and only that value would change
// the output, which the compiler cannot know, so no load is dropped. The
// output is the TPU probe's: kv[b, 0, :H*D] + scale[b, 0, 0] as [B, H, D] in
// q's type. Bound by bytes by construction: its time is the floor of kernels
// #2 and #3 with this access pattern on this card.
//   kv int8 [B, T, 2*H*D] (one layer), scale bf16 [B, 2H, T], out [B, H, D]
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
constexpr int kUnroll = 4;
constexpr int kMaxWords = 2;  // 32-bit words of one slot's D <= 256 bytes a lane owns

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename QT>
__global__ void __launch_bounds__(kThreads) dma_probe_kernel(
    const uint8_t* __restrict__ kv, const __nv_bfloat16* __restrict__ scale, QT* __restrict__ out,
    int T, int H, int D) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int HD = H * D;
  const int row_bytes = 2 * HD;
  const int nw = D >> 2;

  const uint8_t* kvb = kv + (size_t)b * T * row_bytes + (size_t)h * D;
  const unsigned short* k_scale =
      reinterpret_cast<const unsigned short*>(scale + ((size_t)b * 2 * H + h) * T);
  const unsigned short* v_scale =
      reinterpret_cast<const unsigned short*>(scale + ((size_t)b * 2 * H + H + h) * T);

  uint32_t bits = 0;
  for (int base = warp * kUnroll; base < T; base += kWarps * kUnroll) {
    uint32_t kw[kUnroll][kMaxWords];
    uint32_t vw[kUnroll][kMaxWords];
    uint32_t ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // loads first, as the decode kernel issues them
      const int t = base + u;
      const bool ok = t < T;
      ks[u] = ok ? __ldg(k_scale + t) : 0u;
      vs[u] = ok ? __ldg(v_scale + t) : 0u;
      const uint32_t* row = reinterpret_cast<const uint32_t*>(kvb + (size_t)t * row_bytes);
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i) {
        const int j = lane + 32 * i;
        const bool in = ok && j < nw;
        kw[u][i] = in ? __ldg(row + j) : 0u;
        vw[u][i] = in ? __ldg(row + (HD >> 2) + j) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bits += __popc(ks[u]) + __popc(vs[u]);
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i) bits += __popc(kw[u][i]) + __popc(vw[u][i]);
    }
  }

  const float s00 = __bfloat162float(scale[(size_t)b * 2 * H * T]);  // scale[b, 0, 0]
  const int8_t* first = reinterpret_cast<const int8_t*>(kv + (size_t)b * T * row_bytes + (size_t)h * D);
  const size_t oo = ((size_t)b * H + h) * D;
  for (int d = tid; d < D; d += kThreads) {
    float val = (float)first[d] + s00;
    if (bits == 0xFFFFFFFFu) val = -val;  // never true: keeps every load alive
    out[oo + d] = from_float<QT>(val);
  }
}

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

// D must be a multiple of 4 in (0, 256] and kv_layer 4-byte aligned; the
// Python wrapper checks both.
extern "C" int wmar_dma_probe(const void* kv_layer, const void* scale_layer, void* out, int B, int H,
                              int T, int D, int out_is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(H, B);
  const auto* kvp = static_cast<const uint8_t*>(kv_layer);
  const auto* sp = static_cast<const __nv_bfloat16*>(scale_layer);
  if (out_is_bf16) {
    dma_probe_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(kvp, sp, static_cast<__nv_bfloat16*>(out),
                                                              T, H, D);
  } else {
    dma_probe_kernel<float><<<grid, kThreads, 0, s>>>(kvp, sp, static_cast<float*>(out), T, H, D);
  }
  return static_cast<int>(cudaGetLastError());
}

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
