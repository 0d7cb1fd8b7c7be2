// Single-token decode attention over the packed int4 KV cache, for Hopper.
//
// Replaces the TPU kernel ops/flash_decode.py:_packed4_attn_kernel of the
// JAX package (its single-block path, T < 1024). Built with nvcc for
// sm_90a into a shared library with a plain C interface, loaded through
// ctypes by wmar_tpu_torch/ops/flash_decode.py.
//
// Layout of one layer (read in place from the stacked cache by offset):
//   kv    uint8 [B, T, H*D]  low nibble K, high nibble V, value = nibble - 8
//   scale bf16  [B, 2H, T]   rows [0, H) K scales, rows [H, 2H) V scales
//   q     [B, H, D] (bf16 or f32), out [B, H, D] in q's type
//
// What bounds it: bytes. One call reads B*T*H*D cache bytes plus 4*B*H*T
// bytes of scales and does about 4 flops per cache byte, far below the
// card's flops-per-byte balance. The design keeps the byte stream
// coalesced and keeps everything else on chip:
//   - one block per (head h, row b); the D bytes of one (t, h) are
//     contiguous, and neighbouring d are neighbouring bytes;
//   - phase 1: one warp per slot t, lanes across d, a warp-shuffle sum,
//     K from the low nibble times its scale; the scores of the valid slots
//     stay in dynamic shared memory (T floats);
//   - a block max and sum turn them into softmax weights, folded with the
//     V scale of their slot;
//   - phase 2: threads across d accumulate p * V from the high nibble of
//     the same bytes, which the first pass has just brought into L2.
// valid_len is read from device memory, so a decode loop never syncs with
// the host and a CUDA graph can replay the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Reduces one value per warp (held by every lane) across the block.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <typename QT>
__global__ void __launch_bounds__(kThreads) packed4_decode_attention_kernel(
    const QT* __restrict__ q, const uint8_t* __restrict__ kv,
    const __nv_bfloat16* __restrict__ scale, const int32_t* __restrict__ valid_len,
    QT* __restrict__ out, int T, int H, int D, float sm_scale) {
  extern __shared__ float smem[];
  float* p = smem;       // [T] scores, then softmax weights times V scale
  float* qs = p + T;     // [D]
  float* red = qs + D;   // [kWarps]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int HD = H * D;
  const int n = min(max(valid_len[0], 1), T);

  const uint8_t* kvb = kv + (size_t)b * T * HD + (size_t)h * D;
  const __nv_bfloat16* k_scale = scale + ((size_t)b * 2 * H + h) * T;
  const __nv_bfloat16* v_scale = scale + ((size_t)b * 2 * H + H + h) * T;
  const size_t qo = ((size_t)b * H + h) * D;

  for (int d = tid; d < D; d += kThreads) qs[d] = to_float(q[qo + d]);
  __syncthreads();

  // phase 1: scores of the valid slots, one warp per slot
  float m = -INFINITY;
  for (int t = warp; t < n; t += kWarps) {
    const uint8_t* row = kvb + (size_t)t * HD;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += qs[d] * (float)((int)(row[d] & 0xF) - 8);
    const float s = warp_sum(acc) * __bfloat162float(k_scale[t]) * sm_scale;
    if (lane == 0) p[t] = s;
    m = fmaxf(m, s);
  }
  m = block_reduce<true>(m, red);  // its __syncthreads also publishes p

  float l = 0.f;
  for (int t = tid; t < n; t += kThreads) {
    const float e = expf(p[t] - m);
    l += e;
    p[t] = e * __bfloat162float(v_scale[t]);
  }
  l = block_reduce<false>(warp_sum(l), red);
  const float inv_l = 1.f / l;

  // phase 2: threads across d, p * V from the high nibbles
  for (int d = tid; d < D; d += kThreads) {
    const uint8_t* col = kvb + d;
    float acc = 0.f;
#pragma unroll 4
    for (int t = 0; t < n; ++t) acc += p[t] * (float)((int)(col[(size_t)t * HD] >> 4) - 8);
    out[qo + d] = from_float<QT>(acc * inv_l);
  }
}

}  // namespace

extern "C" int wmar_packed4_decode_attention(
    const void* q, const void* kv_layer, const void* scale_layer, const void* valid_len,
    void* out, int B, int H, int T, int D, int q_is_bf16, float sm_scale, void* stream) {
  const dim3 grid(H, B);
  const size_t smem = (size_t)(T + D + kWarps) * sizeof(float);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (q_is_bf16) {
    packed4_decode_attention_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kv_layer),
        static_cast<const __nv_bfloat16*>(scale_layer), static_cast<const int32_t*>(valid_len),
        static_cast<__nv_bfloat16*>(out), T, H, D, sm_scale);
  } else {
    packed4_decode_attention_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const uint8_t*>(kv_layer),
        static_cast<const __nv_bfloat16*>(scale_layer), static_cast<const int32_t*>(valid_len),
        static_cast<float*>(out), T, H, D, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
