// Single-token decode attention over the packed KV caches (int4 and int8),
// streamed in chunks with an online softmax, for Hopper.
//
// Replaces the TPU kernel _packed_attn_kernel_q8 of the JAX package's
// ops/flash_decode.py (the int8 cache, T < 1024, no masks). It was first
// written for the two chunked kernels as well (T >= 1024, through
// _chunked_body, with a per-row first slot, start, and an optional per-row
// slot mask, key_mask); those now have the tiled kernel of
// packed_chunked_attention.cu and come here only at a head dim whose slot
// fits no warp there (no multiple of 8 above 128). So does the short-cache
// int4 kernel (_packed4_attn_kernel, T < 1024), whose own route is the tiled
// kernel too: it comes here at those head dims and at one that is no
// multiple of 4 (its runs are then read byte by byte). One template covers all:
// the payload (int4 or int8) is a template argument, start and key_mask are
// null pointers where the call has none. Built with nvcc for sm_90a into a
// shared library with a plain C interface, loaded through ctypes by
// wmar_tpu_torch/ops/flash_decode.py.
//
// Layout of one layer (read in place from the stacked cache by offset):
//   int4  kv uint8 [B, T, H*D]    low nibble K, high nibble V, value = nibble - 8
//   int8  kv int8  [B, T, 2*H*D]  lanes [0, HD) K, lanes [HD, 2HD) V
//   scale bf16 [B, 2H, T]         rows [0, H) K scales, rows [H, 2H) V scales
//   q [B, H, D] (bf16 or f32), out [B, H, D] in q's type
//   valid_len int32 [1], start int32 [B] or null, key_mask uint8 [B, T] or null
//
// What bounds it: bytes. At Chameleon-7B (24 rows, 32 heads of 128, ~1043
// slots) a full int4 call reads ~102 MB of payload and ~3 MB of scales, at
// about 4 flops per byte, far below the card's flops-per-byte balance. The
// design reads every byte it needs once and nothing else:
//   - one block per (head h, row b), four warps. Slot t of the row is one
//     contiguous D-byte run (2 x D for int8: K and V runs); a lane loads 4
//     bytes of it as one 32-bit word, so a warp reads up to 128 bytes of a
//     slot in one instruction;
//   - the TPU grid's sequential chunk axis becomes a loop inside the block:
//     the block walks [start_b, valid_len) in chunks of 16 slots, each warp
//     4 of them, with its loads issued before its math so that 4 slots per
//     warp are in flight. Slots before start_b and from valid_len on are
//     never read, which is what the TPU index map's chunk skip did; slots
//     whose key_mask byte is 0 are skipped, their payload not read;
//   - each warp keeps its own running max, sum and acc[D] (in registers,
//     4 values of D per word a lane owns) and updates them slot by slot, so
//     nothing is held in shared memory while the row streams; the four
//     warps' states are merged once at the end (4 KB of shared memory at
//     any T). For int4 the one word gives K (for the score) and V (for the
//     sum), so each payload byte is read once.
// Numbers: float32 throughout, the output rounded to q's type at the end.
// A row must have at least one slot in [start_b, valid_len) whose mask is 1
// (every row of the Chameleon path has one); a row with none gets zeros.
// Nothing is read back to the host, so a CUDA graph can replay the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // slots per warp per chunk
constexpr int kMaxD = 256;
constexpr int kMaxWords = kMaxD / 4 / 32;  // 32-bit words of one slot a lane owns

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

// Byte c of a word as the K value (int4: low nibble - 8; int8: signed byte).
template <bool kInt4>
__device__ __forceinline__ float k_of(uint32_t w, int c) {
  const uint32_t byte = (w >> (8 * c)) & 0xFFu;
  if (kInt4) return (float)((int)(byte & 0xFu) - 8);
  return (float)(int)(int8_t)byte;
}

// Byte c as the V value (int4: high nibble - 8 of the K word; int8: signed byte of the V word).
template <bool kInt4>
__device__ __forceinline__ float v_of(uint32_t w, int c) {
  const uint32_t byte = (w >> (8 * c)) & 0xFFu;
  if (kInt4) return (float)((int)(byte >> 4) - 8);
  return (float)(int)(int8_t)byte;
}

// Word j (bytes 4j .. 4j + 3) of a slot's D-byte run. kBytes (a head dim that
// is no multiple of 4, whose runs are not 4-byte aligned): four byte loads, and
// a byte beyond D is 0x88, an int4 value of 0 (q is 0 there, and its acc is
// never stored).
template <bool kBytes>
__device__ __forceinline__ uint32_t load_word(const uint8_t* run, int j, int D) {
  if (!kBytes) return __ldg(reinterpret_cast<const uint32_t*>(run) + j);
  uint32_t w = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) w |= (4 * j + c < D ? static_cast<uint32_t>(__ldg(run + 4 * j + c)) : 0x88u) << (8 * c);
  return w;
}

template <typename QT, bool kInt4, bool kBytes>
__global__ void __launch_bounds__(kThreads) packed_decode_attention_kernel(
    const QT* __restrict__ q, const uint8_t* __restrict__ kv,
    const __nv_bfloat16* __restrict__ scale, const int32_t* __restrict__ valid_len,
    const int32_t* __restrict__ start, const uint8_t* __restrict__ key_mask,
    QT* __restrict__ out, int T, int H, int D, float sm_scale) {
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][kMaxD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int HD = H * D;
  const int row_bytes = kInt4 ? HD : 2 * HD;
  const int nw = (D + 3) >> 2;  // words of one slot's D bytes, the last one ragged where D is no multiple of 4
  const int n = min(max(valid_len[0], 1), T);
  const int lo = start ? min(max(start[b], 0), n) : 0;

  // word j of slot t: K at kvb + t * row_bytes + 4j, V (int8) HD bytes further
  const uint8_t* kvb = kv + (size_t)b * T * row_bytes + (size_t)h * D;
  const __nv_bfloat16* k_scale = scale + ((size_t)b * 2 * H + h) * T;
  const __nv_bfloat16* v_scale = scale + ((size_t)b * 2 * H + H + h) * T;
  const uint8_t* mask = key_mask ? key_mask + (size_t)b * T : nullptr;
  const size_t qo = ((size_t)b * H + h) * D;

  float qf[kMaxWords][4];
  float acc[kMaxWords][4];
#pragma unroll
  for (int i = 0; i < kMaxWords; ++i) {
    const int j = lane + 32 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      qf[i][c] = 4 * j + c < D ? to_float(q[qo + 4 * j + c]) : 0.f;
      acc[i][c] = 0.f;
    }
  }
  float m = -INFINITY;  // running max of this warp's scores
  float l = 0.f;        // running sum of exp(score - m)

  for (int base = lo + warp * kUnroll; base < n; base += kWarps * kUnroll) {
    uint32_t kw[kUnroll][kMaxWords];
    uint32_t vw[kUnroll][kMaxWords];
    float ks[kUnroll], vs[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // loads first: 4 slots in flight
      const int t = base + u;
      ok[u] = t < n && (mask == nullptr || mask[t] != 0);
      ks[u] = ok[u] ? __bfloat162float(k_scale[t]) : 0.f;
      vs[u] = ok[u] ? __bfloat162float(v_scale[t]) : 0.f;
      const uint8_t* run = kvb + (size_t)t * row_bytes;
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i) {
        const int j = lane + 32 * i;
        const bool in = ok[u] && j < nw;
        kw[u][i] = in ? load_word<kBytes>(run, j, D) : 0u;
        vw[u][i] = (!kInt4 && in) ? load_word<kBytes>(run + HD, j, D) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;  // uniform across the warp
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) part += qf[i][c] * k_of<kInt4>(kw[u][i], c);
      const float s = warp_sum(part) * ks[u] * sm_scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);  // 0 while m is -inf
      const float p = expf(s - m_new);
      l = l * corr + p;
      const float pv = p * vs[u];
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][c] = acc[i][c] * corr + pv * v_of<kInt4>(kInt4 ? kw[u][i] : vw[u][i], c);
      m = m_new;
    }
  }

  // merge the four warps' (max, sum, acc)
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kMaxWords; ++i) {
    const int j = lane + 32 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (4 * j + c < D) s_acc[warp][4 * j + c] = acc[i][c];
    }
  }
  __syncthreads();
  float big = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, s_m[w]);
  for (int d = tid; d < D; d += kThreads) {
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_m[w] == -INFINITY) continue;  // this warp saw no slot
      const float f = expf(s_m[w] - big);
      num += s_acc[w][d] * f;
      den += s_l[w] * f;
    }
    out[qo + d] = from_float<QT>(den > 0.f ? num / den : 0.f);
  }
}

template <typename QT, bool kInt4, bool kBytes>
void launch_typed(const void* q, const void* kv, const void* scale, const void* valid_len, const void* start,
                  const void* key_mask, void* out, int B, int H, int T, int D, float sm_scale, cudaStream_t s) {
  packed_decode_attention_kernel<QT, kInt4, kBytes><<<dim3(H, B), kThreads, 0, s>>>(
      static_cast<const QT*>(q), static_cast<const uint8_t*>(kv), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const int32_t*>(valid_len), static_cast<const int32_t*>(start),
      static_cast<const uint8_t*>(key_mask), static_cast<QT*>(out), T, H, D, sm_scale);
}

template <bool kInt4, bool kBytes>
void launch(const void* q, const void* kv, const void* scale, const void* valid_len,
            const void* start, const void* key_mask, void* out, int B, int H, int T, int D,
            int q_is_bf16, float sm_scale, cudaStream_t s) {
  if (q_is_bf16) {
    launch_typed<__nv_bfloat16, kInt4, kBytes>(q, kv, scale, valid_len, start, key_mask, out, B, H, T, D, sm_scale, s);
  } else {
    launch_typed<float, kInt4, kBytes>(q, kv, scale, valid_len, start, key_mask, out, B, H, T, D, sm_scale, s);
  }
}

}  // namespace

// D in (0, 256]; the int8 payload needs D a multiple of 4 and kv_layer 4-byte
// aligned (word loads), the int4 one takes any D (word loads where D is a
// multiple of 4 and kv_layer 4-byte aligned, else byte loads); the Python
// wrapper checks it. start and key_mask may be null.
extern "C" int wmar_packed_decode_attention(
    const void* q, const void* kv_layer, const void* scale_layer, const void* valid_len,
    const void* start, const void* key_mask, void* out, int B, int H, int T, int D,
    int int4_payload, int q_is_bf16, float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 0 || D > kMaxD || (!int4_payload && D % 4 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (int4_payload && (D % 4 != 0 || reinterpret_cast<uintptr_t>(kv_layer) % 4 != 0)) {
    launch<true, true>(q, kv_layer, scale_layer, valid_len, start, key_mask, out, B, H, T, D, q_is_bf16, sm_scale, s);
  } else if (int4_payload) {
    launch<true, false>(q, kv_layer, scale_layer, valid_len, start, key_mask, out, B, H, T, D, q_is_bf16, sm_scale,
                        s);
  } else {
    launch<false, false>(q, kv_layer, scale_layer, valid_len, start, key_mask, out, B, H, T, D, q_is_bf16, sm_scale,
                         s);
  }
  return static_cast<int>(cudaGetLastError());
}
