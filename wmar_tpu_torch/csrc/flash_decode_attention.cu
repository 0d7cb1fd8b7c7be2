// Single-token decode attention over the unpacked KV caches (float and
// int8), streamed with an online softmax, for Hopper.
//
// Replaces two TPU kernels of the JAX package's ops/flash_decode.py:
//   flash_decode_attention     _decode_attn_kernel{,_km}    -> _attn_body     a bf16 or f32 KVCache layer;
//   flash_decode_attention_q8  _decode_attn_kernel_q8{,_km} -> _attn_body_q8  a QuantKVCache layer (int8
//                              payloads with one bf16 scale per slot and head, dequantized in the kernel).
// One template covers both: the payload type (bf16, f32, int8) is a template
// argument; start and key_mask are null pointers where the call has none.
// Built with nvcc for sm_90a into a shared library with a plain C interface,
// loaded through ctypes by wmar_tpu_torch/ops/flash_decode.py.
//
// Layout of one layer (views into the stacked cache, read in place):
//   k, v            [B, H, T, D]  bf16, f32 or int8: slot t of (b, h) is one contiguous run of D values
//   k_scale, v_scale bf16 [B, H, T]  (int8 payload only)
//   q [B, H, D] (bf16 or f32), out [B, H, D] in q's type
//   valid_len int32 [1], start int32 [B] or null, key_mask uint8 [B, T] or null
//
// What bounds it: bytes. A slot costs 2 x D x sizeof(payload) bytes and 4 x D
// flops, one flop per byte at bf16, far below the card's flops-per-byte
// balance. The TPU body holds a whole [T, D] row in fast memory, masks it and
// does two matrix-unit dots; at T = 4096, D = 128 that row is 1 MB and no
// Hopper block holds it. Here nothing of the row is stored:
//   - one block per (head h, row b), eight warps. A lane owns 4 consecutive
//     values of a slot (a 16-byte load for f32, 8 for bf16, 4 for int8), so
//     a warp reads a slot of D <= 128 in one instruction per tensor;
//   - the block walks [start_b, valid_len) in chunks of 32 slots, each warp 4
//     of them, loads issued before the math so that 4 slots of K and V per
//     warp are in flight. Slots outside that range are never read; a slot
//     whose key_mask byte is 0 is skipped before its payload is loaded, so a
//     row that sees 1 slot in 1000 reads 1 slot's bytes;
//   - each warp keeps its own running max, sum and acc[D] in registers and
//     the eight states are merged once through shared memory (4 KB at any T);
//   - int8: the score is (q . k_int) * k_scale and the sum takes
//     p * v_scale * v_int: the same math as scaling every element first, with
//     one rounding per slot instead of one per element.
// Numbers: float32 throughout, the output rounded to q's type at the end. A
// row with no slot that takes part gets zeros. valid_len, start and key_mask
// are read on the device: nothing comes back to the host, so a CUDA graph can
// replay the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // slots per warp per chunk
constexpr int kMaxD = 128;  // a lane owns one quad of a slot: 32 lanes x 4 values

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

// Four consecutive payload values as one load, and as floats.
template <typename KT>
struct Quad;

template <>
struct Quad<float> {
  using Raw = float4;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};

template <>
struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    // a bf16 is the high half of the float of the same value
    f[0] = __uint_as_float(r.x << 16);
    f[1] = __uint_as_float(r.x & 0xFFFF0000u);
    f[2] = __uint_as_float(r.y << 16);
    f[3] = __uint_as_float(r.y & 0xFFFF0000u);
  }
};

template <>
struct Quad<int8_t> {
  using Raw = uint32_t;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ Raw zero() { return 0u; }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = (float)(int)(int8_t)((r >> (8 * c)) & 0xFFu);
  }
};

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) flash_decode_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const __nv_bfloat16* __restrict__ k_scale, const __nv_bfloat16* __restrict__ v_scale,
    const int32_t* __restrict__ valid_len, const int32_t* __restrict__ start,
    const uint8_t* __restrict__ key_mask, QT* __restrict__ out, int T, int H, int D,
    float sm_scale) {
  using Q4 = Quad<KT>;
  using Raw = typename Q4::Raw;
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][kMaxD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nq = D >> 2;  // quads of one slot
  const int n = min(max(valid_len[0], 1), T);
  const int lo = start ? min(max(start[b], 0), n) : 0;

  const size_t bh = (size_t)b * H + h;
  const KT* kb = k + bh * T * D;
  const KT* vb = v + bh * T * D;
  const __nv_bfloat16* ksc = Q4::kScaled ? k_scale + bh * T : nullptr;
  const __nv_bfloat16* vsc = Q4::kScaled ? v_scale + bh * T : nullptr;
  const uint8_t* mask = key_mask ? key_mask + (size_t)b * T : nullptr;
  const size_t qo = bh * D;

  const bool own = lane < nq;  // this lane holds values [4 * lane, 4 * lane + 4) of a slot
  float qf[4];
  float acc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    qf[c] = own ? to_float(q[qo + 4 * lane + c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;  // running max of this warp's scores
  float l = 0.f;        // running sum of exp(score - m)

  for (int base = lo + warp * kUnroll; base < n; base += kWarps * kUnroll) {
    Raw kw[kUnroll];
    Raw vw[kUnroll];
    float ks[kUnroll], vs[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // loads first: 4 slots in flight
      const int t = base + u;
      ok[u] = t < n && (mask == nullptr || mask[t] != 0);
      ks[u] = (Q4::kScaled && ok[u]) ? __bfloat162float(ksc[t]) : 1.f;
      vs[u] = (Q4::kScaled && ok[u]) ? __bfloat162float(vsc[t]) : 1.f;
      const Raw* krow = reinterpret_cast<const Raw*>(kb + (size_t)t * D);
      const Raw* vrow = reinterpret_cast<const Raw*>(vb + (size_t)t * D);
      const bool in = ok[u] && own;
      kw[u] = in ? __ldg(krow + lane) : Q4::zero();
      vw[u] = in ? __ldg(vrow + lane) : Q4::zero();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;  // uniform across the warp
      float kf[4], vf[4];
      Q4::unpack(kw[u], kf);
      Q4::unpack(vw[u], vf);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) part += qf[c] * kf[c];
      const float s = warp_sum(part) * ks[u] * sm_scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);  // 0 while m is -inf
      const float p = expf(s - m_new);
      l = l * corr + p;
      const float pv = p * vs[u];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = acc[c] * corr + pv * vf[c];
      m = m_new;
    }
  }

  // merge the warps' (max, sum, acc)
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  if (own) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s_acc[warp][4 * lane + c] = acc[c];
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

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *valid_len, *start, *key_mask;
  void* out;
  int B, H, T, D;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename KT>
void launch_one(const Args& a) {
  const dim3 grid(a.H, a.B);
  flash_decode_attention_kernel<QT, KT><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
      static_cast<const __nv_bfloat16*>(a.k_scale), static_cast<const __nv_bfloat16*>(a.v_scale),
      static_cast<const int32_t*>(a.valid_len), static_cast<const int32_t*>(a.start),
      static_cast<const uint8_t*>(a.key_mask), static_cast<QT*>(a.out), a.T, a.H, a.D, a.sm_scale);
}

template <typename KT>
void launch_q(const Args& a, int q_is_bf16) {
  if (q_is_bf16) {
    launch_one<__nv_bfloat16, KT>(a);
  } else {
    launch_one<float, KT>(a);
  }
}

}  // namespace

// kv_type: 0 bf16, 1 f32, 2 int8 (then k_scale and v_scale are bf16 [B, H, T]).
// D must be a multiple of 4 in (0, 128] and k, v aligned to 4 of their
// values; the Python wrapper checks both. start and key_mask may be null.
extern "C" int wmar_flash_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* valid_len, const void* start, const void* key_mask, void* out, int B, int H, int T,
    int D, int kv_type, int q_is_bf16, float sm_scale, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, valid_len, start, key_mask, out,
               B, H, T, D, sm_scale, reinterpret_cast<cudaStream_t>(stream)};
  if (D <= 0 || D > kMaxD || D % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (kv_type) {
    case 0: launch_q<__nv_bfloat16>(a, q_is_bf16); break;
    case 1: launch_q<float>(a, q_is_bf16); break;
    case 2: launch_q<int8_t>(a, q_is_bf16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
