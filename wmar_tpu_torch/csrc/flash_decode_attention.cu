// Single-token decode attention over the unpacked KV caches (float and
// int8) for Hopper: every (row, head) split over T in one launch, 16-byte
// loads through a cp.async ring, softmax by the tile.
//
// Replaces two TPU kernels of the JAX package's ops/flash_decode.py:
//   flash_decode_attention     _decode_attn_kernel{,_km}    -> _attn_body     a bf16 or f32 KVCache layer;
//   flash_decode_attention_q8  _decode_attn_kernel_q8{,_km} -> _attn_body_q8  a QuantKVCache layer (int8
//                              payloads with one bf16 scale per slot and head, dequantized in the kernel).
// One template covers both: the payload type (bf16, f32, int8) and the bytes
// of one load (16, 8 or 4) are template arguments; start and key_mask are
// null pointers where the call has none. Built with nvcc for sm_90a into a
// shared library with a plain C interface, loaded through ctypes by
// wmar_tpu_torch/ops/flash_decode.py.
//
// Layout of one layer (views into the stacked cache, read in place):
//   k, v            [B, H, T, D]  bf16, f32 or int8: slot t of (b, h) is one contiguous run of D values
//   k_scale, v_scale bf16 [B, H, T]  (int8 payload only)
//   q [B, H, D] (bf16 or f32), out [B, H, D] in q's type
//   valid_len int32 [1], start int32 [B] or null, key_mask uint8 [B, T] or null
//   partial float32 [B*H, S, 2 + D], counters uint32 [B*H] (all 0 between launches): the wrapper's scratch
//
// What bounds it: bytes. A slot costs 2 x D x sizeof(payload) bytes and 4 x D
// flops, one flop per byte at bf16, far below the card's flops-per-byte
// balance. The TPU body holds a whole [T, D] row in fast memory, masks it and
// does two matrix-unit dots; at T = 4096, D = 128 that row is 1 MB and no
// Hopper block holds it. The card reaches its memory rate only with tens of
// KB of loads in flight on every one of its 132 SMs, so the design is about
// blocks and bytes in flight first, and about the math per byte second:
//   - grid (H, B, S): S blocks of four warps share a (row, head). Block s
//     works out its share of [start_b, valid_len) on the device, in whole
//     tiles: tile j covers slots [start_b + j * tile, + tile), the tiles are
//     dealt in S runs of ceil(tiles / S), a share may be empty. S comes from
//     the shapes only (the wrapper picks it), so a captured launch stays
//     right while the fill grows. Inside a block the warps take the share's
//     tiles in turn, so that the block reads one contiguous run at a time;
//   - a lane owns 16 bytes of a slot (8 bf16, 16 int8 or 4 f32 values; 8 or
//     4 bytes where D x sizeof(payload) is no multiple of 16). The lanes of a
//     slot are the next power of two above D / (values per lane), at least 8,
//     so a warp reads 32 / lanes slots in one instruction (2 for bf16 at D =
//     128, 4 for int8) and a tile is 8 such passes: 16, 32 or 8 slots;
//   - every warp owns a ring of 2 stages in shared memory (8 KB a stage: a
//     tile's K and V), one tile on its way while one is computed. A tile
//     whose slots all take part, where the lanes of a slot cover it exactly
//     (D = 128), is one contiguous run of the cache and comes as two bulk
//     copies (cp.async.bulk, one lane asks, an mbarrier per stage counts the
//     bytes); any other tile comes by cp.async, 16 bytes a lane, live slots
//     only. 64 KB a block, so three blocks share an SM and the wrapper
//     picks S so that the whole grid is on the card at once (a deeper ring
//     or more splits measured slower: fewer blocks fit, and a second wave
//     of blocks costs more than it hides). A lane reads back exactly the
//     bytes it copied, so the ring needs no barrier;
//   - the mask and the scales go by the tile: lane i reads the key_mask byte
//     and (int8) the two scales of slot i of the tile, one ballot gives the
//     tile's live word. A tile with no live slot is skipped before any
//     payload is asked for; in a partly masked tile only the live slots'
//     payload and scales are copied (a masked slot costs its mask byte and
//     nothing else), so a row that sees 1 slot in 1000 reads 1 slot's bytes;
//   - softmax by the tile: the 8 partial dots of a lane are reduced across
//     the lanes of a slot in 8 independent shuffle chains, then one max, one
//     expf per slot and one rescale of acc per tile, then p . V;
//   - each warp keeps its (max, sum, acc[D]) in registers; the four are
//     merged through shared memory. With S = 1 the block writes the output.
//     Else it writes its (max, sum, acc[D]) to `partial`, fences, and adds 1
//     to the (row, head)'s counter; the block that arrives last merges the S
//     partials in split order (the same bits from run to run), writes the
//     output and sets the counter back to 0. No second launch;
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

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPasses = 8;   // slots-per-pass x kPasses = a tile; also the least lanes of a slot
constexpr int kStages = 2;   // tiles of the ring: kStages - 1 on their way
constexpr int kMaxD = 128;
constexpr int kMaxSplits = 16;
constexpr unsigned kFull = 0xffffffffu;

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

// The payload values of one 32-bit word, as floats.
template <typename KT>
struct Word;

template <>
struct Word<float> {
  static constexpr int kValues = 1;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kValues = 2;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
    // a bf16 is the high half of the float of the same value
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xFFFF0000u);
  }
};

template <>
struct Word<int8_t> {
  static constexpr int kValues = 4;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
    // byte + 128 as the low mantissa byte of 2^23 is the float 2^23 + 128 + byte: exact, no int -> float convert
    const uint32_t u = w ^ 0x80808080u;
    f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
    f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
    f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
    f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  }
};

// One lane's load of VB bytes: global -> shared (asynchronous), shared -> words.
template <int VB>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VB == 16) {
    // the warp takes whole 128-byte lines, so L2 may fetch them whole
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else if constexpr (VB == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void commit_group() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A whole tile in one request: a 1-D bulk copy (the TMA engine) that reports its bytes to an mbarrier.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

template <int VB>
__device__ __forceinline__ void load_words(const unsigned char* src, uint32_t* w) {
  if constexpr (VB == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(src);
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  } else if constexpr (VB == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(src);
    w[0] = r.x; w[1] = r.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  }
}

// What a warp knows of a tile between asking for it and computing it.
struct TileMeta {
  uint32_t live;  // bit i: slot i of the tile takes part
  float ks, vs;   // lane i: the scales of slot i (int8 payload)
  bool bulk;      // the tile comes as two bulk copies, which report to the stage's mbarrier
};

// What stays the same over a warp's tiles.
struct WarpCtx {
  const unsigned char* kb;  // this (row, head)'s K and V, as bytes
  const unsigned char* vb;
  const __nv_bfloat16* ksc;
  const __nv_bfloat16* vsc;
  const uint8_t* mask;
  unsigned char* ring;  // this warp's kStages x (K tile, V tile)
  int lo, n;            // slots [lo, n) take part
  int first_tile, n_mine;  // this warp's tiles: first_tile + j * kWarps, j < n_mine
  int tile, spp, lps_log2;
  int D, lane, chunk, grp;
  bool own;  // this lane holds values of a slot
  bool linear;  // the ring's layout is the cache's: a whole tile can come as one bulk copy
  unsigned bars;  // shared address of this warp's kStages mbarriers
};

template <typename KT, int VB>
__device__ __forceinline__ TileMeta request_tile(const WarpCtx& c, int j, int stage) {
  constexpr int kStageBytes = 2 * kPasses * 32 * VB;
  TileMeta mt{0u, 1.f, 1.f, false};
  if (j < c.n_mine) {  // uniform across the warp
    const int t0 = c.lo + (c.first_tile + j * kWarps) * c.tile;
    const int t = t0 + c.lane;
    bool in = c.lane < c.tile && t < c.n;
    if (in && c.mask != nullptr) in = c.mask[t] != 0;
    mt.live = __ballot_sync(kFull, in);
    if (Word<KT>::kScaled && in) {
      mt.ks = __bfloat162float(c.ksc[t]);
      mt.vs = __bfloat162float(c.vsc[t]);
    }
    const uint32_t whole = c.tile == 32 ? kFull : (1u << c.tile) - 1u;
    if (VB == 16 && c.linear && mt.live == whole) {  // uniform across the warp
      mt.bulk = true;
      __syncwarp();  // every lane has read what the stage held
      if (c.lane == 0) {
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(c.ring + stage * kStageBytes));
        const unsigned bar = c.bars + 8u * stage;
        const size_t off = static_cast<size_t>(t0) * c.D * sizeof(KT);
        mbar_expect(bar, kStageBytes);
        bulk_copy(dst, c.kb + off, kStageBytes / 2, bar);
        bulk_copy(dst + kStageBytes / 2, c.vb + off, kStageBytes / 2, bar);
      }
    } else if (mt.live != 0u && c.own) {
      unsigned char* ks = c.ring + stage * kStageBytes;
      unsigned char* vs = ks + kPasses * 32 * VB;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int idx = p * c.spp + c.grp;
        if ((mt.live >> idx) & 1u) {
          const size_t off = (static_cast<size_t>(t0 + idx) * c.D) * sizeof(KT) + static_cast<size_t>(c.chunk) * VB;
          copy_async<VB>(ks + (p * 32 + c.lane) * VB, c.kb + off);
          copy_async<VB>(vs + (p * 32 + c.lane) * VB, c.vb + off);
        }
      }
    }
  }
  commit_group();  // one group per tile, empty or not, so that the waits count tiles
  return mt;
}

template <typename KT, int VB>
__device__ __forceinline__ void compute_tile(const WarpCtx& c, const TileMeta& mt, int stage, const float* qf,
                                             float* acc, float& m, float& l, float sm_scale) {
  constexpr int kStageBytes = 2 * kPasses * 32 * VB;
  constexpr int kWords = VB / 4;
  constexpr int kPerWord = Word<KT>::kValues;
  if (mt.live == 0u) return;  // uniform across the warp
  const unsigned char* ks = c.ring + stage * kStageBytes;
  const unsigned char* vs = ks + kPasses * 32 * VB;
  float s[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int idx = p * c.spp + c.grp;
    float part = 0.f;
    if (((mt.live >> idx) & 1u) && c.own) {
      uint32_t w[kWords];
      load_words<VB>(ks + (p * 32 + c.lane) * VB, w);
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        float f[kPerWord];
        Word<KT>::unpack(w[i], f);
#pragma unroll
        for (int e = 0; e < kPerWord; ++e) part += qf[i * kPerWord + e] * f[e];
      }
    }
    s[p] = part;
  }
  // the lanes of a slot add up their parts: kPasses independent chains
  for (int off = (1 << c.lps_log2) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) s[p] += __shfl_xor_sync(kFull, s[p], off);
  }
  float tile_max = -INFINITY;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int idx = p * c.spp + c.grp;
    const float sc = Word<KT>::kScaled ? __shfl_sync(kFull, mt.ks, idx) : 1.f;
    s[p] = ((mt.live >> idx) & 1u) ? s[p] * sc * sm_scale : -INFINITY;
    tile_max = fmaxf(tile_max, s[p]);
  }
  for (int off = 1 << c.lps_log2; off < 32; off <<= 1) tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, off));
  const float m_new = fmaxf(m, tile_max);  // finite: the tile has a live slot
  const float corr = expf(m - m_new);      // 0 while m is -inf
  l *= corr;
#pragma unroll
  for (int e = 0; e < kWords * kPerWord; ++e) acc[e] *= corr;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int idx = p * c.spp + c.grp;
    const bool on = (mt.live >> idx) & 1u;
    const float vsc = Word<KT>::kScaled ? __shfl_sync(kFull, mt.vs, idx) : 1.f;
    const float pr = on ? expf(s[p] - m_new) : 0.f;
    l += pr;  // every lane of the slot holds the same sum; the slots of other lane groups are added at the end
    if (on && c.own) {
      const float pv = pr * vsc;
      uint32_t w[kWords];
      load_words<VB>(vs + (p * 32 + c.lane) * VB, w);
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        float f[kPerWord];
        Word<KT>::unpack(w[i], f);
#pragma unroll
        for (int e = 0; e < kPerWord; ++e) acc[i * kPerWord + e] += pv * f[e];
      }
    }
  }
  m = m_new;
}

template <typename QT, typename KT, int VB>
__global__ void __launch_bounds__(kThreads) flash_decode_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const __nv_bfloat16* __restrict__ k_scale, const __nv_bfloat16* __restrict__ v_scale,
    const int32_t* __restrict__ valid_len, const int32_t* __restrict__ start,
    const uint8_t* __restrict__ key_mask, QT* __restrict__ out, float* __restrict__ partial,
    unsigned int* __restrict__ counters, int T, int H, int D, int lps_log2, float sm_scale) {
  constexpr int kValues = VB / static_cast<int>(sizeof(KT));  // of one lane
  constexpr int kStageBytes = 2 * kPasses * 32 * VB;
  extern __shared__ __align__(16) unsigned char ring_all[];  // [kWarps][kStages][K tile, V tile]
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][kMaxD];
  __shared__ bool s_last;
  __shared__ __align__(8) unsigned long long s_bar[kWarps][kStages];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = min(max(valid_len[0], 1), T);
  const int lo = start ? min(max(start[b], 0), n) : 0;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t qo = bh * D;

  WarpCtx c;
  c.kb = reinterpret_cast<const unsigned char*>(k + bh * T * D);
  c.vb = reinterpret_cast<const unsigned char*>(v + bh * T * D);
  c.ksc = Word<KT>::kScaled ? k_scale + bh * T : nullptr;
  c.vsc = Word<KT>::kScaled ? v_scale + bh * T : nullptr;
  c.mask = key_mask ? key_mask + static_cast<size_t>(b) * T : nullptr;
  c.ring = ring_all + warp * kStages * kStageBytes;
  c.lo = lo;
  c.n = n;
  c.lps_log2 = lps_log2;
  c.spp = 32 >> lps_log2;
  c.tile = kPasses * c.spp;
  c.D = D;
  c.lane = lane;
  c.chunk = lane & ((1 << lps_log2) - 1);
  c.grp = lane >> lps_log2;
  c.own = c.chunk * kValues < D;
  c.linear = (D * static_cast<int>(sizeof(KT))) == (VB << lps_log2);
  c.bars = static_cast<unsigned>(__cvta_generic_to_shared(&s_bar[warp][0]));
  if (lane == 0) {
    for (int u = 0; u < kStages; ++u) mbar_init(c.bars + 8u * u);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncwarp();
  uint32_t phases = 0u;
  // this block's share of the tiles, and this warp's part of it
  const int n_tiles = (n - lo + c.tile - 1) / c.tile;
  const int per_split = (n_tiles + S - 1) / S;
  const int share = max(min(per_split, n_tiles - split * per_split), 0);
  c.first_tile = split * per_split + warp;
  c.n_mine = share > warp ? (share - warp + kWarps - 1) / kWarps : 0;

  float qf[kValues];
  float acc[kValues];
#pragma unroll
  for (int e = 0; e < kValues; ++e) {
    qf[e] = c.own ? to_float(q[qo + c.chunk * kValues + e]) : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY;  // running max of this warp's scores
  float l = 0.f;        // running sum of exp(score - m) over this lane group's slots

  TileMeta meta[kStages];
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) meta[u] = request_tile<KT, VB>(c, u, u);
  for (int j0 = 0; j0 < c.n_mine; j0 += kStages) {
#pragma unroll
    for (int u = 0; u < kStages; ++u) {  // tile j0 + u lies in stage u
      constexpr int kAhead = kStages - 1;
      meta[(u + kAhead) % kStages] = request_tile<KT, VB>(c, j0 + u + kAhead, (u + kAhead) % kStages);
      wait_group<kAhead>();  // all but the newest kAhead groups have landed: tile j0 + u is there
      if (meta[u].bulk) {
        mbar_wait(c.bars + 8u * u, (phases >> u) & 1u);
        phases ^= 1u << u;
      }
      compute_tile<KT, VB>(c, meta[u], u, qf, acc, m, l, sm_scale);
    }
  }
  wait_group<0>();

  // the lane groups of a warp hold different slots: add them up
  for (int off = 1 << lps_log2; off < 32; off <<= 1) {
    l += __shfl_xor_sync(kFull, l, off);
#pragma unroll
    for (int e = 0; e < kValues; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], off);
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  if (c.grp == 0 && c.own) {
#pragma unroll
    for (int e = 0; e < kValues; ++e) s_acc[warp][c.chunk * kValues + e] = acc[e];
  }
  __syncthreads();
  // merge the warps' (max, sum, acc)
  float big = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, s_m[w]);
  float* mine = partial + (bh * S + split) * (D + 2);
  for (int d = tid; d < D; d += kThreads) {
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_m[w] == -INFINITY) continue;  // this warp saw no slot
      const float f = expf(s_m[w] - big);
      num += s_acc[w][d] * f;
      den += s_l[w] * f;
    }
    if (S == 1) {
      out[qo + d] = from_float<QT>(den > 0.f ? num / den : 0.f);
    } else {
      mine[2 + d] = num;
      if (d == 0) {
        mine[0] = big;
        mine[1] = den;
      }
    }
  }
  if (S == 1) return;

  // the block that arrives last merges the S partials, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[bh], 1u) == static_cast<unsigned>(S - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* all = partial + bh * S * (D + 2);
  float top = -INFINITY;
  for (int s = 0; s < S; ++s) top = fmaxf(top, __ldcg(all + s * (D + 2)));
  for (int d = tid; d < D; d += kThreads) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ms = __ldcg(all + s * (D + 2));
      if (ms == -INFINITY) continue;  // an empty share
      const float f = expf(ms - top);
      num += __ldcg(all + s * (D + 2) + 2 + d) * f;
      den += __ldcg(all + s * (D + 2) + 1) * f;
    }
    out[qo + d] = from_float<QT>(den > 0.f ? num / den : 0.f);
  }
  if (tid == 0) counters[bh] = 0u;  // ready for the next launch on this stream
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *valid_len, *start, *key_mask;
  void *out, *partial, *counters;
  int B, H, T, D, S;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename KT, int VB>
cudaError_t launch_one(const Args& a) {
  constexpr int kValues = VB / static_cast<int>(sizeof(KT));
  if (a.D % kValues != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a.k) % VB != 0 || reinterpret_cast<uintptr_t>(a.v) % VB != 0) {
    return cudaErrorMisalignedAddress;
  }
  int lps_log2 = 0;
  while ((1 << lps_log2) < kPasses || (1 << lps_log2) * kValues < a.D) ++lps_log2;
  if (lps_log2 > 5) return cudaErrorInvalidValue;
  const size_t ring = static_cast<size_t>(kWarps) * kStages * 2 * kPasses * 32 * VB;
  auto kernel = flash_decode_attention_kernel<QT, KT, VB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(ring));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, a.S);
  kernel<<<grid, kThreads, ring, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
      static_cast<const __nv_bfloat16*>(a.k_scale), static_cast<const __nv_bfloat16*>(a.v_scale),
      static_cast<const int32_t*>(a.valid_len), static_cast<const int32_t*>(a.start),
      static_cast<const uint8_t*>(a.key_mask), static_cast<QT*>(a.out), static_cast<float*>(a.partial),
      static_cast<unsigned int*>(a.counters), a.T, a.H, a.D, lps_log2, a.sm_scale);
  return cudaGetLastError();
}

template <typename KT, int VB>
cudaError_t launch_q(const Args& a, int q_is_bf16) {
  return q_is_bf16 ? launch_one<__nv_bfloat16, KT, VB>(a) : launch_one<float, KT, VB>(a);
}

}  // namespace

// kv_type: 0 bf16, 1 f32, 2 int8 (then k_scale and v_scale are bf16 [B, H, T]).
// D must be a multiple of 4 in (0, 128]. A lane loads 16 bytes where D x
// sizeof(payload) is a multiple of 16, else 8, else 4, and k, v must be
// aligned to that load; the Python wrapper checks both. splits in [1, 16]:
// with splits > 1, partial must hold B*H*splits*(D+2) floats and counters
// B*H zeros (the kernel leaves them 0). start and key_mask may be null.
extern "C" int wmar_flash_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* valid_len, const void* start, const void* key_mask, void* out, void* partial, void* counters,
    int B, int H, int T, int D, int splits, int kv_type, int q_is_bf16, float sm_scale, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, valid_len, start, key_mask, out, partial, counters,
               B, H, T, D, splits, sm_scale, reinterpret_cast<cudaStream_t>(stream)};
  if (D <= 0 || D > kMaxD || D % 4 != 0 || splits < 1 || splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1 && (partial == nullptr || counters == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (kv_type) {
    case 0: err = D % 8 == 0 ? launch_q<__nv_bfloat16, 16>(a, q_is_bf16) : launch_q<__nv_bfloat16, 8>(a, q_is_bf16); break;
    case 1: err = launch_q<float, 16>(a, q_is_bf16); break;
    case 2:
      err = D % 16 == 0 ? launch_q<int8_t, 16>(a, q_is_bf16)
            : D % 8 == 0 ? launch_q<int8_t, 8>(a, q_is_bf16)
                         : launch_q<int8_t, 4>(a, q_is_bf16);
      break;
    default: break;
  }
  return static_cast<int>(err);
}
