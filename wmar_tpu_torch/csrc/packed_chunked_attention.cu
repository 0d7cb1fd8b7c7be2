// Single-token decode attention over the packed KV caches (int4 and int8),
// for Hopper: every (row, head) split over T in one
// launch, 16-byte loads through a cp.async ring, softmax by the tile,
// nibbles and bytes made floats without a convert.
//
// Replaces four TPU kernels of the JAX package's ops/flash_decode.py. Two go
// through _chunked_body (:365), with a per-row first slot (start) and an
// optional per-row slot mask (key_mask):
//   packed_decode_attention_q8 (:303)  _packed_attn_kernel_q8_chunked{,_km}  the int8 cache, T >= 1024;
//   packed4_decode_attention   (:798)  _packed4_attn_kernel_chunked{,_km}    the int4 cache, T >= 1024;
// and two are the short-cache kernels, launched here without start and key_mask:
//   packed4_decode_attention   (:817)  _packed4_attn_kernel                  the int4 cache, T < 1024;
//   packed_decode_attention_q8 (:322)  _packed_attn_kernel_q8                the int8 cache, T < 1024.
// A fifth, the DMA probe _dma_probe_kernel (:560, wrapper _packed_dma_probe
// :583: "identical grid/blocks to packed_decode_attention_q8 but the body
// reads one row per block"), is the int8 instantiation with its math compiled
// out (kProbe): the same grid, warp layout, ring and loads over all T slots,
// so that its time is the attention's loads alone. One template covers all:
// the payload (int4 or int8) and the bytes of one load (16, 8 or 4) are
// template arguments; start and key_mask are null pointers where the call
// has none. Built with nvcc for sm_90a into a shared library with a plain C
// interface, loaded through ctypes by wmar_tpu_torch/ops/flash_decode.py. The
// slot-by-slot kernel of packed_decode_attention.cu stays only for head dims
// whose slot fits no warp here (no multiple of 8 above 128).
//
// Layout of one layer (read in place from the stacked cache by offset):
//   int4  kv uint8 [B, T, H*D]    low nibble K, high nibble V, value = nibble - 8
//   int8  kv int8  [B, T, 2*H*D]  lanes [0, HD) K, lanes [HD, 2HD) V
//   scale bf16 [B, 2H, T]         rows [0, H) K scales, rows [H, 2H) V scales
//   q [B, H, D] (bf16 or f32), out [B, H, D] in q's type
//   valid_len int32 [1], start int32 [B] or null, key_mask uint8 [B, T] or null
//   partial float32 [B*H, S, 2 + D], counters uint32 [B*H] (all 0 between launches): the wrapper's scratch
//
// What bounds it: bytes, and closely behind them the instructions. A slot of
// one head costs D bytes (int4) or 2 D (int8) and 4 D flops; the card moves
// 3.35 TB/s only with tens of KB on their way on each of its 132 SMs, and an
// int4 byte holds two values that each need an unpack and a multiply-add:
// about 1,300 instructions a warp for a tile of 32 slots, so that the int4
// kernel is held by its math (its loads alone need two thirds of its time)
// and the int8 kernel by its loads. A slot's row holds all heads, so a head's
// D bytes come at a stride of H*D (int4) or 2*H*D (int8) bytes. The design,
// after the flash-decode kernels of flash_decode_attention.cu:
//   - grid (H, B, S): S blocks of four warps share a (row, head). Block s
//     works out its share of [start_b, valid_len) on the device, in whole
//     tiles: tile j covers slots [start_b + j * tile, + tile), the tiles are
//     dealt in S runs of ceil(tiles / S), a share may be empty. S comes from
//     the shapes only (the wrapper picks it), so a captured launch stays
//     right while the fill grows. Inside a block the warps take the share's
//     tiles in turn;
//   - a lane owns 16 bytes of a head's slot: 16 K and 16 V values (8 or 4
//     bytes where D is no multiple of 16). The lanes of a slot are the next
//     power of two above D / 16, at least 8, so a warp reads 32 / lanes
//     slots in one instruction (4 at D = 128: four whole 128-byte lines) and
//     a tile is 8 such passes: 32 slots at D <= 128, 16 above. A group of
//     lanes takes 8 slots in a row (slot0 + pass), so that a pass's bit of
//     the live word sits at a place known when the kernel is compiled;
//   - every warp owns a ring of two stages in shared memory (a stage is a
//     tile: 4 KB of nibble bytes, or 4 KB of K and 4 KB of V bytes), filled
//     by cp.async, live slots only, one tile on its way while one is
//     computed. A lane reads back exactly the bytes it copied, so the ring
//     needs no barrier. 32 KB a block (int4) and 80 registers a thread let
//     six blocks share an SM, so the 768 blocks of a Chameleon call are on
//     the card at once; the int8 kernel's 64 KB let three;
//   - a warp per (row, head) (kWarpHead, the wrapper's choice, S = 1): where
//     there are at least 12 (row, head) pairs an SM, as at RAR-XL's short
//     cache (128 rows x 16 heads, 258 slots), a block of four warps sharing
//     one pair would give each warp two or three tiles and a merge; there a
//     block is four heads of one row, each warp walks all the tiles of its
//     own pair through its ring and writes its output, with no merge;
//   - the ring is sized by the passes an instantiation runs (Fit), and the
//     launch bounds ask for as many blocks an SM as its ring lets share the
//     228 KB, at most six (int4: 80 registers) or four (int8: 128). RAR-XL's
//     int8 kernel (LPS = 5) runs tiles of three passes (18 slots) through a
//     ring of three stages, 36 KB a block: four blocks an SM, so the 512
//     warp-per-head blocks are on the card in one wave (a ring sized for
//     eight passes took 64 KB: three blocks, two waves);
//   - the int8 short-cache layouts (a warp per (row, head), the window) load
//     through L1 (cp.async.ca, L1Loads), and their launch asks the SM for no
//     more shared memory than their blocks need, so that the rest is L1;
//   - the windowed layout (kWin, int8 only, see Fit): Taming's D = 104 is 8
//     bytes past a multiple of 16, so a head's run starts off 16-byte
//     alignment in every other head; a lane loads 16 bytes of an aligned
//     window of D + 8 bytes (7 of 8 lanes, four slots a pass) instead of 8
//     bytes (13 of 16, two slots a pass), and the 8 bytes of the
//     neighbouring head get q = 0 and are never stored;
//   - a slot of five loads (RAR-XL's D = 80 at 16 bytes) takes groups of
//     five lanes (LPS = 5): six slots a pass and 30 of 32 lanes busy, where
//     groups of eight kept 20 busy; a tile is five such passes, 30 slots.
//     The sums over a group are a shuffle down to its first lane and a
//     broadcast, the sums over the groups a gather in group order;
//   - the mask and the scales go by the tile: lane i reads the key_mask byte
//     and the two scales of slot i of the tile (the scales [2H, T] are
//     contiguous over T), one ballot gives the tile's live word. A tile with
//     no live slot is skipped before any payload is asked for; a masked slot
//     costs its mask byte and nothing else;
//   - softmax by the tile: the 8 partial dots of a lane are reduced across
//     the lanes of a slot in 8 independent shuffle chains, then one max, one
//     exp2f per slot and one rescale of acc per tile, then p . V (scores are
//     kept in base 2). An int4 word is read once from the ring for K (low
//     nibbles) and once for V (high). The passes of a tile are straight-line
//     code: see compute_tile;
//   - the unpack: a byte b put into the low mantissa byte of the float 2^23
//     (one byte-permute) is the float 2^23 + b, exactly; one subtract takes
//     the 2^23 and the offset (8 of a nibble, 128 of a byte made unsigned by
//     one xor a word) off at once. A nibble costs a mask (K) or a shift and a
//     mask (V) for every four values, then permute, subtract and multiply-add:
//     27 instructions for the 8 values of a word where the slot-by-slot
//     kernel's shift, mask, subtract and int -> float convert (a slow
//     instruction) took about 70. Folding K's - 8 into 8 * sum(q) saves
//     nothing here: the subtract that removes the 2^23 removes the 8 with it;
//   - each warp keeps its (max, sum, acc[D]) in registers; the four are
//     merged through shared memory. With S = 1 the block writes the output.
//     Else it writes its (max, sum, acc[D]) to `partial`, fences, and adds 1
//     to the (row, head)'s counter; the block that arrives last merges the S
//     partials in split order (the same bits from run to run), writes the
//     output and sets the counter back to 0. No second launch;
//   - the score is (q . k_int) * k_scale and the sum takes p * v_scale *
//     v_int: one rounding per slot instead of one per element.
// Numbers: float32 throughout, the output rounded to q's type at the end. A
// row with no slot that takes part gets zeros. valid_len, start and key_mask
// are read on the device: nothing comes back to the host, so a CUDA graph can
// replay the launch.
//
// Variants for the short int8 cache (graph-replayed ms of kernel #2 / its
// loads alone, the DMA probe, at RAR-XL 128 x 258 x 16 x 80 and Taming
// 32 x 257 x 16 x 104, NVIDIA H100 80GB HBM3 at 700 W, each a build of this
// source with one constant changed, timed in turns with the shipped one by
// tools/bench_flash_splits.py --packed --short):
//   - int8 launch bounds of six blocks an SM (80 registers): Taming
//     0.0181-0.0183 against 0.0177-0.0178 with four (L2-only loads then);
//   - Taming's 8-byte layout against the window: 0.0183-0.0185 /
//     0.0166-0.0168 against 0.0177-0.0178 / 0.0133-0.0134; a window of
//     eight passes (64 KB, three blocks an SM, two waves): 0.0252-0.0256.
//     Windows of two passes with three or four stages, and of four passes
//     with three, were slower in a first sweep. A lane group over a head
//     pair (208-byte runs, the straddling lane keeping two partial dots) was
//     not built: it gives the window's 16-byte loads but halves the warps;
//   - RAR-XL's five passes and two stages: 0.0405-0.0406 against
//     0.0391-0.0393 (three and three); the L2::256B prefetch hint:
//     0.0404-0.0406; asking for a warp's first tiles before valid_len has
//     come (one split, no start) gained about 1% in a first try and was not
//     kept;
//   - the 16-byte loads through L1 (cp.async.ca, L1Loads) against L2 only:
//     0.0376-0.0379 / 0.0168-0.0171 against 0.0403-0.0409 / 0.0179-0.0181,
//     and the Chameleon t2i shape (blocks over one head, D = 128) 6% slower,
//     so blocks keep L2-only loads; without the carveout the attention is as
//     fast, but the probe's blocks (fewer registers, no merge space) crowd
//     six to an SM with little L1 and take 0.0404 / 0.0162, longer than the
//     attention they should bound;
//   - the loads alone (L2-only) run at 1.8-2.6 TB/s over head dims 48-128 at
//     the same bytes, faster the more bytes one warp load instruction moves:
//     2.4-2.6 at D = 80, 88, 104, 112 and 128 (384-512 bytes), 2.2 at 96
//     (384), 2.4 at 64 (256), 1.8 at 48 (192) (tools/bench_flash_splits.py
//     --dims); the 8-byte layout at D = 104 moved 208.
// Variants that lost or were not built (graph-replayed ms at the Chameleon
// shape, 24 rows x 32 heads of 128 over 1043 slots, int8 / int4, on an
// NVIDIA H100 80GB HBM3 at 700 W, tools/bench_flash_splits.py --packed; the
// slot-by-slot kernel needs 0.199 / 0.150 there):
//   - which blocks read which bytes: each block reads its head's D-byte runs
//     at the row's stride, as above. With the math compiled out the loads
//     alone take 0.069 / 0.038 against byte bounds of 0.057 / 0.029, 1.2-1.3
//     times the bound, so neither a block per group of heads (contiguous
//     runs of g * D bytes) nor a 2-D TMA tensor map over [B*T, H*D] was
//     built: the loads are not what holds the int4 kernel;
//   - the unpack by logic operations alone (a nibble left where it is in the
//     mantissa of the float 2^(23 - shift), one and-or a value, no permute):
//     0.091 / 0.082 against 0.081 / 0.073 for the byte-permute. Packed half2
//     with a magic exponent (lop3 to 1024 + nibble, one hsub2 for two values)
//     needs a half -> float convert per value to keep the sum in f32, the same
//     instruction count, and was not built;
//   - passes that test their slot's live bit before they compute (a branch a
//     pass): 0.075 (int4) against 0.070 without; the 16 multiply-adds of a
//     pass's dot as four short chains: no change;
//   - the int4 ring with 4 stages (64 KB, three blocks an SM): 0.070 against
//     0.059 with 2 stages and six blocks an SM (five blocks, 96 registers:
//     0.071, a second wave of 108 blocks); both rings with 3 stages: 0.106 /
//     0.087; eight blocks an SM at 64 registers spill: 0.124 / 0.075;
//   - S: more than one block per (row, head) only costs where the rows fill
//     the card (S = 2: 0.089 / 0.065); at 3 rows over 4096 slots S = 4 is
//     best (0.046 / 0.035; S = 1: 0.088 / 0.084; S = 8: 0.052 / 0.038).
//
// kProbe (kernel #7) and, for the int4 payload, a build with
// -DWMAR_PACKED_LOADS_ONLY compile the math out: the words read back from the
// ring and the scales are only added up (see compute_tile), so the time is
// that of the loads alone (tools/bench_flash_splits.py --packed; with
// --loads_only for int4, whose output is then meaningless).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPasses = 8;      // slots-per-pass x kPasses = a tile; also the least lanes of a slot
constexpr int kPassesWin = 4;   // the passes of a tile in the windowed layout (kWin, see Fit)
constexpr int kStagesWin = 2;
constexpr int kPassesFive8 = 3;  // int8 in groups of five lanes: passes of a tile (at most 5) and stages
constexpr int kStagesFive8 = 3;
constexpr int kStagesInt4 = 2;  // tiles of a warp's ring: all but one on their way
constexpr int kStagesInt8 = 2;

// The lanes of a slot: a power of two of them (LPS 0: 2^lps_log2, at least kPasses, read at run time), or,
// where a slot is five loads (D = 80 at 16 bytes a load, 20 at 4), LPS = 5: six groups of five lanes a warp
// (two lanes idle) and at most five passes (a tile of 30 slots; the int8 payload runs three, see Fit).
template <int LPS>
struct Lanes {
  static constexpr int kGroups = LPS ? 32 / LPS : 0;
  static constexpr int kPassesOf = LPS ? (32 / kGroups < kPasses ? 32 / kGroups : kPasses) : kPasses;
};
constexpr int kMaxD = 256;
constexpr int kMaxSplits = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemPerSm = 233472;                  // 228 KB of shared memory an SM on the H100
constexpr int kMergeBytes = kWarps * (kMaxD + 2) * 4 + 16;  // the block's static shared memory (s_m, s_l, s_acc)
#ifdef WMAR_PACKED_LOADS_ONLY
constexpr bool kLoadsOnlyBuild = true;
#else
constexpr bool kLoadsOnlyBuild = false;
#endif

// kWin: the windowed layout of the int8 payload at a head dim that is 8, not 16, bytes past a multiple of 16
// (Taming's 104, RAR-XXL's 88). A head's run then starts 8 bytes off 16-byte alignment in every other head;
// instead of 8-byte loads (13 of 16 lanes at D = 104, two slots a pass) each lane loads 16 bytes of a
// 16-byte-aligned window of D + 8 bytes that holds the run (7 of 8 lanes, four slots a pass: twice the bytes a
// load instruction), whose 8 bytes of the neighbouring head are read and given q = 0. Its tile is kPassesWin
// passes, so that its ring is the 8-byte layout's size (four blocks an SM: Taming's 512 blocks in one wave).
// The ring of one instantiation, sized by the passes and stages it runs, and the blocks that share an SM (the
// launch bounds): as many rings (plus the merge space and the 1 KB an SM keeps a block) as fit its shared memory,
// at most six of int4 (80 registers a thread) and four of int8 (128: at 80 the int8 kernel ran 2% slower at
// Taming's shape). int4 at D = 128: 32 KB, six; int8 at D = 128: 64 KB, three; int8 at D = 80 (LPS = 5: three
// passes, three stages): 36 KB, and at D = 104 (the window): 32 KB, four, so that RAR-XL's 512 blocks of a warp
// per (row, head) and Taming's 512 blocks of four warps are on the card at once.
template <bool kInt4, int VB, int LPS, bool kWin>
struct Fit {
  static constexpr bool kFive8 = !kInt4 && LPS == 5;
  static constexpr int kP = kWin ? kPassesWin : kFive8 ? kPassesFive8 : Lanes<LPS>::kPassesOf;
  static constexpr int kStages = kWin ? kStagesWin : kFive8 ? kStagesFive8 : kInt4 ? kStagesInt4 : kStagesInt8;
  static constexpr int kPlane = kP * 32 * VB;                   // a tile's bytes of one payload
  static constexpr int kStageBytes = (kInt4 ? 1 : 2) * kPlane;  // a tile: nibbles, or K and V
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static constexpr int kByMemory = kSmemPerSm / (kRingBytes + kMergeBytes + 1024);
  static constexpr int kCap = kInt4 ? 6 : 4;
  static constexpr int kBlocks = kByMemory < kCap ? kByMemory : kCap;
};
constexpr float kLog2e = 1.4426950408889634f;  // scores are kept in base 2: exp2f is one instruction, expf several

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

// The four bytes of u, each in [0, 256), as the floats byte - offset: a byte as
// the low mantissa byte of 2^23 is the float 2^23 + byte, and bias = 2^23 + offset.
__device__ __forceinline__ void bytes_to_floats(uint32_t u, float bias, float* f) {
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - bias;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - bias;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - bias;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - bias;
}

// The four K values of a K word (int4: the low nibbles - 8; int8: the signed bytes).
template <bool kInt4>
__device__ __forceinline__ void k_values(uint32_t w, float* f) {
  if (kInt4) bytes_to_floats(w & 0x0F0F0F0Fu, 8388616.f, f);
  else bytes_to_floats(w ^ 0x80808080u, 8388736.f, f);
}

// The four V values (int4: the high nibbles - 8 of the K word; int8: the signed bytes of the V word).
template <bool kInt4>
__device__ __forceinline__ void v_values(uint32_t w, float* f) {
  if (kInt4) bytes_to_floats((w >> 4) & 0x0F0F0F0Fu, 8388616.f, f);
  else bytes_to_floats(w ^ 0x80808080u, 8388736.f, f);
}

// One lane's load of VB bytes: global -> shared (asynchronous), shared -> words. kL1: 16-byte loads also kept in
// L1 (.ca), see L1Loads.
template <int VB, bool kL1>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VB == 16 && kL1) {
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else if constexpr (VB == 16) {
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
  float ks, vs;   // lane i: the scales of slot i
};

// What stays the same over a warp's tiles.
struct WarpCtx {
  const unsigned char* kb;  // this (row, head)'s bytes of slot 0: nibbles (int4) or K (int8)
  const __nv_bfloat16* ksc;
  const __nv_bfloat16* vsc;
  const uint8_t* mask;
  unsigned char* ring;     // this warp's stages
  size_t row_bytes;        // from one slot of the row to the next
  int v_off;               // int8: from a slot's K bytes to its V bytes
  int lo, n;               // slots [lo, n) take part
  int first_tile, n_mine, tile_step;  // this warp's tiles: first_tile + j * tile_step, j < n_mine
  int tile, lps_log2;
  int lane, chunk;
  int slot0;  // the lane group's first slot of a tile: it takes slots slot0 + p, p < its passes
  bool own;  // this lane holds values of a slot
};

// Whether an instantiation's 16-byte loads go through L1: the int8 payload's short-cache layouts, a warp per (row,
// head) and the window (7% faster at RAR-XL's and Taming's shapes than through L2 alone), not its blocks of four
// warps over one head (6-8% slower: the Chameleon t2i shape, RAR-XL forced into blocks). With it the launch sets the
// SM's shared memory to what the blocks that fit need (L1Carveout), so that the rest is L1.
template <bool kInt4, bool kWarpHead, bool kWin>
struct L1Loads {
  static constexpr bool value = !kInt4 && (kWarpHead || kWin);
};

template <bool kInt4, int VB, int LPS, bool kWin, bool kL1>
__device__ __forceinline__ TileMeta request_tile(const WarpCtx& c, int j, int stage) {
  using F = Fit<kInt4, VB, LPS, kWin>;
  constexpr int kP = F::kP;
  constexpr int kPlane = F::kPlane;
  constexpr int kStageBytes = F::kStageBytes;
  TileMeta mt{0u, 0.f, 0.f};
  if (j < c.n_mine) {  // uniform across the warp
    const int t0 = c.lo + (c.first_tile + j * c.tile_step) * c.tile;
    const int t = t0 + c.lane;
    bool in = c.lane < c.tile && t < c.n;
    if (in && c.mask != nullptr) in = c.mask[t] != 0;
    mt.live = __ballot_sync(kFull, in);
    if (in) {
      mt.ks = __bfloat162float(c.ksc[t]);
      mt.vs = __bfloat162float(c.vsc[t]);
    }
    if (mt.live != 0u && c.own) {
      unsigned char* ks = c.ring + stage * kStageBytes;
      const uint32_t mine = mt.live >> c.slot0;
      const unsigned char* src0 = c.kb + static_cast<size_t>(t0 + c.slot0) * c.row_bytes + c.chunk * VB;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if ((mine >> p) & 1u) {
          const unsigned char* src = src0 + p * c.row_bytes;
          copy_async<VB, kL1>(ks + (p * 32 + c.lane) * VB, src);
          if (!kInt4) copy_async<VB, kL1>(ks + kPlane + (p * 32 + c.lane) * VB, src + c.v_off);
        }
      }
    }
  }
  commit_group();  // one group per tile, empty or not, so that the waits count tiles
  return mt;
}

// kLoadsOnly (the DMA probe, and the int4 kernels of a -DWMAR_PACKED_LOADS_ONLY build): no math, only the
// bytes the attention reads back from the ring and the scales, each added into `bits` by its top byte (one
// instruction a word). A lane adds at most 8 words a pass and two scales a tile, and a tile is at least 8
// slots, so over T < 2^20 slots the sum stays under 2.3e9: the test against 2^32 - 1 at the end keeps every
// load, and is never true.
template <bool kInt4, int VB, int LPS, bool kWin, bool kLoadsOnly>
__device__ __forceinline__ void compute_tile(const WarpCtx& c, const TileMeta& mt, int stage, const float* qf,
                                             float* acc, float& m, float& l, float sm_scale, uint32_t& bits) {
  using F = Fit<kInt4, VB, LPS, kWin>;
  constexpr int kP = F::kP;
  constexpr int kPlane = F::kPlane;
  constexpr int kWords = VB / 4;
  if (mt.live == 0u) return;  // uniform across the warp
  const unsigned char* ks = c.ring + stage * F::kStageBytes;
  const unsigned char* vs = kInt4 ? ks : ks + kPlane;
  if constexpr (kLoadsOnly) {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (c.own && ((mt.live >> (c.slot0 + p)) & 1u)) {
        uint32_t w[kWords];
        load_words<VB>(ks + (p * 32 + c.lane) * VB, w);
#pragma unroll
        for (int i = 0; i < kWords; ++i) bits += w[i] >> 24;
        if (!kInt4) {
          load_words<VB>(vs + (p * 32 + c.lane) * VB, w);
#pragma unroll
          for (int i = 0; i < kWords; ++i) bits += w[i] >> 24;
        }
      }
    }
    bits += (__float_as_uint(mt.ks) >> 24) + (__float_as_uint(mt.vs) >> 24);
    return;
  }
  // No pass below looks at the live word or at `own` before it computes: a
  // slot that takes no part, or a lane beyond D, reads whatever bytes the ring
  // holds there, and any byte unpacks to a finite float. Its dot is then set
  // to -inf and its probability to 0 (q is 0 in a lane beyond D, and that
  // lane's acc is never stored), so the eight passes are straight-line code
  // that the compiler can interleave.
  float s[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    uint32_t w[kWords];
    load_words<VB>(ks + (p * 32 + c.lane) * VB, w);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      float f[4];
      k_values<kInt4>(w[i], f);
#pragma unroll
      for (int e = 0; e < 4; ++e) part += qf[i * 4 + e] * f[e];
    }
    s[p] = part;
  }
  // the lanes of a slot add up their parts: kP independent chains
  if constexpr (LPS == 0) {
    for (int off = (1 << c.lps_log2) >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int p = 0; p < kP; ++p) s[p] += __shfl_xor_sync(kFull, s[p], off);
    }
  } else {  // groups of LPS lanes: down to the group's first lane, then a broadcast
#pragma unroll
    for (int off = 1; off < LPS; off <<= 1) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float o = __shfl_down_sync(kFull, s[p], off);
        if (c.chunk + off < LPS) s[p] += o;
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) s[p] = __shfl_sync(kFull, s[p], c.lane - c.chunk);
  }
  const uint32_t mine = mt.live >> c.slot0;  // bit p: the slot of pass p takes part (none for an idle lane)
  float tile_max = -INFINITY;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const float sc = __shfl_sync(kFull, mt.ks, c.slot0 + p);
    s[p] = ((mine >> p) & 1u) ? s[p] * sc * sm_scale : -INFINITY;
    tile_max = fmaxf(tile_max, s[p]);
  }
  for (int off = LPS ? 1 : 1 << c.lps_log2; off < 32; off <<= 1) {
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, off));
  }
  const float m_new = fmaxf(m, tile_max);  // finite: the tile has a live slot
  const float corr = exp2f(m - m_new);     // 0 while m is -inf
  l *= corr;
#pragma unroll
  for (int e = 0; e < VB; ++e) acc[e] *= corr;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const bool on = (mine >> p) & 1u;
    const float vsc = __shfl_sync(kFull, mt.vs, c.slot0 + p);
    const float pr = on ? exp2f(s[p] - m_new) : 0.f;
    l += pr;  // every lane of the slot holds the same sum; the slots of other lane groups are added at the end
    const float pv = on ? pr * vsc : 0.f;  // a slot that takes no part has no scale read either
    uint32_t w[kWords];
    load_words<VB>(vs + (p * 32 + c.lane) * VB, w);
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      float f[4];
      v_values<kInt4>(w[i], f);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i * 4 + e] += pv * f[e];
    }
  }
  m = m_new;
}

// Blocks that share an SM: Fit<...>::kBlocks (six of int4; three, five or six of int8 by the ring).
// kWarpHead (S = 1 only): each warp takes a (row, head) of its own, all its tiles, and writes its output; the
// block is kWarps heads of one row. Else the kWarps warps of a block share one (row, head).
// kProbe (int8 only): the DMA probe, kernel #7. The same grid, layout, ring and loads over all T slots (valid_len
// is null; q, start and key_mask too), no math, no merge; it writes kv[b, 0, h*D + d] + scale[b, 0, 0].
template <typename QT, bool kInt4, int VB, bool kWarpHead, int LPS, bool kWin, bool kProbe>
__global__ void __launch_bounds__(kThreads, Fit<kInt4, VB, LPS, kWin>::kBlocks) packed_chunked_attention_kernel(
    const QT* __restrict__ q, const uint8_t* __restrict__ kv, const __nv_bfloat16* __restrict__ scale,
    const int32_t* __restrict__ valid_len, const int32_t* __restrict__ start,
    const uint8_t* __restrict__ key_mask, QT* __restrict__ out, float* __restrict__ partial,
    unsigned int* __restrict__ counters, int T, int H, int D, int lps_log2, float sm_scale) {
  static_assert(!(kProbe && kInt4), "the DMA probe reads the int8 cache");
  static_assert(!kWin || (VB == 16 && LPS == 0 && !kInt4), "the windowed layout: int8, 16-byte loads");
  using F = Fit<kInt4, VB, LPS, kWin>;
  constexpr int kStages = F::kStages;
  constexpr int kP = F::kP;
  constexpr bool kLoadsOnly = kProbe || (kInt4 && kLoadsOnlyBuild);
  constexpr bool kL1 = L1Loads<kInt4, kWarpHead, kWin>::value;
  extern __shared__ __align__(16) unsigned char ring_all[];  // [kWarps][kStages][a tile]
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][kMaxD];
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = kWarpHead ? blockIdx.x * kWarps + warp : blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  if (kWarpHead && h >= H) return;  // no block barrier in this mode
  const int HD = H * D;
  const int n = kProbe ? T : min(max(valid_len[0], 1), T);
  const int lo = start ? min(max(start[b], 0), n) : 0;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t qo = bh * D;

  WarpCtx c;
  c.row_bytes = kInt4 ? HD : 2 * HD;
  c.v_off = HD;
  const int shift = kWin ? (h * D) & 15 : 0;  // kWin: the bytes of the previous head at the window's start
  c.kb = kv + static_cast<size_t>(b) * T * c.row_bytes + static_cast<size_t>(h) * D - shift;
  c.ksc = scale + (static_cast<size_t>(b) * 2 * H + h) * T;
  c.vsc = scale + (static_cast<size_t>(b) * 2 * H + H + h) * T;
  c.mask = key_mask ? key_mask + static_cast<size_t>(b) * T : nullptr;
  c.ring = ring_all + warp * kStages * F::kStageBytes;
  c.lo = lo;
  c.n = n;
  c.lps_log2 = lps_log2;
  c.lane = lane;
  if constexpr (LPS == 0) {
    c.tile = kP * (32 >> lps_log2);
    c.chunk = lane & ((1 << lps_log2) - 1);
    c.slot0 = (lane >> lps_log2) * kP;
    c.own = c.chunk * VB < D + shift;
  } else {
    c.tile = Lanes<LPS>::kGroups * kP;
    c.chunk = lane % LPS;
    c.slot0 = (lane / LPS) * kP;  // the idle lanes' is c.tile
    c.own = lane < Lanes<LPS>::kGroups * LPS && c.chunk * VB < D;
  }
  // this block's share of the tiles, and this warp's part of it
  const int n_tiles = (n - lo + c.tile - 1) / c.tile;
  const int per_split = (n_tiles + S - 1) / S;
  const int share = max(min(per_split, n_tiles - split * per_split), 0);
  if (kWarpHead) {
    c.first_tile = 0;
    c.n_mine = n_tiles;
    c.tile_step = 1;
  } else {
    c.first_tile = split * per_split + warp;
    c.n_mine = share > warp ? (share - warp + kWarps - 1) / kWarps : 0;
    c.tile_step = kWarps;
  }

  float qf[VB];  // a byte of the lane's load is one value of D
  float acc[VB];
#pragma unroll
  for (int e = 0; e < VB; ++e) {
    const int pos = c.chunk * VB + e - shift;  // the value of the head this byte of the load holds, if in [0, D)
    qf[e] = !kProbe && c.own && pos >= 0 && pos < D ? to_float(q[qo + pos]) : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY;  // running max of this warp's scores, in base 2 (the score times log2 e)
  float l = 0.f;        // running sum of exp(score - m) over this lane group's slots
  uint32_t bits = 0u;   // kLoadsOnly: what the loads added up

  TileMeta meta[kStages];
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) meta[u] = request_tile<kInt4, VB, LPS, kWin, kL1>(c, u, u);
  for (int j0 = 0; j0 < c.n_mine; j0 += kStages) {
#pragma unroll
    for (int u = 0; u < kStages; ++u) {  // tile j0 + u lies in stage u
      constexpr int kAhead = kStages - 1;
      meta[(u + kAhead) % kStages] = request_tile<kInt4, VB, LPS, kWin, kL1>(c, j0 + u + kAhead, (u + kAhead) % kStages);
      wait_group<kAhead>();  // all but the newest kAhead groups have landed: tile j0 + u is there
      compute_tile<kInt4, VB, LPS, kWin, kLoadsOnly>(c, meta[u], u, qf, acc, m, l, sm_scale * kLog2e, bits);
    }
  }
  wait_group<0>();
  if constexpr (kProbe) {
    if (bits == 0xFFFFFFFFu) out[qo] = from_float<QT>(0.f);  // never true (see compute_tile): keeps every load
    if ((kWarpHead || (warp == 0 && split == 0)) && c.slot0 == 0 && c.own) {
      const float s00 = __bfloat162float(scale[static_cast<size_t>(b) * 2 * H * T]);  // scale[b, 0, 0]
      const int8_t* first = reinterpret_cast<const int8_t*>(c.kb) + c.chunk * VB;      // kv[b, 0, h*D + ...]
#pragma unroll
      for (int e = 0; e < VB; ++e) {
        const int pos = c.chunk * VB + e - shift;
        if (pos >= 0 && pos < D) out[qo + pos] = from_float<QT>(static_cast<float>(first[e]) + s00);
      }
    }
    return;
  } else if constexpr (kLoadsOnly) {  // the output means nothing; `bits` keeps the loads
    acc[0] += __uint_as_float(bits & 1u);
    m = 0.f;
    l = 1.f;
  }

  // the lane groups of a warp hold different slots: add them up
  if constexpr (LPS == 0) {
    for (int off = 1 << lps_log2; off < 32; off <<= 1) {
      l += __shfl_xor_sync(kFull, l, off);
#pragma unroll
      for (int e = 0; e < VB; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], off);
    }
  } else {  // in group order: lane c of group 0 gathers lane c of every group
    float lt = 0.f, at[VB];
#pragma unroll
    for (int e = 0; e < VB; ++e) at[e] = 0.f;
#pragma unroll
    for (int g = 0; g < Lanes<LPS>::kGroups; ++g) {
      lt += __shfl_sync(kFull, l, g * LPS + c.chunk);
#pragma unroll
      for (int e = 0; e < VB; ++e) at[e] += __shfl_sync(kFull, acc[e], g * LPS + c.chunk);
    }
    l = lt;
#pragma unroll
    for (int e = 0; e < VB; ++e) acc[e] = at[e];
  }
  if (kWarpHead) {  // this warp saw every slot of its (row, head)
    if (c.slot0 == 0 && c.own) {
#pragma unroll
      for (int e = 0; e < VB; ++e) {
        const int pos = c.chunk * VB + e - shift;
        if (pos >= 0 && pos < D) out[qo + pos] = from_float<QT>(l > 0.f ? acc[e] / l : 0.f);
      }
    }
    return;
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  if (c.slot0 == 0 && c.own) {
#pragma unroll
    for (int e = 0; e < VB; ++e) {
      const int pos = c.chunk * VB + e - shift;
      if (pos >= 0 && pos < D) s_acc[warp][pos] = acc[e];
    }
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
      const float f = exp2f(s_m[w] - big);
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
      const float f = exp2f(ms - top);
      num += __ldcg(all + s * (D + 2) + 2 + d) * f;
      den += __ldcg(all + s * (D + 2) + 1) * f;
    }
    out[qo + d] = from_float<QT>(den > 0.f ? num / den : 0.f);
  }
  if (tid == 0) counters[bh] = 0u;  // ready for the next launch on this stream
}

struct Args {
  const void *q, *kv, *scale, *valid_len, *start, *key_mask;
  void *out, *partial, *counters;
  int B, H, T, D, S;
  bool warp_head, probe;
  float sm_scale;
  cudaStream_t stream;
  int* blocks_per_sm;  // not null: report how many blocks of this instantiation share an SM, launch nothing
};

template <typename QT>
using KernelFn = void (*)(const QT*, const uint8_t*, const __nv_bfloat16*, const int32_t*, const int32_t*,
                          const uint8_t*, QT*, float*, unsigned int*, int, int, int, int, float);

template <typename QT, bool kInt4, int VB, int LPS, bool kWin>
KernelFn<QT> pick(bool warp_head, bool probe) {
  if constexpr (!kInt4) {
    if (probe) {
      return warp_head ? &packed_chunked_attention_kernel<QT, false, VB, true, LPS, kWin, true>
                       : &packed_chunked_attention_kernel<QT, false, VB, false, LPS, kWin, true>;
    }
  }
  return warp_head ? &packed_chunked_attention_kernel<QT, kInt4, VB, true, LPS, kWin, false>
                   : &packed_chunked_attention_kernel<QT, kInt4, VB, false, LPS, kWin, false>;
}

// kWin: the windowed layout (int8, D 8 bytes past a multiple of 16, H even); its slot spans D + 8 bytes.
template <typename QT, bool kInt4, int VB, bool kWin = false>
cudaError_t launch_one(const Args& a) {
  if (!kWin && a.D % VB != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a.kv) % VB != 0) return cudaErrorMisalignedAddress;
  const int span = kWin ? a.D + 8 : a.D;
  int lps_log2 = 0;
  while ((1 << lps_log2) < kPasses || (1 << lps_log2) * VB < span) ++lps_log2;
  if (lps_log2 > 5) return cudaErrorInvalidValue;
  const bool five = !kWin && a.D == 5 * VB;
  const int ring = five ? Fit<kInt4, VB, 5, false>::kRingBytes : Fit<kInt4, VB, 0, kWin>::kRingBytes;
  auto select = [&](bool probe) -> KernelFn<QT> {
    if constexpr (kWin) return pick<QT, kInt4, VB, 0, true>(a.warp_head, probe);
    return five ? pick<QT, kInt4, VB, 5, false>(a.warp_head, probe) : pick<QT, kInt4, VB, 0, false>(a.warp_head, probe);
  };
  const KernelFn<QT> kernel = select(a.probe);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
  if (err != cudaSuccess) return err;
  int smem = ring;
  if (!kInt4 && (a.warp_head || kWin)) {  // L1Loads: the loads go through L1
    // Ask the SM for no more shared memory than the attention's blocks that fit need, so that the rest is L1, and
    // give the probe the attention's shared memory a block, so that as many of its blocks share an SM with as much
    // L1 (without its math it needs fewer registers and no merge space, and more of its blocks would fit).
    const KernelFn<QT> attention = select(false);
    int blocks = 0;
    cudaFuncAttributes fa, fk;
    if ((err = cudaFuncSetAttribute(attention, cudaFuncAttributeMaxDynamicSharedMemorySize, ring)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attention, kThreads, ring)) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&fa, attention)) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&fk, kernel)) != cudaSuccess) {
      return err;
    }
    const int footprint = ring + static_cast<int>(fa.sharedSizeBytes);  // the attention's shared memory a block
    const int carveout = (blocks * (footprint + 1024) * 100 + kSmemPerSm - 1) / kSmemPerSm;  // percent, rounded up
    if (a.probe) smem = footprint - static_cast<int>(fk.sharedSizeBytes);
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout)) != cudaSuccess) {
      return err;
    }
  }
  if (a.blocks_per_sm != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.blocks_per_sm, kernel, kThreads, smem);
  }
  const dim3 grid(a.warp_head ? (a.H + kWarps - 1) / kWarps : a.H, a.B, a.S);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const uint8_t*>(a.kv), static_cast<const __nv_bfloat16*>(a.scale),
      static_cast<const int32_t*>(a.valid_len), static_cast<const int32_t*>(a.start),
      static_cast<const uint8_t*>(a.key_mask), static_cast<QT*>(a.out), static_cast<float*>(a.partial),
      static_cast<unsigned int*>(a.counters), a.T, a.H, a.D, lps_log2, a.sm_scale);
  return cudaGetLastError();
}

// Whether the int8 payload takes the windowed layout (see Fit): D 8 bytes past a multiple of 16, from 88 on (below,
// the 8-byte layout keeps more of its lanes busy), and H even, so that every window lies inside its row and the V
// bytes start 16-byte aligned. ops/flash_decode.py:_packed_window holds the same rule.
inline bool windowed(const Args& a) { return a.D % 16 == 8 && a.D >= 88 && a.H % 2 == 0; }

template <bool kInt4>
cudaError_t launch_payload(const Args& a, int q_is_bf16) {
  if (a.D % 16 == 0) {
    return q_is_bf16 ? launch_one<__nv_bfloat16, kInt4, 16>(a) : launch_one<float, kInt4, 16>(a);
  }
  if constexpr (!kInt4) {
    if (windowed(a)) {
      return q_is_bf16 ? launch_one<__nv_bfloat16, false, 16, true>(a) : launch_one<float, false, 16, true>(a);
    }
  }
  if (a.D % 8 == 0) {
    return q_is_bf16 ? launch_one<__nv_bfloat16, kInt4, 8>(a) : launch_one<float, kInt4, 8>(a);
  }
  return q_is_bf16 ? launch_one<__nv_bfloat16, kInt4, 4>(a) : launch_one<float, kInt4, 4>(a);
}

}  // namespace

// D must be a multiple of 4 in (0, 256] whose slot fits 32 lanes: a lane
// loads 16 bytes where D is a multiple of 16 (or the int8 payload takes the
// windowed layout), else 8, else 4 (then D <= 128), and kv_layer must be
// aligned to that load; the Python wrapper checks both.
// splits in [1, 16]: with splits > 1, partial must hold B*H*splits*(D+2)
// floats and counters B*H zeros (the kernel leaves them 0). warp_head (splits
// 1 only): a warp per (row, head). start and key_mask may be null.
extern "C" int wmar_packed_chunked_attention(
    const void* q, const void* kv_layer, const void* scale_layer, const void* valid_len, const void* start,
    const void* key_mask, void* out, void* partial, void* counters, int B, int H, int T, int D, int splits,
    int warp_head, int int4_payload, int q_is_bf16, float sm_scale, void* stream) {
  const Args a{q, kv_layer, scale_layer, valid_len, start, key_mask, out, partial, counters,
               B, H, T, D, splits, warp_head != 0, false, sm_scale, reinterpret_cast<cudaStream_t>(stream), nullptr};
  if (D <= 0 || D > kMaxD || D % 4 != 0 || splits < 1 || splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1 && (warp_head || partial == nullptr || counters == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = int4_payload ? launch_payload<true>(a, q_is_bf16) : launch_payload<false>(a, q_is_bf16);
  return static_cast<int>(err);
}

// Kernel #7, the DMA probe: the int8 instantiation the attention takes at this
// (B, H, D, splits, warp_head), over all T < 2^20 slots, its math compiled out.
// out [B, H, D] in out's type (bf16 or f32) = kv[b, 0, h*D + d] + scale[b, 0, 0].
// The shapes and the alignment as for the attention; no scratch (no merge).
extern "C" int wmar_dma_probe(const void* kv_layer, const void* scale_layer, void* out, int B, int H, int T,
                              int D, int splits, int warp_head, int out_is_bf16, void* stream) {
  const Args a{nullptr, kv_layer, scale_layer, nullptr, nullptr, nullptr, out, nullptr, nullptr,
               B, H, T, D, splits, warp_head != 0, true, 1.f, reinterpret_cast<cudaStream_t>(stream), nullptr};
  if (D <= 0 || D > kMaxD || D % 4 != 0 || T <= 0 || T >= (1 << 20) || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && warp_head)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_payload<false>(a, out_is_bf16));
}

// How many blocks of the kernel the arguments pick share one SM (the occupancy
// calculator's answer for its registers, ring and launch bounds), in
// *blocks_per_sm. probe: kernel #7's instantiation (int8 only).
extern "C" int wmar_packed_blocks_per_sm(int D, int int4_payload, int warp_head, int q_is_bf16, int probe,
                                         int* blocks_per_sm) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || (probe && int4_payload)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               1, 2, 1, D, 1, warp_head != 0, probe != 0, 1.f, nullptr, blocks_per_sm};  // H = 2: as a model's
  const cudaError_t err = int4_payload ? launch_payload<true>(a, q_is_bf16) : launch_payload<false>(a, q_is_bf16);
  return static_cast<int>(err);
}
