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
// rounded and never written to device memory. Two kernels, routed by what
// they are given (never a fallback on failure):
//
// 1. bf16 x, N a multiple of 8: the tensor-core kernel w4_mma_kernel.
//    What bounds it: the weight bytes. At Taming-1.4B (32 rows) a decode
//    step reads ~0.8 GB of nibbles and scales (~0.24 ms at 3.35 TB/s) and does
//    ~104 GFLOP, ~0.1 ms on the tensor cores; the first design did those
//    flops as float32 FMAs on the CUDA cores and took 13 ms. The design:
//    - mma.sync.m16n8k16 with bf16 operands and float32 sums; x is A (M in
//      tiles of 16, so M = 24-32 leaves at most a third of a tile empty, where
//      wgmma's 64-row tiles would be half empty), the weights are B;
//    - a nibble minus 8 is exact in bf16, so the weights reach the tensor
//      cores unrounded. Unpack: one byte-permute puts byte j of two
//      neighbouring byte rows into bytes 0 and 2 of a word; one lop3 keeps
//      their low nibbles and ORs in the bf16 exponent of 128, giving the
//      bf16x2 (128 + lo_a, 128 + lo_b); a shift and a second lop3 do the same
//      for the high nibbles; one bf16x2 subtract of 136 each. Six
//      instructions for four values (see unpack_* below);
//    - no repack of the weights: the payload stays JAX's byte for byte. The
//      k pair of a fragment register is two neighbouring byte rows (k = i,
//      i + 1 of the low half of a group, or i + G/2, i + 1 + G/2 of the high
//      half), so x stays in its natural order. The n order inside a warp's 32
//      columns is free: n8 tile j takes columns 4c + j, so one 32-bit shared
//      word of 4 neighbouring columns feeds 4 tiles, and a thread's sums land
//      on 8 neighbouring columns (one 16-byte store, one 16-byte scale load);
//    - a block is 4 warps x 32 columns = 128 columns and 16 or 32 rows. Its
//      K share is cut into chunks of 128 k (64 byte rows: one group of 128,
//      two of 64, four of 32); chunk by chunk the q bytes [64][128], the
//      scales and the x slice [rows][128] go by 16-byte cp.async into a ring
//      of 4 stages (3 chunks on their way while one is computed). Byte rows
//      are padded to 144 bytes and x rows to 136 values, so the 32 lanes of a
//      warp hit 32 distinct banks;
//    - each group has its own float32 partial (part), and acc += s * part
//      at the group's end, as the plain version does;
//    - K is split over gridDim.z blocks (the wrapper's w4_splits, from the
//      shapes and the SM count only, so a CUDA graph may replay the launch)
//      so that narrow products fill the 132 SMs: 13 column tiles x 8 splits
//      at 1664 x 1664. The chunks are dealt evenly (none is empty). The S
//      blocks of a column tile are one thread-block cluster (S <= 8): each
//      leaves its sums in its own shared memory, and after a cluster barrier
//      block r adds the S sums of 1/S of the tile's values in split order
//      (the same bits from run to run) through distributed shared memory and
//      writes them. No scratch in device memory, no counter, no fence: a
//      first design that merged through global scratch and an arrival counter
//      spent ~20 us in the merge at 11 splits.
//
// 2. f32 x (or N no multiple of 8): the CUDA-core kernel w4_fma_kernel, the
//    first design. bf16 operands cannot hold an f32 x to the f32 tolerance,
//    so f32 x is routed here by its type; it does the flops as float32 FMAs
//    and is bound by instruction issue:
//    - a block per (64 columns, 8 rows); each of its 8 warps takes every 8th
//      group of the K axis, and the warps' sums are added in a fixed order
//      through shared memory at the end;
//    - per group a warp stages its x slice [8 rows, G] in shared memory as
//      float32, transposed to [G][8], so one 16-byte broadcast load brings 4
//      rows' values of one k;
//    - a lane owns 2 neighbouring columns, and one byte gives the weights of
//      rows i and i + G/2; nibbles become floats with an OR into the mantissa
//      of 2^23 and one subtraction.

// -DWMAR_W4_LOADS_ONLY compiles the tensor-core kernel's math out,
// -DWMAR_W4_MATH_ONLY its loads: what each part costs alone, for
// tools/bench_w4.py --variant. Their outputs are meaningless.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Pieces a later w8a16 kernel can share: the bf16 mma tile and the unpack.

// c += a . b over one m16n8k16 tile: a [16 x 16] bf16 (4 registers of bf16x2,
// row-major fragment), b [16 x 8] bf16 (2 registers, column-major fragment),
// c [16 x 8] float32 (4 registers).
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x & mask) | bits in one instruction
__device__ __forceinline__ uint32_t and_or(uint32_t x, uint32_t mask, uint32_t bits) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(x), "r"(mask), "r"(bits));  // 0xEA: (a & b) | c
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_minus_136(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));  // 128 + nibble - 136: exact
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte j of u and byte j of v in bytes 0 and 2 of one word (bytes 1 and 3 are
// never looked at).
__device__ __forceinline__ uint32_t pair_bytes(uint32_t u, uint32_t v, int j) {
  const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
  return __byte_perm(u, v, sel);
}

// From a word of pair_bytes: the bf16x2 (lo_nibble(byte 0) - 8, lo_nibble(byte 2) - 8), exact.
__device__ __forceinline__ uint32_t unpack_lo(uint32_t r) {
  return bf16x2_minus_136(and_or(r, 0x000F000Fu, 0x43004300u));  // 0x4300 | v is the bf16 128 + v
}

// The same from the high nibbles.
__device__ __forceinline__ uint32_t unpack_hi(uint32_t r) {
  return bf16x2_minus_136(and_or(r >> 4, 0x000F000Fu, 0x43004300u));
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16 x).

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTileN = 32 * kMmaWarps;  // columns of a block: 32 a warp
constexpr int kChunkK = 128;            // k values a stage holds
constexpr int kChunkRows = kChunkK / 2;  // byte rows a stage holds
constexpr int kQStride = kTileN + 16;   // bytes of a byte row in shared memory: 36 words, 4 apart mod 32 banks
constexpr int kXStride = kChunkK + 8;   // bf16 of an x row in shared memory: 68 words, 4 apart mod 32 banks
constexpr int kMaxGroupsPerChunk = kChunkK / 32;
constexpr int kStages = 4;  // 6 measured the same (tools/bench_w4.py, 3 blocks an SM become 2)
constexpr int kMaxSplits = 8;  // the S blocks of a tile are one thread-block cluster: at most 8 (portable)

template <int MT>  // m16 tiles of a block: 1 (M <= 16) or 2
struct Layout {
  static constexpr int kRows = 16 * MT;
  static constexpr int kQBytes = kChunkRows * kQStride;
  static constexpr int kSBytes = kMaxGroupsPerChunk * kTileN * 2;
  static constexpr int kXBytes = kRows * kXStride * 2;
  static constexpr int kStageBytes = kQBytes + kSBytes + kXBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes;
};

template <int VB>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? VB : 0;  // 0: the destination is zero-filled, nothing is read
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void commit_group() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Ask for chunk c of the K axis: byte rows [64c, 64c + 64) of q (flat over the
// groups), the scales of the groups in it and x[m0 : m0 + rows, 128c : 128c + 128].
// What lies beyond M, N or K is zero-filled.
template <int MT, int VB>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const __nv_bfloat16* __restrict__ x,
                                           const uint8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
                                           int c, int m0, int n0, int M, int N, int K, int G) {
#ifdef WMAR_W4_MATH_ONLY
  return;  // the stage keeps whatever it holds
#endif
  using L = Layout<MT>;
  const int tid = threadIdx.x;
  const int rows_q = K / 2;
  constexpr int kPerRow = kTileN / VB;
#pragma unroll
  for (int i = tid; i < kChunkRows * kPerRow; i += kMmaThreads) {
    const int r = i / kPerRow, cc = i - r * kPerRow;
    const int row = c * kChunkRows + r, col = n0 + cc * VB;
    const bool in = row < rows_q && col < N;
    copy_async<VB>(stage + r * kQStride + cc * VB, in ? q + static_cast<size_t>(row) * N + col : q, in);
  }
  const int g0 = c * (kChunkK / G);
  const int groups = K / G;
  for (int i = tid; i < kMaxGroupsPerChunk * (kTileN / 8); i += kMmaThreads) {
    const int g = i / (kTileN / 8), cc = i - g * (kTileN / 8);
    const int col = n0 + cc * 8;
    const bool in = g < kChunkK / G && g0 + g < groups && col < N;
    if (g < kChunkK / G) {
      copy_async<16>(stage + L::kQBytes + (g * kTileN + cc * 8) * 2,
                     in ? s + static_cast<size_t>(g0 + g) * N + col : s, in);
    }
  }
#pragma unroll
  for (int i = tid; i < L::kRows * (kChunkK / 8); i += kMmaThreads) {
    const int m = i / (kChunkK / 8), cc = i - m * (kChunkK / 8);
    const int k = c * kChunkK + cc * 8;
    const bool in = m0 + m < M && k < K;
    copy_async<16>(stage + L::kQBytes + L::kSBytes + (m * kXStride + cc * 8) * 2,
                   in ? x + static_cast<size_t>(m0 + m) * K + k : x, in);
  }
}

// The A fragment of x rows [16 mt, 16 mt + 16) at stage-local k column kb: one ldmatrix of four 8 x 8
// matrices (rows 0-7 and 8-15 of columns 0-7, then of columns 8-15), lane i giving the address of row i % 16
// at column 8 (i / 16). (Four 32-bit loads a fragment took 3-5% longer.)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* xs, int mt, int kb, int lane) {
  const __nv_bfloat16* row = xs + (16 * mt + (lane & 15)) * kXStride + kb + 8 * (lane >> 4);
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// One chunk in a stage: every group in it, and at each group's end acc += s * part.
template <int MT, int G>
__device__ __forceinline__ void compute_chunk(const unsigned char* stage, float (&acc)[MT][4][4], int c, int K) {
  using L = Layout<MT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const unsigned char* qs = stage + warp * 32 + 4 * g;  // this thread's column word of every byte row
  const __nv_bfloat16* ss = reinterpret_cast<const __nv_bfloat16*>(stage + L::kQBytes) + warp * 32 + 8 * tig;
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage + L::kQBytes + L::kSBytes);
  const int n_groups = min(kChunkK / G, (K - c * kChunkK) / G);  // the last chunk may hold fewer
  constexpr int half = G / 2;
#ifdef WMAR_W4_LOADS_ONLY
  acc[0][0][0] += __uint_as_float(*reinterpret_cast<const uint32_t*>(qs) & 1u) + __bfloat162float(xs[lane]);
  return;
#endif
#pragma unroll
  for (int grp = 0; grp < kChunkK / G; ++grp) {
    if (grp >= n_groups) break;  // uniform across the block
    float part[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
#pragma unroll
    for (int rb = 0; rb < half; rb += 16) {  // 16 byte rows: a k16 step of low nibbles and one of high
      const int r = grp * half + rb;
      const uint32_t u0 = *reinterpret_cast<const uint32_t*>(qs + (r + 2 * tig) * kQStride);
      const uint32_t u1 = *reinterpret_cast<const uint32_t*>(qs + (r + 2 * tig + 1) * kQStride);
      const uint32_t u2 = *reinterpret_cast<const uint32_t*>(qs + (r + 2 * tig + 8) * kQStride);
      const uint32_t u3 = *reinterpret_cast<const uint32_t*>(qs + (r + 2 * tig + 9) * kQStride);
      uint32_t alo[MT][4], ahi[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        load_a(alo[mt], xs, mt, grp * G + rb, lane);
        load_a(ahi[mt], xs, mt, grp * G + half + rb, lane);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // n8 tile j: columns 4c + j of the warp's 32
        const uint32_t p01 = pair_bytes(u0, u1, j), p23 = pair_bytes(u2, u3, j);
        const uint32_t blo0 = unpack_lo(p01), blo1 = unpack_lo(p23);
        const uint32_t bhi0 = unpack_hi(p01), bhi1 = unpack_hi(p23);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(part[mt][j], alo[mt], blo0, blo1);
          mma_bf16_16816(part[mt][j], ahi[mt], bhi0, bhi1);
        }
      }
    }
    // this thread's columns are 8 tig + 4 e + j of the warp's 32 (e = 0, 1): 8 neighbours
    const uint4 sw = *reinterpret_cast<const uint4*>(ss + grp * kTileN);
    const uint32_t sv[4] = {sw.x, sw.y, sw.z, sw.w};
    float sc[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[2 * i] = __uint_as_float(sv[i] << 16);
      sc[2 * i + 1] = __uint_as_float(sv[i] & 0xFFFF0000u);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = fmaf(sc[4 * (e & 1) + j], part[mt][j][e], acc[mt][j][e]);
  }
}

// Rows 16 mt + g + 8 h, columns 8 tig .. 8 tig + 7 of the warp's 32, as bf16.
template <int MT>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][4][4], __nv_bfloat16* __restrict__ out, int m0,
                                           int n0, int M, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int col = n0 + warp * 32 + 8 * tig;
  if (col >= N) return;  // N is a multiple of 8: the 8 columns are all in or all out
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * mt + g + 8 * h;
      if (m >= M) continue;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // columns 2i and 2i + 1: (e, j) = (2i >> 2, 2i & 3) and ((2i + 1) >> 2, (2i + 1) & 3)
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][(2 * i) & 3][2 * h + ((2 * i) >> 2)],
                                                       acc[mt][(2 * i + 1) & 3][2 * h + ((2 * i + 1) >> 2)]);
        w[i] = *reinterpret_cast<const uint32_t*>(&v);
      }
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + col) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

template <int MT, int VB, int G>
__global__ void __launch_bounds__(kMmaThreads, 3) w4_mma_kernel(  // 3 blocks share an SM (74 KB of ring each)
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
    __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using L = Layout<MT>;
  extern __shared__ __align__(16) unsigned char ring[];
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * L::kRows;
  const int split = blockIdx.z, S = gridDim.z;
  const int chunks = (K + kChunkK - 1) / kChunkK;
  const int c_begin = static_cast<int>(static_cast<long long>(split) * chunks / S);
  const int c_end = static_cast<int>(static_cast<long long>(split + 1) * chunks / S);
  const int n_mine = c_end - c_begin;

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_mine) load_chunk<MT, VB>(ring + i * L::kStageBytes, x, q, s, c_begin + i, m0, n0, M, N, K, G);
    commit_group();  // one group per chunk, empty or not, so that the waits count chunks
  }
  for (int i = 0; i < n_mine; ++i) {
    wait_group<kStages - 2>();  // chunk i has landed for this thread
    __syncthreads();            // ... and for every thread; the stage of chunk i - 1 is free
    const int next = i + kStages - 1;
    if (next < n_mine) {
      load_chunk<MT, VB>(ring + (next % kStages) * L::kStageBytes, x, q, s, c_begin + next, m0, n0, M, N, K, G);
    }
    commit_group();
    compute_chunk<MT, G>(ring + (i % kStages) * L::kStageBytes, acc, c_begin + i, K);
  }
  wait_group<0>();

  if (S == 1) {
    store_tile<MT>(acc, out, m0, n0, M, N);
    return;
  }
  // K is split over the S blocks of this tile's cluster: each leaves its sums in its own shared memory, and
  // block r adds the S sums of a 1/S share of the tile's values, in split order, from the blocks' shared memory
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kVals = MT * 16;  // a thread's sums: (mt, j, e)
  float* mine = reinterpret_cast<float*>(ring);
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[((mt * 4 + j) * 4 + e) * kMmaThreads + threadIdx.x] = acc[mt][j][e];
  cluster.sync();
  const int total = kVals * kMmaThreads;
  const int lo = static_cast<int>(cluster.block_rank()) * total / S;
  const int hi = (static_cast<int>(cluster.block_rank()) + 1) * total / S;
  for (int idx = lo + threadIdx.x; idx < hi; idx += kMmaThreads) {
    float sum = 0.f;
    for (int sp = 0; sp < S; ++sp) sum += cluster.map_shared_rank(mine, sp)[idx];
    const int v = idx / kMmaThreads, t = idx - v * kMmaThreads;  // value v of thread t
    const int mt = v >> 4, j = (v >> 2) & 3, e = v & 3;
    const int lane = t & 31, g = lane >> 2, tig = lane & 3;
    const int m = m0 + 16 * mt + g + 8 * (e >> 1);
    const int col = n0 + (t >> 5) * 32 + 8 * tig + 4 * (e & 1) + j;
    if (m < M && col < N) out[static_cast<size_t>(m) * N + col] = __float2bfloat16_rn(sum);
  }
  cluster.sync();  // no block leaves while the others read its shared memory
}

template <int MT, int VB, int G>
cudaError_t launch_mma(const void* x, const void* q, const void* s, void* out, int M, int N, int K, int splits,
                       cudaStream_t st) {
  auto kernel = w4_mma_kernel<MT, VB, G>;
  const int smem = Layout<MT>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTileN - 1) / kTileN, (M + Layout<MT>::kRows - 1) / Layout<MT>::kRows, splits);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // the S blocks of a tile form one cluster
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
                           static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(out), M, N, K);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MT, int G>
cudaError_t launch_mma_vb(const void* x, const void* q, const void* s, void* out, int M, int N, int K, int splits,
                          cudaStream_t st) {
  return N % 16 == 0 ? launch_mma<MT, 16, G>(x, q, s, out, M, N, K, splits, st)
                     : launch_mma<MT, 8, G>(x, q, s, out, M, N, K, splits, st);
}

template <int MT>
cudaError_t launch_mma_g(const void* x, const void* q, const void* s, void* out, int M, int N, int K, int G,
                         int splits, cudaStream_t st) {
  if (G == 128) return launch_mma_vb<MT, 128>(x, q, s, out, M, N, K, splits, st);
  if (G == 64) return launch_mma_vb<MT, 64>(x, q, s, out, M, N, K, splits, st);
  return launch_mma_vb<MT, 32>(x, q, s, out, M, N, K, splits, st);
}

// ---------------------------------------------------------------------------
// The CUDA-core kernel (f32 x, or N no multiple of 8).

constexpr int kFmaWarps = 8;
constexpr int kFmaThreads = kFmaWarps * 32;
constexpr int kFmaRows = 8;   // rows of x per block
constexpr int kFmaCols = 64;  // output columns per block: 2 per lane

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
__global__ void __launch_bounds__(kFmaThreads) w4_fma_kernel(
    const XT* __restrict__ x, const uint8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
    XT* __restrict__ out, int M, int N, int K, int G) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = G >> 1;
  const int gc = K / G;
  const int n0 = blockIdx.x * kFmaCols;
  const int m0 = blockIdx.y * kFmaRows;
  const int rows = min(kFmaRows, M - m0);
  const int n = n0 + 2 * lane;
  const bool c0 = n < N;
  const bool c1 = n + 1 < N;
  float* xs = smem + warp * G * kFmaRows;  // this warp's x slice, [G][kFmaRows]

  float acc[kFmaRows][2];
  float part[kFmaRows][2];
#pragma unroll
  for (int m = 0; m < kFmaRows; ++m) {
    acc[m][0] = acc[m][1] = 0.f;
    part[m][0] = part[m][1] = 0.f;
  }

  for (int g = warp; g < gc; g += kFmaWarps) {
    __syncwarp();  // every lane is done with the previous group's slice
    for (int idx = lane; idx < G * kFmaRows; idx += 32) {
      const int m = idx / G;
      const int k = idx - m * G;  // lanes across k: coalesced reads of x
      xs[k * kFmaRows + m] = m < rows ? to_float(x[(size_t)(m0 + m) * K + (size_t)g * G + k]) : 0.f;
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
        const float4* xa = reinterpret_cast<const float4*>(xs + (i0 + u) * kFmaRows);
        const float4* xb = reinterpret_cast<const float4*>(xs + (i0 + u + half) * kFmaRows);
#pragma unroll
        for (int j = 0; j < kFmaRows / 4; ++j) {
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
    for (int m = 0; m < kFmaRows; ++m) {
      acc[m][0] = fmaf(s0, part[m][0], acc[m][0]);
      acc[m][1] = fmaf(s1, part[m][1], acc[m][1]);
      part[m][0] = part[m][1] = 0.f;
    }
  }

  // add the warps' K slices in a fixed order (the result does not depend on
  // which block or warp finished first)
  __syncthreads();  // every warp is done with its x slice
  float* red = smem;  // [kFmaWarps][kFmaRows][kFmaCols]
#pragma unroll
  for (int m = 0; m < kFmaRows; ++m) {
    red[(warp * kFmaRows + m) * kFmaCols + 2 * lane] = acc[m][0];
    red[(warp * kFmaRows + m) * kFmaCols + 2 * lane + 1] = acc[m][1];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kFmaRows * kFmaCols; idx += kFmaThreads) {
    const int m = idx / kFmaCols;
    const int c = idx - m * kFmaCols;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kFmaWarps; ++w) sum += red[(w * kFmaRows + m) * kFmaCols + c];
    if (m < rows && n0 + c < N) out[(size_t)(m0 + m) * N + n0 + c] = from_float<XT>(sum);
  }
}

template <typename XT>
cudaError_t launch_fma(const void* x, const void* q, const void* s, void* out, int M, int N, int K, int G,
                       cudaStream_t st) {
  const dim3 grid((N + kFmaCols - 1) / kFmaCols, (M + kFmaRows - 1) / kFmaRows);
  const int xs_floats = kFmaWarps * G * kFmaRows;
  const int red_floats = kFmaWarps * kFmaRows * kFmaCols;
  const size_t smem = (size_t)(xs_floats > red_floats ? xs_floats : red_floats) * sizeof(float);
  w4_fma_kernel<XT><<<grid, kFmaThreads, smem, st>>>(static_cast<const XT*>(x), static_cast<const uint8_t*>(q),
                                                     static_cast<const __nv_bfloat16*>(s), static_cast<XT*>(out), M,
                                                     N, K, G);
  return cudaGetLastError();
}

}  // namespace

// route 1 (tensor cores): x bf16, N a multiple of 8, x, q and s 16-byte
// aligned (q 8-byte aligned where N is no multiple of 16); splits in [1,
// min(8, ceil(K / 128))]. Route 0 (CUDA cores): splits must be 1. The Python
// wrapper checks all of it; a refused launch returns cudaErrorInvalidValue.
extern "C" int wmar_w4_matmul(const void* x, const void* q, const void* s, void* out, int M, int N, int K, int G,
                              int x_is_bf16, int tensor_cores, int splits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || (G != 32 && G != 64 && G != 128) || K % G != 0 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (tensor_cores) {
    const int chunks = (K + kChunkK - 1) / kChunkK;
    if (!x_is_bf16 || N % 8 != 0 || splits > chunks || splits > kMaxSplits) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = M <= 16 ? launch_mma_g<1>(x, q, s, out, M, N, K, G, splits, st)
                  : launch_mma_g<2>(x, q, s, out, M, N, K, G, splits, st);
  } else {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    err = x_is_bf16 ? launch_fma<__nv_bfloat16>(x, q, s, out, M, N, K, G, st)
                    : launch_fma<float>(x, q, s, out, M, N, K, G, st);
  }
  return static_cast<int>(err);
}
