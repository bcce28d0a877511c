// attention_mma: tensor-core products at float32 accuracy and cp.async tile
// copies, shared by the attention kernels: the head-packed K5'
// (attention_packed_fwd.cu) and K6' (attention_packed_bwd.cu), which work on
// dh = 16 or 64 heads of (N, L, D) float32 arrays in blocks of 4 warps, and the
// per-slice K3' (attention_fwd.cu) and K4' (attention_bwd.cu), which work on
// dh = 128 slices of (N, L, 128) arrays in blocks of 8 warps: 4 pairs, each
// pair 16 rows, each warp of a pair one half of the work (pair_sync below).
//
// Products: mma.sync m16n8k8 with tf32 operands and f32 accumulators, in
// the three-term split of CUTLASS's OpMultiplyAddFastF32 ("3xTF32"). Each
// operand x is cut into x_hi = tf32(x) and x_lo = tf32(x - x_hi), and
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi
// is accumulated in f32, small terms first. The dropped a_lo b_lo is about
// 2^-22 of a b; one tf32 product alone would be off by about 2^-11 of each
// term. The tensor cores round their f32 sums toward zero, so a long chain
// of products into one accumulator drifts: summed over L = 700 keys that
// way, K6''s gradients missed 1e-5 of their max abs on the card. So the
// kernels take each tile's product (at most 64 deep) into a fresh
// accumulator and add it to the running sum with an ordinary float add.
//
// Fragment layouts (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A (16 x 8, rows x k): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x cols):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):           c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// An accumulator tile feeds the next product as its A operand without a
// shuffle by relabelling the k index: A's column t stands for k = 2t and
// column t + 4 for k = 2t + 1, so (a0, a1, a2, a3) = (c0, c2, c1, c3), and B
// reads its rows 2t and 2t + 1 in their place (`mma3_b_perm`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rlt {

constexpr int kPackedTile = 64;                 // rows of a block, rows of a streamed tile
constexpr int kPackedWarps = kPackedTile / 16;  // 16 rows per warp
constexpr int kPackedThreads = 32 * kPackedWarps;

// A 64-row tile of one head of width kDh in shared memory (the packed
// kernels take dh = 16 and 64). Its row pitch of kDh + 4 floats puts the 32
// lanes of a B-fragment read on 32 banks, whether it walks along dh
// (g * pitch + t) or along the rows in the relabelled order (2t * pitch + g):
// pitch 68 gives banks 4g + t and 8t + g, pitch 20 banks (20g mod 32) + t
// and 8t + g. The same holds for the A-fragment reads of split_a_tile.
template <int kDh>
struct PackedShape {
  static_assert(kDh % 8 == 0 && kDh <= 64, "dh a multiple of 8, at most 64");
  static constexpr int kPitch = kDh + 4;
  static constexpr int kTileFloats = kPackedTile * kPitch;
  // accumulator tiles of 8 columns across dh, and k-steps of 8 along it
  static constexpr int kCols = kDh / 8;
  // blocks per SM that __launch_bounds__ asks of K5' and K6': dh = 64 was
  // sized for two; at dh = 16 a block needs a quarter of the shared memory,
  // and four (128 registers a thread) ran faster than three on the card
  static constexpr int kMinBlocks = kDh == 64 ? 2 : 4;
};

// The per-slice kernels: dh = 128, pitch 132 for the same reason (g * 132 + t:
// banks 4g + t; 2t * 132 + g: banks 8t + g), 64-row tiles, 8 warps.
constexpr int kSliceDh = 128;
constexpr int kSlicePitch = kSliceDh + 4;
constexpr int kSliceWarps = 8;
constexpr int kSliceThreads = 32 * kSliceWarps;
constexpr int kSliceTileFloats = kPackedTile * kSlicePitch;

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, a and b already split
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4], Split b0,
                                     Split b1) {
  mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

// The A fragment of 16 rows [row0, row0 + 16) of a tile of row pitch
// kPitch at columns [8 kk, 8 kk + 8), split
template <int kPitch>
__device__ __forceinline__ void split_a_tile(Split (&a)[4], const float* tile, int row0,
                                             int kk, int g, int t) {
  const float* p = tile + (row0 + g) * kPitch + 8 * kk + t;
  a[0] = split(p[0]);
  a[1] = split(p[8 * kPitch]);
  a[2] = split(p[4]);
  a[3] = split(p[8 * kPitch + 4]);
}

// An accumulator tile c as the A operand of the next product, in the
// relabelled k order, split
__device__ __forceinline__ void split_acc(const float (&c)[4], Split (&a)[4]) {
  a[0] = split(c[0]);
  a[1] = split(c[2]);
  a[2] = split(c[1]);
  a[3] = split(c[3]);
}

// d += (16 x 8 A) x B where B's k runs along dh: b0 = tile[n][k0 + t],
// b1 = tile[n][k0 + t + 4], n = n0 + g (a K^T or Q^T operand)
template <int kPitch>
__device__ __forceinline__ void mma3_b_rows(float (&d)[4], const Split (&a)[4],
                                            const float* tile, int n0, int k0, int g,
                                            int t) {
  const float* p = tile + (n0 + g) * kPitch + k0 + t;
  mma3(d, a, split(p[0]), split(p[4]));
}

// d += (16 x 8 A) x B in the relabelled k order, B's k running along the
// tile's rows: b0 = tile[k0 + 2t][n0 + g], b1 = tile[k0 + 2t + 1][n0 + g]
template <int kPitch>
__device__ __forceinline__ void mma3_b_perm(float (&d)[4], const Split (&a)[4],
                                            const float* tile, int k0, int n0, int g,
                                            int t) {
  const float* p = tile + (k0 + 2 * t) * kPitch + n0 + g;
  mma3(d, a, split(p[0]), split(p[kPitch]));
}

// d += the tile's product held in `part`, then part = 0
template <int kN>
__device__ __forceinline__ void add_part(float (&d)[kN][4], float (&part)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d[j][e] += part[j][e];
      part[j][e] = 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// The two warps of a pair (warps w and w ^ 4 of an 8-warp block) trade
// accumulator tiles through shared memory
// ---------------------------------------------------------------------------

// Named barrier 1 + pair, for the 64 threads of the pair's two warps
// (barrier 0 is __syncthreads'); orders their shared-memory accesses.
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;" ::"r"(pair + 1) : "memory");
}

// Accumulator tiles c[j] (16 rows x 8 kN columns) into a warp's exchange
// buffer of row pitch kXPitch. A pitch of 8 kN + 8 puts each half-warp's
// float2 accesses (g * kXPitch + 2t: banks 8g + 2t, g < 4) on 32 banks.
template <int kN, int kXPitch>
__device__ __forceinline__ void store_acc(float* x, const float (&c)[kN][4], int g, int t) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    *reinterpret_cast<float2*>(x + g * kXPitch + 8 * j + 2 * t) = make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(x + (g + 8) * kXPitch + 8 * j + 2 * t) =
        make_float2(c[j][2], c[j][3]);
  }
}

// c[j] = the tiles in an exchange buffer
template <int kN, int kXPitch>
__device__ __forceinline__ void load_acc(float (&c)[kN][4], const float* x, int g, int t) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float2 lo = *reinterpret_cast<const float2*>(x + g * kXPitch + 8 * j + 2 * t);
    const float2 hi = *reinterpret_cast<const float2*>(x + (g + 8) * kXPitch + 8 * j + 2 * t);
    c[j][0] = lo.x;
    c[j][1] = lo.y;
    c[j][2] = hi.x;
    c[j][3] = hi.y;
  }
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

// wait until at most `kPending` committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending));
}

// Start copying rows [row0, row0 + 64) of one head's (L, kDh) columns of
// an (N, L, D) array (`src` points at the head's row 0, rows d_model floats
// apart) into a tile of pitch kDh + 4, by the whole block of kThreads
// threads; rows at or past `length` become zeros.
template <int kDh, int kThreads = kPackedThreads>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src, int row0,
                                                int length, int d_model) {
  constexpr int kPitch = kDh + 4;
  constexpr int kQuads = kPackedTile * (kDh / 4);
  static_assert(kQuads % kThreads == 0, "whole float4 per thread");
#pragma unroll
  for (int it = 0; it < kQuads / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kDh / 4);
    const int c4 = (i % (kDh / 4)) * 4;
    const bool valid = row0 + r < length;
    cp_async16(dst + r * kPitch + c4,
               src + static_cast<size_t>(valid ? row0 + r : 0) * d_model + c4, valid);
  }
}

// max and sum over the 4 lanes t = 0..3 that share accumulator rows
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace rlt
