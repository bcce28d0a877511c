// attention_bf16: the bf16 forward of the head-packed K5' at dh = 16
// (attention_packed_fwd.cu: Choopy's and MtChoopy's 8 heads of (N, L, 128)
// arrays), and the bf16 helpers (Bf16Shape, pack_bf16x2, mma_bf16,
// ldmatrix_x4) that attention_bf16_bwd.cuh shares. The bf16 forwards at
// dh = 64 and 128 are attention_bf16_wgmma.cuh's.
//
// Replaces the bf16 form of rlt_tpu/ops/attention.py::_attn_fwd_packed_kernel
// (through _fwd_packed), whose `_mxu` keeps bf16 operands bf16: q, k and v
// enter the products in bf16, S accumulates in f32 (a product of two bf16
// values is exact in f32), the softmax statistics (max, exp, sum, lse) are
// f32, the weights are rounded to bf16 before P V, and o is written in
// bf16; lse is f32 in the f32 kernel's layout, (N, H / pack, L, pack). With
// a dropout rate above 0 the weights are dropped by the keep mask of
// keep_mask.cuh (the f32 kernels' streams, groups and columns) and the kept
// ones scaled by 1 / (1 - rate) before the rounding; lse stays the
// pre-dropout one.
//
// One rounding differs from the TPU kernel, by design. That kernel rounds
// the NORMALISED weights p = e / sum_j e_j; this one streams 64-key tiles and
// rounds e = exp(s - m) against the running max m, dividing O by the f32 sum
// at the end. Each weight is rounded once either way (relative error at most
// 2^-9), so o differs by rounding noise of the same size as the TPU
// kernel's own; tests/test_torch_bf16.py emulates this order in numpy at
// L = 300 and holds it to the JAX kernel within 2 bf16 ulps of max|o| (and
// lse, which no rounding of P touches, within 1e-5). Rounding what the TPU
// kernel rounds would take every score twice (a pass for the sums, then one
// for P V): the flash standard is kept.
//
// What bounds it on an H100: by the roofline the bytes, 2 an element of q,
// k, v and o; in fact the exp, max and sum of every score, the same work at
// any dh, which the tensor cores do not take (PERF.md §6 has its times
// against that bound).
//
// Design: K5''s in bf16. One block of 4 warps per (row n, head h, 64 query
// rows), each warp 16 of the rows; the Q tile and a two-stage cp.async ring
// of 64-key K and V tiles in shared memory as bf16, at a row pitch of
// dh + 8 = 24 elements (48 bytes), so the 8 rows an ldmatrix phase reads
// fall on 8 distinct 16-byte bank groups. The products are mma.sync
// m16n8k16 bf16 with f32 accumulators, one product per tile, their
// fragments loaded by ldmatrix (K^T and Q directly, V with .trans). A
// warp's S tile, 16 x 64 in 8 accumulator tiles, becomes P's A fragments
// without a shuffle: the accumulators of the two n8 tiles of keys
// 16 kk .. 16 kk + 15 are, packed to bf16x2, the k16 step's A fragment.
// The running O is rescaled by exp(m_old - m_new) before each tile's P V
// accumulates into it. The block's 15 KiB of shared memory does not grow
// with L, and any 1 <= L <= 65535 is taken.
//
// Fragment layouts of m16n8k16 (lane = 4 g + t), each register two bf16,
// the lower column (or k) in the lower half:
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)
//   B (16 x 8, k x n): b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g)
//   C (16 x 8, f32): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "keep_mask.cuh"

namespace rlt {

using bf16 = __nv_bfloat16;

template <int kDh>
struct Bf16Shape {
  static_assert(kDh % 16 == 0 && kDh <= 128, "dh a multiple of 16, at most 128");
  static constexpr int kPitch = kDh + 8;  // elements of a tile row
  static constexpr int kTileElems = kPackedTile * kPitch;
  static constexpr int kCols = kDh / 8;   // accumulator tiles of 8 columns across dh
  static constexpr size_t kSmem = sizeof(bf16) * (1 + 2 * 2) * kTileElems;
  // blocks per SM that __launch_bounds__ asks for: the O accumulator grows
  // with dh (8, 32 and 64 f32 a thread)
  static constexpr int kMinBlocks = kDh == 16 ? 4 : (kDh == 64 ? 3 : 2);
};

// {lo, hi} rounded to bf16 and packed, lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and receives in r[i] row l / 4, columns
// 2 (l % 4) .. + 1 of matrix i (with .trans: rows 2 (l % 4) .. + 1, column
// l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// Start copying rows [row0, row0 + 64) of one head's (L, kDh) columns of an
// (N, L, D) bf16 array (`src` at the head's row 0, rows d_model elements
// apart) into a tile of pitch kDh + 8, 16 bytes a copy, by the block's 128
// threads; rows at or past `length` become zeros.
template <int kDh>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, int row0,
                                               int length, int d_model) {
  constexpr int kPitch = Bf16Shape<kDh>::kPitch;
  constexpr int kChunks = kPackedTile * (kDh / 8);
  static_assert(kChunks % kPackedThreads == 0, "whole 16-byte copies per thread");
#pragma unroll
  for (int it = 0; it < kChunks / kPackedThreads; ++it) {
    const int i = threadIdx.x + it * kPackedThreads;
    const int r = i / (kDh / 8);
    const int c8 = (i % (kDh / 8)) * 8;
    const bool valid = row0 + r < length;
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * kPitch + c8));
    const bf16* g = src + static_cast<size_t>(valid ? row0 + r : 0) * d_model + c8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(g),
                 "r"(valid ? 16 : 0));
  }
}

// Dynamic shared memory: q_s[64][kPitch] | 2 stages x (k_t[64][kPitch] | v_t[64][kPitch])
template <int kDh, int kMinBlocks>
__global__ void __launch_bounds__(kPackedThreads, kMinBlocks)
attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, const int32_t* __restrict__ streams,
                     int length, int d_model, int pack, float scale, bool dropout,
                     uint32_t threshold, float inv_keep) {
  using Shape = Bf16Shape<kDh>;
  constexpr int kPitch = Shape::kPitch;
  constexpr int kTileElems = Shape::kTileElems;
  constexpr int kCols = Shape::kCols;
  constexpr int kStages = 2;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* ring = q_s + kTileElems;

  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int w16 = (threadIdx.x / 32) * 16;  // the warp's rows in the block's tile
  const int r0 = blockIdx.x * kPackedTile + w16;
  const size_t base = static_cast<size_t>(n) * length * d_model + head * kDh;
  const int tiles = (length + kPackedTile - 1) / kPackedTile;

  load_tile_bf16<kDh>(q_s, q + base, blockIdx.x * kPackedTile, length, d_model);
  load_tile_bf16<kDh>(ring, k + base, 0, length, d_model);
  load_tile_bf16<kDh>(ring + kTileElems, v + base, 0, length, d_model);
  cp_async_commit();

  // the head's keep mask: columns (head % pack) * L + j of its group's tile
  const uint32_t ncols = static_cast<uint32_t>(pack) * length;
  const uint32_t col0 = static_cast<uint32_t>(head % pack) * length;
  const uint32_t key = dropout ? stream_key(group_stream(streams[n], head / pack)) : 0u;

  // the lane's ldmatrix rows: A and V^T fragments read rows lane % 16 at
  // column block lane / 16; K^T fragments read keys 8 (lane / 16) + lane % 8
  // at column block (lane / 8) % 2
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 8;
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 8;

  // rows g and g + 8 of the warp: running max, this thread's share of the
  // running sum, and the output accumulator (dh / 8 tiles of 8 columns)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float acc[kCols][4] = {};

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      bf16* next = ring + ((it + 1) % kStages) * 2 * kTileElems;
      load_tile_bf16<kDh>(next, k + base, (it + 1) * kPackedTile, length, d_model);
      load_tile_bf16<kDh>(next + kTileElems, v + base, (it + 1) * kPackedTile, length,
                          d_model);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_t = ring + (it % kStages) * 2 * kTileElems;
    const bf16* v_t = k_t + kTileElems;
    const int t0 = it * kPackedTile;

    // S = Q K^T: 8 key tiles of 8, dh / 16 k-steps
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (w16 + a_row) * kPitch + 16 * kk + a_col);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];  // b0, b1 of key tile 2 jp, then of 2 jp + 1
        ldmatrix_x4(b, k_t + (16 * jp + k_row) * kPitch + 16 * kk + k_col);
        mma_bf16(s[2 * jp], a[0], a[1], a[2], a[3], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
      }
    }

    // running max (keys past L are -inf; key t0 < L, so m_new is finite)
    float m_new[2] = {m[0], m[1]}, corr[2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t0 + 8 * j + 2 * t + (e & 1);
        s[j][e] = col < length ? s[j][e] * scale : -INFINITY;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = quad_max(m_new[r]);
      corr[r] = expf(m[r] - m_new[r]);  // 0 on the first tile
      l[r] *= corr[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    }
    // the tile's weights, summed in f32 before dropout and rounding
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float w = expf(s[j][e] - m[r]);  // 0 past L
        l[r] += w;
        if (dropout) {
          const int col = t0 + 8 * j + 2 * t + (e & 1);
          const uint32_t index =
              static_cast<uint32_t>(r0 + g + 8 * r) * ncols + col0 + col;
          s[j][e] = keep_element(index, key, threshold) ? w * inv_keep : 0.0f;
        } else {
          s[j][e] = w;
        }
      }
    }

    // O += P V: the weights of keys 16 kk .. 16 kk + 15 as A, rounded to
    // bf16; V's fragments through ldmatrix.trans, two column tiles a load
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < kCols / 2; ++jp) {
        uint32_t b[4];  // b0, b1 of column tile 2 jp, then of 2 jp + 1
        ldmatrix_x4_trans(b, v_t + (16 * kk + a_row) * kPitch + 16 * jp + a_col);
        mma_bf16(acc[2 * jp], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
    __syncthreads();  // the stage is consumed before the next copy into it
  }

  const int groups = gridDim.y / pack;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = r0 + g + 8 * r;
    if (row < length) {
      const float inv = 1.0f / sum;
      bf16* out = o + base + static_cast<size_t>(row) * d_model + 2 * t;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16x2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      if (t == 0) {
        const size_t li =
            ((static_cast<size_t>(n) * groups + head / pack) * length + row) * pack +
            head % pack;
        lse[li] = m[r] + logf(sum);
      }
    }
  }
}

// Launch the kernel over n rows of `heads` heads of width kDh (d_model =
// heads * kDh); returns cudaGetLastError().
template <int kDh>
int launch_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                         void* lse, const void* streams, int n, int length, int heads,
                         int pack, float rate, uint32_t threshold, cudaStream_t stream) {
  using Shape = Bf16Shape<kDh>;
  constexpr int kMinBlocks = Shape::kMinBlocks;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_bf16_kernel<kDh, kMinBlocks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Shape::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((length + kPackedTile - 1) / kPackedTile, heads, n);
  attn_fwd_bf16_kernel<kDh, kMinBlocks><<<grid, kPackedThreads, Shape::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<const int32_t*>(streams), length, heads * kDh, pack,
      1.0f / sqrtf(static_cast<float>(kDh)), rate > 0.0f, threshold,
      1.0f / (1.0f - rate));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rlt
