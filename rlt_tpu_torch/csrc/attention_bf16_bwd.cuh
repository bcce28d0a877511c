// attention_bf16_bwd: the bf16 backward of the head-packed attention at
// dh = 16 (K6' in attention_packed_bwd.cu: Choopy's and MtChoopy's 8 heads
// of (N, L, D) arrays), as attention_bf16.cuh is for its forward. (dh = 64
// and 128 run attention_bf16_bwd_wgmma.cuh's TMA and wgmma kernels; its
// 64-column swizzled tiles do not take dh = 16.)
//
// Replaces the bf16 form of rlt_tpu/ops/attention.py::_attn_bwd_packed_kernel
// (through _bwd_packed), whose `_mxu` keeps bf16 operands bf16. q, k, v, o
// and the incoming gradient do arrive in bf16, lse in f32 (K5''s layout).
// Per head, recomputing the probabilities from lse:
//   s = q k^T (f32 sums of exact bf16 products),  p = exp(s scale - lse)  f32
//   dP = do v^T  f32;  with dropout pd = keep ? p / (1 - rate) : 0 and
//                       dp = keep ? dP / (1 - rate) : 0, both f32
//   delta = rowsum(f32(do) f32(o))  f32
//   ds = bf16(p (dp - delta) scale),  pd rounded to bf16
//   dq = ds k,  dk = ds^T q,  dv = pd^T do  (f32 sums, stored as bf16)
// The keep mask is the forward's (keep_mask.cuh), regenerated from the same
// streams. Unlike the bf16 forward, this rounds exactly what the TPU kernel
// rounds: p comes from the normalised lse, so ds and pd are final before any
// product takes them, and only the order of the f32 sums differs. (The
// packed TPU kernel also rounds dk_full * mask before its fold product; that
// value is already one head's bf16 product sum, so the extra rounding is
// idempotent and per-head products compute the same function.)
//
// What bounds it on an H100: by the roofline the bytes, 2 an element of
// q, k, v, o, do, dq, dk and dv; in fact the exp, the mask hash and ds of
// every score, taken once in each pass, which weigh four times as much
// against the products at dh = 16 as at dh = 64.
//
// Design: two passes with the forward template's tiles and fragments.
// Blocks of 4 warps, each warp 16 of the block's 64 rows; the block's own
// rows of two operands sit in shared memory as bf16 at a row pitch of dh + 8
// elements (ldmatrix phases on distinct bank groups), while the other
// operands stream through a two-stage cp.async ring of 64-row tiles. The
// products are mma.sync m16n8k16 bf16 with f32 accumulators; an operand read
// along its rows loads by ldmatrix, one read across them by ldmatrix.trans;
// ds and pd, rounded and packed to bf16x2 straight from the S and dP
// accumulators, are the A fragments of the gradient products (the forward's
// trick for P).
//  1. dq kernel: one block per (n, head, 64 query rows) holds Q and dO,
//     takes delta of its rows (from o and do in device memory) and writes it
//     for the second pass, then streams K and V tiles: S = Q K^T and
//     dP = dO V^T, ds in registers, dQ += ds K.
//  2. dkv kernel: one block per (n, head, 64 key rows) holds K and V and
//     streams tiles of Q and dO with their lse and delta, in halves of 32
//     queries: S^T = K Q^T and dP^T = V dO^T, ds^T and pd^T in registers,
//     dV += pd^T dO and dK += ds^T Q.
// Every output element is summed by one thread in a fixed order, so two
// launches on the same inputs give the same bits. Shared memory (19 KiB a
// kernel) does not grow with L; any 1 <= L <= 65535 is taken.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16.cuh"
#include "attention_mma.cuh"
#include "keep_mask.cuh"

namespace rlt {

// Shared-memory layout of both kernels at head width kDh
template <int kDh>
struct Bf16BwdLayout {
  static constexpr int kTileElems = Bf16Shape<kDh>::kTileElems;
  // dq: q_s | do_s | 2 stages x (k_t | v_t), bf16; then delta_s[64] f32
  static constexpr size_t kDqSmem =
      sizeof(bf16) * 6 * kTileElems + sizeof(float) * kPackedTile;
  // dkv: k_s | v_s | 2 stages x (q_t | do_t), bf16; then 2 stages x
  // (lse_t[64] | delta_t[64]) f32
  static constexpr size_t kDkvSmem =
      sizeof(bf16) * 6 * kTileElems + sizeof(float) * 2 * 2 * kPackedTile;
  static_assert(sizeof(bf16) * kTileElems % 16 == 0, "tiles stay 16-byte aligned");
};

// the bf16 pair in the lower and upper halves of u, as floats
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// the lse of head `head`'s row 0 in the (N, heads / pack, L, pack) layout;
// row i is i * pack further
__device__ __forceinline__ const float* bwd_head_lse(const float* lse, int n, int head,
                                                     int heads, int pack, int length) {
  return lse + (static_cast<size_t>(n) * (heads / pack) + head / pack) * length * pack +
         head % pack;
}

// Dynamic shared memory: q_s[64][kPitch] | do_s[64][kPitch] |
// 2 x (k_t[64][kPitch] | v_t[64][kPitch]) | delta_s[64]
template <int kDh, int kMinBlocks>
__global__ void __launch_bounds__(kPackedThreads, kMinBlocks)
attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const int32_t* __restrict__ streams, bf16* __restrict__ dq,
                        float* __restrict__ delta, int length, int heads, int pack,
                        float scale, bool dropout, uint32_t threshold, float inv_keep) {
  using Shape = Bf16Shape<kDh>;
  constexpr int kPitch = Shape::kPitch;
  constexpr int kTileElems = Shape::kTileElems;
  constexpr int kCols = Shape::kCols;
  constexpr int kStages = 2;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* do_s = q_s + kTileElems;
  bf16* ring = do_s + kTileElems;
  float* delta_s = reinterpret_cast<float*>(ring + kStages * 2 * kTileElems);

  const int d_model = heads * kDh;
  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int w16 = (threadIdx.x / 32) * 16;  // the warp's rows in the block's tile
  const int q0 = blockIdx.x * kPackedTile;
  const int r0 = q0 + w16;
  const size_t base = static_cast<size_t>(n) * length * d_model + head * kDh;
  const int tiles = (length + kPackedTile - 1) / kPackedTile;

  load_tile_bf16<kDh>(q_s, q + base, q0, length, d_model);
  load_tile_bf16<kDh>(do_s, dout + base, q0, length, d_model);
  load_tile_bf16<kDh>(ring, k + base, 0, length, d_model);
  load_tile_bf16<kDh>(ring + kTileElems, v + base, 0, length, d_model);
  cp_async_commit();

  // delta of the block's rows from o and do in device memory: two threads
  // per row, dh / 2 columns each (products of bf16 values, exact in f32)
  {
    const int i = threadIdx.x / 2;
    const int c0 = (threadIdx.x % 2) * (kDh / 2);
    const bool valid = q0 + i < length;
    float part = 0.0f;
    if (valid) {
      const size_t off = base + static_cast<size_t>(q0 + i) * d_model + c0;
      const uint4* orow = reinterpret_cast<const uint4*>(o + off);
      const uint4* grow = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int c = 0; c < kDh / 16; ++c) {
        const uint4 a = orow[c];
        const uint4 b = grow[c];
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
        const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part = fmaf(bf16_lo(aw[e]), bf16_lo(bw[e]), part);
          part = fmaf(bf16_hi(aw[e]), bf16_hi(bw[e]), part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (threadIdx.x % 2 == 0) {
      delta_s[i] = part;
      if (valid) delta[(static_cast<size_t>(n) * heads + head) * length + q0 + i] = part;
    }
  }
  __syncthreads();
  float delta_r[2], lse_r[2];
  {
    const float* lse_h = bwd_head_lse(lse, n, head, heads, pack, length);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      delta_r[r] = delta_s[w16 + g + 8 * r];
      lse_r[r] = row < length ? lse_h[static_cast<size_t>(row) * pack] : 0.0f;
    }
  }

  const uint32_t ncols = static_cast<uint32_t>(pack) * length;
  const uint32_t col0 = static_cast<uint32_t>(head % pack) * length;
  const uint32_t key = dropout ? stream_key(group_stream(streams[n], head / pack)) : 0u;
  // the lane's ldmatrix rows, as in the forward: A and trans-B fragments read
  // rows lane % 16 at column block lane / 16; row-major B fragments read rows
  // 8 (lane / 16) + lane % 8 at column block (lane / 8) % 2
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 8;
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 8;
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

    // S = Q K^T and dP = dO V^T: 8 key tiles of 8, dh / 16 k-steps
    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t qa[4], ga[4];
      ldmatrix_x4(qa, q_s + (w16 + a_row) * kPitch + 16 * kk + a_col);
      ldmatrix_x4(ga, do_s + (w16 + a_row) * kPitch + 16 * kk + a_col);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];  // b0, b1 of key tile 2 jp, then of 2 jp + 1
        ldmatrix_x4(b, k_t + (16 * jp + k_row) * kPitch + 16 * kk + k_col);
        mma_bf16(s[2 * jp], qa[0], qa[1], qa[2], qa[3], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa[0], qa[1], qa[2], qa[3], b[2], b[3]);
        ldmatrix_x4(b, v_t + (16 * jp + k_row) * kPitch + 16 * kk + k_col);
        mma_bf16(dp[2 * jp], ga[0], ga[1], ga[2], ga[3], b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], ga[0], ga[1], ga[2], ga[3], b[2], b[3]);
      }
    }
    // ds, in place of s (keys past L have p = 0)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = t0 + 8 * j + 2 * t + (e & 1);
        const float p = col < length ? expf(s[j][e] * scale - lse_r[r]) : 0.0f;
        float gg = dp[j][e];
        if (dropout) {
          const uint32_t index = static_cast<uint32_t>(r0 + g + 8 * r) * ncols + col0 + col;
          gg = keep_element(index, key, threshold) ? gg * inv_keep : 0.0f;
        }
        s[j][e] = p * (gg - delta_r[r]) * scale;
      }
    }
    // dQ += ds K: ds of keys 16 kk .. 16 kk + 15 as A, rounded to bf16; K's
    // fragments through ldmatrix.trans, two column tiles a load
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < kCols / 2; ++jp) {
        uint32_t b[4];  // b0, b1 of column tile 2 jp, then of 2 jp + 1
        ldmatrix_x4_trans(b, k_t + (16 * kk + a_row) * kPitch + 16 * jp + a_col);
        mma_bf16(acc[2 * jp], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
    __syncthreads();  // the stage is consumed before the next copy into it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < length) {
      bf16* out = dq + base + static_cast<size_t>(row) * d_model + 2 * t;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16x2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// Dynamic shared memory: k_s[64][kPitch] | v_s[64][kPitch] |
// 2 x (q_t[64][kPitch] | do_t[64][kPitch]) | 2 x (lse_t[64] | delta_t[64])
template <int kDh, int kMinBlocks>
__global__ void __launch_bounds__(kPackedThreads, kMinBlocks)
attn_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int32_t* __restrict__ streams, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int length, int heads, int pack,
                         float scale, bool dropout, uint32_t threshold, float inv_keep) {
  static_assert(kPackedThreads == 2 * kPackedTile, "one thread per lse and delta float");
  using Shape = Bf16Shape<kDh>;
  constexpr int kPitch = Shape::kPitch;
  constexpr int kTileElems = Shape::kTileElems;
  constexpr int kCols = Shape::kCols;
  constexpr int kStages = 2;
  constexpr int kHalf = kPackedTile / 2;  // queries of a tile taken at once
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);
  bf16* v_s = k_s + kTileElems;
  bf16* ring = v_s + kTileElems;
  float* stats = reinterpret_cast<float*>(ring + kStages * 2 * kTileElems);

  const int d_model = heads * kDh;
  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int w16 = (threadIdx.x / 32) * 16;
  const int k0 = blockIdx.x * kPackedTile + w16;  // the warp's first key row
  const size_t base = static_cast<size_t>(n) * length * d_model + head * kDh;
  const int tiles = (length + kPackedTile - 1) / kPackedTile;
  const float* lse_h = bwd_head_lse(lse, n, head, heads, pack, length);
  const float* delta_h = delta + (static_cast<size_t>(n) * heads + head) * length;

  // query rows [row0, row0 + 64) of Q, dO, lse and delta into stage `st`;
  // rows at or past `length` become zeros
  const auto load_stage = [&](int st, int row0) {
    bf16* tile = ring + st * 2 * kTileElems;
    load_tile_bf16<kDh>(tile, q + base, row0, length, d_model);
    load_tile_bf16<kDh>(tile + kTileElems, dout + base, row0, length, d_model);
    float* stat = stats + st * 2 * kPackedTile;
    const int i = threadIdx.x % kPackedTile;
    const int row = row0 + i;
    const bool valid = row < length;
    if (threadIdx.x < kPackedTile)
      cp_async4(stat + i, lse_h + static_cast<size_t>(valid ? row : 0) * pack, valid);
    else
      cp_async4(stat + kPackedTile + i, delta_h + (valid ? row : 0), valid);
  };
  load_tile_bf16<kDh>(k_s, k + base, blockIdx.x * kPackedTile, length, d_model);
  load_tile_bf16<kDh>(v_s, v + base, blockIdx.x * kPackedTile, length, d_model);
  load_stage(0, 0);
  cp_async_commit();

  const uint32_t ncols = static_cast<uint32_t>(pack) * length;
  const uint32_t col0 = static_cast<uint32_t>(head % pack) * length;
  const uint32_t key = dropout ? stream_key(group_stream(streams[n], head / pack)) : 0u;
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 8;
  const int k_row = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 8;
  float dk_acc[kCols][4] = {}, dv_acc[kCols][4] = {};

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      load_stage((it + 1) % kStages, (it + 1) * kPackedTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* q_t = ring + (it % kStages) * 2 * kTileElems;
    const bf16* do_t = q_t + kTileElems;
    const float* lse_t = stats + (it % kStages) * 2 * kPackedTile;
    const float* delta_t = lse_t + kPackedTile;

#pragma unroll
    for (int h0 = 0; h0 < kPackedTile; h0 += kHalf) {
      // S^T = K Q^T and dP^T = V dO^T over queries h0 .. h0 + 31 of the tile
      float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, k_s + (w16 + a_row) * kPitch + 16 * kk + a_col);
        ldmatrix_x4(va, v_s + (w16 + a_row) * kPitch + 16 * kk + a_col);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];  // b0, b1 of query tile 2 jp, then of 2 jp + 1
          ldmatrix_x4(b, q_t + (h0 + 16 * jp + k_row) * kPitch + 16 * kk + k_col);
          mma_bf16(st[2 * jp], ka[0], ka[1], ka[2], ka[3], b[0], b[1]);
          mma_bf16(st[2 * jp + 1], ka[0], ka[1], ka[2], ka[3], b[2], b[3]);
          ldmatrix_x4(b, do_t + (h0 + 16 * jp + k_row) * kPitch + 16 * kk + k_col);
          mma_bf16(dpt[2 * jp], va[0], va[1], va[2], va[3], b[0], b[1]);
          mma_bf16(dpt[2 * jp + 1], va[0], va[1], va[2], va[3], b[2], b[3]);
        }
      }
      // ds^T in place of st, pd^T in place of dpt (queries past L have p = 0)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = h0 + 8 * j + 2 * t + (e & 1);
          const int row = it * kPackedTile + qi;
          const float p = row < length ? expf(st[j][e] * scale - lse_t[qi]) : 0.0f;
          float pd = p;
          float gg = dpt[j][e];
          if (dropout) {
            const uint32_t index = static_cast<uint32_t>(row) * ncols + col0 +
                                   static_cast<uint32_t>(k0 + g + 8 * (e >> 1));
            const bool keep = keep_element(index, key, threshold);
            pd = keep ? p * inv_keep : 0.0f;
            gg = keep ? gg * inv_keep : 0.0f;
          }
          st[j][e] = p * (gg - delta_t[qi]) * scale;
          dpt[j][e] = pd;
        }
      }
      // dV += pd^T dO and dK += ds^T Q over those queries: pd^T and ds^T of
      // queries 16 kk .. 16 kk + 15 as A, rounded to bf16; dO's and Q's
      // fragments through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa0 = pack_bf16x2(dpt[2 * kk][0], dpt[2 * kk][1]);
        const uint32_t pa1 = pack_bf16x2(dpt[2 * kk][2], dpt[2 * kk][3]);
        const uint32_t pa2 = pack_bf16x2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        const uint32_t pa3 = pack_bf16x2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
        const uint32_t da0 = pack_bf16x2(st[2 * kk][0], st[2 * kk][1]);
        const uint32_t da1 = pack_bf16x2(st[2 * kk][2], st[2 * kk][3]);
        const uint32_t da2 = pack_bf16x2(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        const uint32_t da3 = pack_bf16x2(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        const int qrow = h0 + 16 * kk + a_row;
#pragma unroll
        for (int jp = 0; jp < kCols / 2; ++jp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, do_t + qrow * kPitch + 16 * jp + a_col);
          mma_bf16(dv_acc[2 * jp], pa0, pa1, pa2, pa3, b[0], b[1]);
          mma_bf16(dv_acc[2 * jp + 1], pa0, pa1, pa2, pa3, b[2], b[3]);
          ldmatrix_x4_trans(b, q_t + qrow * kPitch + 16 * jp + a_col);
          mma_bf16(dk_acc[2 * jp], da0, da1, da2, da3, b[0], b[1]);
          mma_bf16(dk_acc[2 * jp + 1], da0, da1, da2, da3, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next copy into it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + g + 8 * r;
    if (row < length) {
      const size_t out = base + static_cast<size_t>(row) * d_model + 2 * t;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        *reinterpret_cast<uint32_t*>(dk + out + 8 * j) =
            pack_bf16x2(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + out + 8 * j) =
            pack_bf16x2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      }
    }
  }
}

// Launch both kernels over n rows of `heads` heads of width kDh (d_model =
// heads * kDh), `delta` an (n, heads, L) f32 scratch array; returns the
// first error.
template <int kDh>
int launch_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const void* lse, const void* streams,
                         void* dq, void* dk, void* dv, void* delta, int n, int length,
                         int heads, int pack, float rate, uint32_t threshold,
                         cudaStream_t stream) {
  constexpr int kMinBlocks = Bf16Shape<kDh>::kMinBlocks;
  using Layout = Bf16BwdLayout<kDh>;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_bf16_kernel<kDh, kMinBlocks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Layout::kDqSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_dkv_bf16_kernel<kDh, kMinBlocks>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Layout::kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  const bool dropout = rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const dim3 grid((length + kPackedTile - 1) / kPackedTile, heads, n);
  attn_bwd_dq_bf16_kernel<kDh, kMinBlocks><<<grid, kPackedThreads, Layout::kDqSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const int32_t*>(streams), static_cast<bf16*>(dq),
      static_cast<float*>(delta), length, heads, pack, scale, dropout, threshold,
      inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkv_bf16_kernel<kDh, kMinBlocks><<<grid, kPackedThreads, Layout::kDkvSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(streams), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), length, heads, pack, scale, dropout, threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rlt
