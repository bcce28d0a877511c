// K3' attention_fwd: per-slice self-attention forward, dh = 128, float32
// (this file's kernel) and bf16 (attention_bf16_wgmma.cuh's at dh = 128,
// behind rlt_attention_fwd_bf16: a slice is one head of D = 128 in a group
// of 1).
//
// Replaces rlt_tpu/ops/attention.py::_attn_fwd_kernel (run through
// _fwd_pallas, fused_attention and multi_head_attention). q, k, v are
// (N, L, 128): the (B, H, L, dh) layout of the JAX package with its N = B * H
// (batch, head) slices flattened. Per slice: o = softmax(q k^T / sqrt(128)) v,
// and lse = log sum_j exp(s_j) per query row, stored as (N, 1, L). With a
// dropout rate above 0 the softmax weights are dropped by the keep mask of
// keep_mask.cuh over the slice's (L, L) score tile (element (i, j) at index
// i * L + j, the slice's own stream, no head group) and the kept ones scaled
// by 1 / (1 - rate); lse stays the pre-dropout one.
//
// What bounds it on an H100: at PLECut's shapes (N = 2 * 3 * batch slices,
// L = 300) the arithmetic is 4 N L^2 dh flops against 4 N L dh floats of
// traffic, so operations bound it. The products run on the tensor cores as
// mma.sync m16n8k8 tf32 in the 3xTF32 split of attention_mma.cuh (three tf32
// products per f32 product), which keeps the 1e-5 agreement with the plain
// f32 version that one tf32 product would miss.
//
// Design: K5''s (attention_packed_fwd.cu) with dh doubled, which its
// registers do not take whole: a warp holding 16 rows of all 128 output
// columns would need the O accumulator, a 64-key score tile and the fresh
// P V accumulator, 160 floats a thread against K5''s 96. So one block of 8
// warps per (slice, 64 query rows): 4 pairs of warps, each pair 16 rows, and
// warp w of a pair (w = 0, 1) owns the dh columns [64 w, 64 w + 64). The
// block's Q tile sits in shared memory, and K and V stream through a
// two-stage ring of 64-key tiles, all with row pitch 132 and filled by
// cp.async, so the next tile's copy runs under this tile's products. Per
// tile each warp takes its 64-deep part of S = Q K^T (over its half of dh)
// in a fresh accumulator; the pair trades the two parts through shared
// memory and adds them with an f32 add, in the same order on both sides, so
// both warps hold the same S. Both then keep the rows' running max and sum
// (each warp redundantly, as the pair's rows are the same), turn S into the
// weights exp(s - m), dropped and scaled where the mask says after the sum
// is taken, and feed them as A fragments straight from the accumulator to
// P V over the warp's own 64 columns of V, in a fresh accumulator added to
// the rescaled running O. Per warp and tile that is K5''s work (384
// mma.sync) and 16 + 16 float2 exchanges. At the end o = O / sum and lse =
// m + log(sum). The block's 201 KiB of shared memory (Q, two stages of K and
// V, the exchange) do not grow with L, one block of 8 warps fills an SM, and
// any 1 <= L <= 65535 is taken (the keep mask's index i * L + j is 32-bit).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16_wgmma.cuh"
#include "attention_mma.cuh"
#include "keep_mask.cuh"

namespace {

using rlt::kSliceDh;
using rlt::kSlicePitch;
using rlt::kSliceThreads;
using rlt::kSliceTileFloats;
using rlt::kSliceWarps;
using rlt::Split;

constexpr int kTile = rlt::kPackedTile;  // query rows of a block, keys of a streamed tile
constexpr int kHalf = kSliceDh / 2;      // the dh columns of one warp of a pair
constexpr int kStages = 2;
constexpr int kXPitch = kTile + 8;       // a row of a warp's exchange buffer
constexpr int kXFloats = 16 * kXPitch;
constexpr size_t kSmem =
    sizeof(float) * ((1 + 2 * kStages) * kSliceTileFloats + kSliceWarps * kXFloats);

// Start copying rows [row0, row0 + 64) of a slice's (L, 128) array into a
// tile of pitch 132, by the whole block.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0,
                                          int length) {
  rlt::load_tile_async<kSliceDh, kSliceThreads>(dst, src, row0, length, kSliceDh);
}

// Dynamic shared memory: q_s[64][132] | kStages x (k_t[64][132] | v_t[64][132]) |
// x_s[8 warps][16][72]
__global__ void __launch_bounds__(kSliceThreads, 1)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, const int32_t* __restrict__ streams,
                int length, float scale, const rlt::Dropout drop) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* ring = q_s + kSliceTileFloats;
  float* x_s = ring + kStages * 2 * kSliceTileFloats;

  const int slice = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pair = warp % 4;
  const int w16 = pair * 16;          // the pair's rows in the block's tile
  const int c0 = (warp / 4) * kHalf;  // the warp's half of dh
  const int r0 = blockIdx.x * kTile + w16;
  const size_t base = static_cast<size_t>(slice) * length * kSliceDh;
  const int tiles = (length + kTile - 1) / kTile;
  float* x_own = x_s + warp * kXFloats;
  const float* x_mate = x_s + (warp ^ 4) * kXFloats;

  load_rows(q_s, q + base, blockIdx.x * kTile, length);
  load_rows(ring, k + base, 0, length);
  load_rows(ring + kSliceTileFloats, v + base, 0, length);
  rlt::cp_async_commit();

  const bool dropout = drop.on();
  const uint32_t key =
      dropout ? rlt::stream_key(static_cast<uint32_t>(streams[slice])) : 0u;
  const uint32_t limit = drop.limit(slice);
  const float inv_keep = drop.scale_of(slice);

  // rows g and g + 8 of the pair: running max, this thread's share of the
  // running sum, and the warp's output accumulator (8 tiles of 8 columns)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float acc[8][4] = {};

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      float* next = ring + ((it + 1) % kStages) * 2 * kSliceTileFloats;
      load_rows(next, k + base, (it + 1) * kTile, length);
      load_rows(next + kSliceTileFloats, v + base, (it + 1) * kTile, length);
      rlt::cp_async_commit();
      rlt::cp_async_wait<1>();
    } else {
      rlt::cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_t = ring + (it % kStages) * 2 * kSliceTileFloats;
    const float* v_t = k_t + kSliceTileFloats;
    const int t0 = it * kTile;

    // the warp's 64-deep part of S = Q K^T, over its half of dh
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      Split qa[4];
      rlt::split_a_tile<kSlicePitch>(qa, q_s, w16, c0 / 8 + kk, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rlt::mma3_b_rows<kSlicePitch>(s[j], qa, k_t, 8 * j, c0 + 8 * kk, g, t);
    }
    // plus the mate's part: the same sum, bit for bit, in both warps
    rlt::store_acc<8, kXPitch>(x_own, s, g, t);
    rlt::pair_sync(pair);
    {
      float mate[8][4];
      rlt::load_acc<8, kXPitch>(mate, x_mate, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += mate[j][e];
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
      m_new[r] = rlt::quad_max(m_new[r]);
      corr[r] = expf(m[r] - m_new[r]);  // 0 on the first tile
      l[r] *= corr[r];
      m[r] = m_new[r];
    }
    // the tile's weights, summed before dropout
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
              static_cast<uint32_t>(r0 + g + 8 * r) * static_cast<uint32_t>(length) + col;
          s[j][e] = rlt::keep_element(index, key, limit) ? w * inv_keep : 0.0f;
        } else {
          s[j][e] = w;
        }
      }
    }

    // O = O corr + P V over the warp's columns: the weights of keys 8 kk..
    // as A, V's rows in the relabelled order, the tile's product in a fresh
    // accumulator
    float pv[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      Split pa[4];
      rlt::split_acc(s[kk], pa);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rlt::mma3_b_perm<kSlicePitch>(pv[j], pa, v_t, 8 * kk, c0 + 8 * j, g, t);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], corr[e >> 1], pv[j][e]);
    }
    // the stage and the exchange buffers are consumed before they are
    // written again
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = rlt::quad_sum(l[r]);
    const int row = r0 + g + 8 * r;
    if (row < length) {
      const float inv = 1.0f / sum;
      float* out = o + base + static_cast<size_t>(row) * kSliceDh + c0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      if (c0 == 0 && t == 0)
        lse[static_cast<size_t>(slice) * length + row] = m[r] + logf(sum);
    }
  }
}

}  // namespace

// q, k, v, o (N, L, 128) and lse (N, 1, L): contiguous float32 device arrays,
// q/k/v/o 16-byte aligned. With rate > 0, `streams` holds N int32 dropout
// streams (one per slice) and `threshold` the keep threshold of
// keep_mask.cuh; with rate == 0 neither is read. With `thresholds` and
// `scales` (N uint32 and N float32 in keep_mask.cuh's per-row encoding)
// slice n drops at its own rate, `streams` is read, and `rate` and
// `threshold` are not. Takes 1 <= L <= 65535. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int rlt_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, const void* streams,
                                 const void* thresholds, const void* scales, int n,
                                 int length, float rate, unsigned int threshold,
                                 void* stream) {
  rlt::Dropout drop;
  if (n < 1 || length < 1 || n > 65535 || length > 65535 ||
      !rlt::make_dropout(drop, rate, threshold, streams, thresholds, scales))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((length + kTile - 1) / kTile, n);
  attn_fwd_kernel<<<grid, kSliceThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const int32_t*>(streams), length,
      1.0f / sqrtf(static_cast<float>(kSliceDh)), drop);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 instance: q, k, v, o (N, L, 128) bf16 and lse (N, 1, L) float32,
// the rest as rlt_attention_fwd. Each slice runs as one head of width 128
// in a group of pack 1, so its keep-mask index is i * L + j on its own
// stream, as above. Launches on `stream` and returns cudaGetLastError().
extern "C" int rlt_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                      void* o, void* lse, const void* streams,
                                      const void* thresholds, const void* scales, int n,
                                      int length, float rate, unsigned int threshold,
                                      void* stream) {
  rlt::Dropout drop;
  if (n < 1 || length < 1 || n > 65535 || length > 65535 ||
      !rlt::make_dropout(drop, rate, threshold, streams, thresholds, scales))
    return static_cast<int>(cudaErrorInvalidValue);
  return rlt::launch_attn_fwd_wgmma<kSliceDh>(q, k, v, o, lse, streams, n, length, 1, 1,
                                              drop, static_cast<cudaStream_t>(stream));
}
