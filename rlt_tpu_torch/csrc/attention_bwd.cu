// K4' attention_bwd: per-slice self-attention backward, dh = 128, float32
// (this file's kernels) and bf16 (attention_bf16_bwd_wgmma.cuh's TMA and
// wgmma kernels at dh = 128, behind rlt_attention_bwd_bf16: a slice is one
// head of D = 128 in a group of 1).
//
// Replaces rlt_tpu/ops/attention.py::_attn_bwd_kernel (run through
// _bwd_pallas and the custom_vjp of fused_attention). q, k, v, o and the
// incoming gradient do are (N, L, 128), the JAX package's (B, H, L, dh) with
// its N = B * H slices flattened; lse is K3''s (N, 1, L). Per slice,
// flash-style, recomputing the probabilities instead of storing them:
//   p = exp(s * scale - lse)          s = q k^T, the pre-dropout softmax
//   dp = do v^T, and with dropout pd = keep ? p / (1 - rate) : 0,
//                                 dp = keep ? dp / (1 - rate) : 0
//   delta = rowsum(do * o) over the slice's 128 columns
//   ds = p (dp - delta) scale
//   dq = ds k,  dk = ds^T q,  dv = pd^T do
// The keep mask is K3''s (keep_mask.cuh over the slice's (L, L) tile),
// regenerated from the same streams.
//
// What bounds it on an H100: operations, 7 L x L x 128 products per slice
// in this two-pass design (s and dp in both passes, then dq, dk and dv)
// against 8 N L dh floats of traffic. They run on the tensor cores as
// mma.sync m16n8k8 tf32 in the 3xTF32 split of attention_mma.cuh, which
// keeps the 1e-5 agreement with the plain f32 version.
//
// Design: K6''s (attention_packed_bwd.cu) with dh doubled, deterministic and
// without atomics. K6''s warps hold 64 (dq) and 128 (dk/dv) accumulator
// floats at 211 and 234 registers; at dh = 128 those would double. So each
// kernel runs blocks of 8 warps, 4 pairs of 16 rows, and warp w of a pair
// (w = 0, 1) owns the gradient columns [64 w, 64 w + 64): the same
// accumulators as K6'. Of the two score-sized products the pair needs (S
// and dP, or their transposes), warp 0 takes the first and warp 1 the
// second, each 128 deep as two 64-deep parts in fresh accumulators joined by
// an f32 add; the pair trades them through shared memory, so both warps
// hold the same S and dP and build the same ds (and pd) in registers. The
// block's own rows of two operands sit in shared memory while the other
// operands stream through a two-stage ring of 64-row tiles, all with row
// pitch 132 and filled by cp.async, so the next tile's copy runs under this
// tile's products. A streamed tile is worked in halves of 32 rows, and each
// tile's (or half's) product is added to the running gradient from a fresh
// accumulator (attention_mma.cuh).
//  1. dq_kernel: one block per (slice, 64 query rows) holds Q and dO, takes
//     delta = rowsum(do * o) of its rows and writes it for the second pass,
//     then streams K and V tiles: S = Q K^T and dP = dO V^T, ds in
//     registers, dQ += ds K (ds fed from the accumulator as A).
//  2. dkv_kernel: one block per (slice, 64 key rows) holds K and V and
//     streams tiles of Q and dO with their lse and delta: S^T = K Q^T and
//     dP^T = V dO^T, then ds^T and pd^T in registers, dV += pd^T dO and
//     dK += ds^T Q.
// Every output element is summed by one thread in a fixed order, so two
// launches on the same inputs give the same bits. Shared memory (218 and
// 219 KiB, one block of 8 warps per SM) does not grow with L; any
// 1 <= L <= 65535 is taken.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16_bwd_wgmma.cuh"
#include "attention_mma.cuh"
#include "keep_mask.cuh"

namespace {

using rlt::add_part;
using rlt::kSliceDh;
using rlt::kSlicePitch;
using rlt::kSliceThreads;
using rlt::kSliceTileFloats;
using rlt::kSliceWarps;
using rlt::Split;

constexpr int kTile = rlt::kPackedTile;  // rows of a block, rows of a streamed tile
constexpr int kHalf = kSliceDh / 2;      // the gradient columns of one warp of a pair
constexpr int kStages = 2;
constexpr int kHalfRows = kTile / 2;     // rows of a streamed tile taken at once
constexpr int kXPitch = kHalfRows + 8;   // a row of a warp's exchange buffer
constexpr int kXFloats = 16 * kXPitch;
// dq_kernel: q_s | do_s | delta_s[64], then kStages x (k_t | v_t), then x_s
constexpr int kDqHeld = 2 * kSliceTileFloats + kTile;
constexpr size_t kDqSmem = sizeof(float) * (kDqHeld + kStages * 2 * kSliceTileFloats +
                                            kSliceWarps * kXFloats);
// dkv_kernel: k_s | v_s, then kStages x (q_t | do_t | lse_t[64] | delta_t[64]),
// then x_s
constexpr int kDkvStage = 2 * kSliceTileFloats + 2 * kTile;
constexpr size_t kDkvSmem = sizeof(float) * (2 * kSliceTileFloats + kStages * kDkvStage +
                                             kSliceWarps * kXFloats);
static_assert(kDqHeld % 4 == 0 && kDkvStage % 4 == 0, "tiles stay 16-byte aligned");

// Start copying rows [row0, row0 + 64) of a slice's (L, 128) array into a
// tile of pitch 132, by the whole block.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0,
                                          int length) {
  rlt::load_tile_async<kSliceDh, kSliceThreads>(dst, src, row0, length, kSliceDh);
}

// The pair's two score-sized products over rows h0.. of a streamed tile:
// this warp's, (16 held rows of `held`) x (32 rows of `streamed`)^T over all
// 128 columns, as two 64-deep parts in fresh accumulators joined by an f32
// add; then the mate's, traded through the exchange buffers. Returns
// (first, second) = (warp 0's product, warp 1's) in both warps.
__device__ __forceinline__ void pair_products(float (&first)[4][4], float (&second)[4][4],
                                              const float* held, const float* streamed,
                                              int w16, int h0, bool is_first, int pair,
                                              float* x_own, const float* x_mate, int g,
                                              int t) {
  float mine[4][4] = {}, part[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    Split a[4];
    rlt::split_a_tile<kSlicePitch>(a, held, w16, kk, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      rlt::mma3_b_rows<kSlicePitch>(mine[j], a, streamed, h0 + 8 * j, 8 * kk, g, t);
  }
#pragma unroll
  for (int kk = 8; kk < 16; ++kk) {
    Split a[4];
    rlt::split_a_tile<kSlicePitch>(a, held, w16, kk, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      rlt::mma3_b_rows<kSlicePitch>(part[j], a, streamed, h0 + 8 * j, 8 * kk, g, t);
  }
  add_part(mine, part);
  rlt::store_acc<4, kXPitch>(x_own, mine, g, t);
  rlt::pair_sync(pair);
  float mate[4][4];
  rlt::load_acc<4, kXPitch>(mate, x_mate, g, t);
  rlt::pair_sync(pair);  // the mate has read x_own before it is written again
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      first[j][e] = is_first ? mine[j][e] : mate[j][e];
      second[j][e] = is_first ? mate[j][e] : mine[j][e];
    }
  }
}

// Dynamic shared memory: q_s[64][132] | do_s[64][132] | delta_s[64] |
// kStages x (k_t[64][132] | v_t[64][132]) | x_s[8 warps][16][40]
__global__ void __launch_bounds__(kSliceThreads, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const int32_t* __restrict__ streams, float* __restrict__ dq,
          float* __restrict__ delta, int length, float scale, const rlt::Dropout drop) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kSliceTileFloats;
  float* delta_s = do_s + kSliceTileFloats;
  float* ring = q_s + kDqHeld;
  float* x_s = ring + kStages * 2 * kSliceTileFloats;

  const int slice = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pair = warp % 4;
  const bool is_first = warp < 4;
  const int w16 = pair * 16;          // the pair's rows in the block's tile
  const int c0 = (warp / 4) * kHalf;  // the warp's gradient columns
  const int q0 = blockIdx.x * kTile;
  const int r0 = q0 + w16;
  const size_t base = static_cast<size_t>(slice) * length * kSliceDh;
  const int tiles = (length + kTile - 1) / kTile;
  float* x_own = x_s + warp * kXFloats;
  const float* x_mate = x_s + (warp ^ 4) * kXFloats;

  load_rows(q_s, q + base, q0, length);
  load_rows(do_s, dout + base, q0, length);
  rlt::cp_async_commit();
  load_rows(ring, k + base, 0, length);
  load_rows(ring + kSliceTileFloats, v + base, 0, length);
  rlt::cp_async_commit();

  // delta of the block's rows: four threads per row, 32 columns each
  rlt::cp_async_wait<1>();
  __syncthreads();
  {
    const int i = threadIdx.x / 4;
    const int cq = (threadIdx.x % 4) * 32;
    const bool valid = q0 + i < length;
    float sum = 0.0f;
    if (valid) {
      const float4* orow = reinterpret_cast<const float4*>(
          o + base + static_cast<size_t>(q0 + i) * kSliceDh + cq);
      const float4* grow = reinterpret_cast<const float4*>(do_s + i * kSlicePitch + cq);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 a = orow[c];
        const float4 b = grow[c];
        sum = fmaf(a.x, b.x, sum);
        sum = fmaf(a.y, b.y, sum);
        sum = fmaf(a.z, b.z, sum);
        sum = fmaf(a.w, b.w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (threadIdx.x % 4 == 0) {
      delta_s[i] = sum;
      if (valid) delta[static_cast<size_t>(slice) * length + q0 + i] = sum;
    }
  }
  __syncthreads();
  float delta_r[2], lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    delta_r[r] = delta_s[w16 + g + 8 * r];
    lse_r[r] = row < length ? lse[static_cast<size_t>(slice) * length + row] : 0.0f;
  }

  const bool dropout = drop.on();
  const uint32_t key =
      dropout ? rlt::stream_key(static_cast<uint32_t>(streams[slice])) : 0u;
  const uint32_t limit = drop.limit(slice);
  const float inv_keep = drop.scale_of(slice);
  // warp 0 of the pair takes S = Q K^T, warp 1 dP = dO V^T
  const float* held = is_first ? q_s : do_s;
  float acc[8][4] = {}, part[8][4] = {};

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

    for (int h0 = 0; h0 < kTile; h0 += kHalfRows) {
      // S and dP over keys h0.. of the tile
      float s[4][4], dp[4][4];
      pair_products(s, dp, held, is_first ? k_t : v_t, w16, h0, is_first, pair, x_own,
                    x_mate, g, t);
      // ds, in place of s (keys past L have p = 0)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = it * kTile + h0 + 8 * j + 2 * t + (e & 1);
          const float p = col < length ? expf(s[j][e] * scale - lse_r[r]) : 0.0f;
          float gg = dp[j][e];
          if (dropout) {
            const uint32_t index =
                static_cast<uint32_t>(r0 + g + 8 * r) * static_cast<uint32_t>(length) + col;
            gg = rlt::keep_element(index, key, limit) ? gg * inv_keep : 0.0f;
          }
          s[j][e] = p * (gg - delta_r[r]) * scale;
        }
      }
      // the tile's ds K over those keys, on the warp's columns of K
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Split da[4];
        rlt::split_acc(s[kk], da);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rlt::mma3_b_perm<kSlicePitch>(part[j], da, k_t, h0 + 8 * kk, c0 + 8 * j, g, t);
      }
    }
    add_part(acc, part);
    __syncthreads();  // the stage is consumed before the next copy into it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < length) {
      float* out = dq + base + static_cast<size_t>(row) * kSliceDh + c0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// Start copying query rows [row0, row0 + 64) of Q, dO, lse and delta into
// one stage of dkv_kernel; rows at or past `length` become zeros.
__device__ __forceinline__ void load_dkv_stage(float* stage, const float* q_n,
                                               const float* do_n, const float* lse_n,
                                               const float* delta_n, int row0, int length) {
  load_rows(stage, q_n, row0, length);
  load_rows(stage + kSliceTileFloats, do_n, row0, length);
  float* lse_t = stage + 2 * kSliceTileFloats;
  const int i = threadIdx.x % kTile;
  const int row = row0 + i;
  const bool valid = row < length;
  if (threadIdx.x < kTile)
    rlt::cp_async4(lse_t + i, lse_n + (valid ? row : 0), valid);
  else if (threadIdx.x < 2 * kTile)
    rlt::cp_async4(lse_t + kTile + i, delta_n + (valid ? row : 0), valid);
}

// Dynamic shared memory: k_s[64][132] | v_s[64][132] |
// kStages x (q_t[64][132] | do_t[64][132] | lse_t[64] | delta_t[64]) |
// x_s[8 warps][16][40]
__global__ void __launch_bounds__(kSliceThreads, 1)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int32_t* __restrict__ streams, float* __restrict__ dk,
           float* __restrict__ dv, int length, float scale, const rlt::Dropout drop) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kSliceTileFloats;
  float* ring = v_s + kSliceTileFloats;
  float* x_s = ring + kStages * kDkvStage;

  const int slice = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pair = warp % 4;
  const bool is_first = warp < 4;
  const int w16 = pair * 16;
  const int c0 = (warp / 4) * kHalf;
  const int k0 = blockIdx.x * kTile + w16;  // the pair's first key row
  const size_t base = static_cast<size_t>(slice) * length * kSliceDh;
  const int tiles = (length + kTile - 1) / kTile;
  const float* lse_n = lse + static_cast<size_t>(slice) * length;
  const float* delta_n = delta + static_cast<size_t>(slice) * length;
  float* x_own = x_s + warp * kXFloats;
  const float* x_mate = x_s + (warp ^ 4) * kXFloats;

  load_rows(k_s, k + base, blockIdx.x * kTile, length);
  load_rows(v_s, v + base, blockIdx.x * kTile, length);
  load_dkv_stage(ring, q + base, dout + base, lse_n, delta_n, 0, length);
  rlt::cp_async_commit();

  const bool dropout = drop.on();
  const uint32_t key =
      dropout ? rlt::stream_key(static_cast<uint32_t>(streams[slice])) : 0u;
  const uint32_t limit = drop.limit(slice);
  const float inv_keep = drop.scale_of(slice);
  // warp 0 of the pair takes S^T = K Q^T, warp 1 dP^T = V dO^T
  const float* held = is_first ? k_s : v_s;
  float dk_acc[8][4] = {}, dv_acc[8][4] = {}, part[8][4] = {};

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      load_dkv_stage(ring + ((it + 1) % kStages) * kDkvStage, q + base, dout + base, lse_n,
                     delta_n, (it + 1) * kTile, length);
      rlt::cp_async_commit();
      rlt::cp_async_wait<1>();
    } else {
      rlt::cp_async_wait<0>();
    }
    __syncthreads();
    const float* q_t = ring + (it % kStages) * kDkvStage;
    const float* do_t = q_t + kSliceTileFloats;
    const float* lse_t = do_t + kSliceTileFloats;
    const float* delta_t = lse_t + kTile;

    for (int h0 = 0; h0 < kTile; h0 += kHalfRows) {
      // S^T and dP^T over queries h0.. of the tile
      float st[4][4], dpt[4][4];
      pair_products(st, dpt, held, is_first ? q_t : do_t, w16, h0, is_first, pair, x_own,
                    x_mate, g, t);
      // ds^T in place of st, pd^T in place of dpt (queries past L have p = 0)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = h0 + 8 * j + 2 * t + (e & 1);
          const int row = it * kTile + qi;
          const float p = row < length ? expf(st[j][e] * scale - lse_t[qi]) : 0.0f;
          float pd = p;
          float gg = dpt[j][e];
          if (dropout) {
            const uint32_t index = static_cast<uint32_t>(row) * static_cast<uint32_t>(length) +
                                   static_cast<uint32_t>(k0 + g + 8 * (e >> 1));
            const bool keep = rlt::keep_element(index, key, limit);
            pd = keep ? p * inv_keep : 0.0f;
            gg = keep ? gg * inv_keep : 0.0f;
          }
          st[j][e] = p * (gg - delta_t[qi]) * scale;
          dpt[j][e] = pd;
        }
      }
      // dV += pd^T dO, then dK += ds^T Q, over those queries, on the warp's
      // columns
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Split pa[4];
        rlt::split_acc(dpt[kk], pa);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rlt::mma3_b_perm<kSlicePitch>(part[j], pa, do_t, h0 + 8 * kk, c0 + 8 * j, g, t);
      }
      add_part(dv_acc, part);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Split da[4];
        rlt::split_acc(st[kk], da);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rlt::mma3_b_perm<kSlicePitch>(part[j], da, q_t, h0 + 8 * kk, c0 + 8 * j, g, t);
      }
      add_part(dk_acc, part);
    }
    __syncthreads();  // the stage is consumed before the next copy into it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + g + 8 * r;
    if (row < length) {
      const size_t out = base + static_cast<size_t>(row) * kSliceDh + c0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(dk + out + 8 * j) =
            make_float2(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
        *reinterpret_cast<float2*>(dv + out + 8 * j) =
            make_float2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      }
    }
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv (N, L, 128), lse (N, 1, L) and delta an
// (N, L) scratch array: contiguous float32 device arrays, the (N, L, 128)
// ones 16-byte aligned. With rate > 0, `streams` holds K3''s N int32
// dropout streams and `threshold` its keep threshold; with `thresholds` and
// `scales`, K3''s per-slice rates (rlt_attention_fwd). Takes
// 1 <= L <= 65535. Launches its two kernels on `stream` and returns the
// first error.
extern "C" int rlt_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, const void* lse,
                                 const void* streams, const void* thresholds,
                                 const void* scales, void* dq, void* dk, void* dv,
                                 void* delta, int n, int length, float rate,
                                 unsigned int threshold, void* stream) {
  rlt::Dropout drop;
  if (n < 1 || length < 1 || n > 65535 || length > 65535 ||
      !rlt::make_dropout(drop, rate, threshold, streams, thresholds, scales))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDqSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(static_cast<float>(kSliceDh));
  const dim3 grid((length + kTile - 1) / kTile, n);
  dq_kernel<<<grid, kSliceThreads, kDqSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const int32_t*>(streams), static_cast<float*>(dq),
      static_cast<float*>(delta), length, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<grid, kSliceThreads, kDkvSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(streams), static_cast<float*>(dk),
      static_cast<float*>(dv), length, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 instance: q, k, v, o, dout, dq, dk, dv (N, L, 128) bf16, lse
// (N, 1, L) and the delta scratch (N, L) float32, the rest as
// rlt_attention_bwd. Each slice runs as one head of width 128 in a group of
// pack 1, so its keep-mask index is i * L + j on its own stream, as above.
// Launches its two kernels on `stream` and returns the first error.
extern "C" int rlt_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      const void* streams, const void* thresholds,
                                      const void* scales, void* dq, void* dk, void* dv,
                                      void* delta, int n, int length, float rate,
                                      unsigned int threshold, void* stream) {
  rlt::Dropout drop;
  if (n < 1 || length < 1 || n > 65535 || length > 65535 ||
      !rlt::make_dropout(drop, rate, threshold, streams, thresholds, scales))
    return static_cast<int>(cudaErrorInvalidValue);
  return rlt::launch_attn_bwd_wgmma<kSliceDh>(q, k, v, o, dout, lse, streams, dq, dk, dv,
                                              delta, n, length, 1, 1, drop,
                                              static_cast<cudaStream_t>(stream));
}
