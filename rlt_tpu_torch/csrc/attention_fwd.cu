// K3' attention_fwd: per-slice self-attention forward, float32, dh = 128.
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
// traffic, so operations bound it. It runs f32 FMAs, not tensor cores: TF32
// would miss the 1e-5 parity with the plain version. In this simple design
// every FMA operand comes from shared memory, and those reads bind first.
//
// The fit: K5' held a whole head's K and V in shared memory. At dh = 128 and
// L = 300 that is 2 * 300 * 132 * 4 B = 317 KB, over the 227 KB a block can
// have. So K3' streams K and V in tiles of kTile = 32 keys, flash-style, with
// a running max and sum per query row: one block per (slice, 32 query rows),
// each warp 4 rows. For each tile: lanes over keys take the scores of the
// warp's rows; the tile's max (warp shuffles) raises the running max m, the
// running sum and the output accumulator are rescaled by exp(m_old - m_new),
// and the tile's weights exp(s - m_new) (dropped and scaled where the mask
// says) go to shared memory; then lanes over column quads add weights x V to
// the accumulator in registers. At the end o = acc / sum and lse =
// m + log(sum). The block needs 53 KB of shared memory whatever L is, so
// several blocks share an SM and one's copies overlap another's FMAs, and
// L may be anything up to 65535 (the keep mask's index i * L + j is 32-bit).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "keep_mask.cuh"

namespace {

using rlt::kSliceDh;
using rlt::kSlicePitch;
using rlt::kSliceWarps;
constexpr int kRows = 4;                          // query rows per warp
constexpr int kBlockRows = kSliceWarps * kRows;   // query rows per block
constexpr int kTile = 32;                         // keys per streamed tile

constexpr size_t kSmem = sizeof(float) * (kBlockRows * kSliceDh + 2 * kTile * kSlicePitch +
                                          kBlockRows * kTile);

// Dynamic shared memory: q_b[kBlockRows][kSliceDh] | k_t[kTile][kSlicePitch] |
// v_t[kTile][kSlicePitch] | p_w[kSliceWarps][kRows][kTile]
__global__ void __launch_bounds__(32 * kSliceWarps)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, const int32_t* __restrict__ streams,
                int length, float scale, bool dropout, uint32_t threshold,
                float inv_keep) {
  extern __shared__ float4 smem4[];
  float* q_b = reinterpret_cast<float*>(smem4);
  float* k_t = q_b + kBlockRows * kSliceDh;
  float* v_t = k_t + kTile * kSlicePitch;
  float* p_w = v_t + kTile * kSlicePitch;

  const int slice = blockIdx.y;
  const int q0 = blockIdx.x * kBlockRows;
  const size_t base = static_cast<size_t>(slice) * length * kSliceDh;
  rlt::load_tile<kBlockRows, kSliceDh>(q_b, q + base, q0, length);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = q0 + warp * kRows;
  const float* qw = q_b + warp * kRows * kSliceDh;
  float* pw = p_w + warp * kRows * kTile;
  const uint32_t key =
      dropout ? rlt::stream_key(static_cast<uint32_t>(streams[slice])) : 0u;
  float m[kRows], sum[kRows];
  float4 acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    sum[r] = 0.0f;
    acc[r] = rlt::zero4();
  }

  for (int t0 = 0; t0 < length; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and Q is in)
    rlt::load_tile<kTile, kSlicePitch>(k_t, k + base, t0, length);
    rlt::load_tile<kTile, kSlicePitch>(v_t, v + base, t0, length);
    __syncthreads();

    // scores of the warp's rows, lanes over the tile's keys
    const int j = t0 + lane;
    float s[kRows] = {};
    const float4* kr = reinterpret_cast<const float4*>(k_t + lane * kSlicePitch);
#pragma unroll 4
    for (int d4 = 0; d4 < kSliceDh / 4; ++d4) {
      const float4 kk = kr[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[r] = rlt::dot4(reinterpret_cast<const float4*>(qw + r * kSliceDh)[d4], kk, s[r]);
    }
    // running max and sum; the tile's weights (key t0 < L, so every tile
    // has a finite score and m_new is finite)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sr = j < length ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], rlt::warp_max(sr));
      const float corr = expf(m[r] - m_new);  // 0 on the first tile
      const float e = expf(sr - m_new);       // 0 past L
      sum[r] = sum[r] * corr + rlt::warp_sum(e);
      acc[r].x *= corr;
      acc[r].y *= corr;
      acc[r].z *= corr;
      acc[r].w *= corr;
      m[r] = m_new;
      float w = e;
      if (dropout && j < length) {
        const uint32_t index =
            static_cast<uint32_t>(r0 + r) * static_cast<uint32_t>(length) + j;
        w = rlt::keep_element(index, key, threshold) ? e * inv_keep : 0.0f;
      }
      pw[r * kTile + lane] = w;
    }
    __syncwarp();

    // acc += weights x V, lanes over the column quads 4 * lane
    for (int u0 = 0; u0 < kTile; u0 += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        p4[r] = *reinterpret_cast<const float4*>(pw + r * kTile + u0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 vv =
            *reinterpret_cast<const float4*>(v_t + (u0 + u) * kSlicePitch + 4 * lane);
#pragma unroll
        for (int r = 0; r < kRows; ++r) rlt::fma4(rlt::component(p4[r], u), vv, acc[r]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r < length) {
      const float inv = 1.0f / sum[r];
      const size_t out = base + static_cast<size_t>(r0 + r) * kSliceDh + 4 * lane;
      *reinterpret_cast<float4*>(o + out) =
          make_float4(acc[r].x * inv, acc[r].y * inv, acc[r].z * inv, acc[r].w * inv);
      if (lane == 0)
        lse[static_cast<size_t>(slice) * length + r0 + r] = m[r] + logf(sum[r]);
    }
  }
}

}  // namespace

// q, k, v, o (N, L, 128) and lse (N, 1, L): contiguous float32 device arrays,
// q/k/v/o 16-byte aligned. With rate > 0, `streams` holds N int32 dropout
// streams (one per slice) and `threshold` the keep threshold of
// keep_mask.cuh; with rate == 0 neither is read. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int rlt_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, const void* streams, int n,
                                 int length, float rate, unsigned int threshold,
                                 void* stream) {
  if (n < 1 || length < 1 || n > 65535 || length > 65535 ||
      !(rate >= 0.0f && rate < 1.0f) || (rate > 0.0f && streams == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((length + kBlockRows - 1) / kBlockRows, n);
  attn_fwd_kernel<<<grid, 32 * kSliceWarps, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const int32_t*>(streams), length,
      1.0f / sqrtf(static_cast<float>(kSliceDh)), rate > 0.0f, threshold,
      1.0f / (1.0f - rate));
  return static_cast<int>(cudaGetLastError());
}
