// K5' attention_packed_fwd: head-packed self-attention forward, float32.
//
// Replaces rlt_tpu/ops/attention.py::_attn_fwd_packed_kernel (run through
// _fwd_packed and fused_attention_packed). q, k, v are (N, L, D) in the raw
// in_proj layout, the heads contiguous in D: head h is columns
// [h*64, (h+1)*64). Per head: o_h = softmax(q_h k_h^T / sqrt(64)) v_h, and
// lse_h = log sum_j exp(s_j) per query row, stored in the JAX layout
// (N, groups, L, pack) with head h at [h / pack, :, h % pack]. With a
// dropout rate above 0, the softmax weights are dropped by the keep mask of
// keep_mask.cuh (per-row stream, head group and column as in the TPU kernel)
// and the kept ones scaled by 1 / (1 - rate); lse stays the pre-dropout one.
//
// It computes the same function, not the TPU's block-masked kbig/vbig trick
// (that trick buys a 128-deep MXU contraction with pack x the MACs; here the
// heads are simply separate). One difference from the TPU kernel: that one
// subtracts the GROUP-wide row max before the per-head sums, which
// underflows a head whose scores sit far below its neighbour's. This kernel
// subtracts each head's own row max: o and lse are the same up to rounding
// wherever the TPU kernel is finite, and stay finite where it is not.
//
// What bounds it on an H100: at the serving shapes (N = 3 * batch, L = 300,
// 4 heads) the arithmetic is 4 N H L^2 dh flops, with 4 N L D floats of
// traffic; at f32 FMA rates (no tensor cores: TF32 would break the 1e-5
// parity) the operations bound it, and in this simple design the shared
// memory reads feeding the FMAs bound it before they do.
//
// Design: one block per (row n, head h, tile of kQTile query rows). The
// block copies the head's whole K and V (L x 64 each, rows padded to
// kPitch floats so float4 reads by neighbouring lanes hit distinct banks)
// into shared memory, which holds L <= 333. Each warp takes kRowsPerWarp
// query rows at a time: scores for its rows with lanes over keys (float4
// dot products), the exact max and exp-sum by warp shuffles, then o with
// lanes over the 64 output columns. Dropout multiplies each exp by its keep
// bit and 1 / (1 - rate) after the sum is taken; at rate 0 that branch is
// not taken and the kernel computes what it computed before dropout existed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "keep_mask.cuh"

namespace {

constexpr int kDh = 64;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kQTile = 64;
constexpr int kPitch = kDh + 4;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int length) {
  return sizeof(float) * (2 * static_cast<size_t>(length) * kPitch +
                          kWarps * kRowsPerWarp * (kDh + length));
}

// Dynamic shared memory: k_s[L][kPitch] | v_s[L][kPitch] |
// q_s[kWarps][kRowsPerWarp][kDh] | p_s[kWarps][kRowsPerWarp][L].
__global__ void __launch_bounds__(32 * kWarps)
attn_packed_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse,
                       const int32_t* __restrict__ streams, int length,
                       int d_model, int pack, float scale, bool dropout,
                       uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + static_cast<size_t>(length) * kPitch;
  float* q_s = v_s + static_cast<size_t>(length) * kPitch;
  float* p_s = q_s + kWarps * kRowsPerWarp * kDh;

  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kQTile;
  const int q_end = min(q0 + kQTile, length);
  const size_t base = static_cast<size_t>(n) * length * d_model + head * kDh;

  // K and V of this head: 16 float4 per row
  for (int i = threadIdx.x; i < length * (kDh / 4); i += blockDim.x) {
    const int row = i / (kDh / 4);
    const int c4 = (i - row * (kDh / 4)) * 4;
    const size_t src = base + static_cast<size_t>(row) * d_model + c4;
    *reinterpret_cast<float4*>(k_s + row * kPitch + c4) =
        *reinterpret_cast<const float4*>(k + src);
    *reinterpret_cast<float4*>(v_s + row * kPitch + c4) =
        *reinterpret_cast<const float4*>(v + src);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qw = q_s + warp * kRowsPerWarp * kDh;
  float* pw = p_s + static_cast<size_t>(warp) * kRowsPerWarp * length;
  const int groups = gridDim.y / pack;
  // the head's keep mask: columns (head % pack) * L + j of its group's tile
  const uint32_t ncols = static_cast<uint32_t>(pack) * length;
  const uint32_t col0 = static_cast<uint32_t>(head % pack) * length;
  const uint32_t key =
      dropout ? rlt::stream_key(rlt::group_stream(streams[n], head / pack)) : 0u;

  for (int r0 = q0 + warp * kRowsPerWarp; r0 < q_end;
       r0 += kWarps * kRowsPerWarp) {
    const int nr = min(kRowsPerWarp, q_end - r0);
    for (int i = lane; i < kRowsPerWarp * kDh; i += 32) {
      const int r = i / kDh;
      const int d = i - r * kDh;
      qw[i] = r < nr ? q[base + static_cast<size_t>(r0 + r) * d_model + d] : 0.0f;
    }
    __syncwarp();

    // scores, lanes over keys
    float m[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) m[r] = -INFINITY;
    for (int j = lane; j < length; j += 32) {
      float s[kRowsPerWarp] = {};
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * kPitch);
#pragma unroll 4
      for (int d4 = 0; d4 < kDh / 4; ++d4) {
        const float4 kk = kr[d4];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 qq = reinterpret_cast<const float4*>(qw + r * kDh)[d4];
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] *= scale;
        pw[r * length + j] = s[r];
        m[r] = fmaxf(m[r], s[r]);
      }
    }
    float sum[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      m[r] = warp_max(m[r]);
      sum[r] = 0.0f;
    }
    for (int j = lane; j < length; j += 32) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float e = expf(pw[r * length + j] - m[r]);
        sum[r] += e;
        if (dropout) {
          const uint32_t index = static_cast<uint32_t>(r0 + r) * ncols + col0 + j;
          pw[r * length + j] =
              rlt::keep_element(index, key, threshold) ? e * inv_keep : 0.0f;
        } else {
          pw[r * length + j] = e;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sum[r] = warp_sum(sum[r]);
    __syncwarp();

    // o = (sum_j e_j v_j) / sum, lanes over output columns lane, lane + 32
    float a0[kRowsPerWarp] = {};
    float a1[kRowsPerWarp] = {};
    for (int j = 0; j < length; ++j) {
      const float v0 = v_s[j * kPitch + lane];
      const float v1 = v_s[j * kPitch + lane + 32];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = pw[r * length + j];
        a0[r] = fmaf(p, v0, a0[r]);
        a1[r] = fmaf(p, v1, a1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (r < nr) {
        const float inv = 1.0f / sum[r];
        const size_t out = base + static_cast<size_t>(r0 + r) * d_model;
        o[out + lane] = a0[r] * inv;
        o[out + lane + 32] = a1[r] * inv;
        if (lane == 0) {
          const size_t li =
              ((static_cast<size_t>(n) * groups + head / pack) * length + r0 + r) *
                  pack + head % pack;
          lse[li] = m[r] + logf(sum[r]);
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// q, k, v, o (N, L, D) with D = heads * 64, lse (N, heads / pack, L, pack):
// contiguous float32 device arrays, q/k/v 16-byte aligned. With rate > 0,
// `streams` holds N int32 dropout streams (one per row n) and `threshold`
// the keep threshold of keep_mask.cuh; with rate == 0 neither is read.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int rlt_attention_packed_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        const void* streams, int n, int length,
                                        int heads, int pack, float rate,
                                        unsigned int threshold, void* stream) {
  if (n < 1 || length < 1 || heads < 1 || pack < 1 || heads % pack != 0 ||
      n > 65535 || heads > 65535 || !(rate >= 0.0f && rate < 1.0f) ||
      (rate > 0.0f && streams == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  int max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(length);
  if (smem > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(attn_packed_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((length + kQTile - 1) / kQTile, heads, n);
  attn_packed_fwd_kernel<<<grid, 32 * kWarps, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const int32_t*>(streams), length,
      heads * kDh, pack, 1.0f / sqrtf(static_cast<float>(kDh)), rate > 0.0f,
      threshold, 1.0f / (1.0f - rate));
  return static_cast<int>(cudaGetLastError());
}
