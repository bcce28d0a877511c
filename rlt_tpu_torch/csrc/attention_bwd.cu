// K4' attention_bwd: per-slice self-attention backward, float32, dh = 128.
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
// What bounds it on an H100: operations. Seven L x L x 128 products per
// slice (s and dp in each of two passes, then dq, dk and dv) against
// 8 N L dh floats of traffic; f32 FMAs (TF32 would miss the parity), every
// operand read from shared memory, so those reads bind first.
//
// The fit: K6' held a head's whole Q and dO (or K and V) in shared memory,
// 163 KB at dh = 64 and L = 300, which doubles at dh = 128. Here the exact
// lse makes p = exp(s * scale - lse) a function of one score alone, with no
// running max to rescale, so both passes stream the other side in tiles of
// kTile = 32 rows and the shared memory needed (71 KB and 75 KB) does not
// grow with L. Deterministic, without atomics, one C launcher, three kernels:
//  1. delta_kernel: one warp per (slice, query row) computes delta.
//  2. dq_kernel: one block per (slice, tile of 32 query rows) holds its rows
//     of Q and dO; each warp takes 4 rows. For each tile of 32 keys of K
//     and V in shared memory: lanes over keys build ds for the warp's rows,
//     then lanes over column quads add ds K to dq, kept in registers.
//  3. dkv_kernel: one block per (slice, tile of 32 key rows) holds its rows
//     of K and V; each warp takes 4 keys. For each tile of 32 query rows of
//     Q, dO, lse and delta: lanes over queries build ds and pd for the
//     warp's keys, then lanes over column quads add ds^T Q to dk and
//     pd^T dO to dv.
// Every output element is written by exactly one thread, so no sum crosses
// blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "keep_mask.cuh"

namespace {

using rlt::component;
using rlt::dot4;
using rlt::fma4;
using rlt::zero4;
constexpr int kDh = rlt::kSliceDh;
constexpr int kPitch = rlt::kSlicePitch;
constexpr int kWarps = rlt::kSliceWarps;
constexpr int kRows = 4;                   // query rows (dq) or keys (dk, dv) per warp
constexpr int kBlockRows = kWarps * kRows; // rows a block owns
constexpr int kTile = 32;                  // rows of the other side per streamed tile
constexpr int kDeltaWarps = 8;

constexpr size_t kDqSmem =
    sizeof(float) * (2 * kBlockRows * kDh + 2 * kTile * kPitch + kBlockRows * kTile);
constexpr size_t kDkvSmem =
    sizeof(float) * (2 * kBlockRows * kDh + 2 * kTile * kPitch + 2 * kTile +
                     2 * kBlockRows * kTile);

// delta (N, L): one warp per (slice, row) of o and do
__global__ void __launch_bounds__(32 * kDeltaWarps)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
             float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const size_t c = static_cast<size_t>(row) * kDh + 4 * lane;
  const float acc = rlt::warp_sum(dot4(*reinterpret_cast<const float4*>(o + c),
                                       *reinterpret_cast<const float4*>(dout + c), 0.0f));
  if (lane == 0) delta[row] = acc;
}

// Dynamic shared memory: q_b[kBlockRows][kDh] | do_b[kBlockRows][kDh] |
// k_t[kTile][kPitch] | v_t[kTile][kPitch] | ds_w[kWarps][kRows][kTile]
__global__ void __launch_bounds__(32 * kWarps)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int32_t* __restrict__ streams, float* __restrict__ dq,
          int length, float scale, bool dropout, uint32_t threshold,
          float inv_keep) {
  extern __shared__ float4 smem4[];
  float* q_b = reinterpret_cast<float*>(smem4);
  float* do_b = q_b + kBlockRows * kDh;
  float* k_t = do_b + kBlockRows * kDh;
  float* v_t = k_t + kTile * kPitch;
  float* ds_w = v_t + kTile * kPitch;

  const int slice = blockIdx.y;
  const int q0 = blockIdx.x * kBlockRows;
  const size_t base = static_cast<size_t>(slice) * length * kDh;
  rlt::load_tile<kBlockRows, kDh>(q_b, q + base, q0, length);
  rlt::load_tile<kBlockRows, kDh>(do_b, dout + base, q0, length);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = q0 + warp * kRows;
  const float* qw = q_b + warp * kRows * kDh;
  const float* dow = do_b + warp * kRows * kDh;
  float* dsw = ds_w + warp * kRows * kTile;
  const uint32_t key =
      dropout ? rlt::stream_key(static_cast<uint32_t>(streams[slice])) : 0u;
  float lse_r[kRows], delta_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool in = r0 + r < length;
    lse_r[r] = in ? lse[static_cast<size_t>(slice) * length + r0 + r] : 0.0f;
    delta_r[r] = in ? delta[static_cast<size_t>(slice) * length + r0 + r] : 0.0f;
  }
  float4 acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = zero4();

  for (int t0 = 0; t0 < length; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and Q, dO are in)
    rlt::load_tile<kTile, kPitch>(k_t, k + base, t0, length);
    rlt::load_tile<kTile, kPitch>(v_t, v + base, t0, length);
    __syncthreads();

    // ds for the warp's rows, lanes over the tile's keys
    const int j = t0 + lane;
    float s[kRows] = {};
    float dp[kRows] = {};
    const float4* kr = reinterpret_cast<const float4*>(k_t + lane * kPitch);
    const float4* vr = reinterpret_cast<const float4*>(v_t + lane * kPitch);
#pragma unroll 4
    for (int d4 = 0; d4 < kDh / 4; ++d4) {
      const float4 kk = kr[d4];
      const float4 vv = vr[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = dot4(reinterpret_cast<const float4*>(qw + r * kDh)[d4], kk, s[r]);
        dp[r] = dot4(reinterpret_cast<const float4*>(dow + r * kDh)[d4], vv, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float ds = 0.0f;
      if (j < length) {
        const float p = expf(s[r] * scale - lse_r[r]);
        float g = dp[r];
        if (dropout) {
          const uint32_t index =
              static_cast<uint32_t>(r0 + r) * static_cast<uint32_t>(length) + j;
          g = rlt::keep_element(index, key, threshold) ? g * inv_keep : 0.0f;
        }
        ds = p * (g - delta_r[r]) * scale;
      }
      dsw[r * kTile + lane] = ds;
    }
    __syncwarp();

    // dq += ds K, lanes over the column quads 4 * lane
    for (int u0 = 0; u0 < kTile; u0 += 4) {
      float4 ds4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        ds4[r] = *reinterpret_cast<const float4*>(dsw + r * kTile + u0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 kk = *reinterpret_cast<const float4*>(k_t + (u0 + u) * kPitch + 4 * lane);
#pragma unroll
        for (int r = 0; r < kRows; ++r) fma4(component(ds4[r], u), kk, acc[r]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r0 + r < length)
      *reinterpret_cast<float4*>(dq + base + static_cast<size_t>(r0 + r) * kDh + 4 * lane) =
          acc[r];
}

// Dynamic shared memory: k_b[kBlockRows][kDh] | v_b[kBlockRows][kDh] |
// q_t[kTile][kPitch] | do_t[kTile][kPitch] | lse_t[kTile] | delta_t[kTile] |
// ds_w[kWarps][kRows][kTile] | pd_w[kWarps][kRows][kTile]
__global__ void __launch_bounds__(32 * kWarps)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int32_t* __restrict__ streams, float* __restrict__ dk,
           float* __restrict__ dv, int length, float scale, bool dropout,
           uint32_t threshold, float inv_keep) {
  extern __shared__ float4 smem4[];
  float* k_b = reinterpret_cast<float*>(smem4);
  float* v_b = k_b + kBlockRows * kDh;
  float* q_t = v_b + kBlockRows * kDh;
  float* do_t = q_t + kTile * kPitch;
  float* lse_t = do_t + kTile * kPitch;
  float* delta_t = lse_t + kTile;
  float* ds_w = delta_t + kTile;
  float* pd_w = ds_w + kBlockRows * kTile;

  const int slice = blockIdx.y;
  const int k0 = blockIdx.x * kBlockRows;
  const size_t base = static_cast<size_t>(slice) * length * kDh;
  rlt::load_tile<kBlockRows, kDh>(k_b, k + base, k0, length);
  rlt::load_tile<kBlockRows, kDh>(v_b, v + base, k0, length);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j0 = k0 + warp * kRows;
  const float* kw = k_b + warp * kRows * kDh;
  const float* vw = v_b + warp * kRows * kDh;
  float* dsw = ds_w + warp * kRows * kTile;
  float* pdw = pd_w + warp * kRows * kTile;
  const uint32_t key =
      dropout ? rlt::stream_key(static_cast<uint32_t>(streams[slice])) : 0u;
  const float* lse_s = lse + static_cast<size_t>(slice) * length;
  const float* delta_s = delta + static_cast<size_t>(slice) * length;
  float4 dk_acc[kRows], dv_acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    dk_acc[r] = zero4();
    dv_acc[r] = zero4();
  }

  for (int t0 = 0; t0 < length; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and K, V are in)
    rlt::load_tile<kTile, kPitch>(q_t, q + base, t0, length);
    rlt::load_tile<kTile, kPitch>(do_t, dout + base, t0, length);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const bool in = t0 + i < length;
      lse_t[i] = in ? lse_s[t0 + i] : 0.0f;
      delta_t[i] = in ? delta_s[t0 + i] : 0.0f;
    }
    __syncthreads();

    // ds and pd for the warp's keys, lanes over the tile's queries
    const int i = t0 + lane;
    float s[kRows] = {};
    float dp[kRows] = {};
    const float4* qr = reinterpret_cast<const float4*>(q_t + lane * kPitch);
    const float4* gr = reinterpret_cast<const float4*>(do_t + lane * kPitch);
#pragma unroll 4
    for (int d4 = 0; d4 < kDh / 4; ++d4) {
      const float4 qq = qr[d4];
      const float4 gg = gr[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = dot4(qq, reinterpret_cast<const float4*>(kw + r * kDh)[d4], s[r]);
        dp[r] = dot4(gg, reinterpret_cast<const float4*>(vw + r * kDh)[d4], dp[r]);
      }
    }
    const float lse_i = lse_t[lane];
    const float delta_i = delta_t[lane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float ds = 0.0f;
      float pd = 0.0f;
      if (i < length) {
        const float p = expf(s[r] * scale - lse_i);
        float g = dp[r];
        pd = p;
        if (dropout) {
          const uint32_t index =
              static_cast<uint32_t>(i) * static_cast<uint32_t>(length) + j0 + r;
          const bool keep = rlt::keep_element(index, key, threshold);
          pd = keep ? p * inv_keep : 0.0f;
          g = keep ? g * inv_keep : 0.0f;
        }
        ds = p * (g - delta_i) * scale;
      }
      dsw[r * kTile + lane] = ds;
      pdw[r * kTile + lane] = pd;
    }
    __syncwarp();

    // dk += ds^T Q and dv += pd^T dO, lanes over the column quads 4 * lane
    for (int u0 = 0; u0 < kTile; u0 += 4) {
      float4 ds4[kRows], pd4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        ds4[r] = *reinterpret_cast<const float4*>(dsw + r * kTile + u0);
        pd4[r] = *reinterpret_cast<const float4*>(pdw + r * kTile + u0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 qq = *reinterpret_cast<const float4*>(q_t + (u0 + u) * kPitch + 4 * lane);
        const float4 gg = *reinterpret_cast<const float4*>(do_t + (u0 + u) * kPitch + 4 * lane);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          fma4(component(ds4[r], u), qq, dk_acc[r]);
          fma4(component(pd4[r], u), gg, dv_acc[r]);
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (j0 + r < length) {
      const size_t out = base + static_cast<size_t>(j0 + r) * kDh + 4 * lane;
      *reinterpret_cast<float4*>(dk + out) = dk_acc[r];
      *reinterpret_cast<float4*>(dv + out) = dv_acc[r];
    }
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv (N, L, 128), lse (N, 1, L) and delta an
// (N, L) scratch array: contiguous float32 device arrays, the (N, L, 128)
// ones 16-byte aligned. With rate > 0, `streams` holds K3''s N int32
// dropout streams and `threshold` its keep threshold. Launches its three
// kernels on `stream` and returns the first error.
extern "C" int rlt_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, const void* lse,
                                 const void* streams, void* dq, void* dk, void* dv,
                                 void* delta, int n, int length, float rate,
                                 unsigned int threshold, void* stream) {
  if (n < 1 || length < 1 || n > 65535 || length > 65535 ||
      static_cast<long long>(n) * length > 0x7fffffffLL ||
      !(rate >= 0.0f && rate < 1.0f) || (rate > 0.0f && streams == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDqSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = n * length;
  delta_kernel<<<(rows + kDeltaWarps - 1) / kDeltaWarps, 32 * kDeltaWarps, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<float*>(delta), rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  const bool dropout = rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const dim3 grid((length + kBlockRows - 1) / kBlockRows, n);
  dq_kernel<<<grid, 32 * kWarps, kDqSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(streams), static_cast<float*>(dq), length, scale,
      dropout, threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<grid, 32 * kWarps, kDkvSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(streams), static_cast<float*>(dk),
      static_cast<float*>(dv), length, scale, dropout, threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}
