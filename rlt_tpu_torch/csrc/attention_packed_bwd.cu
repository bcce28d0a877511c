// K6' attention_packed_bwd: head-packed self-attention backward, float32.
//
// Replaces rlt_tpu/ops/attention.py::_attn_bwd_packed_kernel (run through
// _bwd_packed and the custom_vjp of fused_attention_packed). q, k, v, o and
// the incoming gradient do are (N, L, D) in the raw in_proj layout, head h
// at columns [h*64, (h+1)*64); lse is K5''s (N, groups, L, pack). Per head,
// flash-style, recomputing the probabilities instead of storing them:
//   p = exp(s * scale - lse)          s = q k^T, the pre-dropout softmax
//   dp = do v^T, and with dropout pd = keep ? p / (1 - rate) : 0,
//                                 dp = keep ? dp / (1 - rate) : 0
//   delta = rowsum(do * o) over the head's 64 columns
//   ds = p (dp - delta) scale
//   dq = ds k,  dk = ds^T q,  dv = pd^T do
// The keep mask is K5''s (keep_mask.cuh), regenerated from the same streams.
//
// What bounds it on an H100: operations. Five L x L x 64 products per head
// (s and dp twice, since each pass recomputes them, then dq, or dk and dv)
// against 8 N L D floats of traffic; at f32 FMA rates (no tensor cores: TF32
// would break the 1e-5 parity) and with every FMA operand read from shared
// memory in this simple design, the shared-memory reads bind first.
//
// Design, deterministic and without atomics, one C launcher, three kernels:
//  1. delta_kernel: one warp per (n, query row) computes delta of every head.
//  2. dq_kernel: one block per (n, head, tile of 64 query rows) holds the
//     head's K and V in shared memory (as K5' does). Each warp takes 4 query
//     rows: lanes over keys build ds for its rows, then lanes over the 64
//     output columns sum dq = ds K.
//  3. dkv_kernel: one block per (n, head, tile of 64 key rows) holds the
//     head's Q and dO (rows padded to 68 floats, about 163 KB at L = 300),
//     its lse and its delta. Each warp takes 2 key rows: lanes over queries
//     build ds and pd for them, then lanes over output columns sum
//     dk = ds^T Q and dv = pd^T dO.
// Every output element is written by exactly one thread, so no sum crosses
// blocks. The launcher takes L <= 321 on an H100 (227 KB of shared memory).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "keep_mask.cuh"

namespace {

constexpr int kDh = 64;
constexpr int kPitch = kDh + 4;
constexpr int kTile = 64;       // query rows (dq) or key rows (dk, dv) per block
constexpr int kWarps = 8;
constexpr int kQRows = 4;       // query rows per warp in dq_kernel
constexpr int kKRows = 2;       // key rows per warp in dkv_kernel
constexpr int kDeltaWarps = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a head's rows [0, length) of an (N, L, D) array into shared memory with
// row pitch kPitch
__device__ __forceinline__ void load_head(float* dst, const float* src,
                                          size_t base, int length,
                                          int d_model) {
  for (int i = threadIdx.x; i < length * (kDh / 4); i += blockDim.x) {
    const int row = i / (kDh / 4);
    const int c4 = (i - row * (kDh / 4)) * 4;
    *reinterpret_cast<float4*>(dst + row * kPitch + c4) =
        *reinterpret_cast<const float4*>(src + base + static_cast<size_t>(row) * d_model + c4);
  }
}

size_t dq_smem_bytes(int length) {
  return sizeof(float) * (2 * static_cast<size_t>(length) * kPitch +
                          kWarps * kQRows * (2 * kDh + length));
}

// lse and delta rows rounded up to 4 floats, so that the float4 buffers
// after them stay 16-byte aligned
__host__ __device__ constexpr int padded4(int length) { return (length + 3) & ~3; }

size_t dkv_smem_bytes(int length) {
  return sizeof(float) * (2 * static_cast<size_t>(length) * kPitch +
                          2 * padded4(length) +
                          kWarps * kKRows * (2 * kDh + 2 * length));
}

// delta (N, heads, L): one warp per (n, i) row of o and do
__global__ void __launch_bounds__(32 * kDeltaWarps)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
             float* __restrict__ delta, int rows, int length, int heads) {
  const int row = blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const int n = row / length;
  const int i = row - n * length;
  const size_t base = static_cast<size_t>(row) * heads * kDh;
  for (int h = 0; h < heads; ++h) {
    const size_t c = base + h * kDh + lane;
    float acc = o[c] * dout[c];
    acc = fmaf(o[c + 32], dout[c + 32], acc);
    acc = warp_sum(acc);
    if (lane == 0) delta[(static_cast<size_t>(n) * heads + h) * length + i] = acc;
  }
}

// Dynamic shared memory: k_s[L][kPitch] | v_s[L][kPitch] |
// q_w[kWarps][kQRows][kDh] | do_w[kWarps][kQRows][kDh] | ds_w[kWarps][kQRows][L]
__global__ void __launch_bounds__(32 * kWarps)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int32_t* __restrict__ streams, float* __restrict__ dq,
          int length, int heads, int pack, float scale, bool dropout,
          uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  const int d_model = heads * kDh;
  float* k_s = smem;
  float* v_s = k_s + static_cast<size_t>(length) * kPitch;
  float* q_w = v_s + static_cast<size_t>(length) * kPitch;
  float* do_w = q_w + kWarps * kQRows * kDh;
  float* ds_w = do_w + kWarps * kQRows * kDh;

  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int q_end = min(q0 + kTile, length);
  const size_t base = static_cast<size_t>(n) * length * d_model + head * kDh;
  load_head(k_s, k, base, length, d_model);
  load_head(v_s, v, base, length, d_model);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qw = q_w + warp * kQRows * kDh;
  float* dow = do_w + warp * kQRows * kDh;
  float* dsw = ds_w + static_cast<size_t>(warp) * kQRows * length;
  const int groups = heads / pack;
  const uint32_t ncols = static_cast<uint32_t>(pack) * length;
  const uint32_t col0 = static_cast<uint32_t>(head % pack) * length;
  const uint32_t key =
      dropout ? rlt::stream_key(rlt::group_stream(streams[n], head / pack)) : 0u;
  const float* lse_h = lse + static_cast<size_t>(n) * groups * length * pack +
                       static_cast<size_t>(head / pack) * length * pack + head % pack;
  const float* delta_h = delta + (static_cast<size_t>(n) * heads + head) * length;

  for (int r0 = q0 + warp * kQRows; r0 < q_end; r0 += kWarps * kQRows) {
    const int nr = min(kQRows, q_end - r0);
    for (int i = lane; i < kQRows * kDh; i += 32) {
      const int r = i / kDh;
      const int d = i - r * kDh;
      const size_t src = base + static_cast<size_t>(r0 + r) * d_model + d;
      qw[i] = r < nr ? q[src] : 0.0f;
      dow[i] = r < nr ? dout[src] : 0.0f;
    }
    float lse_r[kQRows], delta_r[kQRows];
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      lse_r[r] = r < nr ? lse_h[static_cast<size_t>(r0 + r) * pack] : 0.0f;
      delta_r[r] = r < nr ? delta_h[r0 + r] : 0.0f;
    }
    __syncwarp();

    // ds for the warp's rows, lanes over keys
    for (int j = lane; j < length; j += 32) {
      float s[kQRows] = {};
      float dp[kQRows] = {};
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * kPitch);
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * kPitch);
#pragma unroll 4
      for (int d4 = 0; d4 < kDh / 4; ++d4) {
        const float4 kk = kr[d4];
        const float4 vv = vr[d4];
#pragma unroll
        for (int r = 0; r < kQRows; ++r) {
          const float4 qq = reinterpret_cast<const float4*>(qw + r * kDh)[d4];
          const float4 gg = reinterpret_cast<const float4*>(dow + r * kDh)[d4];
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
          dp[r] = fmaf(gg.x, vv.x, dp[r]);
          dp[r] = fmaf(gg.y, vv.y, dp[r]);
          dp[r] = fmaf(gg.z, vv.z, dp[r]);
          dp[r] = fmaf(gg.w, vv.w, dp[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kQRows; ++r) {
        const float p = expf(s[r] * scale - lse_r[r]);
        float g = dp[r];
        if (dropout) {
          const uint32_t index = static_cast<uint32_t>(r0 + r) * ncols + col0 + j;
          g = rlt::keep_element(index, key, threshold) ? g * inv_keep : 0.0f;
        }
        dsw[r * length + j] = p * (g - delta_r[r]) * scale;
      }
    }
    __syncwarp();

    // dq = ds K, lanes over output columns lane, lane + 32
    float a0[kQRows] = {};
    float a1[kQRows] = {};
    for (int j = 0; j < length; ++j) {
      const float k0 = k_s[j * kPitch + lane];
      const float k1 = k_s[j * kPitch + lane + 32];
#pragma unroll
      for (int r = 0; r < kQRows; ++r) {
        const float ds = dsw[r * length + j];
        a0[r] = fmaf(ds, k0, a0[r]);
        a1[r] = fmaf(ds, k1, a1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      if (r < nr) {
        const size_t out = base + static_cast<size_t>(r0 + r) * d_model;
        dq[out + lane] = a0[r];
        dq[out + lane + 32] = a1[r];
      }
    }
    __syncwarp();
  }
}

// Dynamic shared memory: q_s[L][kPitch] | do_s[L][kPitch] | lse_s[Lp] |
// delta_s[Lp] (Lp = L rounded up to 4) | k_w[kWarps][kKRows][kDh] | v_w[kWarps][kKRows][kDh] |
// ds_w[kWarps][kKRows][L] | pd_w[kWarps][kKRows][L]
__global__ void __launch_bounds__(32 * kWarps)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int32_t* __restrict__ streams, float* __restrict__ dk,
           float* __restrict__ dv, int length, int heads, int pack,
           float scale, bool dropout, uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  const int d_model = heads * kDh;
  float* q_s = smem;
  float* do_s = q_s + static_cast<size_t>(length) * kPitch;
  float* lse_s = do_s + static_cast<size_t>(length) * kPitch;
  const int lp = padded4(length);
  float* delta_s = lse_s + lp;
  float* k_w = delta_s + lp;
  float* v_w = k_w + kWarps * kKRows * kDh;
  float* ds_w = v_w + kWarps * kKRows * kDh;
  float* pd_w = ds_w + static_cast<size_t>(kWarps) * kKRows * length;

  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int k_end = min(k0 + kTile, length);
  const size_t base = static_cast<size_t>(n) * length * d_model + head * kDh;
  const int groups = heads / pack;
  load_head(q_s, q, base, length, d_model);
  load_head(do_s, dout, base, length, d_model);
  const float* lse_h = lse + static_cast<size_t>(n) * groups * length * pack +
                       static_cast<size_t>(head / pack) * length * pack + head % pack;
  const float* delta_h = delta + (static_cast<size_t>(n) * heads + head) * length;
  for (int i = threadIdx.x; i < length; i += blockDim.x) {
    lse_s[i] = lse_h[static_cast<size_t>(i) * pack];
    delta_s[i] = delta_h[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* kw = k_w + warp * kKRows * kDh;
  float* vw = v_w + warp * kKRows * kDh;
  float* dsw = ds_w + static_cast<size_t>(warp) * kKRows * length;
  float* pdw = pd_w + static_cast<size_t>(warp) * kKRows * length;
  const uint32_t ncols = static_cast<uint32_t>(pack) * length;
  const uint32_t col0 = static_cast<uint32_t>(head % pack) * length;
  const uint32_t key =
      dropout ? rlt::stream_key(rlt::group_stream(streams[n], head / pack)) : 0u;

  for (int j0 = k0 + warp * kKRows; j0 < k_end; j0 += kWarps * kKRows) {
    const int nr = min(kKRows, k_end - j0);
    for (int i = lane; i < kKRows * kDh; i += 32) {
      const int r = i / kDh;
      const int d = i - r * kDh;
      const size_t src = base + static_cast<size_t>(j0 + r) * d_model + d;
      kw[i] = r < nr ? k[src] : 0.0f;
      vw[i] = r < nr ? v[src] : 0.0f;
    }
    __syncwarp();

    // ds and pd for the warp's key rows, lanes over queries
    for (int i = lane; i < length; i += 32) {
      float s[kKRows] = {};
      float dp[kKRows] = {};
      const float4* qr = reinterpret_cast<const float4*>(q_s + i * kPitch);
      const float4* gr = reinterpret_cast<const float4*>(do_s + i * kPitch);
#pragma unroll 4
      for (int d4 = 0; d4 < kDh / 4; ++d4) {
        const float4 qq = qr[d4];
        const float4 gg = gr[d4];
#pragma unroll
        for (int r = 0; r < kKRows; ++r) {
          const float4 kk = reinterpret_cast<const float4*>(kw + r * kDh)[d4];
          const float4 vv = reinterpret_cast<const float4*>(vw + r * kDh)[d4];
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
          dp[r] = fmaf(gg.x, vv.x, dp[r]);
          dp[r] = fmaf(gg.y, vv.y, dp[r]);
          dp[r] = fmaf(gg.z, vv.z, dp[r]);
          dp[r] = fmaf(gg.w, vv.w, dp[r]);
        }
      }
      const float lse_i = lse_s[i];
      const float delta_i = delta_s[i];
#pragma unroll
      for (int r = 0; r < kKRows; ++r) {
        const float p = expf(s[r] * scale - lse_i);
        float pd = p;
        float g = dp[r];
        if (dropout) {
          const uint32_t index = static_cast<uint32_t>(i) * ncols + col0 + j0 + r;
          const bool keep = rlt::keep_element(index, key, threshold);
          pd = keep ? p * inv_keep : 0.0f;
          g = keep ? g * inv_keep : 0.0f;
        }
        dsw[r * length + i] = p * (g - delta_i) * scale;
        pdw[r * length + i] = pd;
      }
    }
    __syncwarp();

    // dk = ds^T Q and dv = pd^T dO, lanes over output columns
    float k_a0[kKRows] = {}, k_a1[kKRows] = {};
    float v_a0[kKRows] = {}, v_a1[kKRows] = {};
    for (int i = 0; i < length; ++i) {
      const float q0v = q_s[i * kPitch + lane];
      const float q1v = q_s[i * kPitch + lane + 32];
      const float g0 = do_s[i * kPitch + lane];
      const float g1 = do_s[i * kPitch + lane + 32];
#pragma unroll
      for (int r = 0; r < kKRows; ++r) {
        const float ds = dsw[r * length + i];
        const float pd = pdw[r * length + i];
        k_a0[r] = fmaf(ds, q0v, k_a0[r]);
        k_a1[r] = fmaf(ds, q1v, k_a1[r]);
        v_a0[r] = fmaf(pd, g0, v_a0[r]);
        v_a1[r] = fmaf(pd, g1, v_a1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kKRows; ++r) {
      if (r < nr) {
        const size_t out = base + static_cast<size_t>(j0 + r) * d_model;
        dk[out + lane] = k_a0[r];
        dk[out + lane + 32] = k_a1[r];
        dv[out + lane] = v_a0[r];
        dv[out + lane + 32] = v_a1[r];
      }
    }
    __syncwarp();
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv (N, L, D) with D = heads * 64, lse
// (N, heads / pack, L, pack), delta an (N, heads, L) scratch array:
// contiguous float32 device arrays, the (N, L, D) ones 16-byte aligned.
// With rate > 0, `streams` holds K5''s N int32 dropout streams and
// `threshold` its keep threshold. Launches its three kernels on `stream` and
// returns the first error.
extern "C" int rlt_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* streams, void* dq, void* dk,
    void* dv, void* delta, int n, int length, int heads, int pack, float rate,
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
  const size_t dq_smem = dq_smem_bytes(length);
  const size_t dkv_smem = dkv_smem_bytes(length);
  if (dq_smem > static_cast<size_t>(max_smem) ||
      dkv_smem > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = n * length;
  delta_kernel<<<(rows + kDeltaWarps - 1) / kDeltaWarps, 32 * kDeltaWarps, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<float*>(delta), rows, length, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  const bool dropout = rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const dim3 grid((length + kTile - 1) / kTile, heads, n);
  dq_kernel<<<grid, 32 * kWarps, dq_smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(streams), static_cast<float*>(dq), length,
      heads, pack, scale, dropout, threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<grid, 32 * kWarps, dkv_smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(streams), static_cast<float*>(dk),
      static_cast<float*>(dv), length, heads, pack, scale, dropout, threshold,
      inv_keep);
  return static_cast<int>(cudaGetLastError());
}
