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
// What bounds it on an H100: operations, 7 L x L x 64 products per head
// in this two-pass design (s and dp in both passes, then dq, dk and dv)
// against 8 N L D floats of traffic. They run on the tensor cores as
// mma.sync m16n8k8 tf32 in the 3xTF32 split of attention_mma.cuh, which
// keeps the 1e-5 agreement with the plain f32 version.
//
// Design, deterministic and without atomics: two kernels of 4 warps, each
// warp taking 16 of the block's 64 rows. The block's own rows of two
// operands sit in shared memory while the other operands stream through a
// two-stage ring of 64-row tiles, all with row pitch 68 and filled by
// cp.async, so the next tile's copy runs under this tile's products. Each
// kernel works through a streamed tile in halves of 32 rows, and adds each
// tile's (or half's) product to its running gradient from a fresh
// accumulator (attention_mma.cuh).
//  1. dq_kernel: one block per (n, head, 64 query rows) holds Q and dO,
//     takes delta = rowsum(do * o) of its rows and writes it for the second
//     pass, then streams K and V tiles: S = Q K^T and dP = dO V^T, ds in
//     registers, dQ += ds K (ds fed from the accumulator as A).
//  2. dkv_kernel: one block per (n, head, 64 key rows) holds K and V and
//     streams tiles of Q and dO with their lse and delta: S^T = K Q^T and
//     dP^T = V dO^T, then ds^T and pd^T in registers, dV += pd^T dO and
//     dK += ds^T Q.
// Every output element is summed by one thread in a fixed order, so two
// launches on the same inputs give the same bits. Shared memory (102 and 103
// KiB, two blocks per SM) does not grow with L; any 1 <= L <= 65535 is
// taken. The held rows are split at each use rather than kept split in
// registers: kept there, they took ptxas to 255 registers a thread with
// 192 (dq) and 328 (dk/dv) bytes of spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "keep_mask.cuh"

namespace {

using rlt::kPackedDh;
using rlt::kPackedPitch;
using rlt::kPackedThreads;
using rlt::kPackedTile;
using rlt::kPackedTileFloats;
using rlt::Split;
using rlt::add_part;

constexpr int kStages = 2;
constexpr int kHalf = kPackedTile / 2;  // rows of a tile taken at once
// dq_kernel: q_s | do_s | delta_s[64], then kStages x (k_t | v_t)
constexpr int kDqHeld = 2 * kPackedTileFloats + kPackedTile;
constexpr size_t kDqSmem = sizeof(float) * (kDqHeld + kStages * 2 * kPackedTileFloats);
// dkv_kernel: k_s | v_s, then kStages x (q_t | do_t | lse_t[64] | delta_t[64])
constexpr int kDkvStage = 2 * kPackedTileFloats + 2 * kPackedTile;
constexpr size_t kDkvSmem = sizeof(float) * (2 * kPackedTileFloats + kStages * kDkvStage);
static_assert(kDqHeld % 4 == 0 && kDkvStage % 4 == 0, "tiles stay 16-byte aligned");

// the lse of head `head`'s row 0 in K5''s (N, groups, L, pack) layout; row i
// is i * pack further
__device__ __forceinline__ const float* head_lse(const float* lse, int n, int head,
                                                 int heads, int pack, int length) {
  return lse + (static_cast<size_t>(n) * (heads / pack) + head / pack) * length * pack +
         head % pack;
}

// Dynamic shared memory: q_s[64][kPackedPitch] | do_s[64][kPackedPitch] |
// delta_s[64] | kStages x (k_t[64][kPackedPitch] | v_t[64][kPackedPitch])
__global__ void __launch_bounds__(kPackedThreads, 2)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const int32_t* __restrict__ streams, float* __restrict__ dq,
          float* __restrict__ delta, int length, int heads, int pack, float scale,
          bool dropout, uint32_t threshold, float inv_keep) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kPackedTileFloats;
  float* delta_s = do_s + kPackedTileFloats;
  float* smem = q_s + kDqHeld;

  const int d_model = heads * kPackedDh;
  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int w16 = (threadIdx.x / 32) * 16;  // the warp's rows in the block's tile
  const int q0 = blockIdx.x * kPackedTile;
  const int r0 = q0 + w16;
  const size_t base = static_cast<size_t>(n) * length * d_model + head * kPackedDh;
  const int tiles = (length + kPackedTile - 1) / kPackedTile;

  rlt::load_tile_async(q_s, q + base, q0, length, d_model);
  rlt::load_tile_async(do_s, dout + base, q0, length, d_model);
  rlt::cp_async_commit();
  rlt::load_tile_async(smem, k + base, 0, length, d_model);
  rlt::load_tile_async(smem + kPackedTileFloats, v + base, 0, length, d_model);
  rlt::cp_async_commit();

  // delta of the block's rows: two threads per row, 32 columns each
  rlt::cp_async_wait<1>();
  __syncthreads();
  {
    const int i = threadIdx.x / 2;
    const int c0 = (threadIdx.x % 2) * 32;
    const bool valid = q0 + i < length;
    float part = 0.0f;
    if (valid) {
      const float4* orow =
          reinterpret_cast<const float4*>(o + base + static_cast<size_t>(q0 + i) * d_model + c0);
      const float4* grow = reinterpret_cast<const float4*>(do_s + i * kPackedPitch + c0);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 a = orow[c];
        const float4 b = grow[c];
        part = fmaf(a.x, b.x, part);
        part = fmaf(a.y, b.y, part);
        part = fmaf(a.z, b.z, part);
        part = fmaf(a.w, b.w, part);
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
    const float* lse_h = head_lse(lse, n, head, heads, pack, length);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      delta_r[r] = delta_s[w16 + g + 8 * r];
      lse_r[r] = row < length ? lse_h[static_cast<size_t>(row) * pack] : 0.0f;
    }
  }

  const uint32_t ncols = static_cast<uint32_t>(pack) * length;
  const uint32_t col0 = static_cast<uint32_t>(head % pack) * length;
  const uint32_t key =
      dropout ? rlt::stream_key(rlt::group_stream(streams[n], head / pack)) : 0u;
  float acc[8][4] = {}, part[8][4] = {};

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      float* next = smem + ((it + 1) % kStages) * 2 * kPackedTileFloats;
      rlt::load_tile_async(next, k + base, (it + 1) * kPackedTile, length, d_model);
      rlt::load_tile_async(next + kPackedTileFloats, v + base, (it + 1) * kPackedTile,
                           length, d_model);
      rlt::cp_async_commit();
      rlt::cp_async_wait<1>();
    } else {
      rlt::cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_t = smem + (it % kStages) * 2 * kPackedTileFloats;
    const float* v_t = k_t + kPackedTileFloats;

    for (int h0 = 0; h0 < kPackedTile; h0 += kHalf) {
      // S = Q K^T and dP = dO V^T over keys h0.. of the tile
      float s[4][4] = {}, dp[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        Split qa[4], ga[4];
        rlt::split_a_tile(qa, q_s, w16, kk, g, t);
        rlt::split_a_tile(ga, do_s, w16, kk, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          rlt::mma3_b_rows(s[j], qa, k_t, h0 + 8 * j, 8 * kk, g, t);
          rlt::mma3_b_rows(dp[j], ga, v_t, h0 + 8 * j, 8 * kk, g, t);
        }
      }
      // ds, in place of s (keys past L have p = 0)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = it * kPackedTile + h0 + 8 * j + 2 * t + (e & 1);
          const float p = col < length ? expf(s[j][e] * scale - lse_r[r]) : 0.0f;
          float gg = dp[j][e];
          if (dropout) {
            const uint32_t index =
                static_cast<uint32_t>(r0 + g + 8 * r) * ncols + col0 + col;
            gg = rlt::keep_element(index, key, threshold) ? gg * inv_keep : 0.0f;
          }
          s[j][e] = p * (gg - delta_r[r]) * scale;
        }
      }
      // the tile's ds K over those keys
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Split da[4];
        rlt::split_acc(s[kk], da);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rlt::mma3_b_perm(part[j], da, k_t, h0 + 8 * kk, 8 * j, g, t);
      }
    }
    add_part(acc, part);
    __syncthreads();  // the stage is consumed before the next copy into it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < length) {
      float* out = dq + base + static_cast<size_t>(row) * d_model + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// Start copying query rows [row0, row0 + 64) of Q, dO, lse and delta into
// one stage of dkv_kernel; rows at or past `length` become zeros.
__device__ __forceinline__ void load_dkv_stage(float* stage, const float* q_h,
                                               const float* do_h, const float* lse_h,
                                               const float* delta_h, int row0, int length,
                                               int d_model, int pack) {
  rlt::load_tile_async(stage, q_h, row0, length, d_model);
  rlt::load_tile_async(stage + kPackedTileFloats, do_h, row0, length, d_model);
  float* lse_t = stage + 2 * kPackedTileFloats;
  const int i = threadIdx.x % kPackedTile;
  const int row = row0 + i;
  const bool valid = row < length;
  if (threadIdx.x < kPackedTile)
    rlt::cp_async4(lse_t + i, lse_h + static_cast<size_t>(valid ? row : 0) * pack, valid);
  else
    rlt::cp_async4(lse_t + kPackedTile + i, delta_h + (valid ? row : 0), valid);
}

// Dynamic shared memory: k_s[64][kPackedPitch] | v_s[64][kPackedPitch] |
// kStages x (q_t[64][kPackedPitch] | do_t[64][kPackedPitch] | lse_t[64] | delta_t[64])
__global__ void __launch_bounds__(kPackedThreads, 2)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int32_t* __restrict__ streams, float* __restrict__ dk,
           float* __restrict__ dv, int length, int heads, int pack, float scale,
           bool dropout, uint32_t threshold, float inv_keep) {
  static_assert(kPackedThreads == 2 * kPackedTile, "one thread per lse and delta float");
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kPackedTileFloats;
  float* smem = v_s + kPackedTileFloats;

  const int d_model = heads * kPackedDh;
  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int w16 = (threadIdx.x / 32) * 16;
  const int k0 = blockIdx.x * kPackedTile + w16;  // the warp's first key row
  const size_t base = static_cast<size_t>(n) * length * d_model + head * kPackedDh;
  const int tiles = (length + kPackedTile - 1) / kPackedTile;
  const float* lse_h = head_lse(lse, n, head, heads, pack, length);
  const float* delta_h = delta + (static_cast<size_t>(n) * heads + head) * length;

  rlt::load_tile_async(k_s, k + base, blockIdx.x * kPackedTile, length, d_model);
  rlt::load_tile_async(v_s, v + base, blockIdx.x * kPackedTile, length, d_model);
  load_dkv_stage(smem, q + base, dout + base, lse_h, delta_h, 0, length, d_model, pack);
  rlt::cp_async_commit();

  const uint32_t ncols = static_cast<uint32_t>(pack) * length;
  const uint32_t col0 = static_cast<uint32_t>(head % pack) * length;
  const uint32_t key =
      dropout ? rlt::stream_key(rlt::group_stream(streams[n], head / pack)) : 0u;
  float dk_acc[8][4] = {}, dv_acc[8][4] = {}, part[8][4] = {};

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      load_dkv_stage(smem + ((it + 1) % kStages) * kDkvStage, q + base, dout + base,
                     lse_h, delta_h, (it + 1) * kPackedTile, length, d_model, pack);
      rlt::cp_async_commit();
      rlt::cp_async_wait<1>();
    } else {
      rlt::cp_async_wait<0>();
    }
    __syncthreads();
    const float* q_t = smem + (it % kStages) * kDkvStage;
    const float* do_t = q_t + kPackedTileFloats;
    const float* lse_t = do_t + kPackedTileFloats;
    const float* delta_t = lse_t + kPackedTile;

    for (int h0 = 0; h0 < kPackedTile; h0 += kHalf) {
      // S^T = K Q^T and dP^T = V dO^T over queries h0.. of the tile
      float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        Split ka[4], va[4];
        rlt::split_a_tile(ka, k_s, w16, kk, g, t);
        rlt::split_a_tile(va, v_s, w16, kk, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          rlt::mma3_b_rows(st[j], ka, q_t, h0 + 8 * j, 8 * kk, g, t);
          rlt::mma3_b_rows(dpt[j], va, do_t, h0 + 8 * j, 8 * kk, g, t);
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
            const bool keep = rlt::keep_element(index, key, threshold);
            pd = keep ? p * inv_keep : 0.0f;
            gg = keep ? gg * inv_keep : 0.0f;
          }
          st[j][e] = p * (gg - delta_t[qi]) * scale;
          dpt[j][e] = pd;
        }
      }
      // dV += pd^T dO, then dK += ds^T Q, over those queries
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Split pa[4];
        rlt::split_acc(dpt[kk], pa);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rlt::mma3_b_perm(part[j], pa, do_t, h0 + 8 * kk, 8 * j, g, t);
      }
      add_part(dv_acc, part);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Split da[4];
        rlt::split_acc(st[kk], da);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rlt::mma3_b_perm(part[j], da, q_t, h0 + 8 * kk, 8 * j, g, t);
      }
      add_part(dk_acc, part);
    }
    __syncthreads();  // the stage is consumed before the next copy into it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + g + 8 * r;
    if (row < length) {
      const size_t out = base + static_cast<size_t>(row) * d_model + 2 * t;
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

// q, k, v, o, dout, dq, dk, dv (N, L, D) with D = heads * 64, lse
// (N, heads / pack, L, pack), delta an (N, heads, L) scratch array:
// contiguous float32 device arrays, the (N, L, D) ones 16-byte aligned.
// With rate > 0, `streams` holds K5''s N int32 dropout streams and
// `threshold` its keep threshold. Takes 1 <= L <= 65535. Launches its two
// kernels on `stream` and returns the first error.
extern "C" int rlt_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* streams, void* dq, void* dk,
    void* dv, void* delta, int n, int length, int heads, int pack, float rate,
    unsigned int threshold, void* stream) {
  if (n < 1 || length < 1 || heads < 1 || pack < 1 || heads % pack != 0 ||
      n > 65535 || length > 65535 || heads > 65535 ||
      !(rate >= 0.0f && rate < 1.0f) || (rate > 0.0f && streams == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDqSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(static_cast<float>(kPackedDh));
  const bool dropout = rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const dim3 grid((length + kPackedTile - 1) / kPackedTile, heads, n);
  dq_kernel<<<grid, kPackedThreads, kDqSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const int32_t*>(streams), static_cast<float*>(dq),
      static_cast<float*>(delta), length, heads, pack, scale, dropout, threshold,
      inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<grid, kPackedThreads, kDkvSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(streams), static_cast<float*>(dk),
      static_cast<float*>(dv), length, heads, pack, scale, dropout, threshold,
      inv_keep);
  return static_cast<int>(cudaGetLastError());
}
