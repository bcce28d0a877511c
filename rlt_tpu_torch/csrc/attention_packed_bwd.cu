// K6' attention_packed_bwd: head-packed self-attention backward, float32
// (this file's kernels) and bf16, behind rlt_attention_packed_bwd_bf16:
// attention_bf16_bwd_wgmma.cuh's TMA and wgmma kernels at dh = 64,
// attention_bf16_dh16.cuh's at dh = 16.
//
// Replaces rlt_tpu/ops/attention.py::_attn_bwd_packed_kernel (run through
// _bwd_packed and the custom_vjp of fused_attention_packed). q, k, v, o and
// the incoming gradient do are (N, L, D) in the raw in_proj layout, head h
// at columns [h*dh, (h+1)*dh), dh = 64 or 16 (one instance of each kernel
// per width, as K5'); lse is K5''s (N, groups, L, pack). Per head,
// flash-style, recomputing the probabilities instead of storing them:
//   p = exp(s * scale - lse)          s = q k^T, the pre-dropout softmax
//   dp = do v^T, and with dropout pd = keep ? p / (1 - rate) : 0,
//                                 dp = keep ? dp / (1 - rate) : 0
//   delta = rowsum(do * o) over the head's dh columns
//   ds = p (dp - delta) scale
//   dq = ds k,  dk = ds^T q,  dv = pd^T do
// The keep mask is K5''s (keep_mask.cuh), regenerated from the same streams.
//
// What bounds it on an H100: operations, 7 L x L x dh products per head
// in this two-pass design (s and dp in both passes, then dq, dk and dv)
// against 8 N L D floats of traffic. They run on the tensor cores as
// mma.sync m16n8k8 tf32 in the 3xTF32 split of attention_mma.cuh, which
// keeps the 1e-5 agreement with the plain f32 version. At dh = 16 the
// elementwise work per score (exp, the mask hash, ds) weighs four times as
// much against the products as at dh = 64.
//
// Design, deterministic and without atomics: two kernels of 4 warps, each
// warp taking 16 of the block's 64 rows. The block's own rows of two
// operands sit in shared memory while the other operands stream through a
// two-stage ring of 64-row tiles, all with row pitch dh + 4 and filled by
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
// KiB at dh = 64, two blocks per SM; 30 and 31 KiB at dh = 16, four,
// PackedShape::kMinBlocks) does not grow with L; any 1 <= L <= 65535 is
// taken. The held rows are split at each use rather than kept split in
// registers: kept there, at dh = 64 they took ptxas to 255 registers a
// thread with 192 (dq) and 328 (dk/dv) bytes of spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16_bwd_wgmma.cuh"
#include "attention_bf16_dh16.cuh"
#include "attention_mma.cuh"
#include "keep_mask.cuh"

namespace {

using rlt::kPackedThreads;
using rlt::kPackedTile;
using rlt::Split;
using rlt::add_part;

constexpr int kStages = 2;
constexpr int kHalf = kPackedTile / 2;  // rows of a tile taken at once

// Shared-memory layout of both kernels at head width kDh
template <int kDh>
struct BwdLayout {
  static constexpr int kTileFloats = rlt::PackedShape<kDh>::kTileFloats;
  // dq_kernel: q_s | do_s | delta_s[64], then kStages x (k_t | v_t)
  static constexpr int kDqHeld = 2 * kTileFloats + kPackedTile;
  static constexpr size_t kDqSmem = sizeof(float) * (kDqHeld + kStages * 2 * kTileFloats);
  // dkv_kernel: k_s | v_s, then kStages x (q_t | do_t | lse_t[64] | delta_t[64])
  static constexpr int kDkvStage = 2 * kTileFloats + 2 * kPackedTile;
  static constexpr size_t kDkvSmem = sizeof(float) * (2 * kTileFloats + kStages * kDkvStage);
  static_assert(kDqHeld % 4 == 0 && kDkvStage % 4 == 0, "tiles stay 16-byte aligned");
};

// the lse of head `head`'s row 0 in K5''s (N, groups, L, pack) layout; row i
// is i * pack further
__device__ __forceinline__ const float* head_lse(const float* lse, int n, int head,
                                                 int heads, int pack, int length) {
  return lse + (static_cast<size_t>(n) * (heads / pack) + head / pack) * length * pack +
         head % pack;
}

// Dynamic shared memory: q_s[64][kPitch] | do_s[64][kPitch] | delta_s[64] |
// kStages x (k_t[64][kPitch] | v_t[64][kPitch])
template <int kDh, int kMinBlocks>
__global__ void __launch_bounds__(kPackedThreads, kMinBlocks)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const int32_t* __restrict__ streams, float* __restrict__ dq,
          float* __restrict__ delta, int length, int heads, int pack, float scale,
          const rlt::Dropout drop) {
  using Shape = rlt::PackedShape<kDh>;
  constexpr int kPitch = Shape::kPitch;
  constexpr int kTileFloats = Shape::kTileFloats;
  constexpr int kCols = Shape::kCols;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTileFloats;
  float* delta_s = do_s + kTileFloats;
  float* smem = q_s + BwdLayout<kDh>::kDqHeld;

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

  rlt::load_tile_async<kDh>(q_s, q + base, q0, length, d_model);
  rlt::load_tile_async<kDh>(do_s, dout + base, q0, length, d_model);
  rlt::cp_async_commit();
  rlt::load_tile_async<kDh>(smem, k + base, 0, length, d_model);
  rlt::load_tile_async<kDh>(smem + kTileFloats, v + base, 0, length, d_model);
  rlt::cp_async_commit();

  // delta of the block's rows: two threads per row, dh / 2 columns each
  rlt::cp_async_wait<1>();
  __syncthreads();
  {
    const int i = threadIdx.x / 2;
    const int c0 = (threadIdx.x % 2) * (kDh / 2);
    const bool valid = q0 + i < length;
    float part = 0.0f;
    if (valid) {
      const float4* orow =
          reinterpret_cast<const float4*>(o + base + static_cast<size_t>(q0 + i) * d_model + c0);
      const float4* grow = reinterpret_cast<const float4*>(do_s + i * kPitch + c0);
#pragma unroll
      for (int c = 0; c < kDh / 8; ++c) {
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
  const bool dropout = drop.on();
  const uint32_t key =
      dropout ? rlt::stream_key(rlt::group_stream(streams[n], head / pack)) : 0u;
  const uint32_t limit = drop.limit(n);
  const float inv_keep = drop.scale_of(n);
  float acc[kCols][4] = {}, part[kCols][4] = {};

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      float* next = smem + ((it + 1) % kStages) * 2 * kTileFloats;
      rlt::load_tile_async<kDh>(next, k + base, (it + 1) * kPackedTile, length, d_model);
      rlt::load_tile_async<kDh>(next + kTileFloats, v + base, (it + 1) * kPackedTile,
                                length, d_model);
      rlt::cp_async_commit();
      rlt::cp_async_wait<1>();
    } else {
      rlt::cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_t = smem + (it % kStages) * 2 * kTileFloats;
    const float* v_t = k_t + kTileFloats;

    for (int h0 = 0; h0 < kPackedTile; h0 += kHalf) {
      // S = Q K^T and dP = dO V^T over keys h0.. of the tile
      float s[4][4] = {}, dp[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kCols; ++kk) {
        Split qa[4], ga[4];
        rlt::split_a_tile<kPitch>(qa, q_s, w16, kk, g, t);
        rlt::split_a_tile<kPitch>(ga, do_s, w16, kk, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          rlt::mma3_b_rows<kPitch>(s[j], qa, k_t, h0 + 8 * j, 8 * kk, g, t);
          rlt::mma3_b_rows<kPitch>(dp[j], ga, v_t, h0 + 8 * j, 8 * kk, g, t);
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
            gg = rlt::keep_element(index, key, limit) ? gg * inv_keep : 0.0f;
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
        for (int j = 0; j < kCols; ++j)
          rlt::mma3_b_perm<kPitch>(part[j], da, k_t, h0 + 8 * kk, 8 * j, g, t);
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
      for (int j = 0; j < kCols; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// Start copying query rows [row0, row0 + 64) of Q, dO, lse and delta into
// one stage of dkv_kernel; rows at or past `length` become zeros.
template <int kDh>
__device__ __forceinline__ void load_dkv_stage(float* stage, const float* q_h,
                                               const float* do_h, const float* lse_h,
                                               const float* delta_h, int row0, int length,
                                               int d_model, int pack) {
  constexpr int kTileFloats = rlt::PackedShape<kDh>::kTileFloats;
  rlt::load_tile_async<kDh>(stage, q_h, row0, length, d_model);
  rlt::load_tile_async<kDh>(stage + kTileFloats, do_h, row0, length, d_model);
  float* lse_t = stage + 2 * kTileFloats;
  const int i = threadIdx.x % kPackedTile;
  const int row = row0 + i;
  const bool valid = row < length;
  if (threadIdx.x < kPackedTile)
    rlt::cp_async4(lse_t + i, lse_h + static_cast<size_t>(valid ? row : 0) * pack, valid);
  else
    rlt::cp_async4(lse_t + kPackedTile + i, delta_h + (valid ? row : 0), valid);
}

// Dynamic shared memory: k_s[64][kPitch] | v_s[64][kPitch] |
// kStages x (q_t[64][kPitch] | do_t[64][kPitch] | lse_t[64] | delta_t[64])
template <int kDh, int kMinBlocks>
__global__ void __launch_bounds__(kPackedThreads, kMinBlocks)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int32_t* __restrict__ streams, float* __restrict__ dk,
           float* __restrict__ dv, int length, int heads, int pack, float scale,
           const rlt::Dropout drop) {
  static_assert(kPackedThreads == 2 * kPackedTile, "one thread per lse and delta float");
  using Shape = rlt::PackedShape<kDh>;
  constexpr int kPitch = Shape::kPitch;
  constexpr int kTileFloats = Shape::kTileFloats;
  constexpr int kCols = Shape::kCols;
  constexpr int kDkvStage = BwdLayout<kDh>::kDkvStage;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kTileFloats;
  float* smem = v_s + kTileFloats;

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
  const float* lse_h = head_lse(lse, n, head, heads, pack, length);
  const float* delta_h = delta + (static_cast<size_t>(n) * heads + head) * length;

  rlt::load_tile_async<kDh>(k_s, k + base, blockIdx.x * kPackedTile, length, d_model);
  rlt::load_tile_async<kDh>(v_s, v + base, blockIdx.x * kPackedTile, length, d_model);
  load_dkv_stage<kDh>(smem, q + base, dout + base, lse_h, delta_h, 0, length, d_model, pack);
  rlt::cp_async_commit();

  const uint32_t ncols = static_cast<uint32_t>(pack) * length;
  const uint32_t col0 = static_cast<uint32_t>(head % pack) * length;
  const bool dropout = drop.on();
  const uint32_t key =
      dropout ? rlt::stream_key(rlt::group_stream(streams[n], head / pack)) : 0u;
  const uint32_t limit = drop.limit(n);
  const float inv_keep = drop.scale_of(n);
  float dk_acc[kCols][4] = {}, dv_acc[kCols][4] = {}, part[kCols][4] = {};

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      load_dkv_stage<kDh>(smem + ((it + 1) % kStages) * kDkvStage, q + base, dout + base,
                     lse_h, delta_h, (it + 1) * kPackedTile, length, d_model, pack);
      rlt::cp_async_commit();
      rlt::cp_async_wait<1>();
    } else {
      rlt::cp_async_wait<0>();
    }
    __syncthreads();
    const float* q_t = smem + (it % kStages) * kDkvStage;
    const float* do_t = q_t + kTileFloats;
    const float* lse_t = do_t + kTileFloats;
    const float* delta_t = lse_t + kPackedTile;

    for (int h0 = 0; h0 < kPackedTile; h0 += kHalf) {
      // S^T = K Q^T and dP^T = V dO^T over queries h0.. of the tile
      float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kCols; ++kk) {
        Split ka[4], va[4];
        rlt::split_a_tile<kPitch>(ka, k_s, w16, kk, g, t);
        rlt::split_a_tile<kPitch>(va, v_s, w16, kk, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          rlt::mma3_b_rows<kPitch>(st[j], ka, q_t, h0 + 8 * j, 8 * kk, g, t);
          rlt::mma3_b_rows<kPitch>(dpt[j], va, do_t, h0 + 8 * j, 8 * kk, g, t);
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
            const bool keep = rlt::keep_element(index, key, limit);
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
        for (int j = 0; j < kCols; ++j)
          rlt::mma3_b_perm<kPitch>(part[j], pa, do_t, h0 + 8 * kk, 8 * j, g, t);
      }
      add_part(dv_acc, part);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Split da[4];
        rlt::split_acc(st[kk], da);
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          rlt::mma3_b_perm<kPitch>(part[j], da, q_t, h0 + 8 * kk, 8 * j, g, t);
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
      for (int j = 0; j < kCols; ++j) {
        *reinterpret_cast<float2*>(dk + out + 8 * j) =
            make_float2(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
        *reinterpret_cast<float2*>(dv + out + 8 * j) =
            make_float2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      }
    }
  }
}

template <int kDh>
int launch_bwd(const float* q, const float* k, const float* v, const float* o,
               const float* dout, const float* lse, const int32_t* streams, float* dq,
               float* dk, float* dv, float* delta, int n, int length, int heads,
               int pack, const rlt::Dropout& drop, cudaStream_t s) {
  constexpr int kMinBlocks = rlt::PackedShape<kDh>::kMinBlocks;
  using Layout = BwdLayout<kDh>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<kDh, kMinBlocks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Layout::kDqSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel<kDh, kMinBlocks>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Layout::kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  const dim3 grid((length + kPackedTile - 1) / kPackedTile, heads, n);
  dq_kernel<kDh, kMinBlocks><<<grid, kPackedThreads, Layout::kDqSmem, s>>>(
      q, k, v, o, dout, lse, streams, dq, delta, length, heads, pack, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<kDh, kMinBlocks><<<grid, kPackedThreads, Layout::kDkvSmem, s>>>(
      q, k, v, dout, lse, delta, streams, dk, dv, length, heads, pack, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv (N, L, D) with D = heads * head_dim, head_dim
// 16 or 64, lse (N, heads / pack, L, pack), delta an (N, heads, L) scratch
// array: contiguous float32 device arrays, the (N, L, D) ones 16-byte
// aligned. With rate > 0, `streams` holds K5''s N int32 dropout streams and
// `threshold` its keep threshold; with `thresholds` and `scales`, K5''s
// per-row rates (rlt_attention_packed_fwd). Takes 1 <= L <= 65535; any other
// head width is refused with cudaErrorInvalidValue. Launches its two kernels
// on `stream` and returns the first error.
extern "C" int rlt_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* streams, const void* thresholds,
    const void* scales, void* dq, void* dk, void* dv, void* delta, int n, int length,
    int heads, int head_dim, int pack, float rate, unsigned int threshold,
    void* stream) {
  rlt::Dropout drop;
  if (n < 1 || length < 1 || heads < 1 || pack < 1 || heads % pack != 0 ||
      n > 65535 || length > 65535 || heads > 65535 ||
      !rlt::make_dropout(drop, rate, threshold, streams, thresholds, scales))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q_ = static_cast<const float*>(q);
  const auto* k_ = static_cast<const float*>(k);
  const auto* v_ = static_cast<const float*>(v);
  const auto* o_ = static_cast<const float*>(o);
  const auto* do_ = static_cast<const float*>(dout);
  const auto* lse_ = static_cast<const float*>(lse);
  const auto* s_ = static_cast<const int32_t*>(streams);
  auto* dq_ = static_cast<float*>(dq);
  auto* dk_ = static_cast<float*>(dk);
  auto* dv_ = static_cast<float*>(dv);
  auto* delta_ = static_cast<float*>(delta);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_bwd<16>(q_, k_, v_, o_, do_, lse_, s_, dq_, dk_, dv_, delta_, n,
                            length, heads, pack, drop, st);
    case 64:
      return launch_bwd<64>(q_, k_, v_, o_, do_, lse_, s_, dq_, dk_, dv_, delta_, n,
                            length, heads, pack, drop, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 instances: q, k, v, o, dout, dq, dk, dv (N, L, D) bf16 with
// D = heads * head_dim, head_dim 16 or 64, lse (N, heads / pack, L, pack) and
// the delta scratch (N, heads, L) float32, the rest as
// rlt_attention_packed_bwd. Launches its two kernels on `stream` and returns
// the first error.
extern "C" int rlt_attention_packed_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* streams, const void* thresholds,
    const void* scales, void* dq, void* dk, void* dv, void* delta, int n, int length,
    int heads, int head_dim, int pack, float rate, unsigned int threshold,
    void* stream) {
  rlt::Dropout drop;
  if (n < 1 || length < 1 || heads < 1 || pack < 1 || heads % pack != 0 ||
      n > 65535 || length > 65535 || heads > 65535 ||
      !rlt::make_dropout(drop, rate, threshold, streams, thresholds, scales))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return rlt::launch_attn_bwd_dh16(q, k, v, o, dout, lse, streams, dq, dk, dv, delta,
                                       n, length, heads, pack, drop, st);
    case 64:
      return rlt::launch_attn_bwd_wgmma<64>(q, k, v, o, dout, lse, streams, dq, dk, dv,
                                            delta, n, length, heads, pack, drop, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
