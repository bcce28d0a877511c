// K5' attention_packed_fwd: head-packed self-attention forward, float32
// (this file's kernel) and bf16 (behind rlt_attention_packed_fwd_bf16:
// attention_bf16_wgmma.cuh's at dh = 64, attention_bf16_dh16.cuh's at dh = 16).
//
// Replaces rlt_tpu/ops/attention.py::_attn_fwd_packed_kernel (run through
// _fwd_packed and fused_attention_packed). q, k, v are (N, L, D) in the raw
// in_proj layout, the heads contiguous in D: head h is columns
// [h*dh, (h+1)*dh), dh = 64 (MMOECut, MOECut, AttnCut, MtAttnCut: 4 heads,
// pack 2) or 16 (Choopy, MtChoopy: 8 heads in one group of pack 8), one
// instance of the kernel each. Per head: o_h = softmax(q_h k_h^T / sqrt(dh)) v_h, and
// lse_h = log sum_j exp(s_j) per query row, stored in the JAX layout
// (N, groups, L, pack) with head h at [h / pack, :, h % pack]. With a
// dropout rate above 0, the softmax weights are dropped by the keep mask of
// keep_mask.cuh (per-row stream, head group and column as in the TPU kernel)
// and the kept ones scaled by 1 / (1 - rate); lse stays the pre-dropout one.
// The rate is the launch's, or row n's own (keep_mask.cuh's Dropout).
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
// 4 heads) the arithmetic is 4 N H L^2 dh flops against 4 N L D floats of
// traffic, so operations bound it. The products run on the tensor cores as
// mma.sync m16n8k8 tf32 in the 3xTF32 split of attention_mma.cuh, three
// tf32 products per f32 product, which keeps the 1e-5 agreement with the
// plain f32 version that one tf32 product would miss. At dh = 16 a score
// costs a quarter of the products it costs at dh = 64 but the same exp, max,
// sum and dropout hash, so that elementwise work, which no roofline of
// products counts, is likely to set the pace there.
//
// Design: one block of 4 warps per (row n, head h, 64 query rows), each
// warp 16 of the rows. The block's Q tile sits in shared memory, and K and V
// stream through a two-stage ring of 64-key tiles, all with row pitch dh + 4
// (PackedShape) and filled by cp.async, so the next tile's copy runs under this tile's
// products. Per tile a warp takes S = Q K^T (16 x 64) into registers, masks
// keys past L with -inf, raises its running row max (kept per head, as K3'
// does) and rescales its running sum, and turns S into the weights
// exp(s - m) (dropped and scaled where the mask says, after the sum is
// taken). These feed P V as A fragments straight from the accumulator
// (attention_mma.cuh); the tile's P V, taken in a fresh accumulator, is
// added to the rescaled running O. At the end o = O / sum and lse = m +
// log(sum). The block's shared memory (85 KiB at dh = 64, 25 KiB at
// dh = 16) does not grow with L, and any 1 <= L <= 65535 is taken. At
// dh = 64 two blocks share an SM; Q's fragments are split at each use rather
// than held split in registers: held, they made ptxas spill 104 bytes a
// thread at three blocks per SM. At dh = 16 a block needs a quarter of the
// shared memory, so PackedShape::kMinBlocks asks ptxas for four blocks per
// SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16_dh16.cuh"
#include "attention_bf16_wgmma.cuh"
#include "attention_mma.cuh"
#include "keep_mask.cuh"

namespace {

using rlt::kPackedThreads;
using rlt::kPackedTile;
using rlt::Split;

constexpr int kStages = 2;

template <int kDh>
constexpr size_t fwd_smem() {
  return sizeof(float) * (1 + kStages * 2) * rlt::PackedShape<kDh>::kTileFloats;
}

// Dynamic shared memory: q_s[64][kPitch] | kStages x (k_t[64][kPitch] | v_t[64][kPitch])
template <int kDh, int kMinBlocks>
__global__ void __launch_bounds__(kPackedThreads, kMinBlocks)
attn_packed_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse,
                       const int32_t* __restrict__ streams, int length,
                       int d_model, int pack, float scale, const rlt::Dropout drop) {
  using Shape = rlt::PackedShape<kDh>;
  constexpr int kPitch = Shape::kPitch;
  constexpr int kTileFloats = Shape::kTileFloats;
  constexpr int kCols = Shape::kCols;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* smem = q_s + kTileFloats;

  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int w16 = (threadIdx.x / 32) * 16;  // the warp's rows in the block's tile
  const int r0 = blockIdx.x * kPackedTile + w16;
  const size_t base = static_cast<size_t>(n) * length * d_model + head * kDh;
  const int tiles = (length + kPackedTile - 1) / kPackedTile;

  rlt::load_tile_async<kDh>(q_s, q + base, blockIdx.x * kPackedTile, length, d_model);
  rlt::load_tile_async<kDh>(smem, k + base, 0, length, d_model);
  rlt::load_tile_async<kDh>(smem + kTileFloats, v + base, 0, length, d_model);
  rlt::cp_async_commit();

  // the head's keep mask: columns (head % pack) * L + j of its group's tile
  const uint32_t ncols = static_cast<uint32_t>(pack) * length;
  const uint32_t col0 = static_cast<uint32_t>(head % pack) * length;
  const bool dropout = drop.on();
  const uint32_t key =
      dropout ? rlt::stream_key(rlt::group_stream(streams[n], head / pack)) : 0u;
  const uint32_t limit = drop.limit(n);
  const float inv_keep = drop.scale_of(n);

  // rows g and g + 8 of the warp: running max, this thread's share of the
  // running sum, and the output accumulator (dh / 8 tiles of 8 columns)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float acc[kCols][4] = {};

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
    const int t0 = it * kPackedTile;

    // S = Q K^T: 8 key columns per accumulator tile, dh / 8 k-steps
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kCols; ++kk) {
      Split qa[4];
      rlt::split_a_tile<kPitch>(qa, q_s, w16, kk, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rlt::mma3_b_rows<kPitch>(s[j], qa, k_t, 8 * j, 8 * kk, g, t);
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
              static_cast<uint32_t>(r0 + g + 8 * r) * ncols + col0 + col;
          s[j][e] = rlt::keep_element(index, key, limit) ? w * inv_keep : 0.0f;
        } else {
          s[j][e] = w;
        }
      }
    }

    // O = O corr + P V: the weights of keys 8 kk.. as A, V's rows in the
    // relabelled order, the tile's product in a fresh accumulator
    float pv[kCols][4] = {};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      Split pa[4];
      rlt::split_acc(s[kk], pa);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        rlt::mma3_b_perm<kPitch>(pv[j], pa, v_t, 8 * kk, 8 * j, g, t);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], corr[e >> 1], pv[j][e]);
    }
    __syncthreads();  // the stage is consumed before the next copy into it
  }

  const int groups = gridDim.y / pack;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = rlt::quad_sum(l[r]);
    const int row = r0 + g + 8 * r;
    if (row < length) {
      const float inv = 1.0f / sum;
      float* out = o + base + static_cast<size_t>(row) * d_model + 2 * t;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      if (t == 0) {
        const size_t li =
            ((static_cast<size_t>(n) * groups + head / pack) * length + row) * pack +
            head % pack;
        lse[li] = m[r] + logf(sum);
      }
    }
  }
}

template <int kDh>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
               const int32_t* streams, int n, int length, int heads, int pack,
               const rlt::Dropout& drop, cudaStream_t stream) {
  constexpr int kMinBlocks = rlt::PackedShape<kDh>::kMinBlocks;
  constexpr size_t smem = fwd_smem<kDh>();
  cudaError_t err = cudaFuncSetAttribute(attn_packed_fwd_kernel<kDh, kMinBlocks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((length + kPackedTile - 1) / kPackedTile, heads, n);
  attn_packed_fwd_kernel<kDh, kMinBlocks><<<grid, kPackedThreads, smem, stream>>>(
      q, k, v, o, lse, streams, length, heads * kDh, pack,
      1.0f / sqrtf(static_cast<float>(kDh)), drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o (N, L, D) with D = heads * head_dim, head_dim 16 or 64, lse
// (N, heads / pack, L, pack): contiguous float32 device arrays, q/k/v
// 16-byte aligned. With rate > 0, `streams` holds N int32 dropout streams
// (one per row n) and `threshold` the keep threshold of keep_mask.cuh; with
// rate == 0 neither is read. With `thresholds` and `scales` (N uint32 and N
// float32, keep_mask.cuh's per-row encoding: 0 and 1 for a row at rate 0),
// row n drops at its own rate, `streams` is read, and `rate` and
// `threshold` are not. Takes 1 <= L <= 65535; any other head width is
// refused with cudaErrorInvalidValue. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rlt_attention_packed_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        const void* streams, const void* thresholds,
                                        const void* scales, int n, int length,
                                        int heads, int head_dim, int pack, float rate,
                                        unsigned int threshold, void* stream) {
  rlt::Dropout drop;
  if (n < 1 || length < 1 || heads < 1 || pack < 1 || heads % pack != 0 ||
      n > 65535 || length > 65535 || heads > 65535 ||
      !rlt::make_dropout(drop, rate, threshold, streams, thresholds, scales))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q_ = static_cast<const float*>(q);
  const auto* k_ = static_cast<const float*>(k);
  const auto* v_ = static_cast<const float*>(v);
  auto* o_ = static_cast<float*>(o);
  auto* lse_ = static_cast<float*>(lse);
  const auto* s_ = static_cast<const int32_t*>(streams);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_fwd<16>(q_, k_, v_, o_, lse_, s_, n, length, heads, pack, drop, st);
    case 64:
      return launch_fwd<64>(q_, k_, v_, o_, lse_, s_, n, length, heads, pack, drop, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 instances: q, k, v, o (N, L, D) bf16 with D = heads * head_dim,
// head_dim 16 or 64, lse (N, heads / pack, L, pack) float32, the rest as
// rlt_attention_packed_fwd. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rlt_attention_packed_fwd_bf16(const void* q, const void* k,
                                             const void* v, void* o, void* lse,
                                             const void* streams, const void* thresholds,
                                             const void* scales, int n, int length,
                                             int heads, int head_dim, int pack,
                                             float rate, unsigned int threshold,
                                             void* stream) {
  rlt::Dropout drop;
  if (n < 1 || length < 1 || heads < 1 || pack < 1 || heads % pack != 0 ||
      n > 65535 || length > 65535 || heads > 65535 ||
      !rlt::make_dropout(drop, rate, threshold, streams, thresholds, scales))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return rlt::launch_attn_fwd_dh16(q, k, v, o, lse, streams, n, length, heads, pack,
                                       drop, st);
    case 64:
      return rlt::launch_attn_fwd_wgmma<64>(q, k, v, o, lse, streams, n, length, heads,
                                            pack, drop, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
