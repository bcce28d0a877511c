// attention_bf16_bwd_wgmma: the bf16 attention backward at dh = 64 (K6''s
// packed heads, attention_packed_bwd.cu) and dh = 128 (K4''s slices,
// attention_bwd.cu: one head of D = 128 in a group of pack 1), written for
// Hopper: tiles by TMA into rings guarded by mbarriers, products by wgmma.
// (dh = 16, Choopy's and MtChoopy's heads, is attention_bf16_dh16.cuh's.)
//
// Replaces the bf16 form of rlt_tpu/ops/attention.py::_attn_bwd_packed_kernel
// (:412, through _bwd_packed) and ::_attn_bwd_kernel (:117, through
// _bwd_pallas), whose `_mxu` keeps bf16 operands bf16. It computes what the
// first bf16 kernels (mma.sync designs, since removed) computed. q, k, v, o and the
// incoming gradient do arrive in bf16, lse in f32 (K3''s or K5''s layout,
// (N, H / pack, L, pack)). Per head, recomputing the probabilities from lse:
//   s = q k^T (f32 sums of exact bf16 products),  p = exp(s scale - lse)  f32
//   dP = do v^T  f32;  with dropout pd = keep ? p / (1 - rate) : 0 and
//                       dp = keep ? dP / (1 - rate) : 0, both f32
//   delta = rowsum(f32(do) f32(o))  f32
//   ds = bf16(p (dp - delta) scale),  pd rounded to bf16
//   dq = ds k,  dk = ds^T q,  dv = pd^T do  (f32 sums, stored as bf16)
// The exponential is taken as 2^(s c - lse log2(e)) with c = log2(e) /
// sqrt(dh), one FFMA and one MUFU.EX2 a score with lse pre-scaled, as the
// forward takes its weights; results below 2^-126 are flushed to 0. The keep
// mask is the forward's (keep_mask.cuh's keep_element at index row * pack *
// L + (head % pack) * L + col on group_stream(streams[n], head / pack)),
// regenerated from the same streams at the same rate (the launch's, or the
// row's own, read once a work item: keep_mask.cuh's Dropout); where a pass
// holds S^T, its rows are keys and its columns queries, and the index is
// taken with them traded back.
//
// What bounds it on an H100: by the roofline the bytes, 2 an element of q,
// k, v, o, do, dq, dk and dv, at N = 189 rows of 4 heads of dh = 64 and L =
// 300, or 378 slices of dh = 128, 232 MB, 0.070 ms at 3.35 TB/s, against
// 0.044 ms for the five L x L x dh products at the dense bf16 rate. This
// design takes seven products (0.062 ms) and each score's exponential and
// mask hash twice; the exponentials, at 16 MUFU.EX2 a clock an SM, take
// ~0.02 ms a pass, and the hash about twice that at rate 0.1.
// The kernels it replaces read 7.5-8.3x the bound: each warp waited on a
// serial chain of its own mma.sync products, blocks of 4 warps did five
// tiles each and exposed their prologue (two resident tiles and the first
// streamed one before any product), crossed two __syncthreads a tile, ran
// the dropout instance's code at rate 0, and at dh = 128 took the dk/dv
// pass's queries 32 at a time.
//
// Design: two persistent kernels of the forward's shape (hopper.cuh), each
// block one consumer warpgroup and one producer warpgroup (of which one warp
// loads), two blocks an SM. setmaxnreg gives the consumers 224 registers a
// thread and the producers 32, so that at dh = 128 the dK and dV
// accumulators (64 keys x 128 columns each, 128 f32 a thread) sit beside
// S^T and dP^T (64 more) in one warpgroup without halving the tiles.
//  1. dq pass: a work item is 64 query rows of one (row n, head). The
//     producer loads the item's Q, dO and O tiles by TMA with lse (times
//     log2 e; +inf past L, so that p = 0 there) by its lanes, and streams
//     the K and V tiles of 64 keys through two-stage rings. The consumers
//     take delta of the item's rows from the swizzled O and dO tiles in
//     shared memory and write it for the second pass, then, per key tile:
//     S = Q K^T and dP = dO V^T (wgmma, both operands from shared memory),
//     ds in registers (only the last tile of a ragged L masks its keys),
//     dQ += ds K (register-A wgmma, ds rounded and packed from the S
//     accumulator, K through the transposed descriptor). V's stage is
//     released after dP, K's after dQ, Q and dO after the last S and dP.
//  2. dkv pass: a work item is 64 key rows of one (row n, head). The
//     producer loads the item's K and V tiles and streams Q and dO tiles
//     by TMA through a two-stage ring, with each tile's lse (times log2 e,
//     +inf past L) and delta by its lanes. Per query tile: S^T = K Q^T and
//     dP^T = V dO^T, ds^T and pd^T in registers (no mask: queries past L
//     have p = 0), dV += pd^T dO and dK += ds^T Q (register-A wgmma, dO and
//     Q through the transposed descriptor).
// kDropout is a template parameter: the rate-0 instance carries no mask
// code. Every output element is summed by one thread in a fixed order, so
// two launches on the same inputs give the same bits. Shared memory (dq: 56
// KiB at dh = 64, 113 KiB at 128; dkv: 49 and 97 KiB) does not grow with L;
// any 1 <= L <= 65535 is taken. ptxas: no spills at dh = 64 and in the dq
// pass; the dkv pass at dh = 128 spills 12 bytes (rate 0) and 48 (dropout).
//
// On an H100 (PERF.md §6): at N = 189, dh = 64, rate 0 the two passes take
// 0.110 and 0.131 ms (0.25 ms, 0.57x the kernels it replaces, 3.5x the
// bound); 378 slices of dh = 128 0.19 ms (0.43x). Tried and dropped (PERF.md
// §6 has the times): one pass per (row n, head, 64-key block) with dQ summed
// into an f32 scratch in a fixed key-block order behind a counter per query
// tile, as FlashAttention-3's deterministic mode does (dS^T through shared
// memory as the MN-major A of dQ = dS K, a delta pre-pass): 2.1-4.9x slower,
// each key block's 64 x dh f32 read-add-write of dQ per query tile costing
// more than the two products and the exponentials it saves at L = 300, and
// the order in key blocks (each waiting on the one before) slower than a
// rotated one (each starting at its own query tile); 3 ring stages (within
// 2%); the producers at 24 registers and the consumers at 232 (within 3%,
// spills in the producer); three blocks an SM of one consumer warpgroup and
// a lone producer warp (setmaxnreg 152 / 24: the launch faults).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "keep_mask.cuh"

namespace rlt {
namespace wgmma_bwd {

using namespace sm90;

constexpr int kThreads = 256;      // consumer warpgroup 0, producer warpgroup 1
constexpr int kBlocksPerSm = 2;    // 128 registers a thread at launch
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 32;  // 2 x (224 + 32) x 128 = the SM's 65,536
constexpr int kStages = 2;         // ring stages of each streamed operand

// The scalars of one launch.
struct Params {
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* delta;  // (N, heads, L): written by the dq pass, read by the dkv pass
  const float* lse;
  const int32_t* streams;
  int length, d_model, heads, pack;
  int items;         // n * heads * tiles: (row n, head, 64-row tile) work items
  float scale;       // 1 / sqrt(dh)
  float scale_log2;  // log2(e) / sqrt(dh)
  Dropout drop;
};

// dq pass shared memory, from a 1024-aligned base: the item's Q, dO and O
// tiles, kStages K tiles, kStages V tiles (each dh / 64 boxes of 64 rows x
// 128 bytes), lse and delta of the item's rows (64 f32 each), then the
// mbarriers q_full, q_empty, k_full[], v_full[], k_empty[], v_empty[].
template <int kDh>
struct DqLayout {
  static_assert(kDh % 64 == 0, "64-column chunks");
  static constexpr int kTile = kDh / 64 * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTile;
  static constexpr int kO = kDo + kTile;
  static constexpr int kK = kO + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kLse = kV + kStages * kTile;
  static constexpr int kDelta = kLse + 4 * kRows;
  static constexpr int kBars = kDelta + 4 * kRows;
  static constexpr size_t kSmem = kBars + 8 * (2 + 4 * kStages);
};

// dkv pass shared memory: the item's K and V tiles, kStages Q tiles,
// kStages dO tiles, kStages (lse, delta) pairs of 64 f32 each, then the
// mbarriers kv_full, kv_empty, qd_full[], qd_empty[].
template <int kDh>
struct DkvLayout {
  static_assert(kDh % 64 == 0, "64-column chunks");
  static constexpr int kTile = kDh / 64 * kBoxBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;
  static constexpr int kDo = kQ + kStages * kTile;
  static constexpr int kStats = kDo + kStages * kTile;
  static constexpr int kBars = kStats + kStages * 8 * kRows;
  static constexpr size_t kSmem = kBars + 8 * (2 + 2 * kStages);
};

__device__ __forceinline__ uint32_t stage_parity(int g) {
  return static_cast<uint32_t>((g / kStages) & 1);
}

// the (n, head) of work item `item`, whose 64-row tile is item % tiles
struct Item {
  int tile, head, n;
  __device__ Item(int item, int tiles, int heads)
      : tile(item % tiles), head(item / tiles % heads), n(item / tiles / heads) {}
};

// The lse of head `head`'s row 0 in the (N, heads / pack, L, pack) layout;
// row i is i * pack further.
__device__ __forceinline__ const float* head_lse(const Params& p, int n, int head) {
  return p.lse +
         (static_cast<size_t>(n) * (p.heads / p.pack) + head / p.pack) * p.length * p.pack +
         head % p.pack;
}

// Rows row0 .. + 63 of an accumulator pair as bf16 (rows below L only):
// the thread's rows first and first + 8, columns head * kDh + 64 j + 8 nb +
// 2 t of an (N, L, d_model) array.
template <int kDh>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[kDh / 64][32],
                                           const Params& p, int n, int head, int first,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = first + 8 * r;
    if (row >= p.length) continue;
    bf16* dst = out + (static_cast<size_t>(n) * p.length + row) * p.d_model + head * kDh + 2 * t;
#pragma unroll
    for (int j = 0; j < kDh / 64; ++j)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        *reinterpret_cast<uint32_t*>(dst + 64 * j + 8 * nb) =
            pack_bf16x2(acc[j][4 * nb + 2 * r], acc[j][4 * nb + 2 * r + 1]);
  }
}

template <int kDh, bool kDropout>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_o,
                         const __grid_constant__ CUtensorMap map_do, const Params p) {
  using L = DqLayout<kDh>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023) __trap();  // the swizzled tiles need a 1024-byte aligned base
  float* lse_s = reinterpret_cast<float*>(smem_raw + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem_raw + L::kDelta);
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;  // stage s's barrier at + 8 s
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  auto k_tile = [&](int g) { return base + L::kK + (g % kStages) * L::kTile; };
  auto v_tile = [&](int g) { return base + L::kV + (g % kStages) * L::kTile; };
  const int length = p.length;
  const int tiles = (length + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1 + 32);  // the loads' bytes and the producer lanes' lse
    mbar_init(q_empty, 4);      // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4);
      mbar_init(v_empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warpgroup: its first warp loads
    regs_down<kProducerRegs>();
    if (threadIdx.x < 160) {
      const int lane = threadIdx.x % 32;
      int g = 0;  // tiles through the rings so far
      int jj = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++jj) {
        const Item w(item, tiles, p.heads);
        const int col = w.head * kDh;
        if (jj > 0) mbar_wait(q_empty, (jj - 1) & 1);  // the previous item's tiles are read
        if (lane == 0) {
          mbar_expect_tx(q_full, 3 * L::kTile);
          tma_tile<kDh>(base + L::kQ, &map_q, col, w.tile * kRows, w.n, q_full);
          tma_tile<kDh>(base + L::kDo, &map_do, col, w.tile * kRows, w.n, q_full);
          tma_tile<kDh>(base + L::kO, &map_o, col, w.tile * kRows, w.n, q_full);
        }
        const float* lse_h = head_lse(p, w.n, w.head);
        for (int r = lane; r < kRows; r += 32) {
          const int row = w.tile * kRows + r;
          lse_s[r] = row < length ? lse_h[static_cast<size_t>(row) * p.pack] * kLog2e : INFINITY;
        }
        mbar_arrive(q_full);
        if (lane != 0) {
          g += tiles;
          continue;
        }
        for (int it = 0; it < tiles; ++it, ++g) {
          const int s = g % kStages;
          const uint32_t released = stage_parity(g) ^ 1;  // the stage's last release
          if (g >= kStages) mbar_wait(k_empty + 8 * s, released);
          mbar_expect_tx(k_full + 8 * s, L::kTile);
          tma_tile<kDh>(k_tile(g), &map_k, col, it * kRows, w.n, k_full + 8 * s);
          if (g >= kStages) mbar_wait(v_empty + 8 * s, released);
          mbar_expect_tx(v_full + 8 * s, L::kTile);
          tma_tile<kDh>(v_tile(g), &map_v, col, it * kRows, w.n, v_full + 8 * s);
        }
      }
    }
  } else {
    regs_up<kConsumerRegs>();
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int gq = lane / 4;
    const int t = lane % 4;
    const float c = p.scale_log2;
    const uint32_t ncols = static_cast<uint32_t>(p.pack) * length;
    int g = 0;
    int jj = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++jj) {
      const Item w(item, tiles, p.heads);
      const int row0 = w.tile * kRows + 16 * warp + gq;  // the thread's rows row0 and row0 + 8
      const uint32_t col0 = static_cast<uint32_t>(w.head % p.pack) * length;
      const uint32_t key =
          kDropout ? stream_key(group_stream(p.streams[w.n], w.head / p.pack)) : 0u;
      const uint32_t limit = kDropout ? p.drop.limit(w.n) : 0u;
      const float inv_keep = kDropout ? p.drop.scale_of(w.n) : 1.0f;
      mbar_wait(q_full, jj & 1);

      // delta of the item's rows from the O and dO tiles: two threads a row,
      // dh / 2 columns each; 16-byte chunk ch of row r sits at chunk ch ^ (r %
      // 8) of its 128-byte row (the 128-byte swizzle)
      {
        const int r = threadIdx.x / 2;
        const int half = threadIdx.x % 2;
        float part = 0.0f;
#pragma unroll
        for (int cc = 0; cc < kDh / 16; ++cc) {
          const int ch = half * (kDh / 16) + cc;
          const int off = (ch / 8) * kBoxBytes + r * 128 + (((ch % 8) ^ (r % 8)) * 16);
          const uint4 a = *reinterpret_cast<const uint4*>(smem_raw + L::kO + off);
          const uint4 b = *reinterpret_cast<const uint4*>(smem_raw + L::kDo + off);
          const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
          const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            part = fmaf(__uint_as_float(aw[e] << 16), __uint_as_float(bw[e] << 16), part);
            part = fmaf(__uint_as_float(aw[e] & 0xffff0000u),
                        __uint_as_float(bw[e] & 0xffff0000u), part);
          }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (half == 0) {
          delta_s[r] = part;
          const int row = w.tile * kRows + r;
          if (row < length)
            p.delta[(static_cast<size_t>(w.n) * p.heads + w.head) * length + row] = part;
        }
      }
      warpgroup_sync();
      float lse2[2], delta_r[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = lse_s[16 * warp + gq + 8 * r];
        delta_r[r] = delta_s[16 * warp + gq + 8 * r];
      }

      float acc[kDh / 64][32];
#pragma unroll
      for (int j = 0; j < kDh / 64; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[j][e] = 0.0f;
      float sc[32], dp[32];
      uint32_t pa[4][4];

      // ds of key tile it in place of its scores (keys past L masked on the
      // last tile only)
      auto take_ds = [&](int it, auto masked) {
        constexpr bool kMask = decltype(masked)::value;
        const int t0 = it * kRows;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const int col = t0 + 8 * (i / 4) + 2 * t + (i & 1);
          float pv = ex2(fmaf(sc[i], c, -lse2[r]));
          if (kMask && col >= length) pv = 0.0f;
          float dpv = dp[i];
          if (kDropout) {
            const uint32_t index = static_cast<uint32_t>(row0 + 8 * r) * ncols + col0 + col;
            dpv = keep_element(index, key, limit) ? dpv * inv_keep : 0.0f;
          }
          sc[i] = pv * (dpv - delta_r[r]) * p.scale;
        }
      };

      for (int it = 0; it < tiles; ++it, ++g) {
        const int s = g % kStages;
        mbar_wait(k_full + 8 * s, stage_parity(g));
        issue_abt<kDh>(sc, base + L::kQ, k_tile(g));
        mbar_wait(v_full + 8 * s, stage_parity(g));
        issue_abt<kDh>(dp, base + L::kDo, v_tile(g));
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if (lane == 0) {
          mbar_arrive(v_empty + 8 * s);
          if (it == tiles - 1) mbar_arrive(q_empty);
        }
        if (it == tiles - 1 && length % kRows != 0)
          take_ds(it, std::true_type{});
        else
          take_ds(it, std::false_type{});
        pack_a(pa, sc);
        issue_ab<kDh>(acc, pa, k_tile(g));
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < kDh / 64; ++j) fence_regs(acc[j]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) keep_live(pa[kk]);
        if (lane == 0) mbar_arrive(k_empty + 8 * s);
      }
      store_rows<kDh>(p.dq, acc, p, w.n, w.head, row0, t);
    }
  }
}

template <int kDh, bool kDropout>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do, const Params p) {
  using L = DkvLayout<kDh>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023) __trap();
  const uint32_t kv_full = base + L::kBars;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t qd_full = kv_empty + 8;  // stage s's barrier at + 8 s
  const uint32_t qd_empty = qd_full + 8 * kStages;
  auto q_tile = [&](int g) { return base + L::kQ + (g % kStages) * L::kTile; };
  auto do_tile = [&](int g) { return base + L::kDo + (g % kStages) * L::kTile; };
  // stage s's lse (times log2 e) of its 64 queries, then their delta
  auto stats = [&](int g) {
    return reinterpret_cast<float*>(smem_raw + L::kStats + (g % kStages) * 8 * kRows);
  };
  const int length = p.length;
  const int tiles = (length + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(qd_full + 8 * s, 1 + 32);  // the loads' bytes and the lanes' lse, delta
      mbar_init(qd_empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    regs_down<kProducerRegs>();
    if (threadIdx.x < 160) {
      const int lane = threadIdx.x % 32;
      int g = 0;
      int jj = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++jj) {
        const Item w(item, tiles, p.heads);
        const int col = w.head * kDh;
        if (jj > 0) mbar_wait(kv_empty, (jj - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(kv_full, 2 * L::kTile);
          tma_tile<kDh>(base + L::kK, &map_k, col, w.tile * kRows, w.n, kv_full);
          tma_tile<kDh>(base + L::kV, &map_v, col, w.tile * kRows, w.n, kv_full);
        }
        const float* lse_h = head_lse(p, w.n, w.head);
        const float* delta_h =
            p.delta + (static_cast<size_t>(w.n) * p.heads + w.head) * length;
        for (int it = 0; it < tiles; ++it, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(qd_empty + 8 * s, stage_parity(g) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(qd_full + 8 * s, 2 * L::kTile);
            tma_tile<kDh>(q_tile(g), &map_q, col, it * kRows, w.n, qd_full + 8 * s);
            tma_tile<kDh>(do_tile(g), &map_do, col, it * kRows, w.n, qd_full + 8 * s);
          }
          float* st = stats(g);
          for (int r = lane; r < kRows; r += 32) {
            const int row = it * kRows + r;
            const bool valid = row < length;
            st[r] = valid ? lse_h[static_cast<size_t>(row) * p.pack] * kLog2e : INFINITY;
            st[kRows + r] = valid ? delta_h[row] : 0.0f;
          }
          mbar_arrive(qd_full + 8 * s);
        }
      }
    }
  } else {
    regs_up<kConsumerRegs>();
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int gq = lane / 4;
    const int t = lane % 4;
    const float c = p.scale_log2;
    const uint32_t ncols = static_cast<uint32_t>(p.pack) * length;
    int g = 0;
    int jj = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++jj) {
      const Item w(item, tiles, p.heads);
      const int key0 = w.tile * kRows + 16 * warp + gq;  // the thread's keys key0, key0 + 8
      const uint32_t col0 = static_cast<uint32_t>(w.head % p.pack) * length;
      const uint32_t key =
          kDropout ? stream_key(group_stream(p.streams[w.n], w.head / p.pack)) : 0u;
      const uint32_t limit = kDropout ? p.drop.limit(w.n) : 0u;
      const float inv_keep = kDropout ? p.drop.scale_of(w.n) : 1.0f;
      float dk[kDh / 64][32], dv[kDh / 64][32];
#pragma unroll
      for (int j = 0; j < kDh / 64; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) dk[j][e] = dv[j][e] = 0.0f;
      float st[32], dpt[32];
      uint32_t dsa[4][4], pda[4][4];
      mbar_wait(kv_full, jj & 1);

      for (int it = 0; it < tiles; ++it, ++g) {
        const int s = g % kStages;
        mbar_wait(qd_full + 8 * s, stage_parity(g));
        issue_abt<kDh>(st, base + L::kK, q_tile(g));
        issue_abt<kDh>(dpt, base + L::kV, do_tile(g));
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        if (it == tiles - 1 && lane == 0) mbar_arrive(kv_empty);  // K and V are read
        // ds^T in place of S^T, pd^T in place of dP^T: rows are the thread's
        // keys, columns the tile's queries 8 j + 2 t + e
        const float* lse_t = stats(g);
        const float* delta_t = lse_t + kRows;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t);
          const float2 dl = *reinterpret_cast<const float2*>(delta_t + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float pv = ex2(fmaf(st[i], c, -((e & 1) ? l2.y : l2.x)));
            float pd = pv;
            float dpv = dpt[i];
            if (kDropout) {
              const int query = it * kRows + 8 * j + 2 * t + (e & 1);
              const uint32_t index = static_cast<uint32_t>(query) * ncols + col0 +
                                     static_cast<uint32_t>(key0 + 8 * (e >> 1));
              const bool keep = keep_element(index, key, limit);
              pd = keep ? pv * inv_keep : 0.0f;
              dpv = keep ? dpv * inv_keep : 0.0f;
            }
            st[i] = pv * (dpv - ((e & 1) ? dl.y : dl.x)) * p.scale;
            dpt[i] = pd;
          }
        }
        pack_a(dsa, st);
        pack_a(pda, dpt);
        issue_ab<kDh>(dv, pda, do_tile(g));
        issue_ab<kDh>(dk, dsa, q_tile(g));
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < kDh / 64; ++j) {
          fence_regs(dv[j]);
          fence_regs(dk[j]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          keep_live(dsa[kk]);
          keep_live(pda[kk]);
        }
        if (lane == 0) mbar_arrive(qd_empty + 8 * s);
      }
      store_rows<kDh>(p.dk, dk, p, w.n, w.head, key0, t);
      store_rows<kDh>(p.dv, dv, p, w.n, w.head, key0, t);
    }
  }
}

template <int kDh, bool kDropout>
int launch_passes(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                  const CUtensorMap& mo, const CUtensorMap& mdo, const Params& p,
                  cudaStream_t stream) {
  constexpr size_t kDqSmem = DqLayout<kDh>::kSmem;
  constexpr size_t kDkvSmem = DkvLayout<kDh>::kSmem;
  auto dq_kernel = attn_bwd_dq_wgmma_kernel<kDh, kDropout>;
  auto dkv_kernel = attn_bwd_dkv_wgmma_kernel<kDh, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kDqSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the persistent grids: as many blocks as the card holds at once (asked of
  // the first card launched on, and kept)
  static const int dq_resident = resident_blocks(dq_kernel, kThreads, kDqSmem);
  static const int dkv_resident = resident_blocks(dkv_kernel, kThreads, kDkvSmem);
  dq_kernel<<<dq_resident < p.items ? dq_resident : p.items, kThreads, kDqSmem, stream>>>(
      mq, mk, mv, mo, mdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<dkv_resident < p.items ? dkv_resident : p.items, kThreads, kDkvSmem, stream>>>(
      mq, mk, mv, mdo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma_bwd

// Launch both passes over n rows of `heads` heads of width kDh (d_model =
// heads * kDh), `delta` an (n, heads, L) f32 scratch array: the bf16
// backward of attention_packed_bwd.cu (dh = 64) and attention_bwd.cu (dh =
// 128). Returns the first error, or cudaErrorInvalidValue where a tensor map
// cannot be encoded.
template <int kDh>
int launch_attn_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, const void* streams, void* dq,
                          void* dk, void* dv, void* delta, int n, int length, int heads,
                          int pack, const Dropout& drop, cudaStream_t stream) {
  using namespace wgmma_bwd;
  const int d_model = heads * kDh;
  CUtensorMap mq, mk, mv, mo, mdo;
  if (!encode_map(&mq, q, n, length, d_model) || !encode_map(&mk, k, n, length, d_model) ||
      !encode_map(&mv, v, n, length, d_model) || !encode_map(&mo, o, n, length, d_model) ||
      !encode_map(&mdo, dout, n, length, d_model))
    return static_cast<int>(cudaErrorInvalidValue);
  // the work items of either pass number under 2^31 for any q that fits on the card
  const long long items = static_cast<long long>(n) * heads * ((length + kRows - 1) / kRows);
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  const Params p{static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk),
                 static_cast<bf16*>(dv),
                 static_cast<float*>(delta),
                 static_cast<const float*>(lse),
                 static_cast<const int32_t*>(streams),
                 length,
                 d_model,
                 heads,
                 pack,
                 static_cast<int>(items),
                 scale,
                 scale * kLog2e,
                 drop};
  return drop.on() ? launch_passes<kDh, true>(mq, mk, mv, mo, mdo, p, stream)
                   : launch_passes<kDh, false>(mq, mk, mv, mo, mdo, p, stream);
}

}  // namespace rlt
