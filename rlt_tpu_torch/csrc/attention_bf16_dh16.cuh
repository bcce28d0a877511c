// attention_bf16_dh16: the bf16 attention forward and backward at dh = 16,
// K5''s and K6''s head-packed instances behind rlt_attention_packed_fwd_bf16
// and rlt_attention_packed_bwd_bf16 (attention_packed_fwd.cu,
// attention_packed_bwd.cu) for Choopy's and MtChoopy's encoder layers, 8
// heads of dh = 16 in one group of pack 8 of (N, L, 128) arrays, written for
// Hopper: tiles by TMA into rings guarded by mbarriers, products by wgmma.
//
// Replaces the bf16 form of rlt_tpu/ops/attention.py::_attn_fwd_packed_kernel
// (:369, through _fwd_packed) and ::_attn_bwd_packed_kernel (:412, through
// _bwd_packed), whose `_mxu` keeps bf16 operands bf16. Per head it computes
// what attention_bf16_wgmma.cuh (forward) and attention_bf16_bwd_wgmma.cuh
// (backward) compute at dh = 64, in the same order of rounding:
//   forward:  S summed in f32; the running max, e = exp(s - m), its sum and
//             lse = m + log(sum) in f32; each weight rounded once to bf16
//             against the running max before P V; O rescaled by
//             exp(m_old - m_new) and divided by the f32 sum at the end; o in
//             bf16, lse in f32 in the layout (N, H / pack, L, pack);
//   backward: p = exp(s scale - lse), dP = do v^T and delta = rowsum(do o)
//             in f32; ds = bf16(p (dp - delta) scale), pd rounded to bf16;
//             dq = ds k, dk = ds^T q, dv = pd^T do summed in f32, stored bf16.
// The exponential is 2^(s c - x) with c = log2(e) / sqrt(dh), one FFMA and
// one MUFU.EX2 a score (results below 2^-126 flushed to 0). At a dropout
// rate above 0 each weight is dropped by keep_mask.cuh's bits at index row *
// pack * L + (head % pack) * L + col on group_stream(streams[n], head /
// pack), the kept ones scaled by 1 / (1 - rate) before the rounding; lse
// stays the pre-dropout one. The rate is the launch's or row n's own
// (keep_mask.cuh's Dropout), read with the key once a work item, so that it
// follows the item and not the block.
//
// What bounds it on an H100. At dh = 16 the products are nearly free and the
// time goes into what each score costs, which does not shrink with dh: at
// N = 63 rows of 8 heads and L = 300, 45.4 M scores a launch, one
// MUFU.EX2 each at 16 a clock an SM takes ~11 us (at 1.98 GHz), the keep
// hash (two multiplies, three shifts, three xors and a compare a score, at
// ~64 integer operations a clock an SM) ~27 us at rate 0.1, against 6.0 us
// of bytes (q, k, v, o) for the forward, 11.7 us for the backward. A score
// takes ~5.5 instructions at rate 0 and ~19 at rate 0.1 (SASS), so issue
// and, above all, latency set the pace: a consumer warp waits on its own
// chains (max, shuffles, exponentials, hash) unless the SM holds many. The
// kernels these replace (the first mma.sync designs) read 0.051 | 0.081 ms
// forward and 0.154 | 0.207 backward there (rate 0 | 0.1), the backward's
// two passes each taking every score's exponential and hash.
//
// Design. The heads of a row lie side by side: one 128-byte TMA box of 64
// columns holds 4 heads, so a work item is 64 rows of one row n and several
// heads, and one box load and one barrier serve all of them. S_h = Q_h K_h^T
// is a single wgmma.m64n64k16 from shared memory, its K-major descriptors at
// the head's 32-byte offset inside the 128-byte swizzled rows (the offset
// attention_bf16_wgmma.cuh gives its k-steps); P_h V_h and the backward's
// other products of n = 16 are wgmma.m64n16k16 with the operand's MN-major
// descriptor at the same 32-byte offset. Each kernel is persistent: one
// consumer warpgroup and one producer warp a block (its lane 0 issues every
// TMA load), as many blocks as the card holds, each walking the items
// blockIdx.x, + gridDim.x, ... The rate-0 instances carry no mask code, and
// the hash takes its key's first mixing step once an item (keep_mask.cuh's
// keep_mixed). Shared memory does not grow with L but for the one-pass
// backward's dQ; any 1 <= L <= 65535 and any heads that packed_group_size
// admits at dh = 16 (a multiple of 8) are taken. Every output element is
// summed by one thread in a fixed order, so two launches on the same inputs
// give the same bits; there are no atomics.
//  forward: items of 64 query rows and 2 heads, four blocks an SM (96
//   registers a thread); the item's Q tile (two buffers: the next item's
//   loads early) and two-stage rings of K and V tiles. A step is one head on
//   one key tile: its S and the previous step's P V run together, then its
//   softmax (the running O rescaled and P V added by one FFMA an element,
//   so that O is never a wgmma accumulator). Items of 4 heads, fewer blocks,
//   and steps that overlap their products with the softmax all read slower
//   (PERF.md §6): the SM needs warps more than overlap.
//  backward, lists of up to 5 tiles (L <= 320): one pass. A work item is
//   the whole list of one row n and 2 heads; delta comes first from a small
//   kernel of its own. Per key tile (K and V on chip) and query tile (Q,
//   dO, lse and delta streamed through a two-stage ring) and head: S^T =
//   K Q^T and dP^T = V dO^T, each score's exponential, keep hash, dS^T and
//   pd^T taken once, dV += pd^T dO and dK += dS^T Q from registers, and
//   dQ += dS K with dS^T stored through shared memory as the MN-major A of
//   the product. dQ of the whole list stays in shared memory in f32 (2 x 5
//   x 64 x 16, each thread's own accumulator fragments) and is written once
//   at the end; dK and dV are written per key tile.
//  backward, longer lists: two passes, as attention_bf16_bwd_wgmma.cuh's at
//   dh = 64, each step's products waited for before the next (overlapping
//   them held more registers). 1. dq pass: a work item is 64 query rows of 4
//   heads, two blocks an SM. The
//   producer loads the item's Q, dO and O tiles and lse (times log2 e; +inf
//   past L) and streams K and V tiles; the consumers take delta of the
//   item's rows from the O and dO tiles and write it for the second pass,
//   then per key tile and head: S = Q K^T and dP = dO V^T, ds in registers,
//   dQ += ds K. 2. dkv pass: a work item is 64 key rows of 2 heads, three
//   blocks an SM. The
//   producer loads the item's K and V tiles and streams Q and dO tiles with
//   each tile's lse and delta; per query tile and head: S^T = K Q^T and
//   dP^T = V dO^T, ds^T and pd^T in registers, dV += pd^T dO and dK +=
//   ds^T Q.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "attention_mma.cuh"
#include "hopper.cuh"
#include "keep_mask.cuh"

namespace rlt {
namespace dh16 {

using namespace sm90;

constexpr int kDh = 16;
constexpr int kThreads = 128 + 32;  // a consumer warpgroup and a producer warp
constexpr int kStages = 2;          // ring stages of each streamed operand
// heads a work item and blocks an SM of each kernel (the forward's measured
// against 4 heads and 2 or 3 blocks, and against overlapping a step's
// products with its softmax: PERF.md §6)
constexpr int kFwdHeads = 2;
constexpr int kFwdBlocks = 4;
constexpr int kDqHeads = 4;
constexpr int kDqBlocks = 2;
constexpr int kDkvHeads = 2;
constexpr int kDkvBlocks = 3;
// the one-pass backward: heads a work item, blocks an SM, and the longest
// list (in 64-row tiles) whose dQ it holds in shared memory; longer lists
// take the two passes
constexpr int kFusedHeads = 2;
constexpr int kFusedBlocks = 2;
constexpr int kFusedMaxTiles = 5;

// f(std::integral_constant<int, 0>{}), ..., f(<kN - 1>): a loop whose index
// is a constant, so that per-head register arrays stay in registers.
template <typename F, int... kI>
__device__ __forceinline__ void static_for_impl(F&& f, std::integer_sequence<int, kI...>) {
  (f(std::integral_constant<int, kI>{}), ...);
}
template <int kN, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, kN>{});
}

// The geometry of a work item's kHeads heads from h0 (a multiple of
// kHeads): kBoxes boxes of 4 heads (64 columns, 128 bytes) from column
// (h0 / 4) * 64; head j's 16 columns at byte (h0 % 4 + j) % 4 * 32 of box
// (h0 % 4 + j) / 4.
template <int kHeads>
struct Heads {
  static_assert(kHeads == 1 || kHeads == 2 || kHeads == 4 || kHeads == 8,
                "1, 2, 4 or 8 heads an item");
  static constexpr int kBoxes = kHeads > 4 ? kHeads / 4 : 1;
  static constexpr int kTile = kBoxes * kBoxBytes;  // a Q, K, V, O or dO tile
  static constexpr int kCols = 64 * kBoxes;         // its columns
};

__device__ __forceinline__ uint32_t head_offset(int h0, int j) {
  const int idx = (h0 & 3) + j;
  return static_cast<uint32_t>((idx >> 2) * kBoxBytes + (idx & 3) * 32);
}

// d (64 x 16, f32) += A B, A (64 x 16) bf16 fragments in registers, B (16 x
// 16) from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16, f32) = A B, as wgmma_rs_n16 with d's old values not read
__device__ __forceinline__ void wgmma_rs_n16_zero(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// d (64 x 16, f32) += A B, A (64 x 16) and B (16 x 16) both from shared
// memory, both MN-major (transposed): dQ += dS K with dS^T's tile rows the
// depth (keys) and its 64 columns the rows of dQ (queries)
__device__ __forceinline__ void wgmma_ss_tt_n16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64) = A B^T over one head's 16 columns: A's and B's rows from
// tiles at the head's byte offset, both K-major; not committed. d's old
// values are not read: an input operand would make the compiler define
// them before the product, which while another product is in flight makes
// ptxas serialize every wgmma of the kernel.
__device__ __forceinline__ void issue_head_abt(float (&d)[32], uint32_t a, uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(sw128_desc(a)), "l"(sw128_desc(b)), "r"(0));
}

// acc (64 x 16) += A B over a depth of 64: A's fragments of depth 16 kk ..
// + 15 in a[kk], B a tile of 64 rows (the depth) at the head's byte offset
// through the MN-major descriptor; issued and committed (not waited for).
__device__ __forceinline__ void issue_head_ab(float (&acc)[8], uint32_t (&a)[4][4],
                                             uint32_t b) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n16(acc, a[kk], sw128_desc(b + kk * 16 * 128));
  wgmma_commit();
}

// acc (64 x 16) = A B over a depth of 64, as issue_head_ab but into a
// fresh accumulator (its old values not read), so that the running O, which
// is rescaled between products, is never a wgmma accumulator: ptxas
// serializes every wgmma of a kernel in which other instructions write an
// accumulator while a product is in flight.
__device__ __forceinline__ void issue_head_ab_fresh(float (&acc)[8], uint32_t (&a)[4][4],
                                                   uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk == 0)
      wgmma_rs_n16_zero(acc, a[kk], sw128_desc(b));
    else
      wgmma_rs_n16(acc, a[kk], sw128_desc(b + kk * 16 * 128));
  }
  wgmma_commit();
}

// The head `head`'s lse of row 0 in the (N, heads / pack, L, pack) layout;
// row i is i * pack further.
__device__ __forceinline__ const float* head_lse(const float* lse, int n, int head, int heads,
                                                 int pack, int length) {
  return lse + (static_cast<size_t>(n) * (heads / pack) + head / pack) * length * pack +
         head % pack;
}

// The scalars of one launch of either direction.
struct Params {
  bf16* o;   // forward
  float* lse;
  bf16* dq;  // backward
  bf16* dk;
  bf16* dv;
  float* delta;  // (N, heads, L): written by the dq pass, read by the dkv pass
  const float* lse_in;
  const int32_t* streams;
  int length, d_model, heads, pack;
  float scale;       // 1 / sqrt(dh)
  float scale_log2;  // log2(e) / sqrt(dh)
  Dropout drop;
};

// The (row n, first head h0, 64-row tile) of work item `item`
struct Item {
  int tile, h0, n;
  __device__ Item(int item, int tiles, int hblocks, int heads_per_item)
      : tile(item % tiles),
        h0(item / tiles % hblocks * heads_per_item),
        n(item / tiles / hblocks) {}
};

// Rows first and first + 8 of one head's accumulator (64 x 16) as bf16
// (rows below L only): columns head * 16 + 8 nb + 2 t of an (N, L, d_model)
// array.
__device__ __forceinline__ void store_head_rows(bf16* out, const float (&acc)[8],
                                                const Params& p, int n, int head, int first,
                                                int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = first + 8 * r;
    if (row >= p.length) continue;
    bf16* dst = out + (static_cast<size_t>(n) * p.length + row) * p.d_model + head * kDh + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
      *reinterpret_cast<uint32_t*>(dst + 8 * nb) =
          pack_bf16x2(acc[4 * nb + 2 * r], acc[4 * nb + 2 * r + 1]);
  }
}

// x, opaque to the compiler: a per-step index base that it may not split
// into per-score constants hoisted out of the loops (one register each)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm("" : "+r"(x));
  return x;
}

__device__ __forceinline__ uint32_t ring_parity(int g) {
  return static_cast<uint32_t>((g / kStages) & 1);
}

// The per-item dropout of the item's heads' group (kHeads divides pack = 8,
// so the item's heads share it): the key with its first mixing step taken,
// and row n's limit and scale, each held in a register for the item.
struct ItemDrop {
  uint32_t mkey, limit;
  float scale;
};

template <bool kDropout>
__device__ __forceinline__ ItemDrop item_drop(const Params& p, int n, int h0) {
  if (!kDropout) return {0u, 0u, 1.0f};
  return {mixed_key(stream_key(group_stream(p.streams[n], h0 / p.pack))), p.drop.limit(n),
          p.drop.scale_of(n)};
}

// The lse (times log2 e; +inf past L, so that p = 0 there) and delta (0
// past L) of query rows it * 64 .. + 63 of kHeads heads from h0 of row n,
// into `st` as [head][lse 64 | delta 64], by the producer warp's lanes.
template <int kHeads>
__device__ __forceinline__ void fill_stats(float* st, const Params& p, int n, int h0, int it,
                                           int lane) {
  for (int e = lane; e < kHeads * kRows; e += 32) {
    const int j = e / kRows, r = e % kRows;
    const int row = it * kRows + r;
    const bool valid = row < p.length;
    const int head = h0 + j;
    st[2 * j * kRows + r] =
        valid ? head_lse(p.lse_in, n, head, p.heads, p.pack,
                         p.length)[static_cast<size_t>(row) * p.pack] *
                    kLog2e
              : INFINITY;
    st[(2 * j + 1) * kRows + r] =
        valid ? p.delta[(static_cast<size_t>(n) * p.heads + head) * p.length + row] : 0.0f;
  }
}

// dS^T and pd^T in place of S^T (st) and dP^T (dpt) of one head on one query
// tile: rows the thread's keys, columns the tile's queries 8 nb + 2 t + e,
// with the tile's lse and delta of the head at `stats` (fill_stats; queries
// past L have p = 0) and the keep index of query 2 t at the thread's keys
// in `ib` (ncols further a query).
template <bool kDropout>
__device__ __forceinline__ void take_ds_t(float (&st)[32], float (&dpt)[32], const float* stats,
                                          uint32_t (&ib)[2], const Params& p, const ItemDrop& d,
                                          uint32_t ncols, int t) {
  const float* lse_t = stats;
  const float* delta_t = stats + kRows;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * nb + 2 * t);
    const float2 dl = *reinterpret_cast<const float2*>(delta_t + 8 * nb + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * nb + e;
      const float pv = ex2(fmaf(st[i], p.scale_log2, -((e & 1) ? l2.y : l2.x)));
      float pd = pv;
      float dpv = dpt[i];
      if (kDropout) {
        const bool keep = keep_mixed(ib[e >> 1] + (e & 1) * ncols, d.mkey, d.limit);
        pd = keep ? pv * d.scale : 0.0f;
        dpv = keep ? dpv * d.scale : 0.0f;
      }
      st[i] = pv * (dpv - ((e & 1) ? dl.y : dl.x)) * p.scale;
      dpt[i] = pd;
    }
    if (kDropout) {
#pragma unroll
      for (int r = 0; r < 2; ++r) ib[r] = opaque(ib[r] + 8 * ncols);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Shared memory, from a 1024-aligned base: two Q tiles (this item's and the
// next one's), kStages K tiles, kStages V tiles, then the mbarriers q_full[2],
// q_empty[2], k_full[], v_full[], k_empty[], v_empty[].
template <int kHeads>
struct FwdLayout {
  static constexpr int kTile = Heads<kHeads>::kTile;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr size_t kSmem = kBars + 8 * (4 + 4 * kStages);
};

template <int kHeads, bool kDropout>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
attn_fwd_dh16_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const Params p, int items) {
  using L = FwdLayout<kHeads>;
  constexpr int kCols = Heads<kHeads>::kCols;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023) __trap();  // the swizzled tiles need a 1024-byte aligned base
  const uint32_t q_full = base + L::kBars;  // Q buffer b's barriers at + 8 b
  const uint32_t q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16;  // stage s's barrier at + 8 s
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  auto q_tile = [&](int jj) { return base + L::kQ + (jj & 1) * L::kTile; };
  auto k_tile = [&](int g) { return base + L::kK + (g % kStages) * L::kTile; };
  auto v_tile = [&](int g) { return base + L::kV + (g % kStages) * L::kTile; };
  auto stage = [](int g) { return 8 * (g % kStages); };

  const int length = p.length;
  const int tiles = (length + kRows - 1) / kRows;  // key tiles, and row tiles
  const int hblocks = p.heads / kHeads;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + 8 * b, 1);
      mbar_init(q_empty + 8 * b, 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4);
      mbar_init(v_empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: its lane 0 issues every load
    if (threadIdx.x != 128) return;
    int g = 0;  // tiles through the ring so far
    int jj = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++jj) {
      const Item w(item, tiles, hblocks, kHeads);
      const int col = (w.h0 / 4) * 64;
      // the item two back in this Q buffer is done with it
      if (jj >= 2) mbar_wait(q_empty + 8 * (jj & 1), ((jj >> 1) - 1) & 1);
      mbar_expect_tx(q_full + 8 * (jj & 1), L::kTile);
      tma_tile<kCols>(q_tile(jj), &map_q, col, w.tile * kRows, w.n, q_full + 8 * (jj & 1));
      for (int it = 0; it < tiles; ++it, ++g) {
        const int s = stage(g);
        const uint32_t released = ring_parity(g) ^ 1;  // the stage's last release
        if (g >= kStages) mbar_wait(k_empty + s, released);
        mbar_expect_tx(k_full + s, L::kTile);
        tma_tile<kCols>(k_tile(g), &map_k, col, it * kRows, w.n, k_full + s);
        if (g >= kStages) mbar_wait(v_empty + s, released);
        mbar_expect_tx(v_full + s, L::kTile);
        tma_tile<kCols>(v_tile(g), &map_v, col, it * kRows, w.n, v_full + s);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const float c = p.scale_log2;
  const int groups = p.heads / p.pack;
  const uint32_t ncols = static_cast<uint32_t>(p.pack) * length;
  int g = 0;
  int jj = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++jj) {
    const Item w(item, tiles, hblocks, kHeads);
    const int row0 = w.tile * kRows + 16 * warp + gq;  // the thread's rows row0 and row0 + 8
    const ItemDrop drop = item_drop<kDropout>(p, w.n, w.h0);
    const uint32_t qt = q_tile(jj);
    // the keep mask's index of the thread's rows at column 2 t of head 0 of
    // the item's group tile (head j adds j * L, key tile it adds 64 it)
    uint32_t index0[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      index0[r] = static_cast<uint32_t>(row0 + 8 * r) * ncols +
                  static_cast<uint32_t>(w.h0 % p.pack) * length + 2 * t;

    // per head j, rows row0 and row0 + 8: running max (of the raw scores),
    // this thread's share of the running sum, O's rescale for the tile just
    // taken, and O (64 x 16: 8 f32 a thread)
    float m[kHeads][2], l[kHeads][2], corr[kHeads][2], acc[kHeads][8];
#pragma unroll
    for (int j = 0; j < kHeads; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[j][r] = -INFINITY;
        l[j][r] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] = 0.0f;
    }
    float sc[32];  // this step's scores, then its weights
    float pv[8];   // the previous step's P V, added to its head's O after it lands
    uint32_t pa[4][4] = {};

    // head j's scores of key tile it (in `x`) -> its weights (the keys past
    // L masked on the last tile only), m, l and corr of head j updated
    auto softmax = [&](auto jc, float (&x)[32], int it, auto masked) {
      constexpr int j = decltype(jc)::value;
      constexpr bool kMask = decltype(masked)::value;
      const int t0 = it * kRows;
      // the thread's 16 scores of row row0 + 8 r are x[4 nb + 2 r + e];
      // their max and sum run as four chains a row
      float part[2][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (kMask && t0 + 8 * (i / 4) + 2 * t + (i & 1) >= length) x[i] = -INFINITY;
        float& y = part[(i >> 1) & 1][(i >> 2) & 3];
        y = i < 16 && !(i & 1) ? x[i] : fmaxf(y, x[i]);
      }
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = quad_max(fmaxf(fmaxf(m[j][r], fmaxf(part[r][0], part[r][1])),
                                           fmaxf(part[r][2], part[r][3])));  // key t0 < L
        corr[j][r] = ex2((m[j][r] - m_new) * c);  // 0 on the first tile
        m[j][r] = m_new;
        mc[r] = m_new * c;
      }
      uint32_t ib[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        ib[r] = kDropout ? opaque(index0[r] + static_cast<uint32_t>(j * length + t0)) : 0u;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float wv = ex2(fmaf(x[i], c, -mc[r]));  // 0 past L
        float& y = part[r][(i >> 2) & 3];
        y = i < 16 && !(i & 1) ? wv : y + wv;
        if (kDropout) {
          const uint32_t index = ib[r] + 8 * (i / 4) + (i & 1);
          x[i] = keep_mixed(index, drop.mkey, drop.limit) ? wv * drop.scale : 0.0f;
        } else {
          x[i] = wv;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[j][r] = l[j][r] * corr[j][r] + ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
    };

    // Step (it, j) takes head j on key tile it: its S = Q K^T and the
    // previous step's P V run together, then its softmax. Every step issues
    // and waits for the same groups (the first step's P V is a stand-in on
    // the K tile, its result unused), so that ptxas, which cannot count
    // groups along branches, does not serialize the products. Blocks that
    // overlap a step's products with its softmax (the next step's S issued
    // ahead) hold more registers, and fewer of them fit an SM: slower.
    mbar_wait(q_full + 8 * (jj & 1), (jj >> 1) & 1);
    for (int it = 0; it < tiles; ++it) {
      const int gi = g + it;
      const bool ragged = it == tiles - 1 && length % kRows != 0;
      mbar_wait(k_full + stage(gi), ring_parity(gi));
      static_for<kHeads>([&](auto jc) {
        constexpr int j = decltype(jc)::value;
        constexpr int pj = (j + kHeads - 1) % kHeads;  // the previous step's head
        const bool prev = j > 0 || it > 0;
        const int pg = j > 0 ? gi : gi - 1;  // its key tile
        wgmma_fence();
        issue_head_abt(sc, qt + head_offset(w.h0, j), k_tile(gi) + head_offset(w.h0, j));
        wgmma_commit();
        if (prev) mbar_wait(v_full + stage(pg), ring_parity(pg));
        issue_head_ab_fresh(pv, pa, prev ? v_tile(pg) + head_offset(w.h0, pj) : k_tile(gi));
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(pv);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) keep_live(pa[kk]);
        if (lane == 0) {
          if (j == kHeads - 1) mbar_arrive(k_empty + stage(gi));
          if (prev && pj == kHeads - 1) mbar_arrive(v_empty + stage(pg));
        }
        if (prev) {  // O = O exp(m_old - m_new) + P V, head pj
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[pj][i] = fmaf(acc[pj][i], corr[pj][(i >> 1) & 1], pv[i]);
        }
        if (ragged)
          softmax(jc, sc, it, std::true_type{});
        else
          softmax(jc, sc, it, std::false_type{});
        pack_a(pa, sc);
      });
    }
    g += tiles;
    {  // the last head's P V of the last tile
      constexpr int j = kHeads - 1;
      mbar_wait(v_full + stage(g - 1), ring_parity(g - 1));
      issue_head_ab_fresh(pv, pa, v_tile(g - 1) + head_offset(w.h0, j));
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) keep_live(pa[kk]);
      if (lane == 0) {
        mbar_arrive(v_empty + stage(g - 1));
        mbar_arrive(q_empty + 8 * (jj & 1));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(acc[j][i], corr[j][(i >> 1) & 1], pv[i]);
    }

    // o = O / sum in bf16, lse = m / sqrt(dh) + log(sum), rows below L only
#pragma unroll
    for (int j = 0; j < kHeads; ++j) {
      const int head = w.h0 + j;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sum = quad_sum(l[j][r]);
        const int row = row0 + 8 * r;
        if (row < length) {
          const float inv = 1.0f / sum;
          bf16* out = p.o + (static_cast<size_t>(w.n) * length + row) * p.d_model +
                      head * kDh + 2 * t;
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
            *reinterpret_cast<uint32_t*>(out + 8 * nb) = pack_bf16x2(
                acc[j][4 * nb + 2 * r] * inv, acc[j][4 * nb + 2 * r + 1] * inv);
          if (t == 0) {
            const size_t li =
                ((static_cast<size_t>(w.n) * groups + head / p.pack) * length + row) * p.pack +
                head % p.pack;
            p.lse[li] = m[j][r] * p.scale + logf(sum);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, pass 1: dq and delta
// ---------------------------------------------------------------------------

// Shared memory, from a 1024-aligned base: the item's Q, dO and O tiles,
// kStages K tiles, kStages V tiles, lse and delta of the item's rows (kHeads
// x 64 f32 each), then the mbarriers q_full, q_empty, k_full[], v_full[],
// k_empty[], v_empty[].
template <int kHeads>
struct DqLayout {
  static constexpr int kTile = Heads<kHeads>::kTile;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTile;
  static constexpr int kO = kDo + kTile;
  static constexpr int kK = kO + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kLse = kV + kStages * kTile;
  static constexpr int kDelta = kLse + 4 * kHeads * kRows;
  static constexpr int kBars = kDelta + 4 * kHeads * kRows;
  static constexpr size_t kSmem = kBars + 8 * (2 + 4 * kStages);
};

template <int kHeads, bool kDropout>
__global__ void __launch_bounds__(kThreads, kDqBlocks)
attn_bwd_dq_dh16_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o,
                        const __grid_constant__ CUtensorMap map_do, const Params p,
                        int items) {
  using L = DqLayout<kHeads>;
  constexpr int kCols = Heads<kHeads>::kCols;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023) __trap();
  float* lse_s = reinterpret_cast<float*>(smem_raw + L::kLse);  // [head][row]
  float* delta_s = reinterpret_cast<float*>(smem_raw + L::kDelta);
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  auto k_tile = [&](int g) { return base + L::kK + (g % kStages) * L::kTile; };
  auto v_tile = [&](int g) { return base + L::kV + (g % kStages) * L::kTile; };
  auto stage = [](int g) { return 8 * (g % kStages); };
  const int length = p.length;
  const int tiles = (length + kRows - 1) / kRows;
  const int hblocks = p.heads / kHeads;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1 + 32);  // the loads' bytes and the producer lanes' lse
    mbar_init(q_empty, 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4);
      mbar_init(v_empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    const int lane = threadIdx.x % 32;
    int g = 0;
    int jj = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++jj) {
      const Item w(item, tiles, hblocks, kHeads);
      const int col = (w.h0 / 4) * 64;
      if (jj > 0) mbar_wait(q_empty, (jj - 1) & 1);  // the previous item's tiles are read
      if (lane == 0) {
        mbar_expect_tx(q_full, 3 * L::kTile);
        tma_tile<kCols>(base + L::kQ, &map_q, col, w.tile * kRows, w.n, q_full);
        tma_tile<kCols>(base + L::kDo, &map_do, col, w.tile * kRows, w.n, q_full);
        tma_tile<kCols>(base + L::kO, &map_o, col, w.tile * kRows, w.n, q_full);
      }
      for (int e = lane; e < kHeads * kRows; e += 32) {
        const int j = e / kRows, r = e % kRows;
        const int row = w.tile * kRows + r;
        lse_s[e] = row < length ? head_lse(p.lse_in, w.n, w.h0 + j, p.heads, p.pack,
                                           length)[static_cast<size_t>(row) * p.pack] *
                                      kLog2e
                                : INFINITY;
      }
      mbar_arrive(q_full);
      if (lane != 0) {
        g += tiles;
        continue;
      }
      for (int it = 0; it < tiles; ++it, ++g) {
        const int s = stage(g);
        const uint32_t released = ring_parity(g) ^ 1;
        if (g >= kStages) mbar_wait(k_empty + s, released);
        mbar_expect_tx(k_full + s, L::kTile);
        tma_tile<kCols>(k_tile(g), &map_k, col, it * kRows, w.n, k_full + s);
        if (g >= kStages) mbar_wait(v_empty + s, released);
        mbar_expect_tx(v_full + s, L::kTile);
        tma_tile<kCols>(v_tile(g), &map_v, col, it * kRows, w.n, v_full + s);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const float c = p.scale_log2;
  const uint32_t ncols = static_cast<uint32_t>(p.pack) * length;
  int g = 0;
  int jj = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++jj) {
    const Item w(item, tiles, hblocks, kHeads);
    const int row0 = w.tile * kRows + 16 * warp + gq;
    const ItemDrop drop = item_drop<kDropout>(p, w.n, w.h0);
    uint32_t index0[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      index0[r] = static_cast<uint32_t>(row0 + 8 * r) * ncols +
                  static_cast<uint32_t>(w.h0 % p.pack) * length + 2 * t;
    mbar_wait(q_full, jj & 1);

    // delta of the item's rows and heads from the O and dO tiles: a (row,
    // head) pair's 16 columns are 16-byte chunks 2 (h % 4) and + 1 of its
    // box row, chunk ch of row r at ch ^ (r % 8) (the 128-byte swizzle)
    for (int e = threadIdx.x; e < kHeads * kRows; e += 128) {
      const int j = e / kRows, r = e % kRows;
      const int idx = (w.h0 & 3) + j;
      float part = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int off = (idx >> 2) * kBoxBytes + r * 128 + ((((idx & 3) * 2 + cc) ^ (r & 7)) * 16);
        const uint4 a = *reinterpret_cast<const uint4*>(smem_raw + L::kO + off);
        const uint4 b = *reinterpret_cast<const uint4*>(smem_raw + L::kDo + off);
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
        const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          part = fmaf(__uint_as_float(aw[q] << 16), __uint_as_float(bw[q] << 16), part);
          part = fmaf(__uint_as_float(aw[q] & 0xffff0000u),
                      __uint_as_float(bw[q] & 0xffff0000u), part);
        }
      }
      delta_s[e] = part;
      const int row = w.tile * kRows + r;
      if (row < length)
        p.delta[(static_cast<size_t>(w.n) * p.heads + w.h0 + j) * length + row] = part;
    }
    warpgroup_sync();

    float acc[kHeads][8];
#pragma unroll
    for (int j = 0; j < kHeads; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] = 0.0f;
    float sc[32], dp[32];
    uint32_t pa[4][4];

    // head j's ds of key tile it in place of its scores (keys past L masked
    // on the last tile only)
    auto take_ds = [&](auto jc, int it, auto masked) {
      constexpr int j = decltype(jc)::value;
      constexpr bool kMask = decltype(masked)::value;
      const int t0 = it * kRows;
      float lse2[2], delta_r[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = lse_s[j * kRows + 16 * warp + gq + 8 * r];
        delta_r[r] = delta_s[j * kRows + 16 * warp + gq + 8 * r];
      }
      uint32_t ib[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        ib[r] = kDropout ? opaque(index0[r] + static_cast<uint32_t>(j * length + t0)) : 0u;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float pv = ex2(fmaf(sc[i], c, -lse2[r]));
        if (kMask && t0 + 8 * (i / 4) + 2 * t + (i & 1) >= length) pv = 0.0f;
        float dpv = dp[i];
        if (kDropout) {
          const uint32_t index = ib[r] + 8 * (i / 4) + (i & 1);
          dpv = keep_mixed(index, drop.mkey, drop.limit) ? dpv * drop.scale : 0.0f;
        }
        sc[i] = pv * (dpv - delta_r[r]) * p.scale;
      }
    };

    // Per key tile, the heads in turn: S = Q K^T and dP = dO V^T, ds in
    // registers, then dQ += ds K, each product waited for before the next
    // step (overlapping them held more registers: fewer blocks an SM).
    for (int it = 0; it < tiles; ++it) {
      const int gi = g + it;
      const bool ragged = it == tiles - 1 && length % kRows != 0;
      mbar_wait(k_full + stage(gi), ring_parity(gi));
      mbar_wait(v_full + stage(gi), ring_parity(gi));
      static_for<kHeads>([&](auto jc) {
        constexpr int j = decltype(jc)::value;
        wgmma_fence();
        issue_head_abt(sc, base + L::kQ + head_offset(w.h0, j), k_tile(gi) + head_offset(w.h0, j));
        issue_head_abt(dp, base + L::kDo + head_offset(w.h0, j),
                       v_tile(gi) + head_offset(w.h0, j));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if (j == kHeads - 1 && lane == 0) mbar_arrive(v_empty + stage(gi));
        if (ragged)
          take_ds(jc, it, std::true_type{});
        else
          take_ds(jc, it, std::false_type{});
        // the item's tiles, lse and delta are read: the next item's may load
        if (j == kHeads - 1 && it == tiles - 1 && lane == 0) mbar_arrive(q_empty);
        pack_a(pa, sc);
        issue_head_ab(acc[j], pa, k_tile(gi) + head_offset(w.h0, j));
        wgmma_wait<0>();
        fence_regs(acc[j]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) keep_live(pa[kk]);
        if (j == kHeads - 1 && lane == 0) mbar_arrive(k_empty + stage(gi));
      });
    }
    g += tiles;
#pragma unroll
    for (int j = 0; j < kHeads; ++j) store_head_rows(p.dq, acc[j], p, w.n, w.h0 + j, row0, t);
  }
}

// ---------------------------------------------------------------------------
// Backward, pass 2: dk and dv
// ---------------------------------------------------------------------------

// Shared memory, from a 1024-aligned base: the item's K and V tiles,
// kStages Q tiles, kStages dO tiles, kStages (lse, delta) blocks of kHeads x
// 2 x 64 f32, then the mbarriers kv_full, kv_empty, qd_full[], qd_empty[].
template <int kHeads>
struct DkvLayout {
  static constexpr int kTile = Heads<kHeads>::kTile;
  static constexpr int kStatBytes = kHeads * 2 * kRows * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;
  static constexpr int kDo = kQ + kStages * kTile;
  static constexpr int kStats = kDo + kStages * kTile;
  static constexpr int kBars = kStats + kStages * kStatBytes;
  static constexpr size_t kSmem = kBars + 8 * (2 + 2 * kStages);
};

template <int kHeads, bool kDropout>
__global__ void __launch_bounds__(kThreads, kDkvBlocks)
attn_bwd_dkv_dh16_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do, const Params p,
                         int items) {
  using L = DkvLayout<kHeads>;
  constexpr int kCols = Heads<kHeads>::kCols;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023) __trap();
  const uint32_t kv_full = base + L::kBars;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t qd_full = kv_empty + 8;  // stage s's barrier at + 8 s
  const uint32_t qd_empty = qd_full + 8 * kStages;
  auto q_tile = [&](int g) { return base + L::kQ + (g % kStages) * L::kTile; };
  auto do_tile = [&](int g) { return base + L::kDo + (g % kStages) * L::kTile; };
  // stage s's lse (times log2 e) of its 64 queries for each head, then their delta
  auto stats = [&](int g) {
    return reinterpret_cast<float*>(smem_raw + L::kStats + (g % kStages) * L::kStatBytes);
  };
  auto stage = [](int g) { return 8 * (g % kStages); };
  const int length = p.length;
  const int tiles = (length + kRows - 1) / kRows;
  const int hblocks = p.heads / kHeads;

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

  if (threadIdx.x >= 128) {  // the producer warp
    const int lane = threadIdx.x % 32;
    int g = 0;
    int jj = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++jj) {
      const Item w(item, tiles, hblocks, kHeads);
      const int col = (w.h0 / 4) * 64;
      if (jj > 0) mbar_wait(kv_empty, (jj - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kTile);
        tma_tile<kCols>(base + L::kK, &map_k, col, w.tile * kRows, w.n, kv_full);
        tma_tile<kCols>(base + L::kV, &map_v, col, w.tile * kRows, w.n, kv_full);
      }
      for (int it = 0; it < tiles; ++it, ++g) {
        const int s = stage(g);
        if (g >= kStages) mbar_wait(qd_empty + s, ring_parity(g) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(qd_full + s, 2 * L::kTile);
          tma_tile<kCols>(q_tile(g), &map_q, col, it * kRows, w.n, qd_full + s);
          tma_tile<kCols>(do_tile(g), &map_do, col, it * kRows, w.n, qd_full + s);
        }
        fill_stats<kHeads>(stats(g), p, w.n, w.h0, it, lane);
        mbar_arrive(qd_full + s);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const uint32_t ncols = static_cast<uint32_t>(p.pack) * length;
  int g = 0;
  int jj = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++jj) {
    const Item w(item, tiles, hblocks, kHeads);
    const int key0 = w.tile * kRows + 16 * warp + gq;  // the thread's keys key0, key0 + 8
    const ItemDrop drop = item_drop<kDropout>(p, w.n, w.h0);
    // the keep mask's index of query 2 t at the thread's keys of head 0 of
    // the item's group tile (head j adds j * L, query q adds q * pack * L)
    uint32_t index0[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      index0[r] = static_cast<uint32_t>(2 * t) * ncols +
                  static_cast<uint32_t>(w.h0 % p.pack) * length +
                  static_cast<uint32_t>(key0 + 8 * r);
    float dk[kHeads][8], dv[kHeads][8];
#pragma unroll
    for (int j = 0; j < kHeads; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) dk[j][e] = dv[j][e] = 0.0f;
    float st[32], dpt[32];
    uint32_t dsa[4][4], pda[4][4];

    // Per query tile, the heads in turn: S^T = K Q^T and dP^T = V dO^T,
    // ds^T and pd^T in registers, then dV += pd^T dO and dK += ds^T Q, each
    // group waited for before the next step.
    mbar_wait(kv_full, jj & 1);
    for (int it = 0; it < tiles; ++it) {
      const int gi = g + it;
      mbar_wait(qd_full + stage(gi), ring_parity(gi));
      static_for<kHeads>([&](auto jc) {
        constexpr int j = decltype(jc)::value;
        wgmma_fence();
        issue_head_abt(st, base + L::kK + head_offset(w.h0, j), q_tile(gi) + head_offset(w.h0, j));
        issue_head_abt(dpt, base + L::kV + head_offset(w.h0, j),
                       do_tile(gi) + head_offset(w.h0, j));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        if (j == kHeads - 1 && it == tiles - 1 && lane == 0) mbar_arrive(kv_empty);
        uint32_t ib[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          ib[r] = kDropout ? opaque(index0[r] + static_cast<uint32_t>(it * kRows) * ncols +
                                    static_cast<uint32_t>(j * length))
                           : 0u;
        take_ds_t<kDropout>(st, dpt, stats(gi) + 2 * j * kRows, ib, p, drop, ncols, t);
        pack_a(dsa, st);
        pack_a(pda, dpt);
        fence_regs(dv[j]);
        fence_regs(dk[j]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_n16(dv[j], pda[kk],
                       sw128_desc(do_tile(gi) + head_offset(w.h0, j) + kk * 16 * 128));
          wgmma_rs_n16(dk[j], dsa[kk],
                       sw128_desc(q_tile(gi) + head_offset(w.h0, j) + kk * 16 * 128));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv[j]);
        fence_regs(dk[j]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          keep_live(dsa[kk]);
          keep_live(pda[kk]);
        }
        if (j == kHeads - 1 && lane == 0) mbar_arrive(qd_empty + stage(gi));
      });
    }
    g += tiles;
#pragma unroll
    for (int j = 0; j < kHeads; ++j) {
      store_head_rows(p.dk, dk[j], p, w.n, w.h0 + j, key0, t);
      store_head_rows(p.dv, dv[j], p, w.n, w.h0 + j, key0, t);
    }
  }
}


// ---------------------------------------------------------------------------
// Backward in one pass (lists of up to kFusedMaxTiles 64-row tiles)
// ---------------------------------------------------------------------------

// delta = rowsum(f32(do) f32(o)) of every (row n, row, head): one thread a
// (row, head), whose kD = 16 columns are 32 contiguous bytes of o and of do.
template <int kD>
__global__ void attn_bwd_delta_dh16_kernel(const bf16* __restrict__ o,
                                           const bf16* __restrict__ dout, float* delta,
                                           int n, int length, int heads) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n) * length * heads) return;
  const int head = static_cast<int>(i % heads);
  const long long row = i / heads;  // n * L + row
  const uint4* a = reinterpret_cast<const uint4*>(o + i * kD);
  const uint4* b = reinterpret_cast<const uint4*>(dout + i * kD);
  float part = 0.0f;
#pragma unroll
  for (int cc = 0; cc < kD / 8; ++cc) {
    const uint4 x = a[cc], y = b[cc];
    const uint32_t aw[4] = {x.x, x.y, x.z, x.w};
    const uint32_t bw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      part = fmaf(__uint_as_float(aw[q] << 16), __uint_as_float(bw[q] << 16), part);
      part = fmaf(__uint_as_float(aw[q] & 0xffff0000u), __uint_as_float(bw[q] & 0xffff0000u),
                  part);
    }
  }
  const long long nn = row / length;
  delta[(nn * heads + head) * length + row % length] = part;
}

// Shared memory, from a 1024-aligned base: the key tile's K and V tiles,
// kStages Q tiles, kStages dO tiles, two dS^T tiles (64 keys x 64 queries,
// bf16, 128-byte swizzle), kStages (lse, delta) blocks of kHeads x 2 x 64
// f32, then the mbarriers kv_full, kv_empty, qd_full[], qd_empty[]; after
// them, dQ of the item's whole list in f32 (kHeads x tiles x 64 x 16, each
// thread's accumulator fragments side by side).
template <int kHeads>
struct FusedLayout {
  static constexpr int kTile = Heads<kHeads>::kTile;
  static constexpr int kStatBytes = kHeads * 2 * kRows * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;
  static constexpr int kDo = kQ + kStages * kTile;
  static constexpr int kDs = kDo + kStages * kTile;
  static constexpr int kStats = kDs + 2 * kBoxBytes;
  static constexpr int kBars = kStats + kStages * kStatBytes;
  static constexpr int kDq = kBars + 8 * (2 + 2 * kStages);
  static constexpr int kDqTile = 128 * 8 * 4;  // one head's dQ of a 64-row tile
  static constexpr size_t smem(int tiles) {
    return kDq + static_cast<size_t>(kHeads) * tiles * kDqTile;
  }
};

template <int kHeads, bool kDropout>
__global__ void __launch_bounds__(kThreads, kFusedBlocks)
attn_bwd_fused_dh16_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do, const Params p,
                           int items) {
  using L = FusedLayout<kHeads>;
  constexpr int kCols = Heads<kHeads>::kCols;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023) __trap();
  const uint32_t kv_full = base + L::kBars;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t qd_full = kv_empty + 8;  // stage s's barrier at + 8 s
  const uint32_t qd_empty = qd_full + 8 * kStages;
  auto q_tile = [&](int g) { return base + L::kQ + (g % kStages) * L::kTile; };
  auto do_tile = [&](int g) { return base + L::kDo + (g % kStages) * L::kTile; };
  auto stats = [&](int g) {
    return reinterpret_cast<float*>(smem_raw + L::kStats + (g % kStages) * L::kStatBytes);
  };
  auto stage = [](int g) { return 8 * (g % kStages); };
  const int length = p.length;
  const int tiles = (length + kRows - 1) / kRows;
  const int hblocks = p.heads / kHeads;

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

  if (threadIdx.x >= 128) {  // the producer warp
    const int lane = threadIdx.x % 32;
    int g = 0;   // query tiles through the ring so far
    int kv = 0;  // key tiles loaded so far
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int h0 = item % hblocks * kHeads;
      const int n = item / hblocks;
      const int col = (h0 / 4) * 64;
      for (int kt = 0; kt < tiles; ++kt, ++kv) {
        if (kv > 0) mbar_wait(kv_empty, (kv - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(kv_full, 2 * L::kTile);
          tma_tile<kCols>(base + L::kK, &map_k, col, kt * kRows, n, kv_full);
          tma_tile<kCols>(base + L::kV, &map_v, col, kt * kRows, n, kv_full);
        }
        for (int it = 0; it < tiles; ++it, ++g) {
          const int s = stage(g);
          if (g >= kStages) mbar_wait(qd_empty + s, ring_parity(g) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(qd_full + s, 2 * L::kTile);
            tma_tile<kCols>(q_tile(g), &map_q, col, it * kRows, n, qd_full + s);
            tma_tile<kCols>(do_tile(g), &map_do, col, it * kRows, n, qd_full + s);
          }
          fill_stats<kHeads>(stats(g), p, n, h0, it, lane);
          mbar_arrive(qd_full + s);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const uint32_t ncols = static_cast<uint32_t>(p.pack) * length;
  float* dq_s = reinterpret_cast<float*>(smem_raw + L::kDq);  // [head][tile][thread][8]
  auto dq_slot = [&](int j, int it) {
    return reinterpret_cast<float4*>(dq_s + ((j * tiles + it) * 128 + threadIdx.x) * 8);
  };
  int g = 0;
  int kv = 0;
  int step = 0;  // dS^T tiles written so far: its buffer is step % 2
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int h0 = item % hblocks * kHeads;
    const int n = item / hblocks;
    const ItemDrop drop = item_drop<kDropout>(p, n, h0);
    for (int e = 0; e < kHeads * tiles; ++e) {
      float4* slot = reinterpret_cast<float4*>(dq_s + (e * 128 + threadIdx.x) * 8);
      slot[0] = slot[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int kt = 0; kt < tiles; ++kt, ++kv) {
      const int key0 = kt * kRows + 16 * warp + gq;  // the thread's keys key0, key0 + 8
      uint32_t index0[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        index0[r] = static_cast<uint32_t>(2 * t) * ncols +
                    static_cast<uint32_t>(h0 % p.pack) * length +
                    static_cast<uint32_t>(key0 + 8 * r);
      float dk[kHeads][8], dv[kHeads][8];
#pragma unroll
      for (int j = 0; j < kHeads; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) dk[j][e] = dv[j][e] = 0.0f;
      mbar_wait(kv_full, kv & 1);
      // Step (it, j) takes head j on query tile it: S^T = K Q^T and dP^T =
      // V dO^T, dS^T and pd^T in registers, dS^T through shared memory (the
      // MN-major A of dQ = dS K), then dV, dK and dQ together. Issuing the
      // next step's scores behind them (their registers kept apart) read
      // slower.
      for (int it = 0; it < tiles; ++it) {
        const int gi = g + it;
        mbar_wait(qd_full + stage(gi), ring_parity(gi));
        static_for<kHeads>([&](auto jc) {
          constexpr int j = decltype(jc)::value;
          float st[32], dpt[32], dqa[8];
          uint32_t dsa[4][4], pda[4][4];
          wgmma_fence();
          issue_head_abt(st, base + L::kK + head_offset(h0, j), q_tile(gi) + head_offset(h0, j));
          issue_head_abt(dpt, base + L::kV + head_offset(h0, j),
                         do_tile(gi) + head_offset(h0, j));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(st);
          fence_regs(dpt);
          uint32_t ib[2];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            ib[r] = kDropout ? opaque(index0[r] + static_cast<uint32_t>(it * kRows) * ncols +
                                      static_cast<uint32_t>(j * length))
                             : 0u;
          take_ds_t<kDropout>(st, dpt, stats(gi) + 2 * j * kRows, ib, p, drop, ncols, t);
          pack_a(dsa, st);
          pack_a(pda, dpt);
          // dS^T into this step's tile: row key (16 warp + gq + 8 (x & 1)),
          // 16-byte chunk nb = 2 kk + (x >> 1) of queries at chunk nb ^ gq
          const uint32_t ds_tile = L::kDs + (step % 2) * kBoxBytes;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int row = 16 * warp + gq + 8 * (x & 1);
              const int nb = 2 * kk + (x >> 1);
              *reinterpret_cast<uint32_t*>(smem_raw + ds_tile + row * 128 +
                                           ((nb ^ gq) * 16) + 4 * t) = dsa[kk][x];
            }
          fence_proxy_async();
          warpgroup_sync();
          // dV += pd^T dO, dK += dS^T Q, and dQ of the query tile += dS K
          float4* slot = dq_slot(j, it);
          {
            const float4 lo = slot[0], hi = slot[1];
            dqa[0] = lo.x; dqa[1] = lo.y; dqa[2] = lo.z; dqa[3] = lo.w;
            dqa[4] = hi.x; dqa[5] = hi.y; dqa[6] = hi.z; dqa[7] = hi.w;
          }
          fence_regs(dv[j]);
          fence_regs(dk[j]);
          fence_regs(dqa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs_n16(dv[j], pda[kk],
                         sw128_desc(do_tile(gi) + head_offset(h0, j) + kk * 16 * 128));
            wgmma_rs_n16(dk[j], dsa[kk],
                         sw128_desc(q_tile(gi) + head_offset(h0, j) + kk * 16 * 128));
            wgmma_ss_tt_n16(dqa, sw128_desc(base + ds_tile + kk * 16 * 128),
                            sw128_desc(base + L::kK + head_offset(h0, j) + kk * 16 * 128));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv[j]);
          fence_regs(dk[j]);
          fence_regs(dqa);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            keep_live(dsa[kk]);
            keep_live(pda[kk]);
          }
          slot[0] = make_float4(dqa[0], dqa[1], dqa[2], dqa[3]);
          slot[1] = make_float4(dqa[4], dqa[5], dqa[6], dqa[7]);
          ++step;
          if (j == kHeads - 1 && lane == 0) mbar_arrive(qd_empty + stage(gi));
        });
      }
      g += tiles;
      if (lane == 0) mbar_arrive(kv_empty);  // K and V are read
#pragma unroll
      for (int j = 0; j < kHeads; ++j) {
        store_head_rows(p.dk, dk[j], p, n, h0 + j, key0, t);
        store_head_rows(p.dv, dv[j], p, n, h0 + j, key0, t);
      }
    }
    // dQ of the whole list, each thread its own fragments
    for (int it = 0; it < tiles; ++it) {
#pragma unroll
      for (int j = 0; j < kHeads; ++j) {
        const float4* slot = dq_slot(j, it);
        const float4 lo = slot[0], hi = slot[1];
        const float dqa[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        store_head_rows(p.dq, dqa, p, n, h0 + j, it * kRows + 16 * warp + gq, t);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// The persistent grid of `kernel`: as many blocks as the card holds at once
// (asked of the first card launched on, and kept by the caller), at most
// one a work item.
inline int grid_of(int resident, int items) { return resident < items ? resident : items; }

template <bool kDropout>
int run_fwd(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
               const Params& p, int items, cudaStream_t stream) {
  constexpr size_t kSmem = FwdLayout<kFwdHeads>::kSmem;
  auto kernel = attn_fwd_dh16_kernel<kFwdHeads, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int resident = resident_blocks(kernel, kThreads, kSmem);
  kernel<<<grid_of(resident, items), kThreads, kSmem, stream>>>(mq, mk, mv, p, items);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDropout>
int run_bwd(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
               const CUtensorMap& mo, const CUtensorMap& mdo, const Params& p, int n,
               int tiles, cudaStream_t stream) {
  constexpr size_t kDqSmem = DqLayout<kDqHeads>::kSmem;
  constexpr size_t kDkvSmem = DkvLayout<kDkvHeads>::kSmem;
  auto dq_kernel = attn_bwd_dq_dh16_kernel<kDqHeads, kDropout>;
  auto dkv_kernel = attn_bwd_dkv_dh16_kernel<kDkvHeads, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kDqSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int dq_resident = resident_blocks(dq_kernel, kThreads, kDqSmem);
  static const int dkv_resident = resident_blocks(dkv_kernel, kThreads, kDkvSmem);
  const int dq_items = n * (p.heads / kDqHeads) * tiles;
  const int dkv_items = n * (p.heads / kDkvHeads) * tiles;
  dq_kernel<<<grid_of(dq_resident, dq_items), kThreads, kDqSmem, stream>>>(mq, mk, mv, mo, mdo,
                                                                         p, dq_items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<grid_of(dkv_resident, dkv_items), kThreads, kDkvSmem, stream>>>(
      mq, mk, mv, mdo, p, dkv_items);
  return static_cast<int>(cudaGetLastError());
}

// The one-pass backward over lists of `tiles` <= kFusedMaxTiles 64-row
// tiles: delta by its own small kernel, then the pass.
template <bool kDropout>
int run_bwd_fused(const void* o, const void* dout, const CUtensorMap& mq,
                  const CUtensorMap& mk, const CUtensorMap& mv, const CUtensorMap& mdo,
                  const Params& p, int n, int tiles, cudaStream_t stream) {
  using L = FusedLayout<kFusedHeads>;
  auto kernel = attn_bwd_fused_dh16_kernel<kFusedHeads, kDropout>;
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::smem(kFusedMaxTiles)));
  if (set != cudaSuccess) return static_cast<int>(set);
  // the persistent grid at each list length's shared memory (asked of the
  // first card launched on, and kept)
  static int resident[kFusedMaxTiles + 1] = {};
  if (resident[tiles] == 0) resident[tiles] = resident_blocks(kernel, kThreads, L::smem(tiles));
  const long long rows = static_cast<long long>(n) * p.length * p.heads;
  attn_bwd_delta_dh16_kernel<kDh><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), p.delta, n, p.length,
      p.heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = n * (p.heads / kFusedHeads);
  kernel<<<grid_of(resident[tiles], items), kThreads, L::smem(tiles), stream>>>(mq, mk, mv, mdo,
                                                                              p, items);
  return static_cast<int>(cudaGetLastError());
}

// The scalars shared by both directions; false where a tensor's work items
// would not fit an int.
inline bool make_params(Params& p, int n, int length, int heads, int pack,
                        const Dropout& drop, const void* streams) {
  const long long items = static_cast<long long>(n) * heads * ((length + kRows - 1) / kRows);
  if (items > 0x7fffffffLL || heads % 8 != 0) return false;
  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  p.streams = static_cast<const int32_t*>(streams);
  p.length = length;
  p.d_model = heads * kDh;
  p.heads = heads;
  p.pack = pack;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.drop = drop;
  return true;
}

}  // namespace dh16

// The forward over n rows of `heads` heads of dh = 16 (d_model = 16 heads,
// heads a multiple of 8): the bf16 launch of attention_packed_fwd.cu at
// dh = 16. Returns cudaGetLastError(), or cudaErrorInvalidValue where a
// tensor map cannot be encoded or the shape is refused.
inline int launch_attn_fwd_dh16(const void* q, const void* k, const void* v, void* o,
                                void* lse, const void* streams, int n, int length, int heads,
                                int pack, const Dropout& drop, cudaStream_t stream) {
  using namespace dh16;
  Params p{};
  if (!make_params(p, n, length, heads, pack, drop, streams))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, n, length, p.d_model) || !encode_map(&mk, k, n, length, p.d_model) ||
      !encode_map(&mv, v, n, length, p.d_model))
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = n * (heads / kFwdHeads) * ((length + kRows - 1) / kRows);
  return drop.on() ? dh16::run_fwd<true>(mq, mk, mv, p, items, stream)
                   : dh16::run_fwd<false>(mq, mk, mv, p, items, stream);
}

// Both backward passes over n rows of `heads` heads of dh = 16, `delta` an
// (n, heads, L) f32 scratch array: the bf16 launch of attention_packed_bwd.cu
// at dh = 16. Returns the first error, or cudaErrorInvalidValue where a
// tensor map cannot be encoded or the shape is refused.
inline int launch_attn_bwd_dh16(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, const void* streams,
                                void* dq, void* dk, void* dv, void* delta, int n, int length,
                                int heads, int pack, const Dropout& drop,
                                cudaStream_t stream) {
  using namespace dh16;
  Params p{};
  if (!make_params(p, n, length, heads, pack, drop, streams))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.delta = static_cast<float*>(delta);
  p.lse_in = static_cast<const float*>(lse);
  CUtensorMap mq, mk, mv, mo, mdo;
  if (!encode_map(&mq, q, n, length, p.d_model) || !encode_map(&mk, k, n, length, p.d_model) ||
      !encode_map(&mv, v, n, length, p.d_model) || !encode_map(&mo, o, n, length, p.d_model) ||
      !encode_map(&mdo, dout, n, length, p.d_model))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (length + kRows - 1) / kRows;
  if (tiles <= kFusedMaxTiles)
    return drop.on() ? dh16::run_bwd_fused<true>(o, dout, mq, mk, mv, mdo, p, n, tiles, stream)
                     : dh16::run_bwd_fused<false>(o, dout, mq, mk, mv, mdo, p, n, tiles,
                                                  stream);
  return drop.on() ? dh16::run_bwd<true>(mq, mk, mv, mo, mdo, p, n, tiles, stream)
                   : dh16::run_bwd<false>(mq, mk, mv, mo, mdo, p, n, tiles, stream);
}

}  // namespace rlt
