// attention_bf16_wgmma: the bf16 attention forward at dh = 64 (K5''s packed
// heads, attention_packed_fwd.cu) and dh = 128 (K3''s slices,
// attention_fwd.cu: one head of D = 128 in a group of pack 1), written for
// Hopper: tiles by TMA into a ring guarded by mbarriers, products by wgmma.
// (dh = 16, Choopy's and MtChoopy's heads, is attention_bf16_dh16.cuh's.)
//
// Replaces the bf16 form of rlt_tpu/ops/attention.py::_attn_fwd_packed_kernel
// (:369, through _fwd_packed) and ::_attn_fwd_kernel (:89, through
// _fwd_pallas), whose `_mxu` keeps bf16 operands bf16. It computes what the
// first bf16 kernel (an mma.sync design, since removed) computed:
// o = softmax(q k^T / sqrt(dh)) v per head with bf16 q, k and v; S summed in
// f32 (a product of two bf16 values is exact in f32); the running max, the
// weights e = exp(s - m), their sum and lse = m + log(sum) in f32; each
// weight rounded once to bf16 against the running max before P V, O
// rescaled by exp(m_old - m_new) and divided by the f32 sum at the end; o
// written in bf16 and lse in f32 in the f32 kernels' layout (N, H / pack, L,
// pack), which for the per-slice kernel is (N, 1, L). tests/test_torch_bf16.py
// emulates this order of rounding in numpy and holds it to the JAX kernel.
// The exponential is taken as 2^(s c - m c) with c = log2(e) / sqrt(dh),
// one FFMA and one MUFU.EX2 a score, its results below 2^-126 flushed to 0
// (lse = m / sqrt(dh) + log(sum)). At a dropout rate above 0 each weight is
// dropped by keep_mask.cuh's keep_element at index row * pack * L +
// (head % pack) * L + col on its group's stream, and the kept ones scaled
// by 1 / (1 - rate) before the rounding, the launch's rate or the row's
// own (keep_mask.cuh's Dropout, read once a work item, so that the rate
// follows the item and not the block); lse stays the pre-dropout one. The
// bf16 backward (attention_bf16_bwd_wgmma.cuh) regenerates the same bits
// from the same index.
//
// What bounds it on an H100: by the roofline the bytes, 2 an element of q,
// k, v and o: at N = 189 rows of 4 heads of dh = 64 and L = 300, or 378
// slices of dh = 128, 116 MB, 0.035 ms at 3.35 TB/s, against 0.018 ms of
// bf16 products at 989 TFLOP/s and about as long for the exponentials at 16
// MUFU.EX2 a clock an SM (dh = 64; half that at 128). The kernel it
// replaces read 3.6-4.0x that bound (PERF.md §6): each warp waited on a
// serial chain of its own mma.sync products, then on its exponentials; a
// block of five tiles exposed its prologue (Q and the first K/V tile
// before any product) and crossed two __syncthreads a tile; and the rate-0
// launch ran the dropout instance's code and a column test on every score.
// At L = 300 the work is short lists: a (row, head) pair is five 64-key
// tiles, so what a work item costs before its first product and after its
// last one weighs as much as the steady state.
//
// Design. A work item is 64 query rows of one (row n, head). A block is one
// consumer warpgroup (128 threads, the 64 rows) and one producer warp, and the
// grid is persistent: as many blocks as the card holds at once, each walking
// the items blockIdx.x, + gridDim.x, ... in order (the row tiles of a head side
// by side, so their K and V are read from L2 together); two blocks share an SM
// at dh = 128, three at 64. The producer's lane 0 loads each item's Q tile and
// streams its K and V tiles of 64 keys through a ring of two stages by TMA
// (cp.async.bulk.tensor over 3-D tensor maps of the (N, L, D) arrays, boxes of
// 64 columns = 128 bytes by 64 rows, 128-byte swizzle; rows past L
// zero-filled), every K and V tile on an mbarrier of its own; the consumer
// warps release each K tile, each V tile and each Q tile through mbarriers of
// their own (one arrival a warp), so the next item's Q and first tiles load
// while the current item finishes. The warpgroup computes S = Q K^T as
// wgmma.m64n64k16 with both operands from shared memory (K-major descriptors of
// the 128-byte swizzle, the k-step an offset of 32 bytes within the swizzled
// row), and O += P V as the register-A wgmma.m64n64k16 with V through a
// transposed (MN-major) descriptor, 64 columns of O a product: the accumulator
// of keys 16 kk .. +15, rounded and packed to bf16x2, is the k-step's A
// fragment, as with mma.sync. The loop is software-pipelined: tile it's S is
// issued, O is rescaled while it runs, tile it - 1's P V is queued behind it,
// and tile it's softmax runs while that P V does (a row's max and sum as four
// chains a thread). Only the last tile of a ragged L masks its keys; the rate-0
// instance (kDropout = false) carries no mask code. Shared memory (40 KiB at
// dh = 64, 80 KiB at dh = 128) does not grow with L, and any 1 <= L <= 65535 is
// taken. So each K/V tile still crosses from L2 once for every 64 query rows
// (five times a head at L = 300). Tried and dropped (PERF.md §6 has the times):
// two to four consumer warpgroups a block sharing each K/V tile (fewer
// warpgroups an SM: slower); clusters of 2 to 8 such blocks, the row tiles of
// one head, each K/V tile loaded once by TMA multicast into all of them
// (1.7-3.3x slower); 128-key tiles (registers); Q's fragments in registers (at
// most 4% at dh = 128, for 30 more registers); the loads issued by a consumer
// thread instead of a producer warp (slower); each tile in turn without the
// pipelining (2-4% slower at rate 0); a grid of one block a work item instead
// of the persistent one (slower); three ring stages or three blocks an SM
// (within 2%).
//
// The device pieces it shares with the backward (TMA, mbarriers, the two
// wgmma operand forms and their fragment layouts, the tensor maps) are in
// hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "hopper.cuh"
#include "keep_mask.cuh"

namespace rlt {
namespace wgmma_fwd {

using namespace sm90;

constexpr int kThreads = 128 + 32;      // a consumer warpgroup and a producer warp

constexpr int kStages = 2;              // K and V ring stages
constexpr int kBlocksPerSm = 2;         // at least two blocks of five warps: 168 registers a thread

// Shared memory, from a 1024-aligned base: Q's tile, kStages K tiles,
// kStages V tiles (each dh / 64 boxes of 64 rows x 128 bytes), then the
// mbarriers q_full, q_empty, k_full[], v_full[], k_empty[], v_empty[].
template <int kDh>
struct Layout {
  static_assert(kDh % 64 == 0, "64-column chunks");
  static constexpr int kChunks = kDh / 64;
  static constexpr int kTileBytes = kChunks * kBoxBytes;  // a Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr size_t kSmem = kBars + 8 * (2 + 4 * kStages);
};

// The scalars of one launch.
struct Params {
  bf16* o;
  float* lse;
  const int32_t* streams;
  int length, d_model, heads, pack;
  int items;         // (row n, head, 64-row tile) work items: n * heads * tiles
  float scale;       // 1 / sqrt(dh)
  float scale_log2;  // log2(e) / sqrt(dh)
  Dropout drop;
};

template <int kDh, bool kDropout>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const Params p) {
  using L = Layout<kDh>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023) __trap();  // the swizzled tiles need a 1024-byte aligned base
  const uint32_t q_tile = base + L::kQ;
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;  // stage s's barrier at + 8 s
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  auto k_tile = [&](int g) { return base + L::kK + (g % kStages) * L::kTileBytes; };
  auto v_tile = [&](int g) { return base + L::kV + (g % kStages) * L::kTileBytes; };
  auto parity = [](int g) { return static_cast<uint32_t>((g / kStages) & 1); };

  const int length = p.length;
  const int tiles = (length + kRows - 1) / kRows;  // key tiles, and row tiles

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4);  // one arrival per consumer warp
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
    for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++jj) {
      const int qt = item % tiles;
      const int col = (item / tiles) % p.heads * kDh;
      const int n = item / tiles / p.heads;
      if (jj > 0) mbar_wait(q_empty, (jj - 1) & 1);  // the previous item's Q is read
      mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_load(q_tile + c * kBoxBytes, &map_q, col + 64 * c, qt * kRows, n, q_full);
      for (int it = 0; it < tiles; ++it, ++g) {
        const int s = g % kStages;
        const uint32_t released = parity(g) ^ 1;  // the stage's last release
        if (g >= kStages) mbar_wait(k_empty + 8 * s, released);
        mbar_expect_tx(k_full + 8 * s, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load(k_tile(g) + c * kBoxBytes, &map_k, col + 64 * c, it * kRows, n,
                   k_full + 8 * s);
        if (g >= kStages) mbar_wait(v_empty + 8 * s, released);
        mbar_expect_tx(v_full + 8 * s, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load(v_tile(g) + c * kBoxBytes, &map_v, col + 64 * c, it * kRows, n,
                   v_full + 8 * s);
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
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++jj) {
    const int qt = item % tiles;
    const int head = (item / tiles) % p.heads;
    const int n = item / tiles / p.heads;
    const int row0 = qt * kRows + 16 * warp + gq;  // the thread's rows row0 and row0 + 8
    // the head's keep mask: columns (head % pack) * L + j of its group's tile
    const uint32_t col0 = static_cast<uint32_t>(head % p.pack) * length;
    const uint32_t key =
        kDropout ? stream_key(group_stream(p.streams[n], head / p.pack)) : 0u;
    const uint32_t limit = kDropout ? p.drop.limit(n) : 0u;
    const float inv_keep = kDropout ? p.drop.scale_of(n) : 1.0f;

    // rows row0 and row0 + 8: running max (of the raw scores), this thread's
    // share of the running sum, O's rescale for the tile just taken, and O
    // (kChunks chunks of 64 columns)
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};
    float corr[2];
    float acc[kChunks][32];
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[j][e] = 0.0f;
    float sc[32];
    uint32_t pa[4][4];

    // tile it's scores -> its weights in sc (the keys past L masked on the
    // last tile only), m and l updated, corr = exp(m_old - m_new)
    auto softmax = [&](int it, auto masked) {
      constexpr bool kMask = decltype(masked)::value;
      const int t0 = it * kRows;
      // the thread's 16 scores of row row0 + 8 r are sc[4 nb + 2 r + e]; their
      // max and sum run as four chains a row, not one
      float part[2][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (kMask && t0 + 8 * (i / 4) + 2 * t + (i & 1) >= length) sc[i] = -INFINITY;
        float& x = part[(i >> 1) & 1][(i >> 2) & 3];  // nb and nb + 4, e = 0 and 1
        x = i < 16 && !(i & 1) ? sc[i] : fmaxf(x, sc[i]);
      }
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = quad_max(fmaxf(fmaxf(m[r], fmaxf(part[r][0], part[r][1])),
                                           fmaxf(part[r][2], part[r][3])));  // key t0 < L: finite
        corr[r] = ex2((m[r] - m_new) * c);  // 0 on the first tile
        m[r] = m_new;
        mc[r] = m_new * c;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float w = ex2(fmaf(sc[i], c, -mc[r]));  // 0 past L
        float& x = part[r][(i >> 2) & 3];
        x = i < 16 && !(i & 1) ? w : x + w;
        if (kDropout) {
          const uint32_t index = static_cast<uint32_t>(row0 + 8 * r) * ncols + col0 + t0 +
                                 8 * (i / 4) + 2 * t + (i & 1);
          sc[i] = keep_element(index, key, limit) ? w * inv_keep : 0.0f;
        } else {
          sc[i] = w;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * corr[r] + ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
    };
    auto take_softmax = [&](int it) {
      if (it == tiles - 1 && length % kRows != 0)
        softmax(it, std::true_type{});
      else
        softmax(it, std::false_type{});
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int j = 0; j < kChunks; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] *= corr[(i >> 1) & 1];
    };
    // the warp is done with Q: after the item's last S = Q K^T
    auto release_q = [&]() {
      if (lane == 0) mbar_arrive(q_empty);
    };

    // Tile 0's scores and weights; then, for each later tile, its S = Q K^T
    // runs on the tensor cores while O is rescaled and the previous tile's
    // P V is queued behind it, and its softmax runs while that P V does.
    mbar_wait(q_full, jj & 1);
    mbar_wait(k_full + 8 * (g % kStages), parity(g));
    issue_abt<kDh>(sc, q_tile, k_tile(g));
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty + 8 * (g % kStages));
    if (tiles == 1) release_q();
    take_softmax(0);
    pack_a(pa, sc);
    for (int it = 1; it < tiles; ++it) {
      const int gi = g + it;
      mbar_wait(k_full + 8 * (gi % kStages), parity(gi));
      issue_abt<kDh>(sc, q_tile, k_tile(gi));
      rescale_o();
      mbar_wait(v_full + 8 * ((gi - 1) % kStages), parity(gi - 1));
      issue_ab<kDh>(acc, pa, v_tile(gi - 1));
      wgmma_wait<1>();  // S of tile it
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty + 8 * (gi % kStages));
      if (it == tiles - 1) release_q();
      take_softmax(it);
      wgmma_wait<0>();  // P V of tile it - 1
#pragma unroll
      for (int j = 0; j < kChunks; ++j) fence_regs(acc[j]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) keep_live(pa[kk]);
      if (lane == 0) mbar_arrive(v_empty + 8 * ((gi - 1) % kStages));
      pack_a(pa, sc);
    }
    g += tiles;
    rescale_o();
    mbar_wait(v_full + 8 * ((g - 1) % kStages), parity(g - 1));
    issue_ab<kDh>(acc, pa, v_tile(g - 1));
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kChunks; ++j) fence_regs(acc[j]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) keep_live(pa[kk]);
    if (lane == 0) mbar_arrive(v_empty + 8 * ((g - 1) % kStages));

    // o = O / sum in bf16, lse = m / sqrt(dh) + log(sum), rows below L only
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[r]);
      const int row = row0 + 8 * r;
      if (row < length) {
        const float inv = 1.0f / sum;
        bf16* out = p.o + (static_cast<size_t>(n) * length + row) * p.d_model + head * kDh +
                    2 * t;
#pragma unroll
        for (int j = 0; j < kChunks; ++j)
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
            *reinterpret_cast<uint32_t*>(out + 64 * j + 8 * nb) = pack_bf16x2(
                acc[j][4 * nb + 2 * r] * inv, acc[j][4 * nb + 2 * r + 1] * inv);
        if (t == 0) {
          const size_t li =
              ((static_cast<size_t>(n) * groups + head / p.pack) * length + row) * p.pack +
              head % p.pack;
          p.lse[li] = m[r] * p.scale + logf(sum);
        }
      }
    }
  }
}

template <int kDh, bool kDropout>
int launch_instance(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                    const Params& p, cudaStream_t stream) {
  constexpr size_t kSmem = Layout<kDh>::kSmem;
  auto kernel = attn_fwd_wgmma_kernel<kDh, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the persistent grid: as many blocks as the card holds at once (asked of
  // the first card launched on, and kept)
  static const int resident = resident_blocks(kernel, kThreads, kSmem);
  const int grid = resident < p.items ? resident : p.items;
  kernel<<<grid, kThreads, kSmem, stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma_fwd

// Launch over n rows of `heads` heads of width kDh (d_model = heads * kDh),
// the launch of attention_packed_fwd.cu (dh = 64) and attention_fwd.cu (dh =
// 128); returns cudaGetLastError(), or cudaErrorInvalidValue where a tensor
// map cannot be encoded.
template <int kDh>
int launch_attn_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                          const void* streams, int n, int length, int heads, int pack,
                          const Dropout& drop, cudaStream_t stream) {
  using namespace wgmma_fwd;
  const int d_model = heads * kDh;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, n, length, d_model) || !encode_map(&mk, k, n, length, d_model) ||
      !encode_map(&mv, v, n, length, d_model))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(kDh));
  // the work items number under 2^31 for any q that fits on the card
  const long long items =
      static_cast<long long>(n) * heads * ((length + kRows - 1) / kRows);
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<bf16*>(o),
                 static_cast<float*>(lse),
                 static_cast<const int32_t*>(streams),
                 length,
                 d_model,
                 heads,
                 pack,
                 static_cast<int>(items),
                 scale,
                 scale * kLog2e,
                 drop};
  return drop.on() ? launch_instance<kDh, true>(mq, mk, mv, p, stream)
                   : launch_instance<kDh, false>(mq, mk, mv, p, stream);
}

}  // namespace rlt
