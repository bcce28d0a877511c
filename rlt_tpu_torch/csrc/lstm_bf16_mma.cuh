// lstm_bf16_mma: the bf16 instances of K1' (lstm_fwd.cu, rlt_lstm_fwd_bf16)
// and K2' (lstm_bwd.cu, rlt_lstm_bwd_bf16), written for Hopper's tensor
// cores. The float32 instances keep their CUDA-core kernels.
//
// Replaces the bf16 form of rlt_tpu/ops/lstm.py::_lstm_fwd_kernel (through
// _fwd_pallas) and ::_lstm_bwd_kernel (through _bwd_pallas), in K1''s and
// K2''s layout (ndir directions folded into the rows; lstm_fwd.cu and
// lstm_bwd.cu describe it), computing the function of the kernels they
// succeed: h, c, and in the backward dh, dc and dgates, carried in f32;
// gates = xw + h_{t-1} W_hh^T and dh_carry = dgates W_hh taken from the f32
// carry and the bf16 weights; hs and dxw rounded to bf16 as they are stored;
// cs and dW_hh^T f32.
//
// The tensor cores without another function: W_hh^T in bf16 is exact as a
// bf16 operand, and the f32 operand (h_{t-1} in K1', dgates in K2''s chain
// and in dW_hh^T) is given as three bf16 parts, x = hi + mid + lo: hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each difference
// exact in f32, so the parts hold x's 24 significant bits exactly (for
// |x| >= 2^-110; below that lo leaves bf16's normal range).
// A product of two bf16 values is exact in f32, and the tensor cores sum the
// partial products in f32: the result is the f32 function up to the order
// of summation (tests/test_torch_bf16_split.py holds both statements on the
// values h and dgates take). The gate recompute of K2' reads the rounded
// bf16 hs, so it is one bf16 x bf16 product.
//
// What bounds the chains on an H100: the L-step serial chain. The CUDA-core
// kernels they succeed re-read W_hh^T from shared memory every step (it is
// 256 KB in f32), for one row a block at B = 63, and widened each bf16
// weight by shifts: 1.75 us a step (PERF.md §6). Here a step takes 0.88 us
// at B = 63, about a third each in the product (the tensor pipe of mma.sync,
// 64 products an SM sub-partition), the activations, and the rest
// (shuffles, the split, the barrier). Here:
//
//  - W_hh^T stays in registers for the whole chain, as mma.sync.m16n8k16 A
//    fragments: a block of H / 16 warps (8 at H = 128) holds the whole 128 x
//    512 bf16 matrix of its direction, 128 registers a thread, and never
//    reads it from memory again.
//  - A step is one product per warp, the three parts of the carried operand
//    side by side in the product's N = 8 columns: column 2p + e is part p of
//    row e (p = 3 is zero), so a tile of 8 columns serves two rows and the
//    three parts cost one product, not three. Lane 4g + t of the
//    accumulator holds part t; two xor shuffles sum the parts and leave
//    each lane one (unit, row) pair: K1' gives warp w the four gates of
//    units 16w .. 16w + 15 (its m-tiles pair gates i, f and g, o of 8 units),
//    so the activations and c stay in the lane; K2' gives warp w the dh of
//    those units (K = 4H, four accumulators so that no chain of dependent
//    products is 32 long). A block takes 2 kNT rows (kNT n-tiles): the
//    launcher picks the fewest of 1, 2 and 4 n-tiles whose blocks fit the
//    SMs in one wave (csrc/lstm_fwd.cu's R = 4 at B = 256 cost 2.7x).
//  - The carried operand goes through a double-buffered shared array in
//    fragment order (one 16-byte load per lane and two k-steps): ONE
//    barrier a step.
//  - The step's inputs (xw in K1'; the gate coefficients, the dc factors
//    and dho in K2') are contiguous rows of a direction, so each step's
//    are bulk copies (cp.async.bulk) into a ring of shared memory kStages
//    steps ahead, completing on an mbarrier: the chain never waits on
//    device memory. The hs, cs and dxw stores stay off the chain.
//
// K2''s two products off the chain run on wgmma with TMA operands (the
// 128-byte swizzle of hopper.cuh): the gate recompute (L B x H) x (H x 4H)
// per direction with W_hh^T's tile resident in shared memory, and dW_hh^T =
// hs^T dgates over (L - 1) B rows in `splits` chunks, each block writing its
// chunk's partial product (dw_reduce_kernel of lstm_bwd.cu sums them in
// order: no atomics). Their rows come in 64-row boxes of (t, b) rows: one
// step of up to 64 rows, or 64 / B steps of a small B (4-D tensor maps;
// rows past B, and the steps before 0 and past L - 1, read as zeros).
// dW_hh^T takes dgates' three parts from where the chain left them: hi is
// the stored dxw itself (bf16(dgates)), and mid and lo overwrite the f32
// coefficient row that the chain has just consumed, as the bf16 row
// [mid(4H) | lo(4H)] of the same 16H bytes, so the scratch dg keeps its
// size: a step of the chain reads 26 bytes a (row, unit) (4 coefficients
// and 2 dc factors in f32, dho) and writes 24 (dxw and the two parts of its
// 4 dgates), as the kernel it succeeds did (its f32 dgates and dxw).
//
// Tried and dropped (PERF.md §6 has the times): the forward chain split over
// a cluster of two blocks, each holding half of W_hh^T and writing its half
// of h_t into both blocks' shared memory before a cluster barrier (1.63x the
// time a step); the step's product as wgmma.m64n8k16 with the A fragments in
// registers and h's parts in a swizzled K-major tile (1.31x); two
// accumulators an m-tile in the forward (within 2%).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace rlt {
namespace lstm_bf16 {

using namespace sm90;

constexpr int kStages = 8;  // ring depth of the chains' step inputs, in steps

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// d += A B, mma.sync.m16n8k16 bf16 -> f32 (not volatile: the compiler may
// schedule independent products around each other)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// x = p[0] + p[1] + p[2] exactly (|x| >= 2^-110)
struct Parts {
  bf16 p[3];
};
__device__ __forceinline__ Parts split3(float x) {
  Parts s;
  s.p[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(s.p[0]);
  s.p[1] = __float2bfloat16_rn(r);
  s.p[2] = __float2bfloat16_rn(r - __bfloat162float(s.p[1]));
  return s;
}

// `bytes` (a multiple of 16) from global `src` into shared `dst` (both
// 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The B operand (K x 8, bf16) of one n-tile in fragment order: for k-steps
// 2 kp and 2 kp + 1, lane l's b0, b1 of each as one uint4 at [kp][l]. The
// bf16 index of B[k][n]: mma.m16n8k16's b0 holds (k = 2t, 2t + 1; n = g) and
// b1 (k = 2t + 8, 2t + 9; n = g) of lane 4g + t. Lanes 8 apart are columns
// 2 apart, 64 elements apart: part p of a row is at frag_index(k, e) + 64 p.
__device__ __forceinline__ int frag_index(int k, int n) {
  const int kk = k >> 4;
  const int w16 = k & 15;
  const int lane = 4 * n + ((w16 & 7) >> 1);
  return ((((kk >> 1) * 32 + lane) * 4 + (kk & 1) * 2 + (w16 >> 3)) << 1) + (k & 1);
}

// The n-tiles a block of a chain takes (2 rows each): the fewest of 1, 2 and
// 4 whose ndir * ceil(B / rows) blocks fit the SMs in one wave, else 4.
inline int chain_tiles(int ndir, int batch, int sms) {
  for (int nt = 1; nt <= 2; nt *= 2)
    if (static_cast<long long>(ndir) * ((batch + 2 * nt - 1) / (2 * nt)) <= sms) return nt;
  return 4;
}

// ---------------------------------------------------------------------------
// K1': the forward chain
// ---------------------------------------------------------------------------

template <int kH, int kNT>
struct FwdLayout {
  static constexpr int kG = 4 * kH;                  // gate columns
  static constexpr int kR = 2 * kNT;                 // rows a block
  static constexpr int kStageBytes = kR * kG * 2;    // xw rows of a step
  static constexpr int kBufElems = kNT * kH * 8;     // bf16 of an h operand
  static constexpr int kBuf = kStages * kStageBytes;
  static constexpr int kBars = kBuf + 2 * kBufElems * 2;
  static constexpr size_t kSmem = kBars + 8 * kStages;
};

// Block = (direction, 2 kNT rows), 2H threads: warp w owns units 16w .. +15.
// Its m-tile j (0..3) pairs gate 2 (j & 1) (rows 0..7) and 2 (j & 1) + 1
// (rows 8..15) of units 16w + 8 (j >> 1) + 0..7; lane 4g + t ends each step
// with the four gates of unit 16w + 8 (t >> 1) + g for row t & 1 of each
// n-tile.
template <int kH, int kNT>
__global__ void __launch_bounds__(2 * kH, 1)
lstm_fwd_mma_kernel(const bf16* __restrict__ xw, const bf16* __restrict__ w,
                    bf16* __restrict__ hs, float* __restrict__ cs, int length, int batch,
                    int ndir) {
  using L = FwdLayout<kH, kNT>;
  constexpr int kG = L::kG;
  constexpr int kR = L::kR;
  constexpr int kKS = kH / 16;
  extern __shared__ __align__(128) uint8_t chain_smem[];
  uint8_t* smem = chain_smem;
  const bf16* xs = reinterpret_cast<const bf16*>(smem);
  bf16* hb = reinterpret_cast<bf16*>(smem + L::kBuf);
  const uint32_t xs0 = smem_u32(smem);
  const uint32_t bar0 = smem_u32(smem + L::kBars);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bpd = (batch + kR - 1) / kR;
  const int dir = blockIdx.x / bpd;
  const int b0 = (blockIdx.x - dir * bpd) * kR;
  const int nb = min(kR, batch - b0);
  const size_t step_rows = static_cast<size_t>(ndir) * batch;
  const size_t row0 = static_cast<size_t>(dir) * batch + b0;
  const bf16* wd = w + static_cast<size_t>(dir) * kH * kG;
  const uint32_t load_bytes = static_cast<uint32_t>(nb) * kG * 2;
  auto issue = [&](int s) {  // step s's xw rows into stage s % kStages
    const uint32_t bar = bar0 + 8 * (s % kStages);
    mbar_expect_tx(bar, load_bytes);
    bulk_load(xs0 + (s % kStages) * L::kStageBytes, xw + (s * step_rows + row0) * kG,
              load_bytes, bar);
  };

  // zero the ring (rows past nb stay zero) and both h operands (h_{-1} = 0,
  // and the columns of part 3)
  for (int i = threadIdx.x; i < L::kBars / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages && s < length; ++s) issue(s);

  uint32_t wa[4][kKS][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bf16* c0 = wd + 2 * (j & 1) * kH + 16 * warp + 8 * (j >> 1) + g;
    const bf16* c1 = c0 + kH;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      const int k = 16 * kk + 2 * tq;
      wa[j][kk][0] = pack2(c0[k * kG], c0[(k + 1) * kG]);
      wa[j][kk][1] = pack2(c1[k * kG], c1[(k + 1) * kG]);
      wa[j][kk][2] = pack2(c0[(k + 8) * kG], c0[(k + 9) * kG]);
      wa[j][kk][3] = pack2(c1[(k + 8) * kG], c1[(k + 9) * kG]);
    }
  }

  const bool hi_half = tq & 2;  // the lane's unit half and row
  const int e = tq & 1;
  const int u = 16 * warp + 8 * (tq >> 1) + g;
  const int slot = frag_index(u, e);
  float c_reg[kNT];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) c_reg[nt] = 0.0f;

  for (int s = 0; s < length; ++s) {
    const bf16* cur = hb + (s & 1) * L::kBufElems;
    bf16* nxt = hb + ((s + 1) & 1) * L::kBufElems;
    const bf16* xst = xs + (s % kStages) * (kR * kG);
    const size_t out_row = s * step_rows + row0;
    mbar_wait(bar0 + 8 * (s % kStages), (s / kStages) & 1);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
      const uint4* bp = reinterpret_cast<const uint4*>(cur + nt * kH * 8) + lane;
#pragma unroll
      for (int kp = 0; kp < kKS / 2; ++kp) {
        const uint4 bv = bp[kp * 32];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma16816(acc[j], wa[j][2 * kp], bv.x, bv.y);
          mma16816(acc[j], wa[j][2 * kp + 1], bv.z, bv.w);
        }
      }
      // lane t holds part t of (unit half j >> 1, gate pair j & 1; gate
      // 2 (j & 1) + (i >> 1), row i & 1): keep this lane's unit half, then
      // its row, summing the parts (t, t ^ 2) and then (t ^ 1, t ^ 3)
      float r1[2][4];
#pragma unroll
      for (int gp = 0; gp < 2; ++gp)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float keep = hi_half ? acc[2 + gp][i] : acc[gp][i];
          const float send = hi_half ? acc[gp][i] : acc[2 + gp][i];
          r1[gp][i] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
        }
      float pre[4];
#pragma unroll
      for (int gp = 0; gp < 2; ++gp)
#pragma unroll
        for (int gi = 0; gi < 2; ++gi) {
          const float keep = e ? r1[gp][2 * gi + 1] : r1[gp][2 * gi];
          const float send = e ? r1[gp][2 * gi] : r1[gp][2 * gi + 1];
          pre[2 * gp + gi] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
        }
      const int rr = 2 * nt + e;
      const bf16* xr = xst + rr * kG + u;
      const float in_g = sigmoid_f32(pre[0] + __bfloat162float(xr[0]));
      const float forget_g = sigmoid_f32(pre[1] + __bfloat162float(xr[kH]));
      const float cell_g = tanhf(pre[2] + __bfloat162float(xr[2 * kH]));
      const float out_g = sigmoid_f32(pre[3] + __bfloat162float(xr[3 * kH]));
      c_reg[nt] = forget_g * c_reg[nt] + in_g * cell_g;
      const float h = out_g * tanhf(c_reg[nt]);
      if (rr < nb) {
        const size_t o = (out_row + rr) * kH + u;
        hs[o] = __float2bfloat16_rn(h);
        cs[o] = c_reg[nt];
      }
      const Parts hp = split3(h);
      bf16* dst = nxt + nt * kH * 8 + slot;
      dst[0] = hp.p[0];
      dst[64] = hp.p[1];
      dst[128] = hp.p[2];
    }
    // h_t is complete before any warp reads it, h_{t-1}'s buffer and the
    // step's stage are read by every warp before they are written again
    __syncthreads();
    if (threadIdx.x == 0 && s + kStages < length) issue(s + kStages);
  }
}

template <int kH, int kNT>
cudaError_t launch_fwd(const bf16* xw, const bf16* w, bf16* hs, float* cs, int length,
                       int batch, int ndir, cudaStream_t stream) {
  using L = FwdLayout<kH, kNT>;
  auto kernel = lstm_fwd_mma_kernel<kH, kNT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(ndir) * ((batch + L::kR - 1) / L::kR);
  kernel<<<static_cast<unsigned>(blocks), 2 * kH, L::kSmem, stream>>>(xw, w, hs, cs, length,
                                                                     batch, ndir);
  return cudaGetLastError();
}

template <int kH>
cudaError_t fwd_tiles(int nt, const bf16* xw, const bf16* w, bf16* hs, float* cs,
                      int length, int batch, int ndir, cudaStream_t stream) {
  switch (nt) {
    case 1: return launch_fwd<kH, 1>(xw, w, hs, cs, length, batch, ndir, stream);
    case 2: return launch_fwd<kH, 2>(xw, w, hs, cs, length, batch, ndir, stream);
    default: return launch_fwd<kH, 4>(xw, w, hs, cs, length, batch, ndir, stream);
  }
}

// ---------------------------------------------------------------------------
// K2': the gate recompute, the reverse chain and dW_hh^T
// ---------------------------------------------------------------------------

template <int kH, int kNT>
struct ChainLayout {
  static constexpr int kG = 4 * kH;
  static constexpr int kR = 2 * kNT;
  static constexpr int kStages = kNT >= 4 ? 4 : lstm_bf16::kStages;
  static constexpr int kCoefBytes = kR * kG * 4;  // a step's f32 coefficient rows
  static constexpr int kGfBytes = kR * kH * 8;    // its dc factors
  static constexpr int kDhoBytes = kR * kH * 2;   // its dho rows
  static constexpr int kStageBytes = kCoefBytes + kGfBytes + kDhoBytes;
  static constexpr int kBufElems = kNT * kG * 8;  // bf16 of a dgates operand
  static constexpr int kBuf = kStages * kStageBytes;
  static constexpr int kBars = kBuf + 2 * kBufElems * 2;
  static constexpr size_t kSmem = kBars + 8 * kStages;
};

// Block = (direction, 2 kNT rows), 2H threads, walking t = L-1 .. 0: warp w
// holds rows 16w .. 16w + 15 of W_hh^T (its units' 4H weights) as the A
// fragments of dh_carry = W_hh^T dgates^T, and lane 4g + t ends each product
// with dh_carry of unit 16w + 8 (t >> 1) + g for row t & 1 of each n-tile,
// whose four dgates it then computes. `coef` holds the gate recompute's
// coefficients (f32, (L, ndir B, 4H)); each row, once its step has read it,
// is overwritten through `dg_parts` by dgates' mid and lo parts.
template <int kH, int kNT>
__global__ void __launch_bounds__(2 * kH, 1)
lstm_bwd_chain_mma_kernel(const bf16* __restrict__ w, const float* coef,
                          const float2* __restrict__ gf, const bf16* __restrict__ dho,
                          bf16* __restrict__ dxw, bf16* dg_parts, int length, int batch,
                          int ndir) {
  using L = ChainLayout<kH, kNT>;
  constexpr int kG = L::kG;
  constexpr int kR = L::kR;
  constexpr int kKS = kG / 16;
  constexpr int kS = L::kStages;
  extern __shared__ __align__(128) uint8_t chain_smem[];
  uint8_t* smem = chain_smem;
  bf16* ob = reinterpret_cast<bf16*>(smem + L::kBuf);
  const uint32_t ring0 = smem_u32(smem);
  const uint32_t bar0 = smem_u32(smem + L::kBars);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bpd = (batch + kR - 1) / kR;
  const int dir = blockIdx.x / bpd;
  const int b0 = (blockIdx.x - dir * bpd) * kR;
  const int nb = min(kR, batch - b0);
  const size_t step_rows = static_cast<size_t>(ndir) * batch;
  const size_t row0 = static_cast<size_t>(dir) * batch + b0;
  const bf16* wd = w + static_cast<size_t>(dir) * kH * kG;
  auto issue = [&](int s) {  // step s (t = L - 1 - s) into stage s % kS
    const size_t row = (length - 1 - s) * step_rows + row0;
    const uint32_t bar = bar0 + 8 * (s % kS);
    const uint32_t dst = ring0 + (s % kS) * L::kStageBytes;
    mbar_expect_tx(bar, static_cast<uint32_t>(nb) * (L::kStageBytes / kR));
    bulk_load(dst, coef + row * kG, nb * kG * 4, bar);
    bulk_load(dst + L::kCoefBytes, gf + row * kH, nb * kH * 8, bar);
    bulk_load(dst + L::kCoefBytes + L::kGfBytes, dho + row * kH, nb * kH * 2, bar);
  };

  for (int i = threadIdx.x; i < L::kBars / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kS && s < length; ++s) issue(s);

  uint32_t wa[kKS][4];
  {
    const bf16* r0 = wd + static_cast<size_t>(16 * warp + g) * kG + 2 * tq;
    const bf16* r8 = r0 + 8 * kG;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      wa[kk][0] = *reinterpret_cast<const uint32_t*>(r0 + 16 * kk);
      wa[kk][1] = *reinterpret_cast<const uint32_t*>(r8 + 16 * kk);
      wa[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 16 * kk + 8);
      wa[kk][3] = *reinterpret_cast<const uint32_t*>(r8 + 16 * kk + 8);
    }
  }

  const bool hi_half = tq & 2;
  const int e = tq & 1;
  const int u = 16 * warp + 8 * (tq >> 1) + g;
  float dc_carry[kNT];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) dc_carry[nt] = 0.0f;

  for (int s = 0; s < length; ++s) {
    const int t = length - 1 - s;
    const bf16* cur = ob + (s & 1) * L::kBufElems;
    bf16* nxt = ob + ((s + 1) & 1) * L::kBufElems;
    const uint8_t* stage = smem + (s % kS) * L::kStageBytes;
    const float* cf = reinterpret_cast<const float*>(stage);
    const float2* gfs = reinterpret_cast<const float2*>(stage + L::kCoefBytes);
    const bf16* dhs = reinterpret_cast<const bf16*>(stage + L::kCoefBytes + L::kGfBytes);
    mbar_wait(bar0 + 8 * (s % kS), (s / kS) & 1);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float dh_carry = 0.0f;  // zero at t = L - 1
      if (s > 0) {
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[a][i] = 0.0f;
        const uint4* bp = reinterpret_cast<const uint4*>(cur + nt * kG * 8) + lane;
#pragma unroll
        for (int kp = 0; kp < kKS / 2; ++kp) {
          const uint4 bv = bp[kp * 32];
          mma16816(acc[(2 * kp) & 3], wa[2 * kp], bv.x, bv.y);
          mma16816(acc[(2 * kp + 1) & 3], wa[2 * kp + 1], bv.z, bv.w);
        }
        // lane t holds part t of (unit half i >> 1, row i & 1)
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
        float r1[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float keep = hi_half ? v[2 + x] : v[x];
          const float send = hi_half ? v[x] : v[2 + x];
          r1[x] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
        }
        const float keep = e ? r1[1] : r1[0];
        const float send = e ? r1[0] : r1[1];
        dh_carry = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
      const int rr = 2 * nt + e;
      const float* cr = cf + rr * kG + u;
      const float2 fac = gfs[rr * kH + u];
      const float dh = __bfloat162float(dhs[rr * kH + u]) + dh_carry;
      const float dc = dc_carry[nt] + dh * fac.x;
      dc_carry[nt] = dc * fac.y;
      const size_t row = t * step_rows + row0 + rr;
      bf16* dst = nxt + nt * kG * 8;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float d = (q == 3 ? dh : dc) * cr[q * kH];
        const Parts dp = split3(d);
        const int slot = frag_index(q * kH + u, e);
        dst[slot] = dp.p[0];
        dst[slot + 64] = dp.p[1];
        dst[slot + 128] = dp.p[2];
        if (rr < nb) {
          dxw[row * kG + q * kH + u] = dp.p[0];
          dg_parts[row * 2 * kG + q * kH + u] = dp.p[1];
          dg_parts[row * 2 * kG + kG + q * kH + u] = dp.p[2];
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && s + kS < length) issue(s + kS);
  }
}

template <int kH, int kNT>
cudaError_t launch_chain(const bf16* w, const float* coef, const float2* gf, const bf16* dho,
                         bf16* dxw, bf16* dg_parts, int length, int batch, int ndir,
                         cudaStream_t stream) {
  using L = ChainLayout<kH, kNT>;
  auto kernel = lstm_bwd_chain_mma_kernel<kH, kNT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(ndir) * ((batch + L::kR - 1) / L::kR);
  kernel<<<static_cast<unsigned>(blocks), 2 * kH, L::kSmem, stream>>>(
      w, coef, gf, dho, dxw, dg_parts, length, batch, ndir);
  return cudaGetLastError();
}

// wgmma m64n64k16 bf16 -> f32, A and B from shared memory, each K-major (0)
// or MN-major (1: the tile's rows are the depth); d = (accumulate ? d : 0) +
// A B
template <int kTnspA, int kTnspB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTnspA), "n"(kTnspB));
}

constexpr int kGemmThreads = 128;  // one warpgroup

// The 64-row boxes of K2''s two products: `rows` = min(B, 64) rows b of each
// of `steps` consecutive steps t (64 / B steps at B <= 64, else one), and
// `per_step` boxes across a step's B rows; a box's rows past rows * steps
// stay zero in shared memory. At B = 63 a box is one step, at B = 1 64.
struct Boxes {
  int rows, steps, per_step;
};

inline Boxes boxes_of(int batch) {
  return batch <= 64 ? Boxes{batch, 64 / batch, 1} : Boxes{64, 1, (batch + 63) / 64};
}

// One box of a 4-D tensor map (c0 columns, c1 rows b, c2 direction, c3
// step) into shared memory, completing on `bar`; a coordinate outside the
// array (a step of -1 or L) reads zeros.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// The map of an (L, ndir B, width) bf16 array as {width, B, ndir, L}, boxes
// of 64 columns by `bx.rows` rows of `bx.steps` steps, 128-byte swizzle.
inline bool encode_steps_map(CUtensorMap* map, const void* ptr, int length, int ndir,
                             int batch, int width, Boxes bx) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(width) * sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(batch),
                              static_cast<cuuint64_t>(ndir), static_cast<cuuint64_t>(length)};
  const cuuint64_t strides[3] = {row, row * batch, row * batch * ndir};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(bx.rows), 1,
                             static_cast<cuuint32_t>(bx.steps)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Gate recompute: grid (G, ceil(H / 64) unit tiles, ndir), 128 threads. A
// work item is one box of rows (t, b); a block walks the items blockIdx.x,
// + G, ... with W_hh^T's four gate tiles of its 64 units resident (4 x
// ceil(H / 64) boxes of 64 k rows by 64 columns) and the items' hs_{t-1}
// boxes through two stages (the step before t = 0 reads as zeros). gates =
// hs_{t-1} W_hh^T (A K-major, B MN-major) for the four gates of the 64
// units, so each thread ends with all four gates of its (row, unit) pairs;
// the epilogue loads a row's xw and c of all its units at once, then writes
// what the chain needs, as lstm_bwd.cu's lstm_bwd_gates_kernel does: the
// four coefficients into `coef` and {o(1 - tanh(c_t)^2), f} into gf.
template <int kH>
struct GatesLayout {
  static constexpr int kKB = (kH + 63) / 64;          // 64-wide boxes of H
  static constexpr int kB = 0;                        // W_hh^T: [gate][k box]
  static constexpr int kA = kB + 4 * kKB * kBoxBytes;  // hs: [stage][k box]
  static constexpr int kBars = kA + 2 * kKB * kBoxBytes;
  static constexpr size_t kSmem = kBars + 8 * 3 + 1024;  // + alignment slack
};

template <int kH>
__global__ void __launch_bounds__(kGemmThreads)
lstm_bwd_gates_wgmma_kernel(const __grid_constant__ CUtensorMap map_hs,
                            const __grid_constant__ CUtensorMap map_w,
                            const bf16* __restrict__ xw, const float* __restrict__ cs,
                            float* __restrict__ coef, float2* __restrict__ gf, int length,
                            int batch, int ndir, Boxes bx, int items) {
  using L = GatesLayout<kH>;
  constexpr int kKB = L::kKB;
  constexpr int kG = 4 * kH;
  extern __shared__ __align__(1024) uint8_t gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const uint32_t b_full = base + L::kBars;
  const uint32_t a_full = b_full + 8;  // stage s at + 8 s
  const int u0 = 64 * blockIdx.y;
  const int dir = blockIdx.z;
  const int box_rows = bx.rows * bx.steps;
  auto issue = [&](int i) {  // the block's i-th item into stage i & 1
    const int item = blockIdx.x + i * gridDim.x;
    if (item >= items) return;
    const uint32_t bar = a_full + 8 * (i & 1);
    mbar_expect_tx(bar, kKB * box_rows * 128);
#pragma unroll
    for (int c = 0; c < kKB; ++c)
      tma_load4(base + L::kA + ((i & 1) * kKB + c) * kBoxBytes, &map_hs, 64 * c,
                64 * (item % bx.per_step), dir, (item / bx.per_step) * bx.steps - 1, bar);
  };
  // the A stages' rows past a box stay zero
  for (int i = threadIdx.x; i < 2 * kKB * kBoxBytes / 16; i += blockDim.x)
    *reinterpret_cast<uint4*>(gemm_smem + (base - smem_u32(gemm_smem)) + L::kA + 16 * i) =
        make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_init(b_full, 1);
    mbar_init(a_full, 1);
    mbar_init(a_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(b_full, 4 * kKB * kBoxBytes);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < kKB; ++c)
        tma_load(base + L::kB + (q * kKB + c) * kBoxBytes, &map_w, q * kH + u0, 64 * c, dir,
                 b_full);
    issue(0);
    issue(1);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  mbar_wait(b_full, 0);
  for (int i = 0;; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    if (item >= items) break;
    const int t0 = (item / bx.per_step) * bx.steps;
    const int bb = item % bx.per_step;
    float acc[4][32];
    mbar_wait(a_full + 8 * (i & 1), (i >> 1) & 1);
    {
      const uint32_t a_tile = base + L::kA + (i & 1) * kKB * kBoxBytes;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t b_tile = base + L::kB + q * kKB * kBoxBytes;
#pragma unroll
        for (int kk = 0; kk < 4 * kKB; ++kk)
          wgmma_ss_t<0, 1>(acc[q],
                           sw128_desc(a_tile + (kk / 4) * kBoxBytes + (kk % 4) * 32),
                           sw128_desc(b_tile + (kk / 4) * kBoxBytes + (kk % 4) * 2048),
                           kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_regs(acc[q]);
    }
    __syncthreads();  // every warp is done with the stage
    if (threadIdx.x == 0) issue(i + 2);

    // acc[q][4j + 2rh + x]: box row 16 warp + g + 8 rh (step t0 + m / rows,
    // row 64 bb + m % rows), unit u0 + 8j + 2 tq + x
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int m = 16 * warp + g + 8 * rh;
      const int tl = m / bx.rows;
      const int t = t0 + tl;
      const int b = 64 * bb + m - tl * bx.rows;
      const bool valid = m < box_rows && t < length && b < batch;
      const size_t row = (static_cast<size_t>(t) * ndir + dir) * batch + b;
      uint32_t xv[8][4];
      float2 c_now[8], c_prev[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = u0 + 8 * j + 2 * tq;
        const bool ok = valid && u < kH;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xv[j][q] = ok ? *reinterpret_cast<const uint32_t*>(xw + row * kG + q * kH + u) : 0u;
        c_now[j] = ok ? *reinterpret_cast<const float2*>(cs + row * kH + u)
                      : make_float2(0.0f, 0.0f);
        c_prev[j] = ok && t > 0 ? *reinterpret_cast<const float2*>(
                                      cs + (row - static_cast<size_t>(ndir) * batch) * kH + u)
                                : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = u0 + 8 * j + 2 * tq;
        if (!valid || u >= kH) continue;
        float out[4][2];
        float4 fac;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float pre[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pre[q] = acc[q][4 * j + 2 * rh + x] +
                     __uint_as_float(x ? xv[j][q] & 0xffff0000u : xv[j][q] << 16);
          const float in_g = sigmoid_f32(pre[0]);
          const float forget_g = sigmoid_f32(pre[1]);
          const float cell_g = tanhf(pre[2]);
          const float out_g = sigmoid_f32(pre[3]);
          const float tanh_c = tanhf(x ? c_now[j].y : c_now[j].x);
          out[0][x] = cell_g * (in_g * (1.0f - in_g));
          out[1][x] = (x ? c_prev[j].y : c_prev[j].x) * (forget_g * (1.0f - forget_g));
          out[2][x] = in_g * (1.0f - cell_g * cell_g);
          out[3][x] = tanh_c * (out_g * (1.0f - out_g));
          (x ? fac.z : fac.x) = out_g * (1.0f - tanh_c * tanh_c);
          (x ? fac.w : fac.y) = forget_g;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float2*>(coef + row * kG + q * kH + u) =
              make_float2(out[q][0], out[q][1]);
        *reinterpret_cast<float4*>(gf + row * kH + u) = fac;
      }
    }
  }
}

// dW_hh^T: grid (4H / 64, ceil(H / 64), ndir * splits), 128 threads. Block
// (n tile, m tile, direction d, chunk s) sums, over the boxes kb of chunk s
// (box kb: rows 64 (kb % per_step) .. of steps t = 1 + (kb / per_step)
// steps ..), hs_{t-1}^T (A, MN-major: the box's rows are the depth) times
// dgates_t's three parts (B, MN-major): hi from dxw, mid and lo from the
// parts rows [mid(4H) | lo(4H)] that the chain left in dg (a step past L-1
// reads zeros). Three stages of four boxes by TMA; each block writes its
// partial tile, zero for an empty chunk.
template <int kH>
struct DwLayout {
  static constexpr int kStages = 3;
  static constexpr int kStageBytes = 4 * kBoxBytes;  // hs, hi, mid, lo
  static constexpr int kBars = kStages * kStageBytes;
  static constexpr size_t kSmem = kBars + 8 * kStages + 1024;
};

template <int kH>
__global__ void __launch_bounds__(kGemmThreads)
lstm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_hs,
                     const __grid_constant__ CUtensorMap map_dxw,
                     const __grid_constant__ CUtensorMap map_parts,
                     float* __restrict__ partial, int length, int ndir, Boxes bx,
                     int splits, int chunk) {
  using L = DwLayout<kH>;
  constexpr int kG = 4 * kH;
  extern __shared__ __align__(1024) uint8_t gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const uint32_t full = base + L::kBars;
  const int n0 = 64 * blockIdx.x;
  const int m0 = 64 * blockIdx.y;
  const int dir = blockIdx.z / splits;
  const int split = blockIdx.z - dir * splits;
  const int kbs = (length - 1 + bx.steps - 1) / bx.steps * bx.per_step;
  const int kb0 = min(kbs, split * chunk);
  const int kb1 = min(kbs, kb0 + chunk);
  const uint32_t box_bytes = bx.rows * bx.steps * 128;
  auto issue = [&](int kb) {
    const int s = (kb - kb0) % L::kStages;
    const uint32_t dst = base + s * L::kStageBytes;
    const uint32_t bar = full + 8 * s;
    const int t = (kb / bx.per_step) * bx.steps;  // hs_{t}, dgates_{t + 1}
    const int r = 64 * (kb % bx.per_step);
    mbar_expect_tx(bar, 4 * box_bytes);
    tma_load4(dst, &map_hs, m0, r, dir, t, bar);
    tma_load4(dst + kBoxBytes, &map_dxw, n0, r, dir, t + 1, bar);
    tma_load4(dst + 2 * kBoxBytes, &map_parts, n0, r, dir, t + 1, bar);
    tma_load4(dst + 3 * kBoxBytes, &map_parts, kG + n0, r, dir, t + 1, bar);
  };
  // the stages' rows past a box stay zero
  for (int i = threadIdx.x; i < L::kBars / 16; i += blockDim.x)
    *reinterpret_cast<uint4*>(gemm_smem + (base - smem_u32(gemm_smem)) + 16 * i) =
        make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int kb = kb0; kb < kb1 && kb < kb0 + L::kStages; ++kb) issue(kb);
  }
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.0f;
  for (int kb = kb0; kb < kb1; ++kb) {
    const int i = kb - kb0;
    const uint32_t st = base + (i % L::kStages) * L::kStageBytes;
    mbar_wait(full + 8 * (i % L::kStages), (i / L::kStages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = sw128_desc(st + kk * 2048);
#pragma unroll
      for (int p = 1; p <= 3; ++p)
        wgmma_ss_t<1, 1>(acc, a, sw128_desc(st + p * kBoxBytes + kk * 2048), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with the stage
    if (threadIdx.x == 0 && kb + L::kStages < kb1) issue(kb + L::kStages);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* out = partial + static_cast<size_t>(blockIdx.z) * kH * kG;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int m = m0 + 16 * warp + (lane >> 2) + 8 * rh;
    if (m >= kH) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * kG + n0 + 8 * j +
                                 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * rh], acc[4 * j + 2 * rh + 1]);
  }
}

// K2''s first three passes on `stream` (lstm_bwd.cu then sums the dW_hh^T
// partials): the gate recompute into dg (the coefficients) and gf, the
// chain into dxw and dg (dgates' parts), and the partial products. Returns
// the first error.
template <int kH>
int bwd_passes(const bf16* xw, const bf16* w, const bf16* hs, const float* cs,
               const bf16* dho, bf16* dxw, float* partial, float2* gf, float* dg,
               int length, int batch, int ndir, int splits, int sms, cudaStream_t stream) {
  const Boxes bx = boxes_of(batch);
  CUtensorMap map_hs, map_w, map_dxw, map_parts;
  if (!encode_steps_map(&map_hs, hs, length, ndir, batch, kH, bx) ||
      !encode_map(&map_w, w, ndir, kH, 4 * kH) ||
      !encode_steps_map(&map_dxw, dxw, length, ndir, batch, 4 * kH, bx) ||
      !encode_steps_map(&map_parts, dg, length, ndir, batch, 8 * kH, bx))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kKB = GatesLayout<kH>::kKB;

  // 1. coefficients into dg, dc factors into gf: about two blocks an SM
  const int items = (length + bx.steps - 1) / bx.steps * bx.per_step;
  const int per_grid = (2 * sms + kKB * ndir - 1) / (kKB * ndir);
  const dim3 gate_grid(std::max(1, std::min(items, per_grid)), kKB, ndir);
  {
    auto kernel = lstm_bwd_gates_wgmma_kernel<kH>;
    constexpr size_t kSmem = GatesLayout<kH>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<gate_grid, kGemmThreads, kSmem, stream>>>(map_hs, map_w, xw, cs, dg, gf,
                                                       length, batch, ndir, bx, items);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // 2. the chain: dgates into dxw (hi) and dg (mid, lo)
  cudaError_t err;
  bf16* parts = reinterpret_cast<bf16*>(dg);
  switch (chain_tiles(ndir, batch, sms)) {
    case 1:
      err = launch_chain<kH, 1>(w, dg, gf, dho, dxw, parts, length, batch, ndir, stream);
      break;
    case 2:
      err = launch_chain<kH, 2>(w, dg, gf, dho, dxw, parts, length, batch, ndir, stream);
      break;
    default:
      err = launch_chain<kH, 4>(w, dg, gf, dho, dxw, parts, length, batch, ndir, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  // 3. the partial products of dW_hh^T over the boxes of steps 1 .. L - 1
  const int kbs = (length - 1 + bx.steps - 1) / bx.steps * bx.per_step;
  const int chunk = std::max(1, (kbs + splits - 1) / splits);
  {
    auto kernel = lstm_dw_wgmma_kernel<kH>;
    constexpr size_t kSmem = DwLayout<kH>::kSmem;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(4 * kH / 64, kKB, ndir * splits);
    kernel<<<grid, kGemmThreads, kSmem, stream>>>(map_hs, map_dxw, map_parts, partial,
                                                  length, ndir, bx, splits, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lstm_bf16
}  // namespace rlt
