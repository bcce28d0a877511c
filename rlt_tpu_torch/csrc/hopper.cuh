// hopper: the Hopper (sm_90a) device pieces that the bf16 kernels written
// for TMA and wgmma share: the attention forward and backward at dh = 64 and
// 128 (attention_bf16_wgmma.cuh, attention_bf16_bwd_wgmma.cuh) and at dh = 16
// (attention_bf16_dh16.cuh), and the bf16 LSTM (lstm_bf16_mma.cuh). Tiles of 64 rows by 64
// bf16 columns (128 bytes) are copied by TMA into shared memory with the
// 128-byte swizzle, every copy completing on an mbarrier; the products are
// wgmma.m64n64k16 with f32 accumulators in one of two operand forms:
//   wgmma_ss:    A (64 x 16) and B (16 x 64) both from shared memory, both
//                K-major: S = Q K^T, where each tile's rows are the product's
//                rows (A) or columns (B) and its 64 columns the depth;
//   wgmma_rs_tn: A (64 x 16) bf16 fragments in registers, B (16 x 64) from
//                shared memory, MN-major (transposed): O += P V, where P's
//                accumulator of keys 16 kk .. + 15, rounded and packed, is
//                the k-step's A fragment and V's tile rows are the depth.
//
// Fragment layouts (lane = 4 g + t of warp w of the warpgroup): wgmma's f32
// accumulator of n columns holds, in d[4 j + e], row 16 w + g + 8 (e >> 1),
// column 8 j + 2 t + (e & 1); its register A fragment of a k16 step is
// mma.m16n8k16's: a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
// a3 (g + 8, 2t + 8..), rows relative to the warp's 16.
//
// The tensor maps are encoded on the host at each launch (the pointers
// change), through cuTensorMapEncodeTiled taken from the driver by
// cudaGetDriverEntryPoint, so the library links without -lcuda.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rlt {

using bf16 = __nv_bfloat16;

// {lo, hi} rounded to bf16 and packed, lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

namespace sm90 {

constexpr int kRows = 64;               // rows of a tile: query rows of a work item, keys
constexpr int kBoxBytes = kRows * 128;  // a box of 64 rows of 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that has not ended after 2^34 clocks (seconds) traps, so that a fault in
// the ring shows as a launch error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// One box of the 3-D tensor map (columns c0, rows c1 of row n = c2) into
// shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A whole tile (kDh / 64 boxes side by side, kBoxBytes apart) of rows
// row0 .. + 63 of row n, columns col .. col + kDh - 1.
template <int kDh>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int col,
                                         int row0, int n, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < kDh / 64; ++c) tma_load(dst + c * kBoxBytes, map, col + 64 * c, row0, n, bar);
}

// A wgmma shared-memory descriptor of the 128-byte swizzle: 8-row groups
// 1024 bytes apart (SBO), `lbo` bytes between 64-column chunks (read only
// for an MN-major operand wider than one chunk), the tile 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most kPending of the warpgroup's committed wgmma groups are
// still running (groups complete in the order they were committed).
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across a
// wgmma fence or wait: the registers pass through an empty volatile asm.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps a register A fragment live up to this point: wgmma reads it
// asynchronously, so its registers may not be reused before the wait.
__device__ __forceinline__ void keep_live(const uint32_t (&a)[4]) {
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

// d (64 x 64, f32) = (accumulate ? d : 0) + A B, A (64 x 16) and B (16 x 64)
// from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A B, A (64 x 16) bf16 fragments in registers, B (16 x
// 64) from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_tn(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) = A B^T over a depth of kDh: A's and B's tiles (64 rows by kDh
// columns, kDh / 64 boxes) both K-major from shared memory, as S = Q K^T;
// issued and committed (not waited for).
template <int kDh>
__device__ __forceinline__ void issue_abt(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_ss(d, sw128_desc(a_tile + (kk / 4) * kBoxBytes + (kk % 4) * 32),
             sw128_desc(b_tile + (kk / 4) * kBoxBytes + (kk % 4) * 32), kk > 0);
  wgmma_commit();
}

// acc (64 x kDh, kDh / 64 chunks of 64 columns) += A B over a depth of 64:
// A's bf16 fragments of depth 16 kk .. 16 kk + 15 in a[kk], B a tile of 64
// rows (the depth) by kDh columns through the transposed descriptor, as
// O += P V; issued and committed (not waited for).
template <int kDh>
__device__ __forceinline__ void issue_ab(float (&acc)[kDh / 64][32], uint32_t (&a)[4][4],
                                        uint32_t b_tile) {
#pragma unroll
  for (int j = 0; j < kDh / 64; ++j) fence_regs(acc[j]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kDh / 64; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tn(acc[j], a[kk], sw128_desc(b_tile + j * kBoxBytes + kk * 16 * 128, kBoxBytes));
  wgmma_commit();
}

// An accumulator of 64 columns, rounded to bf16 and packed as A fragments
// of depth 64: columns 16 kk .. 16 kk + 15 are the k-step's A fragment.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* w = &d[8 * kk];
    a[kk][0] = pack_bf16x2(w[0], w[1]);
    a[kk][1] = pack_bf16x2(w[2], w[3]);
    a[kk][2] = pack_bf16x2(w[4], w[5]);
    a[kk][3] = pack_bf16x2(w[6], w[7]);
  }
}

// 2^x by MUFU.EX2, a result below 2^-126 flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Register rebalancing between the warpgroups of a warp-specialised block
// (every warp of the warpgroup executes it)
template <int kRegs>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's and TMA's reads of it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A barrier of the 128 threads of warpgroup 0 alone (named barrier 1). Each
// warp converges first: bar.sync and the wgmma instructions after it take a
// whole warp, and its threads may come from diverged paths.
__device__ __forceinline__ void warpgroup_sync() {
  __syncwarp();
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// library links without -lcuda); null if the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The 3-D map of an (n, length, d_model) bf16 array, boxes of 64 columns by
// 64 rows of one row n, 128-byte swizzle, rows past L read as zeros.
inline bool encode_map(CUtensorMap* map, const void* ptr, int n, int length, int d_model) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d_model),
                              static_cast<cuuint64_t>(length), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d_model) * sizeof(bf16),
                                 static_cast<cuuint64_t>(length) * d_model * sizeof(bf16)};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The blocks of `kernel` the card holds at once (`threads` a block, `smem`
// bytes of dynamic shared memory): the persistent grid's size. Asked of the
// current card; its max dynamic shared memory must be set first.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, size_t smem) {
  int device = 0, sms = 0, blocks = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return sms * (blocks > 0 ? blocks : 1);
}

}  // namespace sm90
}  // namespace rlt
