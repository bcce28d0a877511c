// attention_tiles: the tile copies and float4 helpers shared by the
// per-slice attention kernels K3' (attention_fwd.cu) and K4'
// (attention_bwd.cu), which work on (N, L, 128) float32 slices in blocks of
// kWarps warps.

#pragma once

#include <cuda_runtime.h>

namespace rlt {

constexpr int kSliceDh = 128;
constexpr int kSliceWarps = 8;
// rows of a streamed tile in shared memory: kSliceDh floats and 4 of
// padding, so float4 reads by neighbouring lanes of neighbouring rows hit
// distinct banks
constexpr int kSlicePitch = kSliceDh + 4;

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

// acc += a * b, elementwise
__device__ __forceinline__ void fma4(float a, const float4& b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// acc + a . b
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float component(const float4& a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + kRows) of a slice's (L, 128) array into shared memory
// with row pitch kPitch, by the whole block; rows at or past `length` are
// zero. Every thread first loads all its float4s into registers, so that
// they are in flight together, and then stores them.
template <int kRows, int kPitch>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int length) {
  constexpr int kQuads = kRows * (kSliceDh / 4);
  constexpr int kThreads = 32 * kSliceWarps;
  static_assert(kQuads % kThreads == 0, "a tile is a whole number of float4 per thread");
  constexpr int kPerThread = kQuads / kThreads;
  float4 staged[kPerThread];
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kSliceDh / 4);
    const int c4 = (i % (kSliceDh / 4)) * 4;
    staged[it] = row0 + r < length
                     ? *reinterpret_cast<const float4*>(
                           src + static_cast<size_t>(row0 + r) * kSliceDh + c4)
                     : zero4();
  }
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kSliceDh / 4);
    const int c4 = (i % (kSliceDh / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * kPitch + c4) = staged[it];
  }
}

}  // namespace rlt
