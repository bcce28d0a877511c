// keep_mask: the counter-based dropout bits shared by the attention kernels
// (attention_packed_fwd.cu, attention_packed_bwd.cu, attention_fwd.cu,
// attention_bwd.cu and the bf16 headers they include).
//
// Replaces rlt_tpu/ops/attention.py::keep_mask (with _streams and
// _group_stream), which the TPU kernels evaluate inside their bodies so that
// the forward and the backward regenerate the same mask without storing it.
// The bits are the JAX package's, bit for bit, and the port's torch twin
// (rlt_tpu_torch/ops/attention.py::keep_mask) gives them on the CPU:
//   x = (row * ncols + col) ^ (uint32(stream) * 0x9E3779B9)
//   x ^= x >> 16; x *= 0x7FEB352D; x ^= x >> 15; x *= 0x846CA68B; x ^= x >> 16
//   keep = x < threshold,  threshold = min(int((1 - rate) * 2^32), 2^32 - 1)
// all in uint32 arithmetic. The threshold is computed on the host in double,
// as the JAX package computes it, and handed to the kernel.
//
// The packed TPU kernel lays the `pack` heads of a group side by side in one
// (L, pack * L) score tile: head h's score (i, j) is element
// (i, (h % pack) * L + j) of group h / pack, whose stream is
// group_stream(stream_of_row, h / pack). The per-slice kernel's tile is the
// slice's own (L, L) scores: element i * L + j of the slice's stream.

#pragma once

#include <cstdint>

namespace rlt {

// _group_stream: group 0 keeps the row's stream; group gi adds
// (gi * 0x7F4A7C15) & 0x7FFFFFFF with int32 wrap-around, done here in
// uint32 because signed overflow is undefined in C++.
__device__ __forceinline__ uint32_t group_stream(int32_t stream, int gi) {
  const uint32_t s = static_cast<uint32_t>(stream);
  if (gi == 0) return s;
  return s + ((static_cast<uint32_t>(gi) * 0x7F4A7C15u) & 0x7FFFFFFFu);
}

// The XOR key of a stream.
__device__ __forceinline__ uint32_t stream_key(uint32_t stream) {
  return stream * 0x9E3779B9u;
}

// True where the element at flat index `index` of the tile is kept.
__device__ __forceinline__ bool keep_element(uint32_t index, uint32_t key,
                                             uint32_t threshold) {
  uint32_t x = index ^ key;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x < threshold;
}

// keep_element with the key's part of the first mixing step taken once:
// (index ^ key) ^ ((index ^ key) >> 16) = index ^ (index >> 16) ^ mixed_key(key),
// so a score costs one xor less. The bits are keep_element's.
__device__ __forceinline__ uint32_t mixed_key(uint32_t key) { return key ^ (key >> 16); }

__device__ __forceinline__ bool keep_mixed(uint32_t index, uint32_t mixed,
                                           uint32_t threshold) {
  uint32_t x = index ^ (index >> 16) ^ mixed;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x < threshold;
}

}  // namespace rlt
