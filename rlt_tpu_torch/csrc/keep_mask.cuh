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
// A launch drops at one rate for every row, or at a rate per row (or per
// slice): a population's members differ in their dropout rate, and their
// rows share one launch. `Dropout` below carries either form; a row reads
// its threshold and its scale once, where it reads its stream. The
// encoding: the kernels test x <= threshold - 1 in uint32, which is x <
// threshold for every threshold t >= 1, and for t = 0 keeps every weight
// (t - 1 wraps to 2^32 - 1). A row at rate 0 has threshold 0 and scale
// exactly 1, so its weights are w * 1 = w: the rate-0 launch's row, bit for
// bit. (2^32 - 1 would not do: a hash equal to 0xFFFFFFFF would still drop
// its weight.) A true threshold of 0, a rate within 2^-32 of 1, is refused
// on the host.
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

// True where the element at flat index `index` of the tile is kept, with
// `limit` = threshold - 1 (Dropout::limit).
__device__ __forceinline__ bool keep_element(uint32_t index, uint32_t key, uint32_t limit) {
  uint32_t x = index ^ key;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x <= limit;
}

// keep_element with the key's part of the first mixing step taken once:
// (index ^ key) ^ ((index ^ key) >> 16) = index ^ (index >> 16) ^ mixed_key(key),
// so a score costs one xor less. The bits are keep_element's.
__device__ __forceinline__ uint32_t mixed_key(uint32_t key) { return key ^ (key >> 16); }

__device__ __forceinline__ bool keep_mixed(uint32_t index, uint32_t mixed, uint32_t limit) {
  uint32_t x = index ^ (index >> 16) ^ mixed;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x <= limit;
}

// The dropout of one launch: one threshold and scale 1 / (1 - rate) for
// every row, or (`thresholds` and `scales` set, N device values each) one
// per row or slice, encoded as above.
struct Dropout {
  const uint32_t* thresholds;  // per row, or null: every row takes `threshold`
  const float* scales;         // per row, beside `thresholds`
  uint32_t threshold;          // 0 at rate 0
  float scale;

  // whether the launch drops at all: per-row values, or a rate above 0
  __host__ __device__ __forceinline__ bool on() const {
    return thresholds != nullptr || threshold != 0u;
  }
  // row n's limit for keep_element and keep_mixed, and its scale
  __device__ __forceinline__ uint32_t limit(int n) const {
    return (thresholds != nullptr ? thresholds[n] : threshold) - 1u;
  }
  __device__ __forceinline__ float scale_of(int n) const {
    return scales != nullptr ? scales[n] : scale;
  }
};

// The Dropout of an entry point's arguments, false where they are invalid:
// `thresholds` and `scales` both set or both null; with them, `streams`
// set and `rate` and `threshold` unread; without, 0 <= rate < 1 and, at a
// rate above 0, `streams` set and a threshold above 0.
inline bool make_dropout(Dropout& d, float rate, uint32_t threshold, const void* streams,
                         const void* thresholds, const void* scales) {
  if ((thresholds == nullptr) != (scales == nullptr)) return false;
  if (thresholds != nullptr) {
    if (streams == nullptr) return false;
    d = {static_cast<const uint32_t*>(thresholds), static_cast<const float*>(scales), 0u,
         1.0f};
    return true;
  }
  if (!(rate >= 0.0f && rate < 1.0f)) return false;
  if (rate > 0.0f && (streams == nullptr || threshold == 0u)) return false;
  d = {nullptr, nullptr, rate > 0.0f ? threshold : 0u, 1.0f / (1.0f - rate)};
  return true;
}

}  // namespace rlt
