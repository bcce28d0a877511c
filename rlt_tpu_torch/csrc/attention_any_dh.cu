// K3'-K6' at any head width: self-attention forward and backward, float32
// and bf16, for every dh from 1 to 512 that the width-specialised instances
// do not take (those run dh 16 and 64 packed, dh 128 per slice).
//
// Replaces, at those widths, rlt_tpu/ops/attention.py::_attn_fwd_kernel and
// _attn_bwd_kernel (per slice, run through _fwd_pallas and _bwd_pallas) and
// _attn_fwd_packed_kernel and _attn_bwd_packed_kernel (head-packed, through
// _fwd_packed and _bwd_packed). The JAX package sends every dh that
// `packed_group_size` admits to the packed kernels and every other dh to the
// per-slice ones, which take any dh.
//
// One body serves both layouts. The packed layout is q, k, v, o (N, L, D)
// with the H heads contiguous in D = H * dh, lse (N, H / pack, L, pack), and
// head h of row n drops on group_stream(streams[n], h / pack) at index
// i * (pack * L) + (h % pack) * L + j. The per-slice layout (N * H, L, dh),
// lse (N * H, 1, L), slice s on streams[s] at index i * L + j, is the same
// layout at one head in a group of one, so the per-slice entry points call
// the packed ones with heads = pack = 1. Each (row, head) pair is a slice of
// the grid. The rate is the launch's, or row n's own (keep_mask.cuh's
// Dropout); each head subtracts its own row max (as the width-specialised
// instances do).
//
// dh is padded in shared memory to a compile-time bucket (8, 16, 32, 64,
// 128, 256 or 512) with zeros, which add exactly 0 to every product; the
// scores are scaled by the true 1 / sqrt(dh). bf16 inputs are widened to f32
// as they are loaded, and every value is rounded where the plain bf16
// versions round it (rlt_tpu_torch/ops/attention.py): the normalised,
// dropped softmax weights before P V, ds and the dropped weights before the
// gradient products, and the stored o, dq, dk, dv. lse and the products'
// sums stay f32.
//
// What bounds it on an H100: the products (4 N H L^2 dh flops forward, about
// twice that backward) at the f32 SIMT rate; these kernels are simple SIMT
// kernels, register-tiled (each thread a micro-tile of scores and of
// outputs, so a product step loads a few values for several multiply-adds),
// with no tensor cores. Design: a block of 256 threads takes one slice and
// a tile of rows (kRows: 64 at dh <= 64, 32 up to 256, 16 at 512) and
// streams the other side in tiles (kKeys: 64 up to 128, 32 at 256, 16 at
// 512), so that f32 K and V tiles fit in shared memory at dh 512 (2 x 16 x
// 513 floats) where 64 keys would not (256 KB). Tiles are stored with pitch
// dh + 1 so that neighbouring threads read neighbouring banks. The forward takes two
// passes over the keys: the row max and sum first, then the normalised
// weights p = exp(s - m) / l, dropped and scaled, into P V; the weights are
// the plain version's, not a running rescale. The backward is a delta pass
// (rowsum(do o)), a dq pass over key tiles and a dk/dv pass over query
// tiles, none with atomics, so a repeated launch is bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "keep_mask.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDh = 512;

// A block's tiles, and the register micro-tile of each that a thread
// computes: each step of a product loads the thread's few rows and columns
// once and takes every pair of them. Scores (kRows, kKeys): thread t takes
// keys t % 16 + 16 j (j < kTC) of rows t / 16 + 16 i (i < kTR). Outputs
// (kRows, kDh): columns t % kCG + kCG v (v < kTCo) of rows t / kCG + kRG w
// (w < kTRo).
template <int kDh>
struct Tiles {
  static constexpr int kRows = kDh <= 64 ? 64 : (kDh <= 256 ? 32 : 16);
  static constexpr int kKeys = kDh <= 128 ? 64 : (kDh <= 256 ? 32 : 16);
  static constexpr int kPitch = kDh + 1;
  static constexpr int kSPitch = kKeys + 1;
  static constexpr int kTR = kRows / 16, kTC = kKeys / 16;
  static constexpr int kTCo = kDh <= 16 ? 1 : (kDh <= 32 ? 2 : (kDh <= 128 ? 4 : 8));
  static constexpr int kCG = kDh / kTCo;
  static constexpr int kRG = kThreads / kCG;
  static constexpr int kTRo = kRows / kRG;
  static_assert(kThreads == 256 && kThreads % kCG == 0 && kRows % kRG == 0, "tiles");
};

// a[i][j] = sum_c x[16 i pitch + c] y[16 j pitch + c]: a thread's micro-tile
// of dot products between rows 16 i of x and rows 16 j of y (x and y at the
// thread's first row of each)
template <int kDh, int kI, int kJ>
__device__ __forceinline__ void tile_dots(float (&a)[kI][kJ], const float* x, const float* y) {
  constexpr int kPitch = kDh + 1;
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) a[i][j] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < kDh; ++c) {
    float xv[kI], yv[kJ];
#pragma unroll
    for (int i = 0; i < kI; ++i) xv[i] = x[16 * i * kPitch + c];
#pragma unroll
    for (int j = 0; j < kJ; ++j) yv[j] = y[16 * j * kPitch + c];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
  }
}

// acc[w][v] += sum_j p[kRG w kSPitch + j] t[j kPitch + kCG v] over the kKeys
// columns of a weight tile p and the rows of a value tile t (p at the
// thread's first row, t at its first column)
template <int kDh>
__device__ __forceinline__ void accumulate(
    float (&acc)[Tiles<kDh>::kTRo][Tiles<kDh>::kTCo], const float* p, const float* t) {
  using C = Tiles<kDh>;
#pragma unroll 4
  for (int j = 0; j < C::kKeys; ++j) {
    float tv[C::kTCo];
#pragma unroll
    for (int v = 0; v < C::kTCo; ++v) tv[v] = t[j * C::kPitch + v * C::kCG];
#pragma unroll
    for (int w = 0; w < C::kTRo; ++w) {
      const float pw = p[w * C::kRG * C::kSPitch + j];
#pragma unroll
      for (int v = 0; v < C::kTCo; ++v) acc[w][v] = fmaf(pw, tv[v], acc[w][v]);
    }
  }
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// x as the plain bf16 versions round it before a product: to bf16 and back
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Where slice s = row * heads + head lives, and how it drops.
struct Geo {
  int n, length, heads, dh, pack;
  float scale;

  __device__ __forceinline__ int row(int s) const { return s / heads; }
  __device__ __forceinline__ int head(int s) const { return s % heads; }
  __device__ __forceinline__ int stride() const { return heads * dh; }
  __device__ __forceinline__ size_t base(int s) const {
    return static_cast<size_t>(row(s)) * length * stride() +
           static_cast<size_t>(head(s)) * dh;
  }
  __device__ __forceinline__ size_t lse_at(int s, int i) const {
    const int h = head(s);
    return ((static_cast<size_t>(row(s)) * (heads / pack) + h / pack) * length + i) *
               pack + h % pack;
  }
  // the keep mask's column offset of the head within its group's tile
  __device__ __forceinline__ uint32_t col0(int s) const {
    return static_cast<uint32_t>(head(s) % pack) * length;
  }
  __device__ __forceinline__ uint32_t ncols() const {
    return static_cast<uint32_t>(pack) * length;
  }
};

struct Drop {
  bool on;
  uint32_t key, limit;
  float scale;
};

__device__ __forceinline__ Drop drop_of(const Geo& g, const rlt::Dropout& d,
                                        const int32_t* streams, int s) {
  if (!d.on()) return {false, 0u, 0u, 1.0f};
  const int n = g.row(s);
  return {true, rlt::stream_key(rlt::group_stream(streams[n], g.head(s) / g.pack)),
          d.limit(n), d.scale_of(n)};
}

// rows [r0, r0 + rows) of slice s into a tile of pitch kPitch, zero past L
// and past dh
template <int kDh, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* src, const Geo& g, int s,
                                          int r0, int rows) {
  constexpr int kPitch = kDh + 1;
  const size_t base = g.base(s);
  for (int idx = threadIdx.x; idx < rows * kDh; idx += kThreads) {
    const int r = idx / kDh, c = idx % kDh;
    tile[r * kPitch + c] = (r0 + r < g.length && c < g.dh)
                               ? load(src + base + static_cast<size_t>(r0 + r) * g.stride() + c)
                               : 0.0f;
  }
}

// the thread's outputs (`accumulate`'s acc) into rows r0 + .. (below L) and
// columns below dh of slice s
template <int kDh, typename T>
__device__ __forceinline__ void store_tile(
    T* dst, const float (&acc)[Tiles<kDh>::kTRo][Tiles<kDh>::kTCo], const Geo& g, int s,
    int r0) {
  using C = Tiles<kDh>;
  const int cb = threadIdx.x % C::kCG, rb = threadIdx.x / C::kCG;
  const size_t base = g.base(s);
#pragma unroll
  for (int w = 0; w < C::kTRo; ++w) {
    const int r = r0 + rb + w * C::kRG;
#pragma unroll
    for (int v = 0; v < C::kTCo; ++v) {
      const int c = cb + v * C::kCG;
      if (r < g.length && c < g.dh) store(dst + base + static_cast<size_t>(r) * g.stride() + c,
                                          acc[w][v]);
    }
  }
}

template <int kDh>
constexpr size_t fwd_smem() {
  using C = Tiles<kDh>;
  return sizeof(float) * ((C::kRows + 2 * C::kKeys) * C::kPitch + C::kRows * C::kSPitch +
                          2 * C::kRows);
}

// Forward: o and lse of slice blockIdx.x's rows blockIdx.y * kRows ..
template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
any_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, const int32_t* __restrict__ streams,
               Geo g, rlt::Dropout dropout) {
  using C = Tiles<kDh>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + C::kRows * C::kPitch;
  float* v_s = k_s + C::kKeys * C::kPitch;
  float* s_s = v_s + C::kKeys * C::kPitch;
  float* m_s = s_s + C::kRows * C::kSPitch;
  float* l_s = m_s + C::kRows;
  const int s = blockIdx.x, i0 = blockIdx.y * C::kRows, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, length = g.length;
  const Drop drop = drop_of(g, dropout, streams, s);

  load_tile<kDh>(q_s, q, g, s, i0, C::kRows);
  if (tid < C::kRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  // each thread's scores: keys kg + 16 j of rows rg + 16 i
  const int kg = tid % 16, rg = tid / 16;
  auto scores = [&](int j0) {
    float a[C::kTR][C::kTC];
    tile_dots<kDh, C::kTR, C::kTC>(a, q_s + rg * C::kPitch, k_s + kg * C::kPitch);
#pragma unroll
    for (int i = 0; i < C::kTR; ++i)
#pragma unroll
      for (int j = 0; j < C::kTC; ++j) {
        const int key = kg + 16 * j;
        s_s[(rg + 16 * i) * C::kSPitch + key] =
            j0 + key < length ? a[i][j] * g.scale : -INFINITY;
      }
  };

  // pass 1: each row's max m and sum l of exp(s - m)
  for (int j0 = 0; j0 < length; j0 += C::kKeys) {
    __syncthreads();
    load_tile<kDh>(k_s, k, g, s, j0, C::kKeys);
    __syncthreads();
    scores(j0);
    __syncthreads();
    for (int r = warp; r < C::kRows; r += kThreads / 32) {
      float mx = -INFINITY;
      for (int jj = lane; jj < C::kKeys; jj += 32) mx = fmaxf(mx, s_s[r * C::kSPitch + jj]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, off));
      const float m_new = fmaxf(m_s[r], mx);  // finite: the tile holds a key
      float sum = 0.0f;
      for (int jj = lane; jj < C::kKeys; jj += 32)
        sum += expf(s_s[r * C::kSPitch + jj] - m_new);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(~0u, sum, off);
      if (lane == 0) {
        l_s[r] = l_s[r] * expf(m_s[r] - m_new) + sum;
        m_s[r] = m_new;
      }
    }
  }

  // pass 2: o = sum_j p_ij v_j with p = exp(s - m) / l, dropped and scaled
  float acc[C::kTRo][C::kTCo] = {};
  const int cb = tid % C::kCG, ob = tid / C::kCG;
  for (int j0 = 0; j0 < length; j0 += C::kKeys) {
    __syncthreads();
    load_tile<kDh>(k_s, k, g, s, j0, C::kKeys);
    load_tile<kDh>(v_s, v, g, s, j0, C::kKeys);
    __syncthreads();
    scores(j0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C::kTR; ++i)
#pragma unroll
      for (int j = 0; j < C::kTC; ++j) {
        const int r = rg + 16 * i, key = kg + 16 * j;
        float p = 0.0f;
        if (j0 + key < length) {
          p = expf(s_s[r * C::kSPitch + key] - m_s[r]) / l_s[r];
          if (drop.on) {
            const uint32_t index = static_cast<uint32_t>(i0 + r) * g.ncols() + g.col0(s) +
                                   static_cast<uint32_t>(j0 + key);
            p = rlt::keep_element(index, drop.key, drop.limit) ? p * drop.scale : 0.0f;
          }
        }
        s_s[r * C::kSPitch + key] = rounded<T>(p);
      }
    __syncthreads();
    accumulate<kDh>(acc, s_s + ob * C::kSPitch, v_s + cb);
  }
  store_tile<kDh>(o, acc, g, s, i0);
  if (tid < C::kRows && i0 + tid < length)
    lse[g.lse_at(s, i0 + tid)] = m_s[tid] + logf(l_s[tid]);
}

// delta[s * L + i] = sum_c do o over slice s's row i, one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
any_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                 Geo g, long long rows) {
  const long long w = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;
  const int s = static_cast<int>(w / g.length), i = static_cast<int>(w % g.length);
  const size_t at = g.base(s) + static_cast<size_t>(i) * g.stride();
  float acc = 0.0f;
  for (int c = lane; c < g.dh; c += 32) acc += load(dout + at + c) * load(o + at + c);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(~0u, acc, off);
  if (lane == 0) delta[w] = acc;
}

template <int kDh>
constexpr size_t dq_smem() {
  using C = Tiles<kDh>;
  return sizeof(float) * ((2 * C::kRows + 2 * C::kKeys) * C::kPitch +
                          C::kRows * C::kSPitch + 2 * C::kRows);
}

// The score (i, j) of a backward pass: p from lse, the dropped weight pd and
// ds = p (dp - delta) scale, both rounded as the plain version rounds them.
struct Grad {
  float ds, pd;
};

template <typename T>
__device__ __forceinline__ Grad grad_of(float qk, float dodv, float lse_i, float delta_i,
                                        const Drop& drop, uint32_t index, const Geo& g) {
  const float p = expf(qk * g.scale - lse_i);
  float pd = p, dp = dodv;
  if (drop.on) {
    const bool keep = rlt::keep_element(index, drop.key, drop.limit);
    pd = keep ? p * drop.scale : 0.0f;
    dp = keep ? dp * drop.scale : 0.0f;
  }
  return {rounded<T>(p * (dp - delta_i) * g.scale), rounded<T>(pd)};
}

// dq of slice blockIdx.x's rows blockIdx.y * kRows .., over key tiles
template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
any_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, const int32_t* __restrict__ streams,
              T* __restrict__ dq, Geo g, rlt::Dropout dropout) {
  using C = Tiles<kDh>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + C::kRows * C::kPitch;
  float* k_s = do_s + C::kRows * C::kPitch;
  float* v_s = k_s + C::kKeys * C::kPitch;
  float* ds_s = v_s + C::kKeys * C::kPitch;
  float* lse_s = ds_s + C::kRows * C::kSPitch;
  float* delta_s = lse_s + C::kRows;
  const int s = blockIdx.x, i0 = blockIdx.y * C::kRows, tid = threadIdx.x;
  const int length = g.length;
  const Drop drop = drop_of(g, dropout, streams, s);

  load_tile<kDh>(q_s, q, g, s, i0, C::kRows);
  load_tile<kDh>(do_s, dout, g, s, i0, C::kRows);
  if (tid < C::kRows) {
    const bool valid = i0 + tid < length;
    lse_s[tid] = valid ? lse[g.lse_at(s, i0 + tid)] : 0.0f;
    delta_s[tid] = valid ? delta[static_cast<size_t>(s) * length + i0 + tid] : 0.0f;
  }
  float acc[C::kTRo][C::kTCo] = {};
  const int kg = tid % 16, rg = tid / 16;
  const int cb = tid % C::kCG, ob = tid / C::kCG;
  for (int j0 = 0; j0 < length; j0 += C::kKeys) {
    __syncthreads();
    load_tile<kDh>(k_s, k, g, s, j0, C::kKeys);
    load_tile<kDh>(v_s, v, g, s, j0, C::kKeys);
    __syncthreads();
    float qk[C::kTR][C::kTC], dv[C::kTR][C::kTC];
    tile_dots<kDh, C::kTR, C::kTC>(qk, q_s + rg * C::kPitch, k_s + kg * C::kPitch);
    tile_dots<kDh, C::kTR, C::kTC>(dv, do_s + rg * C::kPitch, v_s + kg * C::kPitch);
#pragma unroll
    for (int i = 0; i < C::kTR; ++i)
#pragma unroll
      for (int j = 0; j < C::kTC; ++j) {
        const int r = rg + 16 * i, key = kg + 16 * j;
        float ds = 0.0f;
        if (j0 + key < length) {
          const uint32_t index = static_cast<uint32_t>(i0 + r) * g.ncols() + g.col0(s) +
                                 static_cast<uint32_t>(j0 + key);
          ds = grad_of<T>(qk[i][j], dv[i][j], lse_s[r], delta_s[r], drop, index, g).ds;
        }
        ds_s[r * C::kSPitch + key] = ds;
      }
    __syncthreads();
    accumulate<kDh>(acc, ds_s + ob * C::kSPitch, k_s + cb);
  }
  store_tile<kDh>(dq, acc, g, s, i0);
}

template <int kDh>
constexpr size_t dkdv_smem() {
  using C = Tiles<kDh>;
  return sizeof(float) * ((2 * C::kRows + 2 * C::kKeys) * C::kPitch +
                          2 * C::kRows * C::kSPitch + 2 * C::kKeys);
}

// dk and dv of slice blockIdx.x's keys blockIdx.y * kRows .., over query
// tiles of kKeys rows
template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
any_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int32_t* __restrict__ streams,
                T* __restrict__ dk, T* __restrict__ dv, Geo g, rlt::Dropout dropout) {
  using C = Tiles<kDh>;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + C::kRows * C::kPitch;
  float* q_s = v_s + C::kRows * C::kPitch;
  float* do_s = q_s + C::kKeys * C::kPitch;
  float* ds_s = do_s + C::kKeys * C::kPitch;
  float* pd_s = ds_s + C::kRows * C::kSPitch;
  float* lse_s = pd_s + C::kRows * C::kSPitch;
  float* delta_s = lse_s + C::kKeys;
  const int s = blockIdx.x, j0 = blockIdx.y * C::kRows, tid = threadIdx.x;
  const int length = g.length;
  const Drop drop = drop_of(g, dropout, streams, s);

  load_tile<kDh>(k_s, k, g, s, j0, C::kRows);
  load_tile<kDh>(v_s, v, g, s, j0, C::kRows);
  float acc_k[C::kTRo][C::kTCo] = {}, acc_v[C::kTRo][C::kTCo] = {};
  // scores: queries qg + 16 j of keys rg + 16 i
  const int qg = tid % 16, rg = tid / 16;
  const int cb = tid % C::kCG, ob = tid / C::kCG;
  for (int i0 = 0; i0 < length; i0 += C::kKeys) {
    __syncthreads();
    load_tile<kDh>(q_s, q, g, s, i0, C::kKeys);
    load_tile<kDh>(do_s, dout, g, s, i0, C::kKeys);
    if (tid < C::kKeys) {
      const bool valid = i0 + tid < length;
      lse_s[tid] = valid ? lse[g.lse_at(s, i0 + tid)] : 0.0f;
      delta_s[tid] = valid ? delta[static_cast<size_t>(s) * length + i0 + tid] : 0.0f;
    }
    __syncthreads();
    float qk[C::kTR][C::kTC], dv_[C::kTR][C::kTC];
    tile_dots<kDh, C::kTR, C::kTC>(qk, k_s + rg * C::kPitch, q_s + qg * C::kPitch);
    tile_dots<kDh, C::kTR, C::kTC>(dv_, v_s + rg * C::kPitch, do_s + qg * C::kPitch);
#pragma unroll
    for (int i = 0; i < C::kTR; ++i)
#pragma unroll
      for (int j = 0; j < C::kTC; ++j) {
        const int jk = rg + 16 * i, iq = qg + 16 * j;
        Grad gr = {0.0f, 0.0f};
        if (i0 + iq < length && j0 + jk < length) {
          const uint32_t index = static_cast<uint32_t>(i0 + iq) * g.ncols() + g.col0(s) +
                                 static_cast<uint32_t>(j0 + jk);
          gr = grad_of<T>(qk[i][j], dv_[i][j], lse_s[iq], delta_s[iq], drop, index, g);
        }
        ds_s[jk * C::kSPitch + iq] = gr.ds;
        pd_s[jk * C::kSPitch + iq] = gr.pd;
      }
    __syncthreads();
    accumulate<kDh>(acc_k, ds_s + ob * C::kSPitch, q_s + cb);
    accumulate<kDh>(acc_v, pd_s + ob * C::kSPitch, do_s + cb);
  }
  store_tile<kDh>(dk, acc_k, g, s, j0);
  store_tile<kDh>(dv, acc_v, g, s, j0);
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int kDh>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               const void* streams, const Geo& g, const rlt::Dropout& drop, cudaStream_t st) {
  using C = Tiles<kDh>;
  constexpr size_t smem = fwd_smem<kDh>();
  cudaError_t err = allow_smem(any_fwd_kernel<T, kDh>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.n * g.heads, (g.length + C::kRows - 1) / C::kRows);
  any_fwd_kernel<T, kDh><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int32_t*>(streams), g,
      drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kDh>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, const void* streams, void* dq, void* dk, void* dv,
               void* delta, const Geo& g, const rlt::Dropout& drop, cudaStream_t st) {
  using C = Tiles<kDh>;
  const long long rows = static_cast<long long>(g.n) * g.heads * g.length;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  any_delta_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), g,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem_q = dq_smem<kDh>(), smem_kv = dkdv_smem<kDh>();
  if ((err = allow_smem(any_dq_kernel<T, kDh>, smem_q)) != cudaSuccess ||
      (err = allow_smem(any_dkdv_kernel<T, kDh>, smem_kv)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid(g.n * g.heads, (g.length + C::kRows - 1) / C::kRows);
  const auto* q_ = static_cast<const T*>(q);
  const auto* k_ = static_cast<const T*>(k);
  const auto* v_ = static_cast<const T*>(v);
  const auto* do_ = static_cast<const T*>(dout);
  const auto* lse_ = static_cast<const float*>(lse);
  const auto* delta_ = static_cast<const float*>(delta);
  const auto* s_ = static_cast<const int32_t*>(streams);
  any_dq_kernel<T, kDh><<<grid, kThreads, smem_q, st>>>(q_, k_, v_, do_, lse_, delta_, s_,
                                                        static_cast<T*>(dq), g, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  any_dkdv_kernel<T, kDh><<<grid, kThreads, smem_kv, st>>>(
      q_, k_, v_, do_, lse_, delta_, s_, static_cast<T*>(dk), static_cast<T*>(dv), g, drop);
  return static_cast<int>(cudaGetLastError());
}

// The launch's geometry, false where it is invalid.
bool make_geo(Geo& g, int n, int length, int heads, int head_dim, int pack) {
  if (n < 1 || length < 1 || heads < 1 || pack < 1 || heads % pack != 0 || head_dim < 1 ||
      head_dim > kMaxDh || length > 65535 ||
      static_cast<long long>(n) * heads > 2147483647LL)
    return false;
  g = {n, length, heads, head_dim, pack,
       static_cast<float>(1.0 / sqrt(static_cast<double>(head_dim)))};
  return true;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, const void* streams,
        const void* thresholds, const void* scales, int n, int length, int heads,
        int head_dim, int pack, float rate, unsigned int threshold, void* stream) {
  rlt::Dropout drop;
  Geo g;
  if (!make_geo(g, n, length, heads, head_dim, pack) ||
      !rlt::make_dropout(drop, rate, threshold, streams, thresholds, scales))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (head_dim <= 8) return launch_fwd<T, 8>(q, k, v, o, lse, streams, g, drop, st);
  if (head_dim <= 16) return launch_fwd<T, 16>(q, k, v, o, lse, streams, g, drop, st);
  if (head_dim <= 32) return launch_fwd<T, 32>(q, k, v, o, lse, streams, g, drop, st);
  if (head_dim <= 64) return launch_fwd<T, 64>(q, k, v, o, lse, streams, g, drop, st);
  if (head_dim <= 128) return launch_fwd<T, 128>(q, k, v, o, lse, streams, g, drop, st);
  if (head_dim <= 256) return launch_fwd<T, 256>(q, k, v, o, lse, streams, g, drop, st);
  return launch_fwd<T, 512>(q, k, v, o, lse, streams, g, drop, st);
}

template <typename T>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const void* lse, const void* streams, const void* thresholds, const void* scales,
        void* dq, void* dk, void* dv, void* delta, int n, int length, int heads,
        int head_dim, int pack, float rate, unsigned int threshold, void* stream) {
  rlt::Dropout drop;
  Geo g;
  if (!make_geo(g, n, length, heads, head_dim, pack) ||
      !rlt::make_dropout(drop, rate, threshold, streams, thresholds, scales))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define RLT_ANY_BWD(W) \
  launch_bwd<T, W>(q, k, v, o, dout, lse, streams, dq, dk, dv, delta, g, drop, st)
  if (head_dim <= 8) return RLT_ANY_BWD(8);
  if (head_dim <= 16) return RLT_ANY_BWD(16);
  if (head_dim <= 32) return RLT_ANY_BWD(32);
  if (head_dim <= 64) return RLT_ANY_BWD(64);
  if (head_dim <= 128) return RLT_ANY_BWD(128);
  if (head_dim <= 256) return RLT_ANY_BWD(256);
  return RLT_ANY_BWD(512);
#undef RLT_ANY_BWD
}

}  // namespace

// Forward at any head width 1 <= head_dim <= 512: q, k, v, o (N, L, heads *
// head_dim) float32, contiguous, lse (N, heads / pack, L, pack) float32;
// streams, thresholds, scales, rate and threshold as
// rlt_attention_packed_fwd takes them (per row n). The per-slice layout is
// heads = pack = 1 with N the slices. Takes 1 <= L <= 65535. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int rlt_attention_any_fwd(const void* q, const void* k, const void* v, void* o,
                                     void* lse, const void* streams, const void* thresholds,
                                     const void* scales, int n, int length, int heads,
                                     int head_dim, int pack, float rate,
                                     unsigned int threshold, void* stream) {
  return fwd<float>(q, k, v, o, lse, streams, thresholds, scales, n, length, heads,
                    head_dim, pack, rate, threshold, stream);
}

// The bf16 instance: q, k, v, o bf16, lse float32, the rest as above.
extern "C" int rlt_attention_any_fwd_bf16(const void* q, const void* k, const void* v,
                                          void* o, void* lse, const void* streams,
                                          const void* thresholds, const void* scales, int n,
                                          int length, int heads, int head_dim, int pack,
                                          float rate, unsigned int threshold, void* stream) {
  return fwd<__nv_bfloat16>(q, k, v, o, lse, streams, thresholds, scales, n, length, heads,
                            head_dim, pack, rate, threshold, stream);
}

// Backward at any head width: the forward's q, k, v, o and lse, the
// gradient do of o -> dq, dk, dv (o's shape and type), with `delta` (N *
// heads * L float32) as scratch; the rest as rlt_attention_any_fwd.
extern "C" int rlt_attention_any_bwd(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout, const void* lse,
                                     const void* streams, const void* thresholds,
                                     const void* scales, void* dq, void* dk, void* dv,
                                     void* delta, int n, int length, int heads, int head_dim,
                                     int pack, float rate, unsigned int threshold,
                                     void* stream) {
  return bwd<float>(q, k, v, o, dout, lse, streams, thresholds, scales, dq, dk, dv, delta, n,
                    length, heads, head_dim, pack, rate, threshold, stream);
}

// The bf16 instance: q, k, v, o, do, dq, dk, dv bf16, lse and delta float32.
extern "C" int rlt_attention_any_bwd_bf16(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          const void* streams, const void* thresholds,
                                          const void* scales, void* dq, void* dk, void* dv,
                                          void* delta, int n, int length, int heads,
                                          int head_dim, int pack, float rate,
                                          unsigned int threshold, void* stream) {
  return bwd<__nv_bfloat16>(q, k, v, o, dout, lse, streams, thresholds, scales, dq, dk, dv,
                            delta, n, length, heads, head_dim, pack, rate, threshold, stream);
}
