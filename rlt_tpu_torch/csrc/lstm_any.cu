// K1' and K2' at any hidden width: the LSTM recurrence forward and its
// backward, float32 and bf16, for every H from 1 to 2048 that the
// width-specialised instances (lstm_fwd.cu, lstm_bwd.cu, lstm_bf16_mma.cuh:
// H 64, 96 and 128) do not take.
//
// Replaces, at those widths, rlt_tpu/ops/lstm.py::_lstm_fwd_kernel and
// _lstm_bwd_kernel (run through _fwd_pallas and _bwd_pallas; the JAX LSTM
// layer takes them at any H that is a multiple of 128, and lax.scan at any
// other, which computes the same recurrence). The layout is the
// width-specialised instances': `ndir` directions folded into the batch,
// xw (L, ndir * B, 4H) in torch gate order i, f, g, o, W_hh^T (ndir * H,
// 4H), hs (L, ndir * B, H) in xw's type, cs (L, ndir * B, H) float32. In
// bf16 the gates are taken in f32 from the widened xw and W_hh^T, h and c
// are carried in f32, and only the stored hs and dxw are rounded: the plain
// bf16 version's semantics (rlt_tpu_torch/ops/lstm.py).
//
// What bounds it on an H100: W_hh^T is read every step. At H = 256 it is 1
// MiB a direction in f32, more than a block's 227 KB of shared memory, so
// the design that keeps it on chip at H <= 128 stops. Here each block owns
// kRows = 4 batch rows of one direction and every unit of them, so rows
// need no exchange between blocks, and streams W_hh^T from L2 every step
// (a thread takes unit u's four gate columns, coalesced across the warp, and
// reuses each weight for the block's 4 rows). So the L2 reads of W_hh^T, ndir
// * ceil(B / 4) times a step, bound it, ahead of its products at the f32
// SIMT rate. The backward first recomputes every step's gate activations
// from the stored hs in one parallel pass, then runs the reverse chain (dh
// W_hh as one warp per unit k reading W_hh^T's row k across the lanes),
// then sums dW_hh^T = sum_t h_{t-1}^T dgates_t as a tiled product split
// over row chunks, whose partial sums a last pass adds in a fixed order, so
// a repeated launch is bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;        // batch rows a chain block owns
constexpr int kMaxHidden = 2048;  // the chain's carries and dgates fit in shared memory
constexpr int kMaxGridYZ = 65535;
constexpr int kTile = 32;        // the dW_hh^T product's (k, j) tile and row step

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// acc[r][g] = xw[t, row r, g H + u] + sum_k h_s[r][k] W_hh^T[d H + k][g H + u]
// for the block's rows; h_s holds kRows rows of H values
template <typename T>
__device__ __forceinline__ void gates(float (&acc)[kRows][4], const T* xw, const T* w,
                                      const float* h_s, int t, int d, int b0, int nrows,
                                      int batch, int ndir, int hidden, int u) {
  const int g4 = 4 * hidden;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t at = (static_cast<size_t>(t) * ndir * batch + d * batch + b0 + r) * g4 + u;
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = r < nrows ? load(xw + at + g * hidden) : 0.0f;
  }
  const T* wp = w + static_cast<size_t>(d) * hidden * g4 + u;
  // unrolled so that several steps' weight loads are in flight at once: a
  // load from L2 takes hundreds of cycles, and one at a time set the pace
#pragma unroll 8
  for (int k = 0; k < hidden; ++k) {
    const T* row = wp + static_cast<size_t>(k) * g4;
    float wg[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) wg[g] = load(row + g * hidden);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float h = h_s[r * hidden + k];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(h, wg[g], acc[r][g]);
    }
  }
}

// Forward: block (row group blockIdx.x, direction blockIdx.y) runs the chain
// of its rows. Shared memory: h of the rows twice (this step's, the next),
// then c.
template <typename T>
__global__ void lstm_any_fwd_kernel(const T* __restrict__ xw, const T* __restrict__ w,
                                    T* __restrict__ hs, float* __restrict__ cs, int length,
                                    int batch, int hidden, int ndir) {
  extern __shared__ float smem[];
  float* h_s = smem;  // [2][kRows][H]
  float* c_s = h_s + 2 * kRows * hidden;
  const int d = blockIdx.y, b0 = blockIdx.x * kRows;
  const int nrows = min(kRows, batch - b0);
  for (int i = threadIdx.x; i < 3 * kRows * hidden; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  for (int t = 0; t < length; ++t) {
    const float* h_cur = h_s + (t & 1) * kRows * hidden;
    float* h_nxt = h_s + ((t + 1) & 1) * kRows * hidden;
    for (int u = threadIdx.x; u < hidden; u += blockDim.x) {
      float acc[kRows][4];
      gates(acc, xw, w, h_cur, t, d, b0, nrows, batch, ndir, hidden, u);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nrows) continue;
        const float i = sigmoid(acc[r][0]), f = sigmoid(acc[r][1]);
        const float gg = tanhf(acc[r][2]), o = sigmoid(acc[r][3]);
        const float c = f * c_s[r * hidden + u] + i * gg;
        const float h = o * tanhf(c);
        c_s[r * hidden + u] = c;
        h_nxt[r * hidden + u] = h;
        const size_t at =
            (static_cast<size_t>(t) * ndir * batch + d * batch + b0 + r) * hidden + u;
        store(hs + at, h);
        cs[at] = c;
      }
    }
    __syncthreads();
  }
}

// Backward pass 1: every step's gate activations (i, f, g, o after their
// nonlinearities) from the stored h_{t-1}, block (row group, step, direction)
// in parallel, into act (L, ndir * B, 4H) float32.
template <typename T>
__global__ void lstm_any_act_kernel(const T* __restrict__ xw, const T* __restrict__ w,
                                    const T* __restrict__ hs, float* __restrict__ act,
                                    int batch, int hidden, int ndir) {
  extern __shared__ float h_s[];  // [kRows][H]
  const int t = blockIdx.y, d = blockIdx.z, b0 = blockIdx.x * kRows;
  const int nrows = min(kRows, batch - b0);
  for (int i = threadIdx.x; i < kRows * hidden; i += blockDim.x) {
    const int r = i / hidden, k = i % hidden;
    h_s[i] = (t > 0 && r < nrows)
                 ? load(hs + (static_cast<size_t>(t - 1) * ndir * batch + d * batch + b0 + r) *
                                 hidden + k)
                 : 0.0f;
  }
  __syncthreads();
  const int g4 = 4 * hidden;
  for (int u = threadIdx.x; u < hidden; u += blockDim.x) {
    float acc[kRows][4];
    gates(acc, xw, w, h_s, t, d, b0, nrows, batch, ndir, hidden, u);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) continue;
      float* a = act + (static_cast<size_t>(t) * ndir * batch + d * batch + b0 + r) * g4 + u;
      a[0] = sigmoid(acc[r][0]);
      a[hidden] = sigmoid(acc[r][1]);
      a[2 * hidden] = tanhf(acc[r][2]);
      a[3 * hidden] = sigmoid(acc[r][3]);
    }
  }
}

// Backward pass 2: the reverse chain of block (row group, direction):
// dgates from the activations, cs and the carries dh and dc, stored to dxw
// (xw's type) and to dg (float32, unrounded: it feeds dW_hh^T), and the
// carry dh = dgates W_hh, one warp a unit k. Shared memory: dh carry
// [kRows][H], dc carry [kRows][H], dgates [kRows][4H].
template <typename T>
__global__ void lstm_any_chain_kernel(const T* __restrict__ w, const float* __restrict__ cs,
                                      const T* __restrict__ dho, const float* __restrict__ act,
                                      T* __restrict__ dxw, float* __restrict__ dg, int length,
                                      int batch, int hidden, int ndir) {
  extern __shared__ float smem[];
  const int g4 = 4 * hidden;
  float* dh_s = smem;
  float* dc_s = dh_s + kRows * hidden;
  float* dg_s = dc_s + kRows * hidden;
  const int d = blockIdx.y, b0 = blockIdx.x * kRows;
  const int nrows = min(kRows, batch - b0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int i = threadIdx.x; i < 6 * kRows * hidden; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  const T* wd = w + static_cast<size_t>(d) * hidden * g4;
  for (int t = length - 1; t >= 0; --t) {
    for (int u = threadIdx.x; u < hidden; u += blockDim.x) {
      for (int r = 0; r < nrows; ++r) {
        const size_t row = static_cast<size_t>(t) * ndir * batch + d * batch + b0 + r;
        const float* a = act + row * g4 + u;
        const float i = a[0], f = a[hidden], gg = a[2 * hidden], o = a[3 * hidden];
        const float tanh_c = tanhf(cs[row * hidden + u]);
        const float c_prev = t > 0 ? cs[(row - static_cast<size_t>(ndir) * batch) * hidden + u]
                                   : 0.0f;
        const float dh = load(dho + row * hidden + u) + dh_s[r * hidden + u];
        const float dout = dh * tanh_c;
        const float dc = dc_s[r * hidden + u] + dh * o * (1.0f - tanh_c * tanh_c);
        dc_s[r * hidden + u] = dc * f;
        const float dgate[4] = {dc * gg * i * (1.0f - i), dc * c_prev * f * (1.0f - f),
                                dc * i * (1.0f - gg * gg), dout * o * (1.0f - o)};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dg_s[r * g4 + g * hidden + u] = dgate[g];
          store(dxw + row * g4 + g * hidden + u, dgate[g]);
          if (dg != nullptr) dg[row * g4 + g * hidden + u] = dgate[g];
        }
      }
    }
    __syncthreads();
    for (int k = warp; k < hidden; k += warps) {
      const T* wk = wd + static_cast<size_t>(k) * g4;
      float acc[kRows] = {};
#pragma unroll 4
      for (int j = lane; j < g4; j += 32) {
        const float wv = load(wk + j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(dg_s[r * g4 + j], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off /= 2) acc[r] += __shfl_xor_sync(~0u, acc[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) dh_s[r * hidden + k] = acc[r];
      }
    }
    __syncthreads();
  }
}

// Backward pass 3: partial[d][split][k][j] = sum over split's rows m of the
// (L - 1) B rows (step t = 1 + m / B, row b = m % B) of h_{t-1}[k] dg_t[j];
// block (tile of (k, j), split, direction), kTile x kTile outputs, 4 a
// thread.
template <typename T>
__global__ void __launch_bounds__(256)
lstm_any_dw_kernel(const T* __restrict__ hs, const float* __restrict__ dg,
                   float* __restrict__ partial, int length, int batch, int hidden, int ndir,
                   int splits) {
  __shared__ float h_t[kTile][kTile + 1];  // [row][k]
  __shared__ float g_t[kTile][kTile + 1];  // [row][j]
  const int g4 = 4 * hidden;
  const int tiles_j = (g4 + kTile - 1) / kTile;
  const int k0 = (blockIdx.x / tiles_j) * kTile, j0 = (blockIdx.x % tiles_j) * kTile;
  const int split = blockIdx.y, d = blockIdx.z;
  const long long rows = static_cast<long long>(length - 1) * batch;
  const long long m0 = rows * split / splits, m1 = rows * (split + 1) / splits;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;  // ty in [0, 8)
  float acc[4] = {};
  for (long long mb = m0; mb < m1; mb += kTile) {
    for (int i = threadIdx.x; i < kTile * kTile; i += 256) {
      const int r = i / kTile, c = i % kTile;
      const long long m = mb + r;
      float hv = 0.0f, gv = 0.0f;
      if (m < m1) {
        const int t = 1 + static_cast<int>(m / batch), b = static_cast<int>(m % batch);
        const size_t prev = static_cast<size_t>(t - 1) * ndir * batch + d * batch + b;
        const size_t cur = prev + static_cast<size_t>(ndir) * batch;
        if (k0 + c < hidden) hv = load(hs + prev * hidden + k0 + c);
        if (j0 + c < g4) gv = dg[cur * g4 + j0 + c];
      }
      h_t[r][c] = hv;
      g_t[r][c] = gv;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const float gv = g_t[r][tx];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(h_t[r][ty * 4 + q], gv, acc[q]);
    }
    __syncthreads();
  }
  float* out = partial + (static_cast<size_t>(d) * splits + split) * hidden * g4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + ty * 4 + q, j = j0 + tx;
    if (k < hidden && j < g4) out[static_cast<size_t>(k) * g4 + j] = acc[q];
  }
}

// Backward pass 4: dW_hh^T[d H + k][j] = sum over splits, in order.
__global__ void lstm_any_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dw, int hidden, int ndir,
                                       int splits) {
  const size_t per = static_cast<size_t>(hidden) * 4 * hidden;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= per * ndir) return;
  const size_t d = i / per, e = i % per;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partial[(d * splits + s) * per + e];
  dw[i] = acc;
}

int threads_for(int hidden) { return min(256, (hidden + 31) / 32 * 32); }

bool valid(int length, int batch, int hidden, int ndir) {
  return length >= 1 && batch >= 1 && hidden >= 1 && hidden <= kMaxHidden && ndir >= 1 &&
         ndir <= kMaxGridYZ && length <= kMaxGridYZ;
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int fwd(const void* xw, const void* w, void* hs, void* cs, int length, int batch, int hidden,
        int ndir, void* stream) {
  if (!valid(length, batch, hidden, ndir)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 3 * kRows * hidden;
  cudaError_t err = allow_smem(lstm_any_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + kRows - 1) / kRows, ndir);
  lstm_any_fwd_kernel<T><<<grid, threads_for(hidden), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xw), static_cast<const T*>(w), static_cast<T*>(hs),
      static_cast<float*>(cs), length, batch, hidden, ndir);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* xw, const void* w, const void* hs, const void* cs, const void* dho,
        void* dxw, void* dw, void* partial, void* act, void* dg, int length, int batch,
        int hidden, int ndir, int splits, void* stream) {
  if (!valid(length, batch, hidden, ndir) || splits < 1 || splits > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(hidden);
  const int groups = (batch + kRows - 1) / kRows;
  const auto* xw_ = static_cast<const T*>(xw);
  const auto* w_ = static_cast<const T*>(w);
  const auto* hs_ = static_cast<const T*>(hs);
  auto* act_ = static_cast<float*>(act);
  // float32: dxw is dgates itself; bf16: dg holds them unrounded
  auto* dg_ = dg != nullptr ? static_cast<float*>(dg) : static_cast<float*>(dxw);
  const size_t act_smem = sizeof(float) * kRows * hidden;
  const size_t chain_smem = sizeof(float) * 6 * kRows * hidden;
  cudaError_t err;
  if ((err = allow_smem(lstm_any_act_kernel<T>, act_smem)) != cudaSuccess ||
      (err = allow_smem(lstm_any_chain_kernel<T>, chain_smem)) != cudaSuccess)
    return static_cast<int>(err);
  lstm_any_act_kernel<T><<<dim3(groups, length, ndir), threads, act_smem, st>>>(
      xw_, w_, hs_, act_, batch, hidden, ndir);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  lstm_any_chain_kernel<T><<<dim3(groups, ndir), threads, chain_smem, st>>>(
      w_, static_cast<const float*>(cs), static_cast<const T*>(dho), act_,
      static_cast<T*>(dxw), dg != nullptr ? dg_ : nullptr, length, batch, hidden, ndir);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((hidden + kTile - 1) / kTile) * ((4 * hidden + kTile - 1) / kTile);
  lstm_any_dw_kernel<T><<<dim3(tiles, splits, ndir), 256, 0, st>>>(
      hs_, dg_, static_cast<float*>(partial), length, batch, hidden, ndir, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(ndir) * hidden * 4 * hidden;
  lstm_any_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), hidden, ndir, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward at any 1 <= hidden <= 2048: xw (L, ndir * B, 4H) and w_hh_t
// (ndir * H, 4H) float32 -> hs, cs (L, ndir * B, H) float32, all contiguous.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int rlt_lstm_any_fwd(const void* xw, const void* w_hh_t, void* hs, void* cs,
                                int length, int batch, int hidden, int ndir, void* stream) {
  return fwd<float>(xw, w_hh_t, hs, cs, length, batch, hidden, ndir, stream);
}

// The bf16 instance: xw, w_hh_t and hs bf16, cs float32.
extern "C" int rlt_lstm_any_fwd_bf16(const void* xw, const void* w_hh_t, void* hs, void* cs,
                                     int length, int batch, int hidden, int ndir,
                                     void* stream) {
  return fwd<__nv_bfloat16>(xw, w_hh_t, hs, cs, length, batch, hidden, ndir, stream);
}

// Backward at any 1 <= hidden <= 2048: the forward's xw, w_hh_t, hs, cs and
// the gradient dho of hs -> dxw (xw's shape) and dw_hh_t (ndir * H, 4H),
// float32, with the scratch arrays partial (ndir, splits, H, 4H) and act
// (L, ndir * B, 4H) float32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rlt_lstm_any_bwd(const void* xw, const void* w_hh_t, const void* hs,
                                const void* cs, const void* dho, void* dxw, void* dw_hh_t,
                                void* partial, void* act, int length, int batch, int hidden,
                                int ndir, int splits, void* stream) {
  return bwd<float>(xw, w_hh_t, hs, cs, dho, dxw, dw_hh_t, partial, act, nullptr, length,
                    batch, hidden, ndir, splits, stream);
}

// The bf16 instance: xw, w_hh_t, hs, dho and dxw bf16, cs and dw_hh_t
// float32, and a further float32 scratch dg of xw's shape (dgates
// unrounded).
extern "C" int rlt_lstm_any_bwd_bf16(const void* xw, const void* w_hh_t, const void* hs,
                                     const void* cs, const void* dho, void* dxw,
                                     void* dw_hh_t, void* partial, void* act, void* dg,
                                     int length, int batch, int hidden, int ndir, int splits,
                                     void* stream) {
  if (dg == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return bwd<__nv_bfloat16>(xw, w_hh_t, hs, cs, dho, dxw, dw_hh_t, partial, act, dg, length,
                            batch, hidden, ndir, splits, stream);
}
