// K2' lstm_bwd: one direction of the LSTM recurrence, backward, float32.
//
// Replaces rlt_tpu/ops/lstm.py::_lstm_bwd_kernel (run through _bwd_pallas and
// the custom_vjp of fused_lstm). Given K1''s inputs xw (L, B, 4H) and
// W_hh^T (H, 4H), its outputs hs and cs (L, B, H) and the gradient dho of
// hs, it walks time in reverse with the carries dh and dc (zero at t = L-1):
//   gates_t = xw_t + h_{t-1} W_hh^T              (recomputed; h_{-1} = 0)
//   dh = dho_t + dh_carry,  do = dh tanh(c_t)
//   dc = dc_carry + dh o (1 - tanh(c_t)^2),  dc_carry <- dc f
//   di = dc g, df = dc c_{t-1}, dg = dc i        (c_{-1} = 0)
//   dgates = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)] -> dxw_t
//   dh_carry <- dgates W_hh
// and dW_hh^T = sum_t h_{t-1}^T dgates_t, an (H x (L-1)B) x ((L-1)B x 4H)
// product of hs (shifted by one step) and dxw.
//
// What bounds it on an H100: the L-step serial chain, as for K1'. Each step
// takes two products with all of W_hh (the gates from h_{t-1}, and the
// carried dh_{t-1}), and W_hh^T (128 x 512 f32, 256 KB) is more than a
// block's 227 KB of shared memory. The dW_hh^T product is small
// (2.5 GFLOP at B = 63) and parallel, so it is not on the chain.
//
// Design: one C launcher, three kernels.
//  1. lstm_bwd_chain_kernel: as in K1', a block owns R batch rows (1, 2 or
//     4) and walks the L steps itself, one thread per gate column j. The
//     first H - 32 rows of W_hh^T sit in shared memory and thread j holds
//     the last 32 rows of column j in registers for the whole launch. The
//     gates are K1''s product. The carried dh_{t-1}[k] = sum_j dgates[j]
//     W_hh^T[k][j] is a sum over the threads: for a shared-memory row k one
//     warp reads it with lanes over j and sums by shuffles; for the 32
//     register rows each warp folds its 32 lanes' 32 products in 31
//     shuffles (lane l ends with row H - 32 + l) and the 16 warps' partials
//     are summed through shared memory.
//  2. dw_partial_kernel: dW_hh^T tiled 64 x 64, the contraction over the
//     (L-1)B (t, b) rows split into `splits` chunks, each block writing its
//     chunk's partial product: no atomics.
//  3. dw_reduce_kernel: sums the partials in chunk order, so the result is
//     the same on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kRegRows = 32;      // rows of W_hh^T held in registers
constexpr int kMaxThreads = 512;  // 4H at H = 128
constexpr int kTile = 64;         // dW_hh^T output tile (rows and columns)
constexpr int kTileK = 16;        // contraction rows per shared-memory stage
constexpr int kGemmThreads = 256;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[r] += sum over the 4 units k..k+3 of h[r][k+i] * w_i, h from shared.
template <int R>
__device__ __forceinline__ void fma4(float (&acc)[R], const float* h_s,
                                     int hidden, int k, float w0, float w1,
                                     float w2, float w3) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 h = *reinterpret_cast<const float4*>(h_s + r * hidden + k);
    acc[r] = fmaf(h.x, w0, acc[r]);
    acc[r] = fmaf(h.y, w1, acc[r]);
    acc[r] = fmaf(h.z, w2, acc[r]);
    acc[r] = fmaf(h.w, w3, acc[r]);
  }
}

// One halving step of the warp's transposed sum: lanes whose bit N is set
// keep the upper N entries, the others the lower N, each adding its
// partner's copy of the entries it keeps.
template <int N>
__device__ __forceinline__ void fold_step(float (&v)[kRegRows], int lane) {
  const bool upper = (lane & N) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? v[i] : v[i + N];
    const float keep = upper ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
}

// Each lane holds 32 values; returns, in lane l, the sum over the warp's
// lanes of value l.
__device__ __forceinline__ float transpose_sum(float (&v)[kRegRows], int lane) {
  fold_step<16>(v, lane);
  fold_step<8>(v, lane);
  fold_step<4>(v, lane);
  fold_step<2>(v, lane);
  fold_step<1>(v, lane);
  return v[0];
}

size_t chain_smem_bytes(int rows, int hidden) {
  const size_t gates = 4 * static_cast<size_t>(hidden);
  const size_t warps = gates / 32;
  return sizeof(float) * ((hidden - kRegRows) * gates + 3 * rows * hidden +
                          rows * gates + rows * warps * kRegRows);
}

// Dynamic shared memory: w_s[H - 32][4H] | h_s[R][H] (h_{t-1}) |
// dh_s[R][H] (carried dh) | dc_s[R][H] (carried dc) | g_s[R][4H] (gates,
// then dgates) | red_s[R][warps][32] (register rows' partial dh).
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_chain_kernel(const float* __restrict__ xw, const float* __restrict__ w,
                      const float* __restrict__ hs, const float* __restrict__ cs,
                      const float* __restrict__ dho, float* __restrict__ dxw,
                      int length, int batch, int hidden) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int gates = 4 * hidden;
  const int warps = gates / 32;
  const int ks = hidden - kRegRows;  // rows of W_hh^T in shared memory
  float* w_s = smem;
  float* h_s = w_s + static_cast<size_t>(ks) * gates;
  float* dh_s = h_s + R * hidden;
  float* dc_s = dh_s + R * hidden;
  float* g_s = dc_s + R * hidden;
  float* red_s = g_s + R * gates;

  const int j = threadIdx.x;
  const int warp = j / 32;
  const int lane = j % 32;
  const int b0 = blockIdx.x * R;
  const int nb = min(R, batch - b0);

  for (int i = j; i < ks * gates; i += blockDim.x) w_s[i] = w[i];
  float w_r[kRegRows];
#pragma unroll
  for (int k = 0; k < kRegRows; ++k)
    w_r[k] = w[static_cast<size_t>(ks + k) * gates + j];
  for (int i = j; i < R * hidden; i += blockDim.x) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
  }

  for (int t = length - 1; t >= 0; --t) {
    // h_{t-1}, zero at t = 0 and in rows past the batch
    for (int i = j; i < R * hidden; i += blockDim.x) {
      const int r = i / hidden;
      const int u = i - r * hidden;
      h_s[i] = (t > 0 && r < nb)
                   ? hs[(static_cast<size_t>(t - 1) * batch + b0 + r) * hidden + u]
                   : 0.0f;
    }
    __syncthreads();

    // gates = xw_t + h_{t-1} W_hh^T, thread j owns gate column j
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = r < nb ? xw[(static_cast<size_t>(t) * batch + b0 + r) * gates + j] : 0.0f;
    for (int k = 0; k < ks; k += 4) {
      const float* wk = w_s + k * gates + j;
      fma4<R>(acc, h_s, hidden, k, wk[0], wk[gates], wk[2 * gates], wk[3 * gates]);
    }
#pragma unroll
    for (int k = 0; k < kRegRows; k += 4)
      fma4<R>(acc, h_s, hidden, ks + k, w_r[k], w_r[k + 1], w_r[k + 2], w_r[k + 3]);
#pragma unroll
    for (int r = 0; r < R; ++r) g_s[r * gates + j] = acc[r];
    __syncthreads();

    // elementwise, i indexes (row r, unit u) as r * H + u: dgates into g_s
    // and dxw, the carries dc into dc_s
    for (int i = j; i < nb * hidden; i += blockDim.x) {
      const int r = i / hidden;
      const int u = i - r * hidden;
      float* g = g_s + r * gates;
      const float in_g = sigmoid_f32(g[u]);
      const float forget_g = sigmoid_f32(g[hidden + u]);
      const float cell_g = tanhf(g[2 * hidden + u]);
      const float out_g = sigmoid_f32(g[3 * hidden + u]);
      const size_t o = (static_cast<size_t>(t) * batch + b0 + r) * hidden + u;
      const float c_prev = t > 0 ? cs[o - static_cast<size_t>(batch) * hidden] : 0.0f;
      const float tanh_c = tanhf(cs[o]);
      const float dh = dho[o] + dh_s[i];
      const float d_out = dh * tanh_c;
      const float dc = dc_s[i] + dh * out_g * (1.0f - tanh_c * tanh_c);
      dc_s[i] = dc * forget_g;
      const float d_in = dc * cell_g * in_g * (1.0f - in_g);
      const float d_forget = dc * c_prev * forget_g * (1.0f - forget_g);
      const float d_cell = dc * in_g * (1.0f - cell_g * cell_g);
      const float d_o = d_out * out_g * (1.0f - out_g);
      g[u] = d_in;
      g[hidden + u] = d_forget;
      g[2 * hidden + u] = d_cell;
      g[3 * hidden + u] = d_o;
      float* dx = dxw + (static_cast<size_t>(t) * batch + b0 + r) * gates;
      dx[u] = d_in;
      dx[hidden + u] = d_forget;
      dx[2 * hidden + u] = d_cell;
      dx[3 * hidden + u] = d_o;
    }
    __syncthreads();

    // dh_{t-1}[k] = sum_j dgates[j] W_hh^T[k][j]. Shared-memory rows: a warp
    // per row, lanes over j.
    for (int k = warp; k < ks; k += warps) {
      float a[R] = {};
      for (int m = lane; m < gates; m += 32) {
        const float wv = w_s[k * gates + m];
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = fmaf(g_s[r * gates + m], wv, a[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r] = warp_sum(a[r]);
        if (lane == 0) dh_s[r * hidden + k] = a[r];
      }
    }
    // register rows: each warp folds its lanes' products, lane l for row ks + l
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dg = g_s[r * gates + j];
      float v[kRegRows];
#pragma unroll
      for (int k = 0; k < kRegRows; ++k) v[k] = dg * w_r[k];
      red_s[(r * warps + warp) * kRegRows + lane] = transpose_sum(v, lane);
    }
    __syncthreads();
    for (int i = j; i < R * kRegRows; i += blockDim.x) {
      const int r = i / kRegRows;
      const int l = i - r * kRegRows;
      float a = 0.0f;
      for (int wi = 0; wi < warps; ++wi) a += red_s[(r * warps + wi) * kRegRows + l];
      dh_s[r * hidden + ks + l] = a;
    }
    // the next step's first barrier orders these writes before their reads
  }
}

// partial[s] = A[k0:k1]^T B[k0:k1] over chunk s of the contraction rows:
// A (K, m_dim) and B (K, n_dim) row-major, partial (splits, m_dim, n_dim).
__global__ void __launch_bounds__(kGemmThreads)
dw_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ partial, int kdim, int m_dim, int n_dim,
                  int chunk) {
  __shared__ __align__(16) float a_s[kTileK][kTile];
  __shared__ __align__(16) float b_s[kTileK][kTile];
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const int split = blockIdx.z;
  const int k_begin = split * chunk;
  const int k_end = min(kdim, k_begin + chunk);
  const int tid = threadIdx.x;
  const int tm = tid / 16;  // output rows m0 + 4 tm .. + 3
  const int tn = tid % 16;  // output columns n0 + 4 tn .. + 3
  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    for (int i = tid; i < kTileK * kTile; i += kGemmThreads) {
      const int kk = i / kTile;
      const int c = i - kk * kTile;
      const int k = k0 + kk;
      a_s[kk][c] = (k < k_end && m0 + c < m_dim) ? a[static_cast<size_t>(k) * m_dim + m0 + c] : 0.0f;
      b_s[kk][c] = (k < k_end && n0 + c < n_dim) ? b[static_cast<size_t>(k) * n_dim + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][tm * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tn * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(ar[x], br[y], acc[x][y]);
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(split) * m_dim * n_dim;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int m = m0 + tm * 4 + x;
    if (m >= m_dim) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int n = n0 + tn * 4 + y;
      if (n < n_dim) out[static_cast<size_t>(m) * n_dim + n] = acc[x][y];
    }
  }
}

// out = sum over s in order of partial[s], `size` elements each
__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int splits, int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float a = 0.0f;
  for (int s = 0; s < splits; ++s) a += partial[static_cast<size_t>(s) * size + i];
  out[i] = a;
}

template <int R>
cudaError_t launch_chain(const void* xw, const void* w_hh_t, const void* hs,
                         const void* cs, const void* dho, void* dxw, int length,
                         int batch, int hidden, cudaStream_t stream) {
  const size_t smem = chain_smem_bytes(R, hidden);
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_chain_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_bwd_chain_kernel<R><<<(batch + R - 1) / R, 4 * hidden, smem, stream>>>(
      static_cast<const float*>(xw), static_cast<const float*>(w_hh_t),
      static_cast<const float*>(hs), static_cast<const float*>(cs),
      static_cast<const float*>(dho), static_cast<float*>(dxw), length, batch,
      hidden);
  return cudaGetLastError();
}

}  // namespace

// xw, dxw (L, B, 4H), w_hh_t, dw_hh_t (H, 4H), hs, cs, dho (L, B, H),
// partial a (splits, H, 4H) scratch array: contiguous float32 device arrays,
// H a multiple of 32 in [32, 128], 1 <= splits <= 65535. Launches its three
// kernels on `stream` and returns the first error.
extern "C" int rlt_lstm_bwd(const void* xw, const void* w_hh_t, const void* hs,
                            const void* cs, const void* dho, void* dxw,
                            void* dw_hh_t, void* partial, int length, int batch,
                            int hidden, int splits, void* stream) {
  if (length < 1 || batch < 1 || hidden < kRegRows || hidden % 32 != 0 ||
      4 * hidden > kMaxThreads || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  int sms = 0;
  int max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chain_smem_bytes(4, hidden) > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= sms)
    err = launch_chain<1>(xw, w_hh_t, hs, cs, dho, dxw, length, batch, hidden, s);
  else if (batch <= 2 * sms)
    err = launch_chain<2>(xw, w_hh_t, hs, cs, dho, dxw, length, batch, hidden, s);
  else
    err = launch_chain<4>(xw, w_hh_t, hs, cs, dho, dxw, length, batch, hidden, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // dW_hh^T = hs[0 : L-1]^T dxw[1 : L], contracted over (L - 1) * B rows
  const int gates = 4 * hidden;
  const int kdim = (length - 1) * batch;
  const int chunk = (kdim + splits - 1) / splits;
  const dim3 grid((gates + kTile - 1) / kTile, (hidden + kTile - 1) / kTile, splits);
  dw_partial_kernel<<<grid, kGemmThreads, 0, s>>>(
      static_cast<const float*>(hs),
      static_cast<const float*>(dxw) + static_cast<size_t>(batch) * gates,
      static_cast<float*>(partial), kdim, hidden, gates, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = hidden * gates;
  dw_reduce_kernel<<<(size + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw_hh_t), splits, size);
  return static_cast<int>(cudaGetLastError());
}
