// K1' lstm_fwd: one direction of the LSTM recurrence, forward, float32.
//
// Replaces rlt_tpu/ops/lstm.py::_lstm_fwd_kernel (run through _fwd_pallas and
// fused_lstm). Computes, for pre-projected gate inputs xw = x W_ih^T + b_ih +
// b_hh of shape (L, B, 4H) and the recurrent weights W_hh^T (H, 4H):
//   gates_t = xw_t + h_{t-1} W_hh^T      (torch gate order i, f, g, o)
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g),  h_t = sigmoid(o) tanh(c_t)
// from a zero state, writing every h_t to hs and every c_t to cs (L, B, H);
// cs is what the training slice's backward kernel reads.
//
// What bounds it on an H100: the L-step serial chain, not the card's byte or
// FLOP rate. Each step multiplies the (rows, H) state by the whole of
// W_hh^T, and at H = 128 W_hh^T is 128 x 512 floats = 256 KB: more than the
// 227 KB of shared memory a block may hold. So every step of every block
// reads all of W_hh^T from on-chip storage, and the next step waits for it.
//
// Design: batch rows are independent in the recurrence, so a block owns R
// rows and walks all L steps itself (the loop replaces the TPU's sequential
// grid; the TPU's padding of B to 8 and its direction fold are not carried
// over). R is 1, 2 or 4: the fewest rows per block that keep the blocks
// within the card's SMs, since a step's cost grows with its rows and a block
// fills an SM's shared memory. One thread per gate column j in [0, 4H) keeps
// the R partial sums of column j in registers. W_hh^T is split between the
// two on-chip stores: its first H - 32 rows are copied once into shared
// memory, and thread j holds the last 32 rows of column j in 32 registers for
// the whole launch, so no step reads W_hh^T from L2. h, c and the step's
// gates live in shared memory; h is read four units at a time as a float4
// broadcast. The next step's xw is loaded into registers while this step
// computes. Splitting W_hh^T over a thread block cluster is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRegRows = 32;      // rows of W_hh^T held in registers
constexpr int kMaxThreads = 512;  // 4H at H = 128

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
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

size_t smem_bytes(int rows, int hidden) {
  const size_t gates = 4 * static_cast<size_t>(hidden);
  return sizeof(float) * ((hidden - kRegRows) * gates + 2 * rows * hidden +
                          rows * gates);
}

// Dynamic shared memory: w_s[H - 32][4H] | h_s[R][H] | c_s[R][H] | g_s[R][4H].
// blockDim.x == 4H <= 512 with H a multiple of 32, so every h row starts on a
// 16-byte boundary.
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ w,
                float* __restrict__ hs, float* __restrict__ cs, int length,
                int batch, int hidden) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int gates = 4 * hidden;
  const int ks = hidden - kRegRows;  // rows of W_hh^T in shared memory
  float* w_s = smem;
  float* h_s = w_s + static_cast<size_t>(ks) * gates;
  float* c_s = h_s + R * hidden;
  float* g_s = c_s + R * hidden;

  const int j = threadIdx.x;
  const int b0 = blockIdx.x * R;
  const int nb = min(R, batch - b0);

  for (int i = j; i < ks * gates; i += blockDim.x) w_s[i] = w[i];
  float w_r[kRegRows];
#pragma unroll
  for (int k = 0; k < kRegRows; ++k)
    w_r[k] = w[static_cast<size_t>(ks + k) * gates + j];
  for (int i = j; i < R * hidden; i += blockDim.x) {
    h_s[i] = 0.0f;
    c_s[i] = 0.0f;
  }
  float x_next[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    x_next[r] = r < nb ? xw[static_cast<size_t>(b0 + r) * gates + j] : 0.0f;
  __syncthreads();

  for (int t = 0; t < length; ++t) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = x_next[r];
    if (t + 1 < length) {
      const float* xw_n = xw + (static_cast<size_t>(t + 1) * batch + b0) * gates + j;
#pragma unroll
      for (int r = 0; r < R; ++r)
        x_next[r] = r < nb ? xw_n[static_cast<size_t>(r) * gates] : 0.0f;
    }
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

    // i indexes (row r, unit u) as r * H + u, the layout of h_s and c_s
    for (int i = j; i < nb * hidden; i += blockDim.x) {
      const int r = i / hidden;
      const int u = i - r * hidden;
      const float* g = g_s + r * gates;
      const float in_g = sigmoid_f32(g[u]);
      const float forget_g = sigmoid_f32(g[hidden + u]);
      const float cell_g = tanhf(g[2 * hidden + u]);
      const float out_g = sigmoid_f32(g[3 * hidden + u]);
      const float c = forget_g * c_s[i] + in_g * cell_g;
      const float h = out_g * tanhf(c);
      c_s[i] = c;
      h_s[i] = h;
      const size_t o = (static_cast<size_t>(t) * batch + b0 + r) * hidden + u;
      hs[o] = h;
      cs[o] = c;
    }
    __syncthreads();
  }
}

template <int R>
cudaError_t launch(const void* xw, const void* w_hh_t, void* hs, void* cs,
                   int length, int batch, int hidden, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, hidden);
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_fwd_kernel<R><<<(batch + R - 1) / R, 4 * hidden, smem, stream>>>(
      static_cast<const float*>(xw), static_cast<const float*>(w_hh_t),
      static_cast<float*>(hs), static_cast<float*>(cs), length, batch, hidden);
  return cudaGetLastError();
}

}  // namespace

// xw (L, B, 4H), w_hh_t (H, 4H), hs and cs (L, B, H): contiguous float32
// device arrays, H a multiple of 32 in [32, 128]. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int rlt_lstm_fwd(const void* xw, const void* w_hh_t, void* hs,
                            void* cs, int length, int batch, int hidden,
                            void* stream) {
  if (length < 1 || batch < 1 || hidden < kRegRows || hidden % 32 != 0 ||
      4 * hidden > kMaxThreads)
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
  if (smem_bytes(4, hidden) > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= sms) err = launch<1>(xw, w_hh_t, hs, cs, length, batch, hidden, s);
  else if (batch <= 2 * sms)
    err = launch<2>(xw, w_hh_t, hs, cs, length, batch, hidden, s);
  else
    err = launch<4>(xw, w_hh_t, hs, cs, length, batch, hidden, s);
  return static_cast<int>(err);
}
