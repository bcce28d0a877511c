// K1' lstm_fwd: the LSTM recurrence forward over ndir directions, float32
// and bf16 (the bf16 instance's kernel in lstm_bf16_mma.cuh).
//
// Replaces rlt_tpu/ops/lstm.py::_lstm_fwd_kernel (run through _fwd_pallas by
// fused_lstm at ndir = 1, fused_lstm_bidir at ndir = 2, and
// jax.vmap(fused_lstm_bidir) over K population members, which Pallas
// batching turns into one kernel over the members), in its layout:
// pre-projected gate inputs xw = x W_ih^T + b_ih + b_hh of shape
// (L, ndir * B, 4H), rows d * B .. d * B + B - 1 of each step belonging to
// direction d (in kernel time order; the caller flips the reverse one), and
// the recurrent weights W_hh^T (ndir * H, 4H), rows d * H .. d * H + H - 1
// for direction d. Per direction:
//   gates_t = xw_t + h_{t-1} W_hh^T      (torch gate order i, f, g, o)
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g),  h_t = sigmoid(o) tanh(c_t)
// from a zero state, writing every h_t to hs and every c_t to cs
// (L, ndir * B, H); cs is what the backward kernel K2' reads.
//
// Population members (rlt_tpu/population.py, under jax.vmap): K members'
// BiLSTM layers are K * 2 independent directions, each with its own W_hh^T,
// so they fold into the same layout at ndir = 2K, direction d = 2m + s for
// member m and side s (0 forward, 1 reverse). Nothing in the kernel depends
// on how many directions there are: a block finds its direction from
// blockIdx.x and its W_hh^T block from the direction, and every offset is a
// size_t. The launcher takes any ndir >= 1 whose grid fits.
//
// What bounds it on an H100: the L-step serial chain, not the card's byte or
// FLOP rate. Each step multiplies the (rows, H) state by the whole of
// W_hh^T, and at H = 128 W_hh^T is 128 x 512 floats = 256 KB: more than the
// 227 KB of shared memory a block may hold. So every step of every block
// streams W_hh^T from on-chip storage, and the next step waits for it.
//
// Design: batch rows and directions are independent in the recurrence, so a
// block owns R rows of one direction and walks all L steps itself (the loop
// replaces the TPU's sequential grid; the TPU's padding of B to 8 is not
// carried over). R is 1, 2 or 4: the fewest rows per block that keep the
// ndir * ceil(B / R) blocks within the card's SMs, since a block fills an
// SM's shared memory; at B = 63 the two directions' 126 chains run at once.
// Past 4 rows a block more directions take more waves: at B = 63, K = 4
// members (ndir = 8) fill 128 of the 132 SMs once, K = 8 (ndir = 16) twice.
// A step's cost is the shared memory its warps read: W_hh^T once, and the
// whole of h_{t-1} once per warp. So a block has 2H threads, 8 warps at
// H = 128, each thread owning gate q of the two units v and v + H/2
// (columns qH + v and qH + v + H/2; thread 4v + q, so a unit's four gates
// sit in four adjacent lanes), and at 2H threads a thread may hold 255
// registers: the last 64 rows of both its columns stay in 128 registers for
// the whole launch, and only the first H - 64 rows sit in shared memory,
// permuted once at load so that each thread finds each of its columns'
// rows 4m .. 4m + 3 as one float4 beside its lanes' (a warp reads 512
// contiguous bytes a load). h_{t-1} is read four units at a time as a float4 broadcast that
// feeds both columns. The four pre-activations of a unit meet by shuffles
// inside the lane group, every lane of the group carries c_t in a register,
// and h_t goes to a double-buffered h_s: ONE barrier per step. Before this
// design (PR 1's), one thread per gate column (16 warps, 32 register rows)
// took two barriers a step: the gates went through shared memory to a
// second set of threads, and h and c back through shared memory. The next
// step's xw is loaded into registers while this step computes.
//
// bf16 (rlt_lstm_fwd_bf16; the JAX kernel on bf16 operands): xw and W_hh^T
// arrive in bf16 and hs leaves in bf16, while h and c are carried in f32.
// Its kernel is lstm_bf16_mma.cuh's, on the tensor cores with W_hh^T
// resident in registers. The template below is launched for float32 only:
// its bf16 branches are not instantiated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lstm_bf16_mma.cuh"

namespace {

constexpr int kRegRows = 64;      // rows of each of a thread's columns in registers
constexpr int kMaxThreads = 256;  // 2H at H = 128
constexpr long long kMaxBlocks = 2147483647;  // gridDim.x

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float widen(float x) { return x; }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }

// the bf16 pair in the lower and upper halves of u, as floats
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// acc[r][s] += sum over the 4 units k..k+3 of h[r][k+i] * w_s.i, h from
// shared memory with a row pitch of `pitch` floats: one broadcast read of h
// feeds the thread's two columns.
template <int R>
__device__ __forceinline__ void fma4x2(float (&acc)[R][2], const float* h, int pitch,
                                       int k, float4 w0, float4 w1) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 hv = *reinterpret_cast<const float4*>(h + r * pitch + k);
    acc[r][0] = fmaf(hv.x, w0.x, acc[r][0]);
    acc[r][1] = fmaf(hv.x, w1.x, acc[r][1]);
    acc[r][0] = fmaf(hv.y, w0.y, acc[r][0]);
    acc[r][1] = fmaf(hv.y, w1.y, acc[r][1]);
    acc[r][0] = fmaf(hv.z, w0.z, acc[r][0]);
    acc[r][1] = fmaf(hv.z, w1.z, acc[r][1]);
    acc[r][0] = fmaf(hv.w, w0.w, acc[r][0]);
    acc[r][1] = fmaf(hv.w, w1.w, acc[r][1]);
  }
}

template <typename T>
size_t smem_bytes(int rows, int hidden) {
  return sizeof(T) * static_cast<size_t>(hidden - kRegRows) * 4 * hidden +
         sizeof(float) * 2 * rows * hidden;
}

// Dynamic shared memory: the shared-memory rows of W_hh^T, then
// h_s[2][R][H] (h_{t-1} and h_t, f32, alternating by step). float:
// w_s[(H - 64) / 4][2][2H][4], where w_s[m][s][4v + q][e] =
// W_hh^T[4m + e][qH + v + s H/2]; bf16: w_s[(H - 64) / 4][2H][2][4], the
// same elements with a thread's two columns side by side (16 bytes). With H
// a multiple of 32 and blockDim.x == 2H <= 256, h_s starts on a 16-byte
// boundary, and so does every h row.
template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_fwd_kernel(const T* __restrict__ xw, const T* __restrict__ w,
                T* __restrict__ hs, float* __restrict__ cs, int length,
                int batch, int hidden, int ndir) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  const int gates = 4 * hidden;
  const int half = hidden / 2;
  const int threads = 2 * hidden;
  const int ks = hidden - kRegRows;  // rows of W_hh^T in shared memory
  T* w_s = reinterpret_cast<T*>(smem4);
  float* h_s = reinterpret_cast<float*>(w_s + static_cast<size_t>(ks) * gates);

  const int tid = threadIdx.x;
  const int v = tid >> 2;  // hidden units v and v + H/2
  const int q = tid & 3;   // gate: i, f, g, o
  const int col = q * hidden + v;
  const int blocks_per_dir = (batch + R - 1) / R;
  const int dir = blockIdx.x / blocks_per_dir;
  const int b0 = (blockIdx.x - dir * blocks_per_dir) * R;
  const int nb = min(R, batch - b0);
  const size_t step_rows = static_cast<size_t>(ndir) * batch;
  const size_t row0 = static_cast<size_t>(dir) * batch + b0;
  const T* wd = w + static_cast<size_t>(dir) * hidden * gates;

  for (int i = tid; i < ks * gates; i += threads) {
    int th, k, s;  // thread 4v' + q', row, column half
    if (kF32) {
      th = (i >> 2) % threads;
      k = ((i >> 2) / (2 * threads)) * 4 + (i & 3);
      s = (i >> 2) / threads & 1;
    } else {
      th = (i >> 3) % threads;
      k = ((i >> 3) / threads) * 4 + (i & 3);
      s = (i >> 2) & 1;
    }
    const int c = (th & 3) * hidden + (th >> 2) + s * half;
    w_s[i] = wd[static_cast<size_t>(k) * gates + c];
  }
  float w_r0[kRegRows], w_r1[kRegRows];
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) {
    w_r0[k] = widen(wd[static_cast<size_t>(ks + k) * gates + col]);
    w_r1[k] = widen(wd[static_cast<size_t>(ks + k) * gates + col + half]);
  }
  for (int i = tid; i < 2 * R * hidden; i += threads) h_s[i] = 0.0f;
  float x_next[R][2];
  float c_reg[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T* x0 = xw + (row0 + r) * gates + col;
    x_next[r][0] = r < nb ? widen(x0[0]) : 0.0f;
    x_next[r][1] = r < nb ? widen(x0[half]) : 0.0f;
    c_reg[r][0] = 0.0f;
    c_reg[r][1] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < length; ++t) {
    const float* h_cur = h_s + (t & 1) * R * hidden;
    float* h_nxt = h_s + ((t + 1) & 1) * R * hidden;
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r][0] = x_next[r][0];
      acc[r][1] = x_next[r][1];
    }
    if (t + 1 < length) {
      const T* xw_n = xw + ((t + 1) * step_rows + row0) * gates + col;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        x_next[r][0] = r < nb ? widen(xw_n[static_cast<size_t>(r) * gates]) : 0.0f;
        x_next[r][1] =
            r < nb ? widen(xw_n[static_cast<size_t>(r) * gates + half]) : 0.0f;
      }
    }
    if (kF32) {
      const float4* w4 = reinterpret_cast<const float4*>(w_s) + tid;
#pragma unroll 4
      for (int k = 0; k < ks; k += 4) {
        const float4* wk = w4 + (k >> 2) * 2 * threads;
        fma4x2<R>(acc, h_cur, hidden, k, wk[0], wk[threads]);
      }
    } else {
      const uint4* w8 = reinterpret_cast<const uint4*>(w_s) + tid;
#pragma unroll 4
      for (int k = 0; k < ks; k += 4) {
        const uint4 u = w8[(k >> 2) * threads];
        fma4x2<R>(acc, h_cur, hidden, k,
                  make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y)),
                  make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w)));
      }
    }
#pragma unroll
    for (int k = 0; k < kRegRows; k += 4)
      fma4x2<R>(acc, h_cur, hidden, ks + k,
                make_float4(w_r0[k], w_r0[k + 1], w_r0[k + 2], w_r0[k + 3]),
                make_float4(w_r1[k], w_r1[k + 1], w_r1[k + 2], w_r1[k + 3]));

    // gate q's activation, then each unit's four gates from the lane group
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float a = q == 2 ? tanhf(acc[r][s]) : sigmoid_f32(acc[r][s]);
        const float in_g = __shfl_sync(0xffffffffu, a, 0, 4);
        const float forget_g = __shfl_sync(0xffffffffu, a, 1, 4);
        const float cell_g = __shfl_sync(0xffffffffu, a, 2, 4);
        const float out_g = __shfl_sync(0xffffffffu, a, 3, 4);
        c_reg[r][s] = forget_g * c_reg[r][s] + in_g * cell_g;
        const float h = out_g * tanhf(c_reg[r][s]);
        const int u = v + s * half;
        if (q == 0) h_nxt[r * hidden + u] = h;
        if (r < nb) {
          const size_t o = (t * step_rows + row0 + r) * hidden + u;
          if (q == 1) hs[o] = narrow<T>(h);
          if (q == 2) cs[o] = c_reg[r][s];
        }
      }
    }
    // h_t is complete before any thread reads it; h_{t-1}'s buffer is not
    // written again until every thread has passed the next step's barrier
    __syncthreads();
  }
}

template <typename T, int R>
cudaError_t launch(const void* xw, const void* w_hh_t, void* hs, void* cs,
                   int length, int batch, int hidden, int ndir,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(R, hidden);
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_fwd_kernel<T, R><<<ndir * ((batch + R - 1) / R), 2 * hidden, smem, stream>>>(
      static_cast<const T*>(xw), static_cast<const T*>(w_hh_t), static_cast<T*>(hs),
      static_cast<float*>(cs), length, batch, hidden, ndir);
  return cudaGetLastError();
}

template <typename T>
int lstm_fwd(const void* xw, const void* w_hh_t, void* hs, void* cs, int length,
             int batch, int hidden, int ndir, void* stream) {
  if (length < 1 || batch < 1 || hidden < kRegRows || hidden % 32 != 0 ||
      2 * hidden > kMaxThreads || ndir < 1 ||
      static_cast<long long>(ndir) * ((batch + 3) / 4) > kMaxBlocks)
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
  if (smem_bytes<T>(4, hidden) > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndir * batch <= sms)
    err = launch<T, 1>(xw, w_hh_t, hs, cs, length, batch, hidden, ndir, s);
  else if (ndir * ((batch + 1) / 2) <= sms)
    err = launch<T, 2>(xw, w_hh_t, hs, cs, length, batch, hidden, ndir, s);
  else
    err = launch<T, 4>(xw, w_hh_t, hs, cs, length, batch, hidden, ndir, s);
  return static_cast<int>(err);
}

}  // namespace

// xw (L, ndir * B, 4H), w_hh_t (ndir * H, 4H), hs and cs (L, ndir * B, H):
// contiguous float32 device arrays, H a multiple of 32 in [64, 128], ndir
// >= 1 (1, 2, or 2K for K population members), B the rows of one
// direction. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rlt_lstm_fwd(const void* xw, const void* w_hh_t, void* hs,
                            void* cs, int length, int batch, int hidden,
                            int ndir, void* stream) {
  return lstm_fwd<float>(xw, w_hh_t, hs, cs, length, batch, hidden, ndir, stream);
}

// The bf16 instance: xw, w_hh_t and hs bf16, cs float32, xw 16-byte
// aligned (its rows arrive by bulk copies), H one of 64, 96 and 128; the
// rest as rlt_lstm_fwd.
extern "C" int rlt_lstm_fwd_bf16(const void* xw, const void* w_hh_t, void* hs,
                                 void* cs, int length, int batch, int hidden,
                                 int ndir, void* stream) {
  using rlt::lstm_bf16::fwd_tiles;
  if (length < 1 || batch < 1 || ndir < 1 ||
      (hidden != 64 && hidden != 96 && hidden != 128) ||
      static_cast<long long>(ndir) * ((batch + 1) / 2) > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(xw) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = rlt::lstm_bf16::chain_tiles(ndir, batch, sms);
  const bf16* x = static_cast<const bf16*>(xw);
  const bf16* w = static_cast<const bf16*>(w_hh_t);
  bf16* h = static_cast<bf16*>(hs);
  float* c = static_cast<float*>(cs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 64: err = fwd_tiles<64>(nt, x, w, h, c, length, batch, ndir, s); break;
    case 96: err = fwd_tiles<96>(nt, x, w, h, c, length, batch, ndir, s); break;
    default: err = fwd_tiles<128>(nt, x, w, h, c, length, batch, ndir, s);
  }
  return static_cast<int>(err);
}
