// K2' lstm_bwd: the LSTM recurrence backward over ndir directions, float32
// and bf16 (the bf16 instance's kernels in lstm_bf16_mma.cuh).
//
// Replaces rlt_tpu/ops/lstm.py::_lstm_bwd_kernel (run through _bwd_pallas and
// the custom_vjp of fused_lstm and fused_lstm_bidir, and under jax.vmap over
// population members, ndir = 2K as in K1'), in K1''s layout: xw
// (L, ndir * B, 4H) and W_hh^T (ndir * H, 4H) partitioned by direction, K1''s
// outputs hs and cs and the gradient dho of hs (L, ndir * B, H). Per
// direction it walks time in reverse with the carries dh and dc (zero at
// t = L-1):
//   gates_t = xw_t + h_{t-1} W_hh^T              (recomputed; h_{-1} = 0)
//   dh = dho_t + dh_carry,  do = dh tanh(c_t)
//   dc = dc_carry + dh o (1 - tanh(c_t)^2),  dc_carry <- dc f
//   di = dc g, df = dc c_{t-1}, dg = dc i        (c_{-1} = 0)
//   dgates = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)] -> dxw_t
//   dh_carry <- dgates W_hh
// and dW_hh^T = sum_t h_{t-1}^T dgates_t per direction, an
// (H x (L-1)B) x ((L-1)B x 4H) product of hs (shifted by one step) and dxw.
//
// What bounds it on an H100: the L-step serial chain, as for K1'. W_hh^T
// (128 x 512 f32, 256 KB) is more than a block's 227 KB of shared memory, so
// each step of a chain streams it from on-chip storage. Only the carried
// dh_{t-1} = dgates W_hh depends on the carries: the gates and their
// activations depend on the inputs alone. The old design (PR 2) recomputed
// them inside the reverse loop, a second 128-deep product per thread per
// step, and took four barriers a step (h_{t-1} in, gates out, dgates out,
// the register rows' partial sums out), with every global load in the step.
//
// Design: one C launcher, four kernels.
//  1. lstm_bwd_gates_kernel (parallel, off the chain): the gates of every
//     (t, row) as an (L B, H) x (H, 4H) product per direction, tiled 64 rows
//     by 16 units x 4 gates so that a thread holds a unit's four gates, then
//     their activations with c_t and c_{t-1}, folded into what the chain
//     needs: dgates is linear in (dh, dc),
//       dgates = [dc g i(1-i), dc c_{t-1} f(1-f), dc i(1-g^2), dh tanh(c_t) o(1-o)]
//     so the four coefficients are written IN PLACE into the dxw buffer
//     (which the chain then overwrites with dgates: no (L, ndir B, 4H)
//     buffer of activations), and o(1 - tanh(c_t)^2) and f, the dc update's
//     factors, into a (L, ndir B, H, 2) scratch array. Each thread loads its
//     share of the next 16-deep stage into registers while the block
//     multiplies the current one (so does dw_partial_kernel).
//  2. lstm_bwd_chain_kernel: as in K1', a block owns R rows (1, 2 or 4) of
//     one direction, chosen from ndir * B against the SM count, and walks
//     the L steps with 2H threads (8 warps at H = 128). Thread 4v + q holds
//     the carries of units v and v + H/2 and does quarter q of each one's
//     4H-term contraction dh_carry[k] = sum_j dgates[j] W_hh^T[k][j]: the H
//     columns of gate q, read from a float4 broadcast of dgates that feeds
//     both units. Of each unit's H values of W_hh^T, the last 64 stay in
//     registers for the whole launch (128 registers; at 2H threads a thread
//     may hold 255) and the first H - 64 sit in shared memory, permuted once
//     so that a warp reads 512 contiguous bytes a load. Two xor shuffles sum
//     the four quarters, (q0 + q1) + (q2 + q3) in every lane, so all four
//     lanes of a unit hold the same dh and dc, and lane q then computes gate
//     q's dgate itself. dgates go to a double-buffered shared array,
//     gate-major with a row pitch of H + 8 floats (writes and float4 reads
//     on distinct banks): ONE barrier per step (four before). The next
//     step's coefficients, dc factors and dho are loaded into registers
//     before the barrier, to land during the contraction.
//  3. dw_partial_kernel: dW_hh^T tiled 64 x 64 per direction, the
//     contraction over the (L-1)B (t, b) rows split into `splits` chunks,
//     each block writing its chunk's partial product: no atomics.
//  4. dw_reduce_kernel: sums the partials in chunk order, so the result is
//     the same on every run.
// Population members fold in as K1''s do, at ndir = 2K: the chain's grid is
// ndir * ceil(B / R) blocks, the gate and dW passes carry the direction on
// the grid's z axis (ndir and ndir * splits), and each member's dW_hh^T
// stays its own. The scratch grows with ndir: at B = 63 and K = 8
// (ndir = 16) gf is 310 MB and the partials (ndir, 32, H, 4H) 134 MB.
//
// bf16 (rlt_lstm_bwd_bf16; the JAX kernel on bf16 operands): xw, W_hh^T,
// hs and dho arrive in bf16 and cs in f32; the carries dh and dc and dgates
// are f32, only the stored dxw is rounded to bf16, and dW_hh^T is f32. Its
// gate recompute, chain and dW_hh^T products are lstm_bf16_mma.cuh's (the
// tensor cores; W_hh^T resident in the chain's registers), its partials
// summed by dw_reduce_kernel below. The template below is launched for
// float32 only: its bf16 branches are not instantiated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "lstm_bf16_mma.cuh"

namespace {

constexpr int kRegRows = 64;      // W_hh^T values of each unit held in registers
constexpr int kMaxThreads = 256;  // 2H at H = 128
constexpr long long kMaxBlocks = 2147483647;  // gridDim.x
constexpr int kMaxGridZ = 65535;              // gridDim.z: ndir, ndir * splits
constexpr int kTile = 64;         // GEMM output tile (rows and columns)
constexpr int kTileK = 16;        // contraction rows per shared-memory stage
constexpr int kPitchA = kTile + 4;
constexpr int kGemmThreads = 256;
constexpr int kLoads = kTileK * kTile / kGemmThreads;  // a thread's loads per operand and stage
constexpr int kGateUnits = 16;    // hidden units per gate-kernel tile

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float widen(float x) { return x; }

// acc[x][y] += sum over the stage's kTileK rows of a_s[kk][4tm + x] *
// b_s[kk][4tn + y]
__device__ __forceinline__ void tile_fma(float (&acc)[4][4],
                                         const float (*a_s)[kPitchA],
                                         const float (*b_s)[kTile], int tm, int tn) {
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
}

// Row of step t, batch row b of direction `dir` in the (L, ndir B, .) layout.
__device__ __forceinline__ size_t layout_row(int t, int b, int batch, int ndir,
                                             int dir) {
  return (static_cast<size_t>(t) * ndir + dir) * batch + b;
}

// Grid (ceil(L B / 64), H / 16, ndir), 256 threads. Tile rows m = t B + b,
// tile columns 4j + q = gate q of unit u0 + j: thread (tm, tn) ends with the
// four gates of unit u0 + tn for rows 4tm .. 4tm + 3. `coef` is f32: dxw
// itself in the f32 instance, the scratch dg in the bf16 one.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
lstm_bwd_gates_kernel(const T* __restrict__ xw, const T* __restrict__ w,
                      const T* __restrict__ hs, const float* __restrict__ cs,
                      float* __restrict__ coef, float2* __restrict__ gf,
                      int length, int batch, int hidden, int ndir) {
  __shared__ __align__(16) float a_s[kTileK][kPitchA];
  __shared__ __align__(16) float b_s[kTileK][kTile];
  const int m_dim = length * batch;
  const int m0 = blockIdx.x * kTile;
  const int u0 = blockIdx.y * kGateUnits;
  const int dir = blockIdx.z;
  const int gates = 4 * hidden;
  const T* wd = w + static_cast<size_t>(dir) * hidden * gates;
  const int tid = threadIdx.x;
  const int tm = tid / 16;
  const int tn = tid % 16;
  // this thread's 4 + 4 loads of every stage: a_s[kk][mm] = h_{t-1}[k0 + kk]
  // of row m0 + mm (zero at t = 0 and past the rows), b_s[kb][4j + q] =
  // W_hh^T[k0 + kb][qH + u0 + j]; offsets without k0, -1 for a zero
  long long a_off[kLoads];
  int b_off[kLoads];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int i = tid + l * kGemmThreads;
    const int m = m0 + i / kTileK;
    const int t = m / batch;
    a_off[l] = (m < m_dim && t > 0)
                   ? static_cast<long long>(layout_row(t - 1, m - t * batch, batch, ndir, dir)) *
                             hidden + i % kTileK
                   : -1;
    const int c = i % kTile;
    b_off[l] = (i / kTile) * gates + (c / kGateUnits) * hidden + u0 + c % kGateUnits;
  }
  float ra[kLoads], rb[kLoads];
  const auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      ra[l] = a_off[l] >= 0 ? widen(hs[a_off[l] + k0]) : 0.0f;
      rb[l] = widen(wd[static_cast<size_t>(k0) * gates + b_off[l]]);
    }
  };
  float acc[4][4] = {};
  load(0);
  for (int k0 = 0; k0 < hidden; k0 += kTileK) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = tid + l * kGemmThreads;
      a_s[i % kTileK][i / kTileK] = ra[l];
      const int c = i % kTile;
      b_s[i / kTile][4 * (c % kGateUnits) + c / kGateUnits] = rb[l];
    }
    __syncthreads();
    if (k0 + kTileK < hidden) load(k0 + kTileK);  // in flight during the products
    tile_fma(acc, a_s, b_s, tm, tn);
    __syncthreads();
  }
  const int u = u0 + tn;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int m = m0 + tm * 4 + x;
    if (m >= m_dim) continue;
    const int t = m / batch;
    const size_t row = layout_row(t, m - t * batch, batch, ndir, dir);
    const T* xr = xw + row * gates + u;
    const float in_g = sigmoid_f32(acc[x][0] + widen(xr[0]));
    const float forget_g = sigmoid_f32(acc[x][1] + widen(xr[hidden]));
    const float cell_g = tanhf(acc[x][2] + widen(xr[2 * hidden]));
    const float out_g = sigmoid_f32(acc[x][3] + widen(xr[3 * hidden]));
    const float c_prev =
        t > 0 ? cs[(row - static_cast<size_t>(ndir) * batch) * hidden + u] : 0.0f;
    const float tanh_c = tanhf(cs[row * hidden + u]);
    float* cr = coef + row * gates + u;
    cr[0] = cell_g * (in_g * (1.0f - in_g));
    cr[hidden] = c_prev * (forget_g * (1.0f - forget_g));
    cr[2 * hidden] = in_g * (1.0f - cell_g * cell_g);
    cr[3 * hidden] = tanh_c * (out_g * (1.0f - out_g));
    gf[row * hidden + u] = make_float2(out_g * (1.0f - tanh_c * tanh_c), forget_g);
  }
}

size_t chain_smem_bytes(int rows, int hidden) {
  return sizeof(float) * (static_cast<size_t>(hidden - kRegRows) * 4 * hidden +
                          2 * rows * 4 * (hidden + 8));
}

// acc[r][s] += sum over the 4 entries u..u+3 of v[r][u+i] * w_s.i, v from
// shared memory with a row pitch of `pitch` floats: one broadcast read
// feeds both units.
template <int R>
__device__ __forceinline__ void fma4x2(float (&acc)[R][2], const float* v, int pitch,
                                       int u, float4 w0, float4 w1) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(v + r * pitch + u);
    acc[r][0] = fmaf(x.x, w0.x, acc[r][0]);
    acc[r][1] = fmaf(x.x, w1.x, acc[r][1]);
    acc[r][0] = fmaf(x.y, w0.y, acc[r][0]);
    acc[r][1] = fmaf(x.y, w1.y, acc[r][1]);
    acc[r][0] = fmaf(x.z, w0.z, acc[r][0]);
    acc[r][1] = fmaf(x.z, w1.z, acc[r][1]);
    acc[r][0] = fmaf(x.w, w0.w, acc[r][0]);
    acc[r][1] = fmaf(x.w, w1.w, acc[r][1]);
  }
}

// A chain step's inputs of rows row .. row + R - 1 (zero past the nb rows of
// the batch), for units k0 and k0 + H/2: this lane's coefficient (its slot of
// the f32 dgates array `dg`, gate q), the unit's dc factors
// {o(1 - tanh(c)^2), f}, and dho.
template <typename T, int R>
__device__ __forceinline__ void load_step(float (&coef)[R][2], float (&gam)[R][2],
                                          float (&fgt)[R][2], float (&dh_in)[R][2],
                                          const float* dg, const float2* gf,
                                          const T* dho, size_t row, int nb,
                                          int hidden, int q, int k0) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t rr = row + r;
    const bool in = r < nb;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = k0 + s * (hidden / 2);
      coef[r][s] = in ? dg[rr * 4 * hidden + q * hidden + k] : 0.0f;
      const float2 g = in ? gf[rr * hidden + k] : make_float2(0.0f, 0.0f);
      gam[r][s] = g.x;
      fgt[r][s] = g.y;
      dh_in[r][s] = in ? widen(dho[rr * hidden + k]) : 0.0f;
    }
  }
}

// Dynamic shared memory: w_s[(H - 64) / 4][2][2H][4], where
// w_s[m][s][4v + q][e] = W_hh^T[v + s H/2][qH + 4m + e] (f32, W_hh^T widened
// in the bf16 instance) | dg_s[2][R][4][H + 8] (dgates gate-major,
// alternating by step). `dg` holds the coefficients, overwritten by the f32
// dgates; the f32 instance's dg is dxw, the bf16 one also writes the rounded
// dgates to dxw.
template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_bwd_chain_kernel(const T* __restrict__ w, const float2* __restrict__ gf,
                      const T* __restrict__ dho, float* __restrict__ dg,
                      T* __restrict__ dxw, int length, int batch, int hidden,
                      int ndir) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int gates = 4 * hidden;
  const int half = hidden / 2;
  const int threads = 2 * hidden;
  const int ks = hidden - kRegRows;  // values of a unit's slice in shared memory
  const int pitch = hidden + 8;
  float* w_s = smem;
  float* dg_s = w_s + static_cast<size_t>(ks) * gates;  // dgates of a step

  const int tid = threadIdx.x;
  const int v = tid >> 2;  // hidden units v and v + H/2
  const int q = tid & 3;   // gate, and quarter of the dh contraction
  const int blocks_per_dir = (batch + R - 1) / R;
  const int dir = blockIdx.x / blocks_per_dir;
  const int b0 = (blockIdx.x - dir * blocks_per_dir) * R;
  const int nb = min(R, batch - b0);
  const size_t step_rows = static_cast<size_t>(ndir) * batch;
  const size_t row0 = static_cast<size_t>(dir) * batch + b0;
  const T* wd = w + static_cast<size_t>(dir) * hidden * gates;

  for (int i = tid; i < ks * gates; i += threads) {
    const int th = (i >> 2) % threads;  // thread 4v' + q'
    const int k = (th >> 2) + ((i >> 2) / threads & 1) * half;
    const int u = ((i >> 2) / (2 * threads)) * 4 + (i & 3);
    w_s[i] = widen(wd[static_cast<size_t>(k) * gates + (th & 3) * hidden + u]);
  }
  float w_r0[kRegRows], w_r1[kRegRows];
#pragma unroll
  for (int u = 0; u < kRegRows; ++u) {
    w_r0[u] = widen(wd[static_cast<size_t>(v) * gates + q * hidden + ks + u]);
    w_r1[u] = widen(wd[static_cast<size_t>(v + half) * gates + q * hidden + ks + u]);
  }

  float coef[R][2], gam[R][2], fgt[R][2], dh_in[R][2];
  load_step<T, R>(coef, gam, fgt, dh_in, dg, gf, dho, (length - 1) * step_rows + row0,
                  nb, hidden, q, v);
  float dh_carry[R][2], dc_carry[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      dh_carry[r][s] = 0.0f;
      dc_carry[r][s] = 0.0f;
    }
  __syncthreads();

  for (int t = length - 1; t >= 0; --t) {
    float* dgs = dg_s + (t & 1) * R * 4 * pitch;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float dh = dh_in[r][s] + dh_carry[r][s];
        const float dc = dc_carry[r][s] + dh * gam[r][s];
        dc_carry[r][s] = dc * fgt[r][s];
        const float d = (q == 3 ? dh : dc) * coef[r][s];
        const int k = v + s * half;
        dgs[(r * 4 + q) * pitch + k] = d;
        if (r < nb) {
          const size_t o = (t * step_rows + row0 + r) * gates + q * hidden + k;
          dg[o] = d;
          if constexpr (!kF32) dxw[o] = __float2bfloat16_rn(d);
        }
      }
    }
    if (t == 0) break;  // no carry into step -1; every thread leaves here
    load_step<T, R>(coef, gam, fgt, dh_in, dg, gf, dho, (t - 1) * step_rows + row0, nb,
                    hidden, q, v);
    // this step's dgates are complete before any thread reads them; their
    // buffer is not written again until every thread has passed the next
    // step's barrier
    __syncthreads();

    // quarter q of dh_carry[k]: sum over u of dgates[qH + u] W_hh^T[k][qH + u]
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r][0] = 0.0f;
      acc[r][1] = 0.0f;
    }
    const float* dq = dgs + q * pitch;
    const float4* w4 = reinterpret_cast<const float4*>(w_s) + tid;
#pragma unroll 4
    for (int u = 0; u < ks; u += 4) {
      const float4* wu = w4 + (u >> 2) * 2 * threads;
      fma4x2<R>(acc, dq, 4 * pitch, u, wu[0], wu[threads]);
    }
#pragma unroll
    for (int u = 0; u < kRegRows; u += 4)
      fma4x2<R>(acc, dq, 4 * pitch, ks + u,
                make_float4(w_r0[u], w_r0[u + 1], w_r0[u + 2], w_r0[u + 3]),
                make_float4(w_r1[u], w_r1[u + 1], w_r1[u + 2], w_r1[u + 3]));
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float pair = acc[r][s] + __shfl_xor_sync(0xffffffffu, acc[r][s], 1);
        dh_carry[r][s] = pair + __shfl_xor_sync(0xffffffffu, pair, 2);
      }
  }
}

// partial[dir][s] = A_dir[k0:k1]^T B_dir[k0:k1] over chunk s of the
// contraction rows kk = t B + b: A_dir's row kk is a[(t ndir + dir) B + b]
// (m_dim wide; hs, widened in the bf16 instance), B_dir's is
// b[(t ndir + dir) B + b] (n_dim wide; the f32 dgates); partial
// (ndir, splits, m_dim, n_dim). Grid (n tiles, m tiles, ndir * splits).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
dw_partial_kernel(const T* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ partial, int kdim, int m_dim, int n_dim,
                  int chunk, int batch, int ndir, int splits) {
  __shared__ __align__(16) float a_s[kTileK][kPitchA];
  __shared__ __align__(16) float b_s[kTileK][kTile];
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const int dir = blockIdx.z / splits;
  const int split = blockIdx.z - dir * splits;
  const int k_begin = split * chunk;
  const int k_end = min(kdim, k_begin + chunk);
  const int tid = threadIdx.x;
  const int tm = tid / 16;  // output rows m0 + 4 tm .. + 3
  const int tn = tid % 16;  // output columns n0 + 4 tn .. + 3
  // this thread's 4 + 4 loads of the stage at k0, zero past the chunk
  float ra[kLoads], rb[kLoads];
  const auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = tid + l * kGemmThreads;
      const int k = k0 + i / kTile;
      const int c = i % kTile;
      const int t = k / batch;
      const size_t row = layout_row(t, k - t * batch, batch, ndir, dir);
      ra[l] = (k < k_end && m0 + c < m_dim) ? widen(a[row * m_dim + m0 + c]) : 0.0f;
      rb[l] = (k < k_end && n0 + c < n_dim) ? b[row * n_dim + n0 + c] : 0.0f;
    }
  };
  float acc[4][4] = {};
  if (k_begin < k_end) load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = tid + l * kGemmThreads;
      a_s[i / kTile][i % kTile] = ra[l];
      b_s[i / kTile][i % kTile] = rb[l];
    }
    __syncthreads();
    if (k0 + kTileK < k_end) load(k0 + kTileK);  // in flight during the products
    tile_fma(acc, a_s, b_s, tm, tn);
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(blockIdx.z) * m_dim * n_dim;
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

// out[d][i] = sum over s in order of partial[d][s][i], `size` elements per
// direction
__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int splits, int size,
                                 int ndir) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ndir * size) return;
  const int d = i / size;
  const float* p = partial + static_cast<size_t>(d) * splits * size + (i - d * size);
  float a = 0.0f;
  for (int s = 0; s < splits; ++s) a += p[static_cast<size_t>(s) * size];
  out[i] = a;
}

template <typename T, int R>
cudaError_t launch_chain(const void* w_hh_t, const void* gf, const void* dho,
                         float* dg, void* dxw, int length, int batch, int hidden,
                         int ndir, cudaStream_t stream) {
  const size_t smem = chain_smem_bytes(R, hidden);
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_chain_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_bwd_chain_kernel<T, R><<<ndir * ((batch + R - 1) / R), 2 * hidden, smem, stream>>>(
      static_cast<const T*>(w_hh_t), static_cast<const float2*>(gf),
      static_cast<const T*>(dho), dg, static_cast<T*>(dxw), length, batch, hidden,
      ndir);
  return cudaGetLastError();
}

// The four kernels on `stream`; `dg` is the f32 coefficient and dgates
// array (dxw itself in the f32 instance). Returns the first error.
template <typename T>
int lstm_bwd(const void* xw, const void* w_hh_t, const void* hs, const void* cs,
             const void* dho, void* dxw, void* dw_hh_t, void* partial, void* gf,
             float* dg, int length, int batch, int hidden, int ndir, int splits,
             void* stream) {
  if (length < 1 || batch < 1 || hidden < kRegRows || hidden % 32 != 0 ||
      2 * hidden > kMaxThreads || ndir < 1 || splits < 1 ||
      static_cast<long long>(ndir) * splits > kMaxGridZ ||
      static_cast<long long>(ndir) * ((batch + 3) / 4) > kMaxBlocks ||
      static_cast<long long>(ndir) * hidden * 4 * hidden > kMaxBlocks)
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
  const int gates = 4 * hidden;

  // 1. coefficients into dg, dc factors into gf
  const dim3 gate_grid((length * batch + kTile - 1) / kTile, hidden / kGateUnits, ndir);
  lstm_bwd_gates_kernel<T><<<gate_grid, kGemmThreads, 0, s>>>(
      static_cast<const T*>(xw), static_cast<const T*>(w_hh_t),
      static_cast<const T*>(hs), static_cast<const float*>(cs), dg,
      static_cast<float2*>(gf), length, batch, hidden, ndir);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2. the chain: dgates over the coefficients, in place (and into dxw)
  if (ndir * batch <= sms)
    err = launch_chain<T, 1>(w_hh_t, gf, dho, dg, dxw, length, batch, hidden, ndir, s);
  else if (ndir * ((batch + 1) / 2) <= sms)
    err = launch_chain<T, 2>(w_hh_t, gf, dho, dg, dxw, length, batch, hidden, ndir, s);
  else
    err = launch_chain<T, 4>(w_hh_t, gf, dho, dg, dxw, length, batch, hidden, ndir, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 3-4. dW_hh^T = hs[0 : L-1]^T dgates[1 : L] per direction, contracted over
  // (L - 1) * B rows
  const int kdim = (length - 1) * batch;
  const int chunk = (kdim + splits - 1) / splits;
  const dim3 grid((gates + kTile - 1) / kTile, (hidden + kTile - 1) / kTile,
                  ndir * splits);
  dw_partial_kernel<T><<<grid, kGemmThreads, 0, s>>>(
      static_cast<const T*>(hs), dg + static_cast<size_t>(ndir) * batch * gates,
      static_cast<float*>(partial), kdim, hidden, gates, chunk, batch, ndir, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = hidden * gates;
  dw_reduce_kernel<<<(ndir * size + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw_hh_t), splits, size,
      ndir);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xw, dxw (L, ndir * B, 4H), w_hh_t, dw_hh_t (ndir * H, 4H), hs, cs, dho
// (L, ndir * B, H), scratch arrays gf (L, ndir * B, H, 2) and partial
// (ndir, splits, H, 4H): contiguous float32 device arrays, H a multiple of
// 32 in [64, 128], ndir >= 1 (1, 2, or 2K for K population members), B the
// rows of one direction, splits >= 1 and ndir * splits <= 65535 (the grid's
// z extent). Launches its four kernels on `stream` and returns the first
// error.
extern "C" int rlt_lstm_bwd(const void* xw, const void* w_hh_t, const void* hs,
                            const void* cs, const void* dho, void* dxw,
                            void* dw_hh_t, void* partial, void* gf, int length,
                            int batch, int hidden, int ndir, int splits,
                            void* stream) {
  return lstm_bwd<float>(xw, w_hh_t, hs, cs, dho, dxw, dw_hh_t, partial, gf,
                         static_cast<float*>(dxw), length, batch, hidden, ndir, splits,
                         stream);
}

// The bf16 instance: xw, w_hh_t, hs, dho and dxw bf16, cs, dw_hh_t and the
// scratch arrays float32, and a further float32 scratch dg of dxw's shape
// (the coefficients, then dgates' mid and lo parts); w_hh_t, hs and dho
// 16-byte aligned (TMA and bulk copies), H one of 64, 96 and 128; the rest
// as rlt_lstm_bwd.
extern "C" int rlt_lstm_bwd_bf16(const void* xw, const void* w_hh_t, const void* hs,
                                 const void* cs, const void* dho, void* dxw,
                                 void* dw_hh_t, void* partial, void* gf, void* dg,
                                 int length, int batch, int hidden, int ndir,
                                 int splits, void* stream) {
  using rlt::lstm_bf16::bwd_passes;
  if (length < 1 || batch < 1 || ndir < 1 || splits < 1 ||
      (hidden != 64 && hidden != 96 && hidden != 128) ||
      static_cast<long long>(ndir) * splits > kMaxGridZ ||
      static_cast<long long>(ndir) * ((batch + 1) / 2) > kMaxBlocks ||
      static_cast<long long>(length) * ndir > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const ptrs[] = {xw, w_hh_t, hs, cs, dho, dxw, partial, gf, dg};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(xw);
  const bf16* w = static_cast<const bf16*>(w_hh_t);
  const bf16* h = static_cast<const bf16*>(hs);
  const float* c = static_cast<const float*>(cs);
  const bf16* d = static_cast<const bf16*>(dho);
  bf16* dx = static_cast<bf16*>(dxw);
  float* part = static_cast<float*>(partial);
  float2* f = static_cast<float2*>(gf);
  float* g = static_cast<float*>(dg);
  int code;
  switch (hidden) {
    case 64:
      code = bwd_passes<64>(x, w, h, c, d, dx, part, f, g, length, batch, ndir, splits, sms, s);
      break;
    case 96:
      code = bwd_passes<96>(x, w, h, c, d, dx, part, f, g, length, batch, ndir, splits, sms, s);
      break;
    default:
      code = bwd_passes<128>(x, w, h, c, d, dx, part, f, g, length, batch, ndir, splits, sms,
                             s);
  }
  if (code != 0) return code;
  const int size = hidden * 4 * hidden;
  dw_reduce_kernel<<<(ndir * size + 255) / 256, 256, 0, s>>>(
      part, static_cast<float*>(dw_hh_t), splits, size, ndir);
  return static_cast<int>(cudaGetLastError());
}
