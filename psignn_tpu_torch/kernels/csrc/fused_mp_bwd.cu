// Fused directional message passing, backward (VJP), for Hopper (sm_90a).
//
// Replaces the TPU kernel psignn_tpu/kernels/fused_mp.py:_fused_mp_bwd_kernel
// (pallas_call at fused_mp.py:574).  The forward (fused_mp_fwd.cu) computes,
// per aggregation row n of one direction's CSR,
//
//   out[n] = sum_{e in row n} W2 · relu(pre_e) + b2,
//   pre_e  = W1a·h[n] + W1b·h[oth_e] + W1c·ea_e + b1.
//
// Given the output cotangent g (n_rows, d_out), this file computes
//
//   dha[n]  = sum_{e in row n} dpre_e            dpre_e = (W2ᵀ·g[n]) ⊙ (pre_e > 0)
//   dhb[j]  = sum_{e : oth_e = j} dpre_e
//   dW2     = sum_n g[n] ⊗ A_r[n]                 A_r[n] = sum_{e in row n} relu(pre_e)
//   db2     = sum_n deg(n) · g[n]
//   db1     = sum_n dha[n]
//   dW1c    = sum_e dpre_e ⊗ ea_e
//
// and the wrapper (fused_mp.py:_fused_mp_bwd_cuda) forms the dense rest as
// the JAX package does outside its kernel (fused_mp.py:598-606):
// dh = dha·W1a + dhb·W1b, dW1a = hᵀ·dha, dW1b = hᵀ·dhb.
//
// Design.  Three launches on one stream, no float atomics, so two calls are
// bit-identical:
//   1. rows:  one thread owns one row of the aggregation CSR.  Since every
//      edge of row n carries the same cotangent g[n], W2ᵀ·g[n] is formed once
//      per row (and stored, for pass 2).  The thread recomputes each edge's
//      pre-activation with f32 FMAs in the forward kernel's order, writes
//      dpre_e, and sums dha[n] and A_r[n] in registers.
//   2. cols:  dhb needs a sum per *source* node, which the aggregation CSR
//      scatters.  Instead of atomics, one thread owns one row of the
//      reversed CSR (the opposite direction's packing: row j lists exactly
//      the edges whose other endpoint is j, with the same edge_attr).  It
//      recomputes pre_e with the same FMA sequence as pass 1, so the ReLU
//      mask agrees bit for bit, and sums (W2ᵀ·g[n])[k] where pre_e > 0.
//   3. reduce: one block per parameter-gradient entry sums its per-row (or
//      per-edge) terms: each thread a fixed strided slice, then a fixed
//      shared-memory tree.  The order never changes between launches.
// The TPU kernel's one-hot MXU matmuls over RCM windows, the VMEM
// accumulators carried across its sequential grid and the segment-sum of
// overlapping dhb windows are not carried over: Hopper gathers directly,
// its blocks run in no order, and a second pass over the reversed CSR
// replaces the overlapping windows.
//
// What bounds it on an H100.  At the radius-5 headline mesh (11,214 rows,
// 65,139 edges, D = Dh = D_out = 10, edge_dim 3) one VJP must move about
// 2.4 MB (h, g, one CSR, weights in; dh and the parameter gradients out)
// and do about 30 MFLOP: 0.7 us at 3.35 TB/s and less at 67 TFLOP/s f32.
// So, as for the forward kernel, the call is bound by launch latency and
// the serial edge walk of each thread, not by bytes or operations.  This
// simple version also writes and re-reads dpre (E·Dh floats) and four
// (n_rows, Dh) scratch arrays, about 6 MB more; fusing them away is later
// work.
//
// D, Dh, D_out <= 32 and edge_dim <= 8 are run-time parameters, as in the
// forward kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxEdgeDim = 8;
constexpr int kReduceThreads = 256;

// w1 (dh, 2d + edge_dim), b1 (dh,), w2 (d_out, dh) into shared memory
__device__ __forceinline__ void load_weights(float* smem, const float* w1,
                                             const float* b1, const float* w2,
                                             int k_in, int dh, int d_out) {
  for (int i = threadIdx.x; i < dh * k_in; i += blockDim.x) smem[i] = w1[i];
  for (int i = threadIdx.x; i < dh; i += blockDim.x) smem[dh * k_in + i] = b1[i];
  for (int i = threadIdx.x; i < d_out * dh; i += blockDim.x)
    smem[dh * k_in + dh + i] = w2[i];
  __syncthreads();
}

// Pass 1: rows of the aggregation CSR.
template <int MAXW>
__global__ void __launch_bounds__(kThreads)
fused_mp_bwd_rows_kernel(const float* __restrict__ h,
                         const float* __restrict__ g,       // (n_rows, d_out)
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ oth,
                         const float* __restrict__ ea,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         float* __restrict__ gw,            // (n_rows, dh)
                         float* __restrict__ dpre,          // (E, dh)
                         float* __restrict__ dha,           // (n_rows, dh)
                         float* __restrict__ ar,            // (n_rows, dh)
                         int n_rows, int d, int dh, int d_out, int edge_dim) {
  extern __shared__ float smem[];
  const int k_in = 2 * d + edge_dim;
  load_weights(smem, w1, b1, w2, k_in, dh, d_out);
  const float* s_w1 = smem;
  const float* s_b1 = s_w1 + dh * k_in;
  const float* s_w2 = s_b1 + dh;

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_rows) return;

  // base[k] = b1[k] + W1a[k]·h[n], in the forward kernel's FMA order
  float hn[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) hn[i] = (i < d) ? h[(size_t)n * d + i] : 0.f;
  float base[MAXW];
  float gwk[MAXW];   // (W2ᵀ·g[n])[k]: the same for every edge of the row
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    float s = 0.f, t = 0.f;
    if (k < dh) {
      s = s_b1[k];
#pragma unroll
      for (int i = 0; i < MAXW; ++i)
        if (i < d) s = fmaf(s_w1[k * k_in + i], hn[i], s);
      for (int o = 0; o < d_out; ++o)
        t = fmaf(s_w2[o * dh + k], g[(size_t)n * d_out + o], t);
      gw[(size_t)n * dh + k] = t;
    }
    base[k] = s;
    gwk[k] = t;
  }

  float acc_d[MAXW], acc_r[MAXW];
#pragma unroll
  for (int k = 0; k < MAXW; ++k) acc_d[k] = acc_r[k] = 0.f;

  const int e0 = row_ptr[n];
  const int e1 = row_ptr[n + 1];
  for (int e = e0; e < e1; ++e) {
    const size_t j = (size_t)oth[e];
    float hj[MAXW];
#pragma unroll
    for (int i = 0; i < MAXW; ++i) hj[i] = (i < d) ? h[j * d + i] : 0.f;
    float ev[kMaxEdgeDim];
#pragma unroll
    for (int c = 0; c < kMaxEdgeDim; ++c)
      ev[c] = (c < edge_dim) ? ea[(size_t)e * edge_dim + c] : 0.f;
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
      if (k < dh) {
        float p = base[k];
        const float* wk = s_w1 + k * k_in;
#pragma unroll
        for (int i = 0; i < MAXW; ++i)
          if (i < d) p = fmaf(wk[d + i], hj[i], p);
#pragma unroll
        for (int c = 0; c < kMaxEdgeDim; ++c)
          if (c < edge_dim) p = fmaf(wk[2 * d + c], ev[c], p);
        const float dp = (p > 0.f) ? gwk[k] : 0.f;
        dpre[(size_t)e * dh + k] = dp;
        acc_d[k] += dp;
        acc_r[k] += fmaxf(p, 0.f);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    if (k < dh) {
      dha[(size_t)n * dh + k] = acc_d[k];
      ar[(size_t)n * dh + k] = acc_r[k];
    }
  }
}

// Pass 2: rows of the reversed CSR (row j = the edges whose source is j).
template <int MAXW>
__global__ void __launch_bounds__(kThreads)
fused_mp_bwd_cols_kernel(const float* __restrict__ h,
                         const float* __restrict__ gw,      // (n_rows, dh)
                         const int* __restrict__ rrow_ptr,
                         const int* __restrict__ roth,      // aggregation node
                         const float* __restrict__ rea,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         float* __restrict__ dhb,           // (n_rows, dh)
                         int n_rows, int d, int dh, int d_out, int edge_dim) {
  extern __shared__ float smem[];
  const int k_in = 2 * d + edge_dim;
  load_weights(smem, w1, b1, w2, k_in, dh, d_out);
  const float* s_w1 = smem;
  const float* s_b1 = s_w1 + dh * k_in;

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_rows) return;

  float hj[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) hj[i] = (i < d) ? h[(size_t)j * d + i] : 0.f;
  float acc[MAXW];
#pragma unroll
  for (int k = 0; k < MAXW; ++k) acc[k] = 0.f;

  const int e0 = rrow_ptr[j];
  const int e1 = rrow_ptr[j + 1];
  for (int e = e0; e < e1; ++e) {
    const size_t n = (size_t)roth[e];
    float hn[MAXW];
#pragma unroll
    for (int i = 0; i < MAXW; ++i) hn[i] = (i < d) ? h[n * d + i] : 0.f;
    float ev[kMaxEdgeDim];
#pragma unroll
    for (int c = 0; c < kMaxEdgeDim; ++c)
      ev[c] = (c < edge_dim) ? rea[(size_t)e * edge_dim + c] : 0.f;
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
      if (k < dh) {
        // the FMA sequence of pass 1 (b1, W1a·h[n], W1b·h[j], W1c·ea):
        // the same pre_e to the bit, so both passes share one ReLU mask
        const float* wk = s_w1 + k * k_in;
        float p = s_b1[k];
#pragma unroll
        for (int i = 0; i < MAXW; ++i)
          if (i < d) p = fmaf(wk[i], hn[i], p);
#pragma unroll
        for (int i = 0; i < MAXW; ++i)
          if (i < d) p = fmaf(wk[d + i], hj[i], p);
#pragma unroll
        for (int c = 0; c < kMaxEdgeDim; ++c)
          if (c < edge_dim) p = fmaf(wk[2 * d + c], ev[c], p);
        if (p > 0.f) acc[k] += gw[n * dh + k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MAXW; ++k)
    if (k < dh) dhb[(size_t)j * dh + k] = acc[k];
}

// Pass 3: one block per parameter-gradient entry, in the layout
// [dW2 (d_out, dh) | db2 (d_out) | db1 (dh) | dW1c (dh, edge_dim)].
__global__ void __launch_bounds__(kReduceThreads)
fused_mp_bwd_reduce_kernel(const float* __restrict__ g,
                           const int* __restrict__ row_ptr,
                           const float* __restrict__ ea,
                           const float* __restrict__ dpre,
                           const float* __restrict__ dha,
                           const float* __restrict__ ar,
                           float* __restrict__ params,
                           int n_rows, int n_edges, int dh, int d_out,
                           int edge_dim) {
  __shared__ float red[kReduceThreads];
  const int t = threadIdx.x;
  int p = blockIdx.x;
  float s = 0.f;
  if (p < d_out * dh) {
    const int o = p / dh, k = p % dh;
    for (int n = t; n < n_rows; n += kReduceThreads)
      s = fmaf(g[(size_t)n * d_out + o], ar[(size_t)n * dh + k], s);
  } else if ((p -= d_out * dh) < d_out) {
    for (int n = t; n < n_rows; n += kReduceThreads)
      s = fmaf((float)(row_ptr[n + 1] - row_ptr[n]), g[(size_t)n * d_out + p],
               s);
  } else if ((p -= d_out) < dh) {
    for (int n = t; n < n_rows; n += kReduceThreads)
      s += dha[(size_t)n * dh + p];
  } else {
    p -= dh;
    const int k = p / edge_dim, c = p % edge_dim;
    for (int e = t; e < n_edges; e += kReduceThreads)
      s = fmaf(dpre[(size_t)e * dh + k], ea[(size_t)e * edge_dim + c], s);
  }
  red[t] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (t < w) red[t] += red[t + w];
    __syncthreads();
  }
  if (t == 0) params[blockIdx.x] = red[0];
}

template <int MAXW>
int launch_passes(const float* h, const float* g, const int* row_ptr,
                  const int* oth, const float* ea, const int* rrow_ptr,
                  const int* roth, const float* rea, const float* w1,
                  const float* b1, const float* w2, float* gw, float* dpre,
                  float* dha, float* dhb, float* ar, int n_rows, int d, int dh,
                  int d_out, int edge_dim, size_t smem, cudaStream_t s) {
  const dim3 grid((n_rows + kThreads - 1) / kThreads);
  fused_mp_bwd_rows_kernel<MAXW><<<grid, kThreads, smem, s>>>(
      h, g, row_ptr, oth, ea, w1, b1, w2, gw, dpre, dha, ar, n_rows, d, dh,
      d_out, edge_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_mp_bwd_cols_kernel<MAXW><<<grid, kThreads, smem, s>>>(
      h, gw, rrow_ptr, roth, rea, w1, b1, w2, dhb, n_rows, d, dh, d_out,
      edge_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes.  Launches the three passes on
// `stream`, does not synchronise, allocates nothing (the caller passes the
// scratch gw, dpre, dha, ar and the outputs dha, dhb, params), and returns
// the first cudaGetLastError() that is not 0 (0 on success).  The caller
// has checked shapes and types.
extern "C" int psignn_fused_mp_bwd(
    const float* h, const float* g, const int* row_ptr, const int* oth,
    const float* ea, const int* rrow_ptr, const int* roth, const float* rea,
    const float* w1, const float* b1, const float* w2, float* gw, float* dpre,
    float* dha, float* dhb, float* ar, float* params, int n_rows, int n_edges,
    int d, int dh, int d_out, int edge_dim, void* stream) {
  if (d < 1 || d > 32 || dh < 1 || dh > 32 || d_out < 1 || d_out > 32 ||
      edge_dim < 0 || edge_dim > kMaxEdgeDim || n_rows < 0 || n_edges < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows > 0) {
    const size_t smem =
        sizeof(float) * (dh * (2 * d + edge_dim) + dh + d_out * dh);
    const int rc =
        ((d > dh ? d : dh) <= 16)
            ? launch_passes<16>(h, g, row_ptr, oth, ea, rrow_ptr, roth, rea,
                                w1, b1, w2, gw, dpre, dha, dhb, ar, n_rows, d,
                                dh, d_out, edge_dim, smem, s)
            : launch_passes<32>(h, g, row_ptr, oth, ea, rrow_ptr, roth, rea,
                                w1, b1, w2, gw, dpre, dha, dhb, ar, n_rows, d,
                                dh, d_out, edge_dim, smem, s);
    if (rc != 0) return rc;
  }
  const int n_params = d_out * dh + d_out + dh + dh * edge_dim;
  fused_mp_bwd_reduce_kernel<<<n_params, kReduceThreads, 0, s>>>(
      g, row_ptr, ea, dpre, dha, ar, params, n_rows, n_edges, dh, d_out,
      edge_dim);
  return (int)cudaGetLastError();
}
