// Fused directional message passing, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel psignn_tpu/kernels/fused_mp.py:_fused_mp_kernel
// (pallas_call at fused_mp.py:418; contract mp_from_blocks, :218-234).
// For every aggregation node n, with the edges of n in CSR order,
//
//   out[n] = sum_{e in row n} W2 · relu(W1a·h[n] + W1b·h[oth_e] + W1c·ea_e + b1) + b2
//
// which is the 2-layer edge MLP of [x_i, x_j, edge_attr] scatter-added at
// the aggregation node ("to": receivers, "from": senders).  Self-loops and
// masked edges were dropped when the CSR was packed.
//
// Design.  One thread owns one CSR row: it computes W1a·h[n] + b1 once,
// then walks its edges, gathers h[oth_e] and ea_e, forms the hidden
// pre-activation with f32 FMAs and accumulates relu(pre) in registers.
// The TPU kernel's one-hot MXU matmuls over RCM windows are not carried
// over: they existed because Mosaic has no fast in-kernel gather, and
// Hopper gathers directly.  Unlike the TPU version, W1a·h and W1b·h are
// formed here per row and per edge instead of as two dense matmuls outside,
// so one launch does the whole call.  The weights (a few hundred floats)
// sit in shared memory, read as warp-wide broadcasts.  Each row is written
// once, by its owner: no atomics, so two launches are bit-identical.
//
// Summation order.  W2 is linear, so the row sum is taken over the hidden
// activations before W2, and the per-edge b2 becomes deg(n)·b2.  The plain
// version (fused_mp.py:mp_from_csr) applies W2 per edge and sums after.
// The two differ by f32 rounding only: the kernel is held to the plain
// version within 1e-5 · max(1, max|out|) (chip_smoke.py KERNEL_REL_TOL).
//
// What bounds it on an H100.  At the radius-5 headline mesh (11,214 rows,
// 65,139 edges, D = Dh = 10, edge_dim 3) one call must move about 2 MB and
// do about 13.5 MFLOP: 0.6 us at 3.35 TB/s, and far below the f32 rate.
// So a call is bound by launch latency and by the serial edge walk of the
// longest row, not by bytes or operations; with one thread per row only
// 176 blocks of 64 threads are in flight on 132 SMs.
//
// D, Dh, D_out <= 32 and edge_dim <= 8 are run-time parameters, so the DSS
// (edge_dim 1) and DS-GPS models can reuse the kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxEdgeDim = 8;

template <int MAXW>
__global__ void __launch_bounds__(kThreads)
fused_mp_fwd_kernel(const float* __restrict__ h,
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ oth,
                    const float* __restrict__ ea,
                    const float* __restrict__ w1,   // (dh, 2d + edge_dim)
                    const float* __restrict__ b1,   // (dh,)
                    const float* __restrict__ w2,   // (d_out, dh)
                    const float* __restrict__ b2,   // (d_out,)
                    float* __restrict__ out,        // (n_rows, d_out)
                    int n_rows, int d, int dh, int d_out, int edge_dim) {
  extern __shared__ float smem[];
  const int k_in = 2 * d + edge_dim;
  float* s_w1 = smem;
  float* s_b1 = s_w1 + dh * k_in;
  float* s_w2 = s_b1 + dh;
  float* s_b2 = s_w2 + d_out * dh;
  for (int i = threadIdx.x; i < dh * k_in; i += blockDim.x) s_w1[i] = w1[i];
  for (int i = threadIdx.x; i < dh; i += blockDim.x) s_b1[i] = b1[i];
  for (int i = threadIdx.x; i < d_out * dh; i += blockDim.x) s_w2[i] = w2[i];
  for (int i = threadIdx.x; i < d_out; i += blockDim.x) s_b2[i] = b2[i];
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_rows) return;

  // base[k] = b1[k] + W1a[k]·h[n]: the part of the pre-activation shared by
  // every edge of the row
  float hn[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) hn[i] = (i < d) ? h[(size_t)n * d + i] : 0.f;
  float base[MAXW];
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    float s = 0.f;
    if (k < dh) {
      s = s_b1[k];
#pragma unroll
      for (int i = 0; i < MAXW; ++i)
        if (i < d) s = fmaf(s_w1[k * k_in + i], hn[i], s);
    }
    base[k] = s;
  }

  float acc[MAXW];
#pragma unroll
  for (int k = 0; k < MAXW; ++k) acc[k] = 0.f;

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
        acc[k] += fmaxf(p, 0.f);
      }
    }
  }

  const float deg = (float)(e1 - e0);
  for (int o = 0; o < d_out; ++o) {
    float s = deg * s_b2[o];
#pragma unroll
    for (int k = 0; k < MAXW; ++k)
      if (k < dh) s = fmaf(s_w2[o * dh + k], acc[k], s);
    out[(size_t)n * d_out + o] = s;
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() of the
// launch (0 on success).  The caller has checked shapes and types.
extern "C" int psignn_fused_mp_fwd(const float* h, const int* row_ptr,
                                   const int* oth, const float* ea,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2,
                                   float* out, int n_rows, int d, int dh,
                                   int d_out, int edge_dim, void* stream) {
  if (n_rows <= 0) return 0;
  if (d < 1 || d > 32 || dh < 1 || dh > 32 || d_out < 1 || d_out > 32 ||
      edge_dim < 0 || edge_dim > kMaxEdgeDim)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (dh * (2 * d + edge_dim) + dh + d_out * dh + d_out);
  const dim3 grid((n_rows + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((d > dh ? d : dh) <= 16) {
    fused_mp_fwd_kernel<16><<<grid, kThreads, smem, s>>>(
        h, row_ptr, oth, ea, w1, b1, w2, b2, out, n_rows, d, dh, d_out,
        edge_dim);
  } else {
    fused_mp_fwd_kernel<32><<<grid, kThreads, smem, s>>>(
        h, row_ptr, oth, ea, w1, b1, w2, b2, out, n_rows, d, dh, d_out,
        edge_dim);
  }
  return (int)cudaGetLastError();
}
