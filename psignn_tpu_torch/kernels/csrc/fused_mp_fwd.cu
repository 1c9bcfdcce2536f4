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
// What bounds it on an H100.  At the radius-5 headline mesh (11,214 rows,
// 65,139 edges, D = Dh = 10, edge_dim 3) one call must move about 2 MB and
// do about 13.5 MFLOP: 0.6 us at 3.35 TB/s, and far below the f32 rate.
// So a call is bound by launch latency, by the gathers along each row and
// by the instructions that bring each gathered row to the lanes that need
// it, not by bytes or operations.
//
// Design: a group of G lanes per CSR row, lane k owning hidden unit k
// (G = 16 when every width is <= 16, else 32), with row k of W1 and row k
// of W2 in its registers.  A fixed grid walks the rows with a fixed stride,
// so the weights are loaded once per thread.  Per row, the group stages
// h[n] in shared memory and lane k forms base_k = b1[k] + W1a[k]·h[n].  The
// row's edges are taken G at a time: lane t gathers h[oth_e] and ea_e of
// the chunk's edge t into its slot of shared memory (all loads of a chunk
// in flight together), then every lane reads each slot as broadcast float4
// loads, continues pre_k with W1b[k]·h[j] and W1c[k]·ea_e in that order,
// and sums relu(pre_k).  Finally acc is staged in shared memory and lane
// o < D_out writes out[n,o] = deg·b2[o] + Σ_k W2[o,k]·acc_k as one coalesced
// row.  Each row is written once, by its group: no atomics, so two launches
// are bit-identical.  The model's widths (D = Dh = D_out = 10, edge_dim 3
// or 1) are compiled as constants; other widths up to 32 (edge_dim up to
// 8) take a variant with run-time bounds.
//
// The TPU kernel's one-hot MXU matmuls over RCM windows are not carried
// over: they existed because Mosaic has no fast in-kernel gather, and
// Hopper gathers directly.  W2 is linear, so the row sum is taken over the
// hidden activations before W2, and the per-edge b2 becomes deg(n)·b2; the
// plain version (fused_mp.py:mp_from_csr) applies W2 per edge and sums
// after.  The two differ by f32 rounding only (chip_smoke.py
// KERNEL_REL_TOL: 1e-5 · max(1, max|out|)).
//
// Times on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (chip_smoke.py, device time per call at the headline mesh, `to`): the
// earlier design with one thread per row took 0.0201 ms; this one's time
// is in PERF.md's kernel table.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxEdgeDim = 8;
constexpr int kMaxBlocks = 132 * 8;   // 8 blocks a multiprocessor of an H100

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// The lanes of this thread's group in its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) return 0xffffffffu;
  else return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// x[0, W) from a 16-byte aligned slot of shared memory
template <int W>
__device__ __forceinline__ void read_slot(const float* s, float (&x)[W]) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 v = s4[q];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

// FD > 0: d = dh = d_out = FD; FE > 0: edge_dim = FE (compile-time widths).
template <int G, int FD, int FE>
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
  constexpr int ND = FD ? FD : G;           // bound of d, dh, d_out
  constexpr int NE = FE ? FE : kMaxEdgeDim; // bound of edge_dim
  constexpr int SW = round4(ND + NE);       // an edge's slot: h[j] | ea_e
  constexpr int RW = round4(ND);            // the row's slot: h[n], then acc
  constexpr int kGroups = kThreads / G;
  constexpr int kGroupFloats = G * SW + RW;
  if (FD) d = dh = d_out = FD;
  if (FE) edge_dim = FE;
  const int k_in = 2 * d + edge_dim;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_w1 = smem + kGroups * kGroupFloats;   // (dh, k_in)
  for (int i = threadIdx.x; i < dh * k_in; i += blockDim.x) s_w1[i] = w1[i];
  __syncthreads();

  const int lane = threadIdx.x % G;     // hidden unit k, input i, output o
  float* slots = smem + (threadIdx.x / G) * kGroupFloats;
  float* row_slot = slots + G * SW;
  const unsigned mask = group_mask<G>();

  // lane k's row of W1 and lane o's row of W2 (zero past the widths)
  const bool kv = lane < dh, ov = lane < d_out;
  float wa[ND], wb[ND], wc[NE], w2o[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    wa[i] = (kv && i < d) ? s_w1[lane * k_in + i] : 0.f;
    wb[i] = (kv && i < d) ? s_w1[lane * k_in + d + i] : 0.f;
    w2o[i] = (ov && i < dh) ? w2[lane * dh + i] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < NE; ++c)
    wc[c] = (kv && c < edge_dim) ? s_w1[lane * k_in + 2 * d + c] : 0.f;
  const float bk = kv ? b1[lane] : 0.f;
  const float b2o = ov ? b2[lane] : 0.f;

  for (int n = blockIdx.x * kGroups + threadIdx.x / G; n < n_rows;
       n += gridDim.x * kGroups) {     // the whole group takes the same rows
    if (lane < d) row_slot[lane] = h[(size_t)n * d + lane];
    const int e0 = row_ptr[n];
    const int e1 = row_ptr[n + 1];
    __syncwarp(mask);
    // base_k = b1[k] + W1a[k]·h[n]: the part of pre shared by the row's edges
    float base = bk;
    {
      float x[RW];
      read_slot<RW>(row_slot, x);
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (i < d) base = fmaf(wa[i], x[i], base);
    }

    float acc = 0.f;
    for (int c0 = e0; c0 < e1; c0 += G) {
      const int cnt = min(G, e1 - c0);
      if (lane < cnt) {                 // lane t gathers the chunk's edge t
        const size_t j = (size_t)oth[c0 + lane];
        const size_t ej = (size_t)(c0 + lane) * edge_dim;
        float* sl = slots + lane * SW;
#pragma unroll
        for (int i = 0; i < ND; ++i)
          if (i < d) sl[i] = h[j * d + i];
#pragma unroll
        for (int c = 0; c < NE; ++c)
          if (c < edge_dim) sl[ND + c] = ea[ej + c];
      }
      __syncwarp(mask);
#pragma unroll 2
      for (int t = 0; t < cnt; ++t) {
        float x[SW];
        read_slot<SW>(slots + t * SW, x);
        float p = base;
#pragma unroll
        for (int i = 0; i < ND; ++i)
          if (i < d) p = fmaf(wb[i], x[i], p);
#pragma unroll
        for (int c = 0; c < NE; ++c)
          if (c < edge_dim) p = fmaf(wc[c], x[ND + c], p);
        acc += fmaxf(p, 0.f);
      }
      __syncwarp(mask);
    }

    // lane o: out[n, o] = deg·b2[o] + Σ_k W2[o, k]·acc_k
    __syncwarp(mask);
    if (kv) row_slot[lane] = acc;
    __syncwarp(mask);
    float s = (float)(e1 - e0) * b2o;
    {
      float x[RW];
      read_slot<RW>(row_slot, x);
#pragma unroll
      for (int k = 0; k < ND; ++k)
        if (k < dh) s = fmaf(w2o[k], x[k], s);
    }
    if (ov) out[(size_t)n * d_out + lane] = s;
    __syncwarp(mask);
  }
}

template <int G, int FD, int FE>
void launch(const float* h, const int* row_ptr, const int* oth,
            const float* ea, const float* w1, const float* b1,
            const float* w2, const float* b2, float* out, int n_rows, int d,
            int dh, int d_out, int edge_dim, cudaStream_t s) {
  constexpr int ND = FD ? FD : G, NE = FE ? FE : kMaxEdgeDim;
  constexpr int kGroups = kThreads / G;
  const size_t smem =
      sizeof(float) * (kGroups * (G * round4(ND + NE) + round4(ND)) +
                       dh * (2 * d + edge_dim));
  int grid = (n_rows + kGroups - 1) / kGroups;
  grid = grid < kMaxBlocks ? grid : kMaxBlocks;
  fused_mp_fwd_kernel<G, FD, FE><<<grid, kThreads, smem, s>>>(
      h, row_ptr, oth, ea, w1, b1, w2, b2, out, n_rows, d, dh, d_out,
      edge_dim);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool model = d == 10 && dh == 10 && d_out == 10;
  const int wmax = d > dh ? (d > d_out ? d : d_out) : (dh > d_out ? dh : d_out);
  if (model && edge_dim == 3)
    launch<16, 10, 3>(h, row_ptr, oth, ea, w1, b1, w2, b2, out, n_rows, d,
                      dh, d_out, edge_dim, s);
  else if (model && edge_dim == 1)
    launch<16, 10, 1>(h, row_ptr, oth, ea, w1, b1, w2, b2, out, n_rows, d,
                      dh, d_out, edge_dim, s);
  else if (wmax <= 16)
    launch<16, 0, 0>(h, row_ptr, oth, ea, w1, b1, w2, b2, out, n_rows, d, dh,
                     d_out, edge_dim, s);
  else
    launch<32, 0, 0>(h, row_ptr, oth, ea, w1, b1, w2, b2, out, n_rows, d, dh,
                     d_out, edge_dim, s);
  return (int)cudaGetLastError();
}
