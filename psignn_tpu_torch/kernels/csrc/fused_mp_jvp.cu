// Fused directional message passing, tangent (forward-mode JVP), for
// Hopper (sm_90a).
//
// It has no TPU counterpart: JAX linearizes the XLA message passing
// (psignn_tpu/ops.py:48-67) and has no JVP of its Pallas kernel.  The port
// needs one because Newton-Krylov's inner GMRES multiplies by the Jacobian
// of f_θ, and every message passing on the card goes through a
// hand-written kernel.  For every aggregation node n, with the edges of n
// in CSR order and the direction v (N, D),
//
//   z_e   = W1a·h[n] + W1b·h[oth_e] + W1c·ea_e + b1
//   t[n]  = sum_{e in row n} W2 · (1[z_e > 0] ⊙ (W1a·v[n] + W1b·v[oth_e]))
//
// which is the derivative of fused_mp_fwd.cu's out[n] along v: the edge
// features, b1 and b2 carry no tangent.
//
// Design: fused_mp_fwd.cu's row loop over the same CSR.  A group of G
// lanes per row, lane k owning hidden unit k with row k of W1 and row k of
// W2 in its registers; a fixed grid walks the rows with a fixed stride.
// Per row the group stages h[n] and v[n] together in shared memory; lane k
// forms base_k = b1[k] + W1a[k]·h[n] and dbase_k = W1a[k]·v[n].  The row's
// edges are taken G at a time: lane t gathers h[oth_e], v[oth_e] and ea_e
// of the chunk's edge t into its slot, then every lane reads each slot as
// broadcast float4 loads, recomputes z_k for ReLU's mask and adds
// dbase_k + W1b[k]·v[j] to its sum where z_k > 0.  Finally the sums are
// staged in shared memory and lane o < D_out writes t[n,o] = Σ_k W2[o,k]·s_k
// as one coalesced row.  Each row is written once, by its group: no
// atomics, so two launches are bit-identical.  The model's widths (D = Dh
// = D_out = 10, edge_dim 3 or 1) are compiled as constants; other widths
// up to 32 (edge_dim up to 8) take a variant with run-time bounds.
//
// z_e is summed in the forward kernel's order (base, then W1b·h[j], then
// W1c·ea_e), so the mask is the one the forward kernel's ReLU applied.
// The plain version (fused_mp.py:mp_jvp_from_csr) applies W2 per edge and
// sums after; the two differ by f32 rounding only (chip_smoke.py
// KERNEL_REL_TOL: 1e-5 · max(1, max|out|)).  Its time on the card is in
// PERF.md's kernel table.

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
fused_mp_jvp_kernel(const float* __restrict__ h,
                    const float* __restrict__ v,    // (n_rows, d) direction
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ oth,
                    const float* __restrict__ ea,
                    const float* __restrict__ w1,   // (dh, 2d + edge_dim)
                    const float* __restrict__ b1,   // (dh,)
                    const float* __restrict__ w2,   // (d_out, dh)
                    float* __restrict__ out,        // (n_rows, d_out)
                    int n_rows, int d, int dh, int d_out, int edge_dim) {
  constexpr int ND = FD ? FD : G;           // bound of d, dh, d_out
  constexpr int NE = FE ? FE : kMaxEdgeDim; // bound of edge_dim
  constexpr int SW = round4(2 * ND + NE);   // an edge's slot: h[j] | v[j] | ea_e
  constexpr int RW = round4(2 * ND);        // the row's slot: h[n] | v[n], then s
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

  for (int n = blockIdx.x * kGroups + threadIdx.x / G; n < n_rows;
       n += gridDim.x * kGroups) {     // the whole group takes the same rows
    if (lane < d) {
      row_slot[lane] = h[(size_t)n * d + lane];
      row_slot[ND + lane] = v[(size_t)n * d + lane];
    }
    const int e0 = row_ptr[n];
    const int e1 = row_ptr[n + 1];
    __syncwarp(mask);
    // the parts of z_k and of its tangent shared by the row's edges
    float base = bk, dbase = 0.f;
    {
      float x[RW];
      read_slot<RW>(row_slot, x);
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (i < d) {
          base = fmaf(wa[i], x[i], base);
          dbase = fmaf(wa[i], x[ND + i], dbase);
        }
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
          if (i < d) {
            sl[i] = h[j * d + i];
            sl[ND + i] = v[j * d + i];
          }
#pragma unroll
        for (int c = 0; c < NE; ++c)
          if (c < edge_dim) sl[2 * ND + c] = ea[ej + c];
      }
      __syncwarp(mask);
#pragma unroll 2
      for (int t = 0; t < cnt; ++t) {
        float x[SW];
        read_slot<SW>(slots + t * SW, x);
        float p = base, dp = dbase;
#pragma unroll
        for (int i = 0; i < ND; ++i)
          if (i < d) {
            p = fmaf(wb[i], x[i], p);
            dp = fmaf(wb[i], x[ND + i], dp);
          }
#pragma unroll
        for (int c = 0; c < NE; ++c)
          if (c < edge_dim) p = fmaf(wc[c], x[2 * ND + c], p);
        acc += p > 0.f ? dp : 0.f;
      }
      __syncwarp(mask);
    }

    // lane o: t[n, o] = Σ_k W2[o, k]·s_k
    __syncwarp(mask);
    if (kv) row_slot[lane] = acc;
    __syncwarp(mask);
    float s = 0.f;
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
void launch(const float* h, const float* v, const int* row_ptr,
            const int* oth, const float* ea, const float* w1,
            const float* b1, const float* w2, float* out, int n_rows, int d,
            int dh, int d_out, int edge_dim, cudaStream_t s) {
  constexpr int ND = FD ? FD : G, NE = FE ? FE : kMaxEdgeDim;
  constexpr int kGroups = kThreads / G;
  const size_t smem =
      sizeof(float) * (kGroups * (G * round4(2 * ND + NE) + round4(2 * ND)) +
                       dh * (2 * d + edge_dim));
  int grid = (n_rows + kGroups - 1) / kGroups;
  grid = grid < kMaxBlocks ? grid : kMaxBlocks;
  fused_mp_jvp_kernel<G, FD, FE><<<grid, kThreads, smem, s>>>(
      h, v, row_ptr, oth, ea, w1, b1, w2, out, n_rows, d, dh, d_out,
      edge_dim);
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() of the
// launch (0 on success).  The caller has checked shapes and types.
extern "C" int psignn_fused_mp_jvp(const float* h, const float* v,
                                   const int* row_ptr, const int* oth,
                                   const float* ea, const float* w1,
                                   const float* b1, const float* w2,
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
    launch<16, 10, 3>(h, v, row_ptr, oth, ea, w1, b1, w2, out, n_rows, d, dh,
                      d_out, edge_dim, s);
  else if (model && edge_dim == 1)
    launch<16, 10, 1>(h, v, row_ptr, oth, ea, w1, b1, w2, out, n_rows, d, dh,
                      d_out, edge_dim, s);
  else if (wmax <= 16)
    launch<16, 0, 0>(h, v, row_ptr, oth, ea, w1, b1, w2, out, n_rows, d, dh,
                     d_out, edge_dim, s);
  else
    launch<32, 0, 0>(h, v, row_ptr, oth, ea, w1, b1, w2, out, n_rows, d, dh,
                     d_out, edge_dim, s);
  return (int)cudaGetLastError();
}
