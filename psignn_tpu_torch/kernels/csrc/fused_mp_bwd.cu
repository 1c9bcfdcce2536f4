// Fused directional message passing, backward (VJP), for Hopper (sm_90a).
//
// Replaces the TPU kernel psignn_tpu/kernels/fused_mp.py:_fused_mp_bwd_kernel
// (pallas_call at fused_mp.py:574) and the dense products that the JAX
// package forms outside it (fused_mp.py:598-606).  The forward
// (fused_mp_fwd.cu) computes, per aggregation row n of one direction's CSR,
//
//   out[n] = sum_{e in row n} W2 · relu(pre_e) + b2,
//   pre_e  = W1a·h[n] + W1b·h[oth_e] + W1c·ea_e + b1.
//
// Given the output cotangent g (n_rows, d_out), with gw[n] = W2ᵀ·g[n] and
// dpre_e = gw[n] ⊙ (pre_e > 0) for the edges e of row n, this file computes
//
//   dha[n] = sum_{e in row n} dpre_e       dhb[j] = sum_{e : oth_e = j} dpre_e
//   dh     = dha·W1a + dhb·W1b
//   dW1a   = sum_n dha[n] ⊗ h[n]           dW1b = sum_j dhb[j] ⊗ h[j]
//   dW1c   = sum_e dpre_e ⊗ ea_e           db1  = sum_n dha[n]
//   dW2    = sum_n g[n] ⊗ A_r[n]           A_r[n] = sum_{e in row n} relu(pre_e)
//   db2    = sum_n deg(n) · g[n]
//
// and writes dh (n_rows, d) and the parameter gradients in the layout
// [dW1 (dh, 2d + edge_dim) | db1 | dW2 (d_out, dh) | db2].
//
// What bounds it on an H100.  At the 50-mesh train batch (24,782 rows,
// 127,067 edges, D = Dh = D_out = 10, edge_dim 3) one VJP must move about
// 5.1 MB (h, g, one CSR, the weights in; dh and the parameter gradients
// out) and do about 66 MFLOP: 1.5 us at 3.35 TB/s, and less at 67 TFLOP/s
// f32.  So the call is bound by launch latency, the gathers along each row
// and the instructions that bring gathered rows to the lanes, not by bytes
// or operations.
//
// Design.  Three launches on one stream, no float atomics, so two calls are
// bit-identical.  In the first two, as in the forward kernel, a group of G
// lanes owns one CSR row at a time (G = 16 when every width is <= 16, else
// 32), lane k owning hidden unit k with its weights in registers; a fixed
// grid walks the rows with a fixed stride, and every lane keeps its share
// of the parameter gradients in registers across its rows.
//   1. rows:  the aggregation CSR.  Per row, the group stages h[n] and g[n]
//      in shared memory; lane k forms base_k = b1[k] + W1a[k]·h[n] and
//      gw_k = Σ_o W2[o,k]·g[n,o].  The edges come G at a time: lane t
//      gathers h[oth_e] and ea_e of edge t into its slot, and every lane
//      reads the slots as broadcast float4 loads, continues pre_k with
//      W1b[k]·h[j] and W1c[k]·ea_e, and takes dp = pre_k > 0 ? gw_k : 0,
//      dha_k += dp, A_r,k += relu(pre_k), dW1c[k,:] += dp·ea_e.  Per row,
//      dW2[:,k] += g[n]·A_r,k, db2 += deg·g[n], db1_k += dha_k and
//      dW1a[k,:] += dha_k·h[n].  Writes base, gw and dha (n_rows, dh);
//      nothing of size E.
//   2. cols:  the reversed CSR (the opposite direction's packing: row j
//      lists exactly the edges whose other endpoint is j).  The edges come
//      G at a time: lane t gathers base[n] and gw[n] of edge t's
//      aggregation node n, and ea_e, into its slot.  Lane k continues
//      pre_k from base[n,k] with pass 1's FMAs on the same operands,
//      W1b[k]·h[j] then W1c[k]·ea_e, so the ReLU mask agrees with pass 1
//      bit for bit; dhb_k += mask·gw[n,k].
//      Then lane i < d writes dh[j,i] = Σ_k dha[j,k]·W1a[k,i] +
//      dhb_k·W1b[k,i], and lane k adds dhb_k·h[j] to dW1b[k,:].
//   At the end of passes 1 and 2 each block sums its lanes' partials in a
//   fixed order (a shuffle butterfly over the groups of a warp, then the
//   warps in order through shared memory) into its row of a
//   (n_blocks, n_params) buffer; pass 1 fills the columns of dW1a, dW1c,
//   db1, dW2 and db2, pass 2 those of dW1b.
//   3. reduce: each parameter entry is the sum of its column, contiguous
//      slices of the blocks summed in order and then added in order.
// The model's widths (D = Dh = D_out = 10, edge_dim 3 or 1) are compiled
// as constants; other widths up to 32 (edge_dim up to 8) take a variant
// with run-time bounds.  The TPU kernel's one-hot MXU matmuls over RCM
// windows, the VMEM accumulators carried across its sequential grid and
// the segment-sum of overlapping dhb windows are not carried over: Hopper
// gathers directly, its blocks run in no order, and a pass over the
// reversed CSR replaces the overlapping windows.
//
// Times on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (chip_smoke.py, device time per call at the train batch, `to`): the
// earlier design (one thread per row, an (E, Dh) scratch of dpre, one
// reduction block per parameter entry, and four cuBLAS products outside)
// took 0.1440 ms in its own three kernels; this one's time is in PERF.md's
// kernel table.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEdgeDim = 8;
constexpr int kReduceCols = 32;
constexpr int kReduceSlices = 16;
constexpr int kReduceBatch = 8;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

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

// Compile-time bounds of the widths: FD > 0 fixes d = dh = d_out = FD,
// FE > 0 fixes edge_dim = FE; 0 leaves them to run time, up to G and 8.
template <int G, int FD, int FE>
struct Widths {
  static constexpr int ND = FD ? FD : G;
  static constexpr int NE = FE ? FE : kMaxEdgeDim;
  static constexpr int kGroups = kThreads / G;
  // pass 1, per group: G edge slots (h[j] | ea_e), a row slot (h[n] | g[n])
  static constexpr int SW1 = round4(ND + NE);
  static constexpr int kGroup1 = G * SW1 + round4(2 * ND);
  static constexpr int NV1 = 2 * ND + NE + 2;   // lane partials of pass 1
  // pass 2, per group: G edge slots (base[n] | gw[n] | ea_e), a row slot
  static constexpr int SW2 = round4(2 * ND + NE);
  static constexpr int kGroup2 = G * SW2 + round4(2 * ND);
};

// The block's sum of every lane's v[m] for equal lane-in-group k, written
// to out_row[col(m, k)] where col >= 0.  Every thread of the block calls it
// once; `red` is shared memory of kWarps·NV·G floats, and the caller's
// other uses of shared memory are over.
template <int G, int NV, typename Col>
__device__ __forceinline__ void block_partials(float (&v)[NV], float* red,
                                               float* out_row, Col col) {
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < NV; ++m)
      v[m] += __shfl_xor_sync(0xffffffffu, v[m], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane < G)
#pragma unroll
    for (int m = 0; m < NV; ++m) red[(warp * NV + m) * G + lane] = v[m];
  __syncthreads();
  for (int idx = threadIdx.x; idx < NV * G; idx += kThreads) {
    const int m = idx / G, k = idx % G;
    const int c = col(m, k);
    if (c < 0) continue;
    float s = red[m * G + k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[(w * NV + m) * G + k];
    out_row[c] = s;
  }
}

// Pass 1: rows of the aggregation CSR.
template <int G, int FD, int FE>
__global__ void __launch_bounds__(kThreads)
fused_mp_bwd_rows_kernel(const float* __restrict__ h,
                         const float* __restrict__ g,       // (n_rows, d_out)
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ oth,
                         const float* __restrict__ ea,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         float* __restrict__ base_out,      // (n_rows, dh)
                         float* __restrict__ gw,            // (n_rows, dh)
                         float* __restrict__ dha,           // (n_rows, dh)
                         float* __restrict__ partials,      // (n_blocks, P)
                         int n_rows, int d, int dh, int d_out, int edge_dim,
                         int n_params) {
  using W = Widths<G, FD, FE>;
  constexpr int ND = W::ND, NE = W::NE, SW = W::SW1, RW = round4(2 * ND);
  if (FD) d = dh = d_out = FD;
  if (FE) edge_dim = FE;
  const int k_in = 2 * d + edge_dim;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_w1 = smem + W::kGroups * W::kGroup1;   // (dh, k_in)
  for (int i = threadIdx.x; i < dh * k_in; i += blockDim.x) s_w1[i] = w1[i];
  __syncthreads();

  const int lane = threadIdx.x % G;
  float* slots = smem + (threadIdx.x / G) * W::kGroup1;
  float* row_slot = slots + G * SW;
  const unsigned mask = group_mask<G>();
  const bool kv = lane < dh;
  // lane k's row of W1 and column of W2
  float wa[ND], wb[ND], wc[NE], w2k[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    wa[i] = (kv && i < d) ? s_w1[lane * k_in + i] : 0.f;
    wb[i] = (kv && i < d) ? s_w1[lane * k_in + d + i] : 0.f;
    w2k[i] = (kv && i < d_out) ? w2[i * dh + lane] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < NE; ++c)
    wc[c] = (kv && c < edge_dim) ? s_w1[lane * k_in + 2 * d + c] : 0.f;
  const float bk = kv ? b1[lane] : 0.f;

  // lane k's partials: dW1a[k,:] | dW1c[k,:] | dW2[:,k] | db1[k] | db2[k]
  constexpr int kA = 0, kC = ND, kW2 = ND + NE, kB1 = 2 * ND + NE;
  float part[W::NV1];
#pragma unroll
  for (int m = 0; m < W::NV1; ++m) part[m] = 0.f;

  for (int n = blockIdx.x * W::kGroups + threadIdx.x / G; n < n_rows;
       n += gridDim.x * W::kGroups) {  // the whole group takes the same rows
    if (lane < d) row_slot[lane] = h[(size_t)n * d + lane];
    const float gv = lane < d_out ? g[(size_t)n * d_out + lane] : 0.f;
    if (lane < d_out) row_slot[ND + lane] = gv;
    const int e0 = row_ptr[n];
    const int e1 = row_ptr[n + 1];
    __syncwarp(mask);
    float base = bk, gwk = 0.f;         // b1[k] + W1a[k]·h[n], (W2ᵀ·g[n])[k]
    {
      float x[RW];
      read_slot<RW>(row_slot, x);
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (i < d) base = fmaf(wa[i], x[i], base);
#pragma unroll
      for (int o = 0; o < ND; ++o)
        if (o < d_out) gwk = fmaf(w2k[o], x[ND + o], gwk);
    }
    if (kv) {
      base_out[(size_t)n * dh + lane] = base;
      gw[(size_t)n * dh + lane] = gwk;
    }

    float dha_k = 0.f, ar_k = 0.f;
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
        const float dp = p > 0.f ? gwk : 0.f;
        dha_k += dp;
        ar_k += fmaxf(p, 0.f);
#pragma unroll
        for (int c = 0; c < NE; ++c)
          if (c < edge_dim) part[kC + c] = fmaf(dp, x[ND + c], part[kC + c]);
      }
      __syncwarp(mask);
    }
    if (kv) dha[(size_t)n * dh + lane] = dha_k;
    {
      float x[RW];
      read_slot<RW>(row_slot, x);
#pragma unroll
      for (int o = 0; o < ND; ++o)
        if (o < d_out) part[kW2 + o] = fmaf(x[ND + o], ar_k, part[kW2 + o]);
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (i < d) part[kA + i] = fmaf(dha_k, x[i], part[kA + i]);
    }
    part[kB1] += dha_k;
    part[kB1 + 1] = fmaf((float)(e1 - e0), gv, part[kB1 + 1]);
    __syncwarp(mask);
  }

  const int off_w2 = dh * k_in + dh;
  block_partials<G, W::NV1>(
      part, smem, partials + (size_t)blockIdx.x * n_params,
      [=](int m, int k) {
        if (m == kB1 + 1) return k < d_out ? off_w2 + d_out * dh + k : -1;
        if (k >= dh) return -1;
        if (m < kC) return m < d ? k * k_in + m : -1;
        if (m < kW2)
          return m - kC < edge_dim ? k * k_in + 2 * d + (m - kC) : -1;
        if (m < kB1) return m - kW2 < d_out ? off_w2 + (m - kW2) * dh + k : -1;
        return dh * k_in + k;           // db1
      });
}

// Pass 2: rows of the reversed CSR (row j = the edges whose other end is j).
template <int G, int FD, int FE>
__global__ void __launch_bounds__(kThreads)
fused_mp_bwd_cols_kernel(const float* __restrict__ h,
                         const float* __restrict__ base,    // (n_rows, dh)
                         const float* __restrict__ gw,      // (n_rows, dh)
                         const float* __restrict__ dha,     // (n_rows, dh)
                         const int* __restrict__ rrow_ptr,
                         const int* __restrict__ roth,      // aggregation node
                         const float* __restrict__ rea,
                         const float* __restrict__ w1,
                         float* __restrict__ dh_out,        // (n_rows, d)
                         float* __restrict__ partials,      // (n_blocks, P)
                         int n_rows, int d, int dh, int edge_dim,
                         int n_params) {
  using W = Widths<G, FD, FE>;
  constexpr int ND = W::ND, NE = W::NE, SW = W::SW2, RW = round4(2 * ND);
  if (FD) d = dh = FD;
  if (FE) edge_dim = FE;
  const int k_in = 2 * d + edge_dim;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_w1 = smem + W::kGroups * W::kGroup2;   // (dh, k_in)
  for (int i = threadIdx.x; i < dh * k_in; i += blockDim.x) s_w1[i] = w1[i];
  __syncthreads();

  const int lane = threadIdx.x % G;
  float* slots = smem + (threadIdx.x / G) * W::kGroup2;
  float* row_slot = slots + G * SW;
  const unsigned mask = group_mask<G>();
  const bool kv = lane < dh, iv = lane < d;
  float wb[ND], wc[NE];
#pragma unroll
  for (int i = 0; i < ND; ++i)
    wb[i] = (kv && i < d) ? s_w1[lane * k_in + d + i] : 0.f;
#pragma unroll
  for (int c = 0; c < NE; ++c)
    wc[c] = (kv && c < edge_dim) ? s_w1[lane * k_in + 2 * d + c] : 0.f;
  float part[ND];                       // dW1b[k, :]
#pragma unroll
  for (int i = 0; i < ND; ++i) part[i] = 0.f;

  for (int j = blockIdx.x * W::kGroups + threadIdx.x / G; j < n_rows;
       j += gridDim.x * W::kGroups) {
    if (iv) row_slot[lane] = h[(size_t)j * d + lane];
    const int e0 = rrow_ptr[j];
    const int e1 = rrow_ptr[j + 1];
    __syncwarp(mask);
    float hj[RW];
    read_slot<RW>(row_slot, hj);

    float dhb_k = 0.f;
    for (int c0 = e0; c0 < e1; c0 += G) {
      const int cnt = min(G, e1 - c0);
      if (lane < cnt) {                 // lane t gathers the chunk's edge t
        const size_t n = (size_t)roth[c0 + lane];
        const size_t ej = (size_t)(c0 + lane) * edge_dim;
        float* sl = slots + lane * SW;
#pragma unroll
        for (int k = 0; k < ND; ++k) {
          if (k < dh) {
            sl[k] = base[n * dh + k];
            sl[ND + k] = gw[n * dh + k];
          }
        }
#pragma unroll
        for (int c = 0; c < NE; ++c)
          if (c < edge_dim) sl[2 * ND + c] = rea[ej + c];
      }
      __syncwarp(mask);
#pragma unroll 2
      for (int t = 0; t < cnt; ++t) {
        const float* sl = slots + t * SW;
        float x[round4(NE)];
        read_slot<round4(NE)>(sl + 2 * ND, x);
        // pass 1's FMAs from base[n]: W1b·h[j], then W1c·ea
        float p = kv ? sl[lane] : 0.f;
#pragma unroll
        for (int i = 0; i < ND; ++i)
          if (i < d) p = fmaf(wb[i], hj[i], p);
#pragma unroll
        for (int c = 0; c < NE; ++c)
          if (c < edge_dim) p = fmaf(wc[c], x[c], p);
        dhb_k += (kv && p > 0.f) ? sl[ND + lane] : 0.f;
      }
      __syncwarp(mask);
    }

    // lane i: dh[j, i] = Σ_k dha[j, k]·W1a[k, i] + dhb_k·W1b[k, i]
    const float dha_k = kv ? dha[(size_t)j * dh + lane] : 0.f;
    if (kv) {
      row_slot[lane] = dha_k;
      row_slot[ND + lane] = dhb_k;
    }
    __syncwarp(mask);
    float x[RW];
    read_slot<RW>(row_slot, x);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      if (k < dh) {
        s = fmaf(iv ? s_w1[k * k_in + lane] : 0.f, x[k], s);
        s = fmaf(iv ? s_w1[k * k_in + d + lane] : 0.f, x[ND + k], s);
      }
    }
    if (iv) dh_out[(size_t)j * d + lane] = s;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (i < d) part[i] = fmaf(dhb_k, hj[i], part[i]);
    __syncwarp(mask);
  }

  block_partials<G, ND>(part, smem, partials + (size_t)blockIdx.x * n_params,
                        [=](int m, int k) {
                          return (k < dh && m < d) ? k * k_in + d + m : -1;
                        });
}

// Pass 3: params[c] = Σ_b partials[b, c] in a fixed order.
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
fused_mp_bwd_reduce_kernel(const float* __restrict__ partials,
                           float* __restrict__ params, int n_blocks,
                           int n_params) {
  __shared__ float red[kReduceSlices][kReduceCols];
  const int x = threadIdx.x % kReduceCols, y = threadIdx.x / kReduceCols;
  const int c = blockIdx.x * kReduceCols + x;
  const int per = (n_blocks + kReduceSlices - 1) / kReduceSlices;
  const int b0 = min(y * per, n_blocks), b1 = min(b0 + per, n_blocks);
  float s = 0.f;
  if (c < n_params) {
    const float* col = partials + c;
    int b = b0;
    for (; b + kReduceBatch <= b1; b += kReduceBatch) {
      float v[kReduceBatch];            // loads in flight, sums in order
#pragma unroll
      for (int u = 0; u < kReduceBatch; ++u)
        v[u] = col[(size_t)(b + u) * n_params];
#pragma unroll
      for (int u = 0; u < kReduceBatch; ++u) s += v[u];
    }
    for (; b < b1; ++b) s += col[(size_t)b * n_params];
  }
  red[y][x] = s;
  __syncthreads();
  if (y == 0 && c < n_params) {
#pragma unroll
    for (int w = 1; w < kReduceSlices; ++w) s += red[w][x];
    params[c] = s;
  }
}

template <int G, int FD, int FE>
int launch_passes(const float* h, const float* g, const int* row_ptr,
                  const int* oth, const float* ea, const int* rrow_ptr,
                  const int* roth, const float* rea, const float* w1,
                  const float* b1, const float* w2, float* base, float* gw,
                  float* dha, float* dh_out, float* partials, int n_blocks,
                  int n_rows, int d, int dh, int d_out, int edge_dim,
                  int n_params, cudaStream_t s) {
  using W = Widths<G, FD, FE>;
  const int w1_size = dh * (2 * d + edge_dim);
  const int f1 = W::kGroups * W::kGroup1 + w1_size;
  const int f2 = W::kGroups * W::kGroup2 + w1_size;
  const int r1 = kWarps * W::NV1 * G, r2 = kWarps * W::ND * G;
  const size_t smem1 = sizeof(float) * (f1 > r1 ? f1 : r1);
  const size_t smem2 = sizeof(float) * (f2 > r2 ? f2 : r2);
  fused_mp_bwd_rows_kernel<G, FD, FE><<<n_blocks, kThreads, smem1, s>>>(
      h, g, row_ptr, oth, ea, w1, b1, w2, base, gw, dha, partials, n_rows, d,
      dh, d_out, edge_dim, n_params);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_mp_bwd_cols_kernel<G, FD, FE><<<n_blocks, kThreads, smem2, s>>>(
      h, base, gw, dha, rrow_ptr, roth, rea, w1, dh_out, partials, n_rows, d,
      dh, edge_dim, n_params);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes.  Launches the three passes on
// `stream`, does not synchronise, allocates nothing (the caller passes the
// scratch base, gw, dha (n_rows, dh) and partials (max_blocks, n_params),
// and the outputs dh_out (n_rows, d) and params (n_params,)), and returns
// the first cudaGetLastError() that is not 0 (0 on success).  The passes
// run on min(max_blocks, ceil(n_rows / rows per block)) blocks, at least
// one.  The caller has checked shapes and types.
extern "C" int psignn_fused_mp_bwd(
    const float* h, const float* g, const int* row_ptr, const int* oth,
    const float* ea, const int* rrow_ptr, const int* roth, const float* rea,
    const float* w1, const float* b1, const float* w2, float* base,
    float* gw, float* dha, float* dh_out, float* partials, float* params,
    int n_rows, int d, int dh, int d_out, int edge_dim, int max_blocks,
    void* stream) {
  if (d < 1 || d > 32 || dh < 1 || dh > 32 || d_out < 1 || d_out > 32 ||
      edge_dim < 0 || edge_dim > kMaxEdgeDim || n_rows < 0 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_params = dh * (2 * d + edge_dim) + dh + d_out * dh + d_out;
  const bool model = d == 10 && dh == 10 && d_out == 10;
  const int wmax = d > dh ? (d > d_out ? d : d_out) : (dh > d_out ? dh : d_out);
  const int rows_per_block = kThreads / (wmax <= 16 ? 16 : 32);
  int n_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  n_blocks = n_blocks < 1 ? 1 : (n_blocks > max_blocks ? max_blocks : n_blocks);
#define PSIGNN_PASSES(G, FD, FE)                                             \
  launch_passes<G, FD, FE>(h, g, row_ptr, oth, ea, rrow_ptr, roth, rea, w1, \
                           b1, w2, base, gw, dha, dh_out, partials,         \
                           n_blocks, n_rows, d, dh, d_out, edge_dim,        \
                           n_params, s)
  const int rc = (model && edge_dim == 3) ? PSIGNN_PASSES(16, 10, 3)
                 : (model && edge_dim == 1) ? PSIGNN_PASSES(16, 10, 1)
                 : wmax <= 16                ? PSIGNN_PASSES(16, 0, 0)
                                             : PSIGNN_PASSES(32, 0, 0);
#undef PSIGNN_PASSES
  if (rc != 0) return rc;
  const int grid = (n_params + kReduceCols - 1) / kReduceCols;
  fused_mp_bwd_reduce_kernel<<<grid, kReduceCols * kReduceSlices, 0, s>>>(
      partials, params, n_blocks, n_params);
  return (int)cudaGetLastError();
}
