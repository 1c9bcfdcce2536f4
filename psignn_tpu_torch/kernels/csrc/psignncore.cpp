// psignncore: the host runtime of the PyTorch/CUDA port, bound through
// ctypes by psignn_tpu_torch/native.py.
//
// A copy of the JAX package's native/psignncore.cpp: the same five extern "C"
// functions with the same arithmetic and loop order, so that the two builds
// agree bit for bit where the compiler allows.  P1 finite-element assembly
// (COO triplets and the load vector), a Jacobi-preconditioned conjugate-
// gradient solve of an SPD CSR system, reverse Cuthill-McKee ordering of a
// CSR pattern, and pack_mp_blocks_core, which reproduces the JAX package's
// edge-block packing for its TPU kernel (psignn_tpu/kernels/fused_mp.py,
// pack_mp_blocks); the port's own kernels read a CSR instead
// (psignn_tpu_torch/kernels/fused_mp.py).  No path of the port calls this
// library.  Its scipy/numpy counterparts are psignn_tpu_torch/data/fem.py
// (assemble_p1, apply_dirichlet) and dist/partition.py (rcm_permutation);
// callers choose between them.
//
// Build: at first use, by psignn_tpu_torch/kernels/build.py, with $CXX (else
// g++) -O3 -march=native -fPIC -shared -std=c++17 -Wall, into
// psignn_tpu_torch/kernels/build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// P1 stiffness assembly (COO triplets, 9 per triangle).
// pts: (npts, 2) row-major; tris: (ntri, 3).
// rows/cols/vals must hold 9*ntri entries.
// ---------------------------------------------------------------------------
void assemble_p1_coo(const double* pts, int64_t npts, const int32_t* tris,
                     int64_t ntri, int32_t* rows, int32_t* cols,
                     double* vals) {
  (void)npts;
  for (int64_t t = 0; t < ntri; ++t) {
    const int32_t i0 = tris[3 * t], i1 = tris[3 * t + 1], i2 = tris[3 * t + 2];
    const double x0 = pts[2 * i0], y0 = pts[2 * i0 + 1];
    const double x1 = pts[2 * i1], y1 = pts[2 * i1 + 1];
    const double x2 = pts[2 * i2], y2 = pts[2 * i2 + 1];
    const double det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
    const double area = 0.5 * std::fabs(det);
    // gradients of barycentric basis (b, c coefficients)
    const double b[3] = {y1 - y2, y2 - y0, y0 - y1};
    const double c[3] = {x2 - x1, x0 - x2, x1 - x0};
    const double inv4a = 1.0 / (4.0 * area);
    const int32_t idx[3] = {i0, i1, i2};
    int64_t off = 9 * t;
    for (int a = 0; a < 3; ++a) {
      for (int bb = 0; bb < 3; ++bb) {
        rows[off] = idx[a];
        cols[off] = idx[bb];
        vals[off] = (b[a] * b[bb] + c[a] * c[bb]) * inv4a;
        ++off;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Load vector: b_i = sum_T sum_q w_q * f(x_q) * lambda_i(x_q) * area_T.
// fq: (ntri, nq) source values at quadrature points; lam: (nq, 3) barycentric
// coords; w: (nq,) weights.  b must be zero-initialized, length npts.
// ---------------------------------------------------------------------------
void assemble_load(const double* pts, const int32_t* tris, int64_t ntri,
                   const double* fq, const double* lam, const double* w,
                   int64_t nq, double* b) {
  for (int64_t t = 0; t < ntri; ++t) {
    const int32_t i0 = tris[3 * t], i1 = tris[3 * t + 1], i2 = tris[3 * t + 2];
    const double x0 = pts[2 * i0], y0 = pts[2 * i0 + 1];
    const double x1 = pts[2 * i1], y1 = pts[2 * i1 + 1];
    const double x2 = pts[2 * i2], y2 = pts[2 * i2 + 1];
    const double det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
    const double area = 0.5 * std::fabs(det);
    double acc[3] = {0.0, 0.0, 0.0};
    for (int64_t q = 0; q < nq; ++q) {
      const double fw = fq[t * nq + q] * w[q] * area;
      acc[0] += fw * lam[3 * q];
      acc[1] += fw * lam[3 * q + 1];
      acc[2] += fw * lam[3 * q + 2];
    }
    b[i0] += acc[0];
    b[i1] += acc[1];
    b[i2] += acc[2];
  }
}

// ---------------------------------------------------------------------------
// Jacobi-preconditioned CG on CSR (SPD).  Returns iterations used, or -1.
// ---------------------------------------------------------------------------
int32_t solve_cg(const int64_t* indptr, const int32_t* indices,
                 const double* data, int64_t n, const double* b, double* x,
                 double tol, int32_t maxiter) {
  std::vector<double> r(n), p(n), Ap(n), z(n), dinv(n);
  for (int64_t i = 0; i < n; ++i) {
    double d = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
      if (indices[k] == i) d = data[k];
    dinv[i] = (d != 0.0) ? 1.0 / d : 1.0;
  }
  auto spmv = [&](const double* v, double* out) {
    for (int64_t i = 0; i < n; ++i) {
      double acc = 0.0;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
        acc += data[k] * v[indices[k]];
      out[i] = acc;
    }
  };
  std::memset(x, 0, n * sizeof(double));
  double bnorm = 0.0;
  for (int64_t i = 0; i < n; ++i) bnorm += b[i] * b[i];
  bnorm = std::sqrt(bnorm);
  if (bnorm == 0.0) return 0;

  for (int64_t i = 0; i < n; ++i) {
    r[i] = b[i];
    z[i] = dinv[i] * r[i];
    p[i] = z[i];
  }
  double rz = 0.0;
  for (int64_t i = 0; i < n; ++i) rz += r[i] * z[i];

  for (int32_t it = 0; it < maxiter; ++it) {
    spmv(p.data(), Ap.data());
    double pAp = 0.0;
    for (int64_t i = 0; i < n; ++i) pAp += p[i] * Ap[i];
    if (pAp == 0.0) return -1;
    const double alpha = rz / pAp;
    double rnorm = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      x[i] += alpha * p[i];
      r[i] -= alpha * Ap[i];
      rnorm += r[i] * r[i];
    }
    if (std::sqrt(rnorm) < tol * bnorm) return it + 1;
    double rz_new = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      z[i] = dinv[i] * r[i];
      rz_new += r[i] * z[i];
    }
    const double beta = rz_new / rz;
    rz = rz_new;
    for (int64_t i = 0; i < n; ++i) p[i] = z[i] + beta * p[i];
  }
  return -1;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee on a CSR pattern (assumed structurally symmetric).
// perm[k] = old index of the node at new position k.
// ---------------------------------------------------------------------------
void rcm_order(const int64_t* indptr, const int32_t* indices, int64_t n,
               int32_t* perm) {
  std::vector<int32_t> degree(n);
  for (int64_t i = 0; i < n; ++i)
    degree[i] = static_cast<int32_t>(indptr[i + 1] - indptr[i]);
  std::vector<char> visited(n, 0);
  int64_t out = 0;
  std::vector<int32_t> order;
  order.reserve(64);
  for (;;) {
    // lowest-degree unvisited seed
    int64_t seed = -1;
    int32_t best = INT32_MAX;
    for (int64_t i = 0; i < n; ++i)
      if (!visited[i] && degree[i] < best) { best = degree[i]; seed = i; }
    if (seed < 0) break;
    std::queue<int32_t> bfs;
    bfs.push(static_cast<int32_t>(seed));
    visited[seed] = 1;
    while (!bfs.empty()) {
      const int32_t u = bfs.front();
      bfs.pop();
      perm[out++] = u;
      order.clear();
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        const int32_t v = indices[k];
        if (!visited[v]) {
          visited[v] = 1;
          order.push_back(v);
        }
      }
      std::sort(order.begin(), order.end(),
                [&](int32_t a, int32_t b2) { return degree[a] < degree[b2]; });
      for (int32_t v : order) bfs.push(v);
    }
  }
  // reverse for RCM
  for (int64_t i = 0; i < n / 2; ++i)
    std::swap(perm[i], perm[n - 1 - i]);
}

// ---------------------------------------------------------------------------
// Fused-MP block packing hot loop (see psignn_tpu/kernels/fused_mp.py,
// pack_mp_blocks).
// Inputs: edges already filtered (no self loops / masked) and sorted by agg.
// Outputs sized (n_blocks * e_cap): agg_local, oth_global int32; mask f32;
// per-block win_start int32.  Returns required window size.
// ---------------------------------------------------------------------------
int32_t pack_mp_blocks_core(const int32_t* agg, const int32_t* oth,
                            int64_t nedges, int64_t n_node_cap,
                            int64_t block_n, int64_t e_cap,
                            int32_t* agg_local, int32_t* oth_global,
                            float* mask, int32_t* win_start,
                            int64_t* block_fill) {
  const int64_t n_blocks = n_node_cap / block_n;
  for (int64_t i = 0; i < n_blocks; ++i) {
    win_start[i] = 0;
    block_fill[i] = 0;
  }
  std::vector<int32_t> omin(n_blocks, INT32_MAX), omax(n_blocks, -1);
  for (int64_t e = 0; e < nedges; ++e) {
    const int64_t blk = agg[e] / block_n;
    const int64_t slot = block_fill[blk]++;
    if (slot >= e_cap) return -1;  // caller sized e_cap too small
    agg_local[blk * e_cap + slot] =
        static_cast<int32_t>(agg[e] - blk * block_n);
    oth_global[blk * e_cap + slot] = oth[e];
    mask[blk * e_cap + slot] = 1.0f;
    omin[blk] = std::min(omin[blk], oth[e]);
    omax[blk] = std::max(omax[blk], oth[e]);
  }
  int32_t max_need = static_cast<int32_t>(block_n);
  for (int64_t i = 0; i < n_blocks; ++i) {
    if (omax[i] < 0) continue;
    const int32_t ws =
        static_cast<int32_t>((omin[i] / block_n) * block_n);
    win_start[i] = ws;
    max_need = std::max(max_need, omax[i] - ws + 1);
  }
  return max_need;
}

}  // extern "C"
