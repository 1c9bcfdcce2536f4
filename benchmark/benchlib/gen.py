"""Frozen traffic generator: blob meshes, their P1 FEM Poisson solves and
the Ψ-GNN (Dirichlet) graph samples the requests carry.

A copy of ``psignn_tpu_torch.data.meshgen.blob_mesh``,
``psignn_tpu_torch.data.fem.solve_poisson`` and
``psignn_tpu_torch.data.reader.psignn_sample_from_fem`` with its
``REF_STATS``, as they stood when the benchmark was defined.  The copy is
the yardstick: a later change to the program's data path changes the
program, not the inputs it is measured on.  ``tests/test_gen.py`` holds
it to the program's generator bit for bit.  numpy and scipy only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from scipy.interpolate import CubicSpline
from scipy.spatial import Delaunay

# the reference code base's normalisation statistics (Dirichlet Ψ-GNN and
# DS-GPS, psignn reader.py:73-77)
REF_STATS = dict(
    prb_mean=[0.0464, -0.0006], prb_std=[9.6267, 3.2935],
    dist_mean=[0.0, 0.0, 0.0655], dist_std=[0.0507, 0.0507, 0.0293],
)

# Degree-4 Dunavant quadrature on the reference triangle (6 points)
_QP = np.array([
    [0.445948490915965, 0.445948490915965],
    [0.445948490915965, 0.108103018168070],
    [0.108103018168070, 0.445948490915965],
    [0.091576213509771, 0.091576213509771],
    [0.091576213509771, 0.816847572980459],
    [0.816847572980459, 0.091576213509771],
])
_QW = np.array([
    0.223381589678011, 0.223381589678011, 0.223381589678011,
    0.109951743655322, 0.109951743655322, 0.109951743655322,
])


@dataclasses.dataclass
class Mesh:
    points: np.ndarray         # (N, 2) float64
    triangles: np.ndarray      # (T, 3) int32
    boundary_mask: np.ndarray  # (N,) bool

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])


def points_in_polygon(polygon: np.ndarray, pts: np.ndarray,
                      chunk: int = 4096) -> np.ndarray:
    """(P,) bool: even-odd ray-crossing test of each point."""
    x0, y0 = polygon[:, 0], polygon[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    out = np.empty(len(pts), bool)
    for lo in range(0, len(pts), chunk):
        tx = pts[lo:lo + chunk, 0:1]
        ty = pts[lo:lo + chunk, 1:2]
        yflag0 = y0 >= ty
        yflag1 = y1 >= ty
        crosses = (yflag0 != yflag1) & (
            ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == yflag1)
        out[lo:lo + chunk] = (np.count_nonzero(crosses, axis=1) % 2) == 1
    return out


def _boundary_spline(radius: float, nb_bound_points: int,
                     rng: np.random.Generator):
    alpha = np.linspace(0.0, 2.0 * np.pi, nb_bound_points)
    xs, ys = [], []
    for i in range(nb_bound_points - 1):
        t = (1.0 - 0.75) * rng.random() + 0.75
        xs.append(t * radius * np.cos(alpha[i]))
        ys.append(t * radius * np.sin(alpha[i]))
    xs.append(xs[0])
    ys.append(ys[0])
    pts = np.stack([xs, ys], axis=1)
    s = np.arange(len(pts), dtype=np.float64)
    return CubicSpline(s, pts, bc_type="periodic")


def _sample_boundary(spline, n_ctrl: int, hsize: float) -> np.ndarray:
    dense_t = np.linspace(0.0, n_ctrl - 1, 4096, endpoint=False)
    dense = spline(dense_t)
    seg = np.linalg.norm(np.diff(dense, axis=0, append=dense[:1]), axis=1)
    arclen = np.concatenate([[0.0], np.cumsum(seg)])[:-1]
    total = arclen[-1] + seg[-1]
    n_bnd = max(8, int(round(total / hsize)))
    targets = np.linspace(0.0, total, n_bnd, endpoint=False)
    idx = np.clip(np.searchsorted(arclen, targets), 0, len(dense) - 1)
    return dense[idx]


def _interior_points(boundary: np.ndarray, hsize: float,
                     rng: np.random.Generator) -> np.ndarray:
    lo = boundary.min(axis=0) - hsize
    hi = boundary.max(axis=0) + hsize
    dx = hsize
    dy = hsize * np.sqrt(3.0) / 2.0
    ys = np.arange(lo[1], hi[1], dy)
    pts = []
    for row, y in enumerate(ys):
        xs = np.arange(lo[0] + (0.5 * dx if row % 2 else 0.0), hi[0], dx)
        for x in xs:
            pts.append((x, y))
    pts = np.asarray(pts)
    if len(pts) == 0:
        return np.zeros((0, 2))
    pts = pts + rng.uniform(-0.12, 0.12, pts.shape) * hsize
    pts = pts[points_in_polygon(boundary, pts)]
    if len(pts):
        d2 = np.min(np.sum((pts[:, None, :] - boundary[None, :, :]) ** 2,
                           axis=-1), axis=1)
        pts = pts[d2 > (0.35 * hsize) ** 2]
    return pts


def _laplacian_smooth(boundary: np.ndarray, interior: np.ndarray,
                      passes: int = 4) -> np.ndarray:
    if len(interior) == 0 or passes == 0:
        return interior
    n_b = len(boundary)
    for _ in range(passes):
        points = np.concatenate([boundary, interior])
        tri = Delaunay(points)
        cent = points[tri.simplices].mean(axis=1)
        tris = tri.simplices[points_in_polygon(boundary, cent)]
        e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
        e = np.concatenate([e, e[:, ::-1]])
        acc = np.zeros_like(points)
        cnt = np.zeros(len(points))
        np.add.at(acc, e[:, 0], points[e[:, 1]])
        np.add.at(cnt, e[:, 0], 1)
        new = np.where(cnt[:, None] > 0,
                       acc / np.maximum(cnt, 1)[:, None], points)
        interior = new[n_b:]
    return interior


def blob_mesh(radius: float, hsize: float, rng: np.random.Generator,
              nb_bound_points: int = 10) -> Mesh:
    """One random blob mesh: perturbed circle, periodic spline boundary,
    jittered hex interior, 4 smoothing passes, clipped Delaunay."""
    spline = _boundary_spline(radius, nb_bound_points, rng)
    boundary = _sample_boundary(spline, nb_bound_points, hsize)
    interior = _interior_points(boundary, hsize, rng)
    interior = _laplacian_smooth(boundary, interior)
    points = np.concatenate([boundary, interior], axis=0)
    tri = Delaunay(points)
    cent = points[tri.simplices].mean(axis=1)
    triangles = tri.simplices[points_in_polygon(boundary, cent)].astype(
        np.int32)
    n_bnd = len(boundary)
    used = np.zeros(len(points), bool)
    used[triangles.ravel()] = True
    remap = -np.ones(len(points), np.int64)
    remap[used] = np.arange(used.sum())
    bmask = np.zeros(int(used.sum()), bool)
    bmask[remap[np.arange(n_bnd)[used[:n_bnd]]]] = True
    return Mesh(points=points[used],
                triangles=remap[triangles].astype(np.int32),
                boundary_mask=bmask)


def _assemble_p1(mesh: Mesh, f_fn):
    pts, tris, n = mesh.points, mesh.triangles, mesh.n_points
    p0, p1, p2 = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    j00 = p1[:, 0] - p0[:, 0]
    j01 = p2[:, 0] - p0[:, 0]
    j10 = p1[:, 1] - p0[:, 1]
    j11 = p2[:, 1] - p0[:, 1]
    area = 0.5 * np.abs(j00 * j11 - j01 * j10)
    b_ = np.stack([p1[:, 1] - p2[:, 1], p2[:, 1] - p0[:, 1],
                   p0[:, 1] - p1[:, 1]], axis=1)
    c_ = np.stack([p2[:, 0] - p1[:, 0], p0[:, 0] - p2[:, 0],
                   p1[:, 0] - p0[:, 0]], axis=1)
    rows, cols, vals = [], [], []
    inv4a = 1.0 / (4.0 * area)
    for i in range(3):
        for j in range(3):
            rows.append(tris[:, i])
            cols.append(tris[:, j])
            vals.append((b_[:, i] * b_[:, j] + c_[:, i] * c_[:, j]) * inv4a)
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n)).tocsr()
    A.sum_duplicates()
    b_vec = np.zeros(n)
    lam = np.stack([1.0 - _QP[:, 0] - _QP[:, 1], _QP[:, 0], _QP[:, 1]], axis=1)
    xq = (lam[None, :, 0:1] * p0[:, None, :] + lam[None, :, 1:2] * p1[:, None, :]
          + lam[None, :, 2:3] * p2[:, None, :])
    fq = f_fn(xq[..., 0], xq[..., 1])
    for i in range(3):
        contrib = (fq * lam[None, :, i] * _QW[None, :]).sum(axis=1) * area
        np.add.at(b_vec, tris[:, i], contrib)
    return A, b_vec


def _apply_dirichlet(A, b, idx, values):
    A = A.tolil()
    for i, v in zip(idx, values):
        A.rows[i] = [int(i)]
        A.data[i] = [1.0]
        b[i] = v
    return A.tocsr(), b


def _random_quadratics(rng: np.random.Generator, radius: float):
    pf = rng.uniform(-10, 10, 3)
    pg = rng.uniform(-10, 10, 6)
    R = radius

    def f(x, y):
        return pf[0] * (x / R - 1.0) ** 2 + pf[1] * (y / R) ** 2 + pf[2]

    def g(x, y):
        return (pg[0] * (x / R) ** 2 + pg[1] * (x / R) * (y / R)
                + pg[2] * (y / R) ** 2 + pg[3] * (x / R) + pg[4] * (y / R)
                + pg[5])

    return f, g


def solve_poisson(mesh: Mesh, radius: float, rng: np.random.Generator
                  ) -> Dict[str, np.ndarray]:
    """-Δu = f, u = g on the boundary, f and g random quadratics: the
    dolfin-style system (Dirichlet rows zeroed, unit diagonal), its sparse
    direct solution and the per-node and per-edge features."""
    f_fn, g_fn = _random_quadratics(rng, radius)
    A, b = _assemble_p1(mesh, f_fn)
    bidx = np.where(mesh.boundary_mask)[0]
    gvals = g_fn(mesh.points[bidx, 0], mesh.points[bidx, 1])
    A, b = _apply_dirichlet(A, b, bidx, gvals)
    sol = spla.spsolve(A.tocsc(), b).reshape(-1, 1)
    f_all = f_fn(mesh.points[:, 0], mesh.points[:, 1]).reshape(-1, 1)
    prb_data = np.concatenate([f_all, np.zeros_like(f_all)], axis=1)
    tags = np.zeros((mesh.n_points, 1))
    tags[bidx] = 1.0
    prb_data[bidx, 0] = 0.0
    prb_data[bidx, 1] = gvals
    coeff = sp.find(A)
    edge_index = np.stack([coeff[0], coeff[1]], axis=1).astype(np.int64)
    d = mesh.points[edge_index[:, 0]] - mesh.points[edge_index[:, 1]]
    distance = np.concatenate([d, np.linalg.norm(d, axis=1, keepdims=True)],
                              axis=1)
    return dict(A=A.astype(np.float64), b=b.reshape(-1, 1),
                coordinates=mesh.points, sol=sol, prb_data=prb_data,
                tags=tags, distance=distance)


def psignn_sample_from_fem(s: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A solve → the graph sample both model families read, in mesh node
    order: COO edges over the nonzeros of A (self-loops included), x = 0
    inside and b on Dirichlet nodes, normalised problem data and edge
    features, all float32 (indices int32)."""
    stats = {k: np.array(v) for k, v in REF_STATS.items()}
    c = sp.find(s["A"])
    f32 = np.float32
    b = np.asarray(s["b"], f32).reshape(-1, 1)
    sol = np.asarray(s["sol"], f32).reshape(-1, 1)
    tags = np.asarray(s["tags"], f32).reshape(len(sol), -1)
    x = np.zeros_like(sol)
    bnd = tags[:, 0] == 1
    x[bnd] = b[bnd]
    return dict(
        x=x, b=b, sol=sol,
        prb_data=np.asarray((np.asarray(s["prb_data"]) - stats["prb_mean"])
                            / stats["prb_std"], f32),
        tags=tags, pos=np.asarray(s["coordinates"], f32),
        senders=c[0].astype(np.int32), receivers=c[1].astype(np.int32),
        a_ij=c[2].reshape(-1, 1).astype(f32),
        edge_attr=np.asarray((np.asarray(s["distance"]) - stats["dist_mean"])
                             / stats["dist_std"], f32))

