"""P1 (linear Lagrange) FEM assembly and Poisson sampling (numpy + scipy).

Port of ``psignn_tpu/data/fem.py`` (``assemble_p1``, ``apply_dirichlet``,
``random_quadratics``, ``compute_edge_distance``, ``solve_poisson``,
``vertex_unit_normals``, ``solve_poisson_mixed``).  Dirichlet rows are
overwritten dolfin-style — row zeroed, unit diagonal, rhs = boundary
value — and their columns are kept, so ``A`` is NOT symmetric: the "to"
and "from" message-passing packings differ.  In the mixed variant the
homogeneous Neumann condition is natural in the weak form: its rows are
left as assembled.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .meshgen import Mesh

# Degree-4 Dunavant quadrature on the reference triangle (6 points) —
# exact for the cubic integrand f·φ with quadratic f.
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


def assemble_p1(mesh: Mesh, f_fn) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Stiffness A (CSR) and load b for -Δu = f with P1 elements."""
    pts = mesh.points
    tris = mesh.triangles
    n = mesh.n_points

    p0 = pts[tris[:, 0]]
    p1 = pts[tris[:, 1]]
    p2 = pts[tris[:, 2]]
    j00 = p1[:, 0] - p0[:, 0]
    j01 = p2[:, 0] - p0[:, 0]
    j10 = p1[:, 1] - p0[:, 1]
    j11 = p2[:, 1] - p0[:, 1]
    area = 0.5 * np.abs(j00 * j11 - j01 * j10)

    # gradients of the barycentric basis: ∇λ_i = perp(opposite edge) / (2A)
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
          + lam[None, :, 2:3] * p2[:, None, :])          # (T, Q, 2)
    fq = f_fn(xq[..., 0], xq[..., 1])                      # (T, Q)
    for i in range(3):
        contrib = (fq * lam[None, :, i] * _QW[None, :]).sum(axis=1) * area
        np.add.at(b_vec, tris[:, i], contrib)
    return A, b_vec


def apply_dirichlet(A: sp.csr_matrix, b: np.ndarray, idx: np.ndarray,
                    values: np.ndarray) -> Tuple[sp.csr_matrix, np.ndarray]:
    """dolfin ``DirichletBC.apply(A, b)``: zero the row, unit diagonal,
    rhs = boundary value (no column symmetrisation)."""
    A = A.tolil()
    for i, v in zip(idx, values):
        A.rows[i] = [int(i)]
        A.data[i] = [1.0]
        b[i] = v
    return A.tocsr(), b


def random_quadratics(rng: np.random.Generator, radius: float):
    """The reference's random source f (3 coefficients) and boundary field
    g (6 coefficients), coefficients U(-10, 10)."""
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


def compute_edge_distance(edge_index: np.ndarray,
                          coords: np.ndarray) -> np.ndarray:
    """(E, 3) per-edge [dx, dy, ‖d‖] with d = coord[i] − coord[j]."""
    d = coords[edge_index[:, 0]] - coords[edge_index[:, 1]]
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([d, norm], axis=1)


def solve_poisson(mesh: Mesh, radius: float = 1.0,
                  rng: Optional[np.random.Generator] = None
                  ) -> Dict[str, np.ndarray]:
    """One Poisson sample on ``mesh``: A (csr), b (N,1), coordinates (N,2),
    sol (N,1) from a sparse direct solve, prb_data (N,2), tags (N,1),
    distance (E,3)."""
    if rng is None:
        rng = np.random.default_rng()
    f_fn, g_fn = random_quadratics(rng, radius)
    A, b = assemble_p1(mesh, f_fn)

    bidx = np.where(mesh.boundary_mask)[0]
    gvals = g_fn(mesh.points[bidx, 0], mesh.points[bidx, 1])
    A, b = apply_dirichlet(A, b, bidx, gvals)

    sol = spla.spsolve(A.tocsc(), b).reshape(-1, 1)

    f_all = f_fn(mesh.points[:, 0], mesh.points[:, 1]).reshape(-1, 1)
    prb_data = np.concatenate([f_all, np.zeros_like(f_all)], axis=1)
    tags = np.zeros((mesh.n_points, 1))
    tags[bidx] = 1.0
    prb_data[bidx, 0] = 0.0
    prb_data[bidx, 1] = gvals

    coeff = sp.find(A)
    edge_index = np.stack([coeff[0], coeff[1]], axis=1).astype(np.int64)
    distance = compute_edge_distance(edge_index, mesh.points)

    return dict(A=A.astype(np.float64), b=b.reshape(-1, 1),
                coordinates=mesh.points, sol=sol, prb_data=prb_data,
                tags=tags, distance=distance)


def vertex_unit_normals(mesh: Mesh) -> np.ndarray:
    """(N, 2) outward unit normals on boundary vertices, 0 inside: the
    edge-length-weighted mean of a vertex's two facet normals, normalised.
    The boundary loop is CCW, so facet t = (dx, dy) has outward normal
    (dy, −dx)."""
    normals = np.zeros((mesh.n_points, 2))
    loop = mesh.boundary_loop
    if loop is None or len(loop) == 0:
        return normals
    p = mesh.points[loop]
    edge = np.roll(p, -1, axis=0) - p           # facet i: loop[i]→loop[i+1]
    fn = np.stack([edge[:, 1], -edge[:, 0]], axis=1)
    vn = fn + np.roll(fn, 1, axis=0)            # facets i-1 and i
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.divide(vn, norm, out=np.zeros_like(vn), where=norm > 0)
    normals[loop] = vn
    return normals


def solve_poisson_mixed(mesh: Mesh, radius: float = 1.0,
                        rng: Optional[np.random.Generator] = None,
                        tag_dirichlet: int = 101) -> Dict[str, np.ndarray]:
    """One mixed-BC Poisson sample: Dirichlet rows on the 101-tagged
    vertices only.  ``tags`` is one-hot [interior, dirichlet, neumann] and
    ``prb_data`` is [f, g, f_neumann]; ``unit_normal_vector`` (N, 2) is
    added to ``solve_poisson``'s keys."""
    if rng is None:
        rng = np.random.default_rng()
    f_fn, g_fn = random_quadratics(rng, radius)
    A, b = assemble_p1(mesh, f_fn)

    normals = vertex_unit_normals(mesh)
    didx = np.where(mesh.boundary_tag == tag_dirichlet)[0]
    gvals = g_fn(mesh.points[didx, 0], mesh.points[didx, 1])
    A, b = apply_dirichlet(A, b, didx, gvals)

    sol = spla.spsolve(A.tocsc(), b).reshape(-1, 1)

    n = mesh.n_points
    f_all = f_fn(mesh.points[:, 0], mesh.points[:, 1])
    # the whole boundary is marked Neumann first, then the Dirichlet rows
    # are overwritten: the order of these writes is the encoding
    tags = np.zeros((n, 3))
    tags[:, 0] = 1.0
    full_bnd = np.where(mesh.boundary_mask)[0]
    tags[full_bnd, 0] = 0.0
    tags[full_bnd, 2] = 1.0
    prb_data = np.zeros((n, 3))
    prb_data[:, 0] = f_all
    prb_data[full_bnd, 2] = prb_data[full_bnd, 0]
    prb_data[full_bnd, 0] = 0.0
    tags[didx, 1] = 1.0
    tags[didx, 2] = 0.0
    prb_data[didx, 1] = gvals
    prb_data[didx, 2] = 0.0

    coeff = sp.find(A)
    edge_index = np.stack([coeff[0], coeff[1]], axis=1).astype(np.int64)
    distance = compute_edge_distance(edge_index, mesh.points)

    return dict(A=A.astype(np.float64), b=b.reshape(-1, 1),
                coordinates=mesh.points, sol=sol, prb_data=prb_data,
                tags=tags, distance=distance, unit_normal_vector=normals)
