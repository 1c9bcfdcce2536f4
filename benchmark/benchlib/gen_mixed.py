"""Frozen traffic generator of the mixed Dirichlet–Neumann cells: mixed
blob meshes, their P1 FEM Poisson solves with homogeneous Neumann arcs,
and the mixed Ψ-GNN graph samples the requests carry; and the mixes'
pools, cached.

A copy of ``psignn_tpu_torch.data.meshgen.mixed_blob_mesh``,
``psignn_tpu_torch.data.fem.vertex_unit_normals`` and
``solve_poisson_mixed``, and ``psignn_tpu_torch.data.reader.
psignn_sample_from_fem(variant="mixed")`` with the mixed ``REF_STATS``,
as they stood when the mixed cell was defined; the parts they share
with the Dirichlet generator are ``gen``'s, which is frozen too.  The
copy is the yardstick: a later change to the program's data path changes
the program, not the inputs it is measured on.  The port's test
``tests/test_torch_gen_mixed.py`` holds it to the program's generator
bit for bit.  The vertex normals are the edge-length-weighted mean of a
boundary vertex's two facet normals, where the reference code base
projects FEniCS's ``FacetNormal`` (``mixed/dataset/extract_data.py:
120-137``).  numpy and scipy only.

A mix's pool (``radii``, ``meshes_per_radius``, ``hsize``, ``pool_seed``)
is drawn as the program's sweep draws it (``eval.sweep.
growing_geometry_sweep`` with ``variant="mixed"``): radius by radius,
mesh by mesh, the mesh and then its solve from one stream.  A checkout's
first run draws it in a child process and keeps it in
``benchmark/.cache/pools/``, keyed by the mix's pool fields and the
source of this file and of ``gen``; every run reads it from there, as
``pool.py`` does for the Dirichlet mixes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from scipy.spatial import Delaunay

from . import gen
from .gen import (_apply_dirichlet, _assemble_p1, _boundary_spline,
                  _interior_points, _laplacian_smooth, _random_quadratics,
                  points_in_polygon)

# the reference code base's normalisation statistics of the mixed Ψ-GNN
# (mixed/psignn/utilities/reader.py:74-81)
REF_STATS = dict(
    prb_mean=[-0.4319, 0.0289, -0.0189], prb_std=[8.4245, 2.1942, 2.8585],
    dist_mean=[0.0, 0.0, 0.0572], dist_std=[0.0445, 0.0443, 0.0258],
    normal_mean=[0.0007, -0.0004], normal_std=[0.2773, 0.2959],
)
TAG_DIRICHLET, TAG_NEUMANN = 101, 303


@dataclasses.dataclass
class Mesh:
    points: np.ndarray         # (N, 2) float64
    triangles: np.ndarray      # (T, 3) int32
    boundary_mask: np.ndarray  # (N,) bool
    boundary_tag: np.ndarray   # (N,) int32, 0 inside
    boundary_loop: np.ndarray  # (n_bnd,) int32, counter-clockwise

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])


def _sample_boundary(spline, n_ctrl: int, hsize: float):
    """The closed curve sampled at ≈hsize arc-length spacing, and each
    sample's spline parameter."""
    dense_t = np.linspace(0.0, n_ctrl - 1, 4096, endpoint=False)
    dense = spline(dense_t)
    seg = np.linalg.norm(np.diff(dense, axis=0, append=dense[:1]), axis=1)
    arclen = np.concatenate([[0.0], np.cumsum(seg)])[:-1]
    total = arclen[-1] + seg[-1]
    n_bnd = max(8, int(round(total / hsize)))
    targets = np.linspace(0.0, total, n_bnd, endpoint=False)
    idx = np.clip(np.searchsorted(arclen, targets), 0, len(dense) - 1)
    return dense[idx], dense_t[idx]


def _triangulate(boundary: np.ndarray, interior: np.ndarray,
                 bnd_tags: np.ndarray) -> Mesh:
    """Delaunay of boundary and interior clipped to the polygon, unused
    vertices dropped, boundary tags and loop kept."""
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
    orig_b = np.arange(n_bnd)[used[:n_bnd]]
    loop = remap[orig_b].astype(np.int32)
    n = int(used.sum())
    bmask = np.zeros(n, bool)
    bmask[loop] = True
    btag = np.zeros(n, np.int32)
    btag[loop] = bnd_tags[orig_b]
    return Mesh(points=points[used], triangles=remap[triangles].astype(
        np.int32), boundary_mask=bmask, boundary_tag=btag,
        boundary_loop=loop)


def mixed_blob_mesh(radius: float, hsize: float, rng: np.random.Generator,
                    nb_bound_points: int = 10) -> Mesh:
    """One mixed blob mesh: the blob's boundary in four arcs by quarters
    of the spline parameter, two opposite arcs Dirichlet (which pair from
    ``rng``), the other two Neumann; a vertex touching a Dirichlet facet
    is Dirichlet."""
    spline = _boundary_spline(radius, nb_bound_points, rng)
    boundary, params = _sample_boundary(spline, nb_bound_points, hsize)
    t_max = float(nb_bound_points - 1)
    p1 = np.roll(params, -1)
    p1 = np.where(p1 < params, p1 + t_max, p1)
    mid = ((params + p1) / 2.0) % t_max
    quarter = np.minimum(mid / t_max * 4.0, 3.999).astype(int)
    sense = int(rng.integers(0, 2))
    facet_is_d = np.isin(quarter, [0, 2] if sense == 1 else [1, 3])
    vert_is_d = facet_is_d | np.roll(facet_is_d, 1)
    bnd_tags = np.where(vert_is_d, TAG_DIRICHLET, TAG_NEUMANN).astype(
        np.int32)
    interior = _interior_points(boundary, hsize, rng)
    interior = _laplacian_smooth(boundary, interior)
    return _triangulate(boundary, interior, bnd_tags)


def vertex_unit_normals(mesh: Mesh) -> np.ndarray:
    """(N, 2) outward unit normals on boundary vertices, 0 inside."""
    normals = np.zeros((mesh.n_points, 2))
    loop = mesh.boundary_loop
    if loop is None or len(loop) == 0:
        return normals
    p = mesh.points[loop]
    edge = np.roll(p, -1, axis=0) - p
    fn = np.stack([edge[:, 1], -edge[:, 0]], axis=1)
    vn = fn + np.roll(fn, 1, axis=0)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.divide(vn, norm, out=np.zeros_like(vn), where=norm > 0)
    normals[loop] = vn
    return normals


def solve_poisson_mixed(mesh: Mesh, radius: float, rng: np.random.Generator
                        ) -> Dict[str, np.ndarray]:
    """-Δu = f, u = g on the Dirichlet arcs and a homogeneous Neumann
    condition on the others: the dolfin-style system (Dirichlet rows
    zeroed, unit diagonal), its sparse direct solution, one-hot tags
    [interior, dirichlet, neumann], prb_data [f, g, f_neumann], edge
    features and the normals."""
    f_fn, g_fn = _random_quadratics(rng, radius)
    A, b = _assemble_p1(mesh, f_fn)
    normals = vertex_unit_normals(mesh)
    didx = np.where(mesh.boundary_tag == TAG_DIRICHLET)[0]
    gvals = g_fn(mesh.points[didx, 0], mesh.points[didx, 1])
    A, b = _apply_dirichlet(A, b, didx, gvals)
    sol = spla.spsolve(A.tocsc(), b).reshape(-1, 1)
    n = mesh.n_points
    f_all = f_fn(mesh.points[:, 0], mesh.points[:, 1])
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
    d = mesh.points[edge_index[:, 0]] - mesh.points[edge_index[:, 1]]
    distance = np.concatenate([d, np.linalg.norm(d, axis=1, keepdims=True)],
                              axis=1)
    return dict(A=A.astype(np.float64), b=b.reshape(-1, 1),
                coordinates=mesh.points, sol=sol, prb_data=prb_data,
                tags=tags, distance=distance, unit_normal_vector=normals)


def psignn_sample_from_fem(s: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A mixed solve → the mixed Ψ-GNN graph sample in mesh node order:
    COO edges over the nonzeros of A, x = 0 off the Dirichlet rows and b
    on them, normalised problem data, edge features and normals, all
    float32 (indices int32)."""
    stats = {k: np.array(v) for k, v in REF_STATS.items()}
    c = sp.find(s["A"])
    f32 = np.float32
    b = np.asarray(s["b"], f32).reshape(-1, 1)
    sol = np.asarray(s["sol"], f32).reshape(-1, 1)
    tags = np.asarray(s["tags"], f32).reshape(len(sol), -1)
    x = np.zeros_like(sol)
    bnd = tags[:, 1] == 1
    x[bnd] = b[bnd]
    return dict(
        x=x, b=b, sol=sol,
        prb_data=np.asarray((np.asarray(s["prb_data"]) - stats["prb_mean"])
                            / stats["prb_std"], f32),
        tags=tags, pos=np.asarray(s["coordinates"], f32),
        senders=c[0].astype(np.int32), receivers=c[1].astype(np.int32),
        a_ij=c[2].reshape(-1, 1).astype(f32),
        edge_attr=np.asarray((np.asarray(s["distance"]) - stats["dist_mean"])
                             / stats["dist_std"], f32),
        unit_normal_vector=np.asarray(
            (np.asarray(s["unit_normal_vector"]) - stats["normal_mean"])
            / stats["normal_std"], f32))


# ------------------------------------------------------------------ pools

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache", "pools")
KEYS = ("x", "b", "sol", "prb_data", "tags", "pos", "senders", "receivers",
        "a_ij", "edge_attr", "unit_normal_vector")
FIELDS = ("radii", "meshes_per_radius", "hsize", "pool_seed")


def draw(fields: dict) -> List[Dict[str, np.ndarray]]:
    """The pool's samples, mesh by mesh, in pool order."""
    rng = np.random.default_rng(int(fields["pool_seed"]) % (1 << 64))
    out = []
    for radius in fields["radii"]:
        for _ in range(fields["meshes_per_radius"]):
            mesh = mixed_blob_mesh(radius, fields["hsize"], rng)
            out.append(psignn_sample_from_fem(
                solve_poisson_mixed(mesh, radius, rng)))
    return out


def _path(fields: dict) -> str:
    src = b""
    for mod in (gen.__file__, __file__):
        with open(mod, "rb") as f:
            src += f.read()
    key = hashlib.sha256(json.dumps(fields, sort_keys=True).encode()
                         + src).hexdigest()[:16]
    return os.path.join(CACHE, "mixed-" + key + ".npz")


def _keep(fields: dict) -> None:
    path = _path(fields)
    samples = draw(fields)
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, count=len(samples),
             **{f"{i}.{k}": s[k] for i, s in enumerate(samples) for k in KEYS})
    os.replace(tmp, path)


def mesh_pool(traffic: dict, cache: Optional[bool] = True) -> List[Dict]:
    """``pool.mesh_pool``'s entries of a mixed mix: [{"radius",
    "sample", "senders", "receivers", "n", "e"}] in pool order, read from
    the checkout's cache (which a child process fills first where no
    earlier run did); ``cache=False`` draws in this process."""
    fields = {k: traffic[k] for k in FIELDS}
    if cache:
        path = _path(fields)
        if not os.path.exists(path):
            subprocess.run([sys.executable, "-m",
                            "benchmark.benchlib.gen_mixed",
                            json.dumps(fields)], cwd=ROOT, check=True)
        with np.load(path) as z:
            samples = [{k: z[f"{i}.{k}"] for k in KEYS}
                       for i in range(int(z["count"]))]
    else:
        samples = draw(fields)
    radii = [r for r in fields["radii"]
             for _ in range(fields["meshes_per_radius"])]
    return [dict(radius=r, sample=s, senders=s["senders"],
                 receivers=s["receivers"], n=int(s["x"].shape[0]),
                 e=int(np.count_nonzero(s["senders"] != s["receivers"])))
            for r, s in zip(radii, samples)]


if __name__ == "__main__":
    _keep(json.loads(sys.argv[1]))
