"""Random blob-domain triangular meshes (numpy + scipy only).

Port of ``psignn_tpu/data/meshgen.py`` (``Mesh``, ``blob_mesh``,
``mixed_blob_mesh``, ``circle_mesh``, ``mesh_from_dolfin_h5`` and their
helpers).  The domain family is the
reference's: perturbed circle points, a periodic cubic spline through them,
boundary samples at ≈``hsize`` arc-length spacing, a jittered hex lattice
inside, four Laplacian smoothing passes, and a Delaunay triangulation
clipped to the polygon.  The mixed variant tags the boundary vertices
Dirichlet (101) or Neumann (303) by arcs.

The one change: ``matplotlib.path.Path.contains_points`` becomes
``points_in_polygon``, a numpy even-odd crossing test written with the same
comparisons, so the same ``np.random.default_rng(seed)`` gives identical
points and triangles without matplotlib.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.interpolate import CubicSpline
from scipy.spatial import Delaunay


@dataclasses.dataclass
class Mesh:
    points: np.ndarray        # (N, 2) float64 vertex coordinates
    triangles: np.ndarray     # (T, 3) int32 vertex indices
    boundary_mask: np.ndarray  # (N,) bool, True for boundary vertices
    boundary_tag: np.ndarray   # (N,) int32 segment tag, 0 for interior
    boundary_loop: Optional[np.ndarray] = None  # (n_bnd,) int32, CCW order

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])


def points_in_polygon(polygon: np.ndarray, pts: np.ndarray,
                      chunk: int = 4096) -> np.ndarray:
    """(P,) bool: is each point inside the closed polygon (even-odd rule)?

    A ray cast in +x counts the polygon edges it crosses; the comparisons
    are those of matplotlib's ``point_in_path`` crossing test, so points
    off the boundary classify identically.  Points go through in chunks to
    bound the (chunk, n_vertices) temporaries."""
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
    """Periodic cubic spline through perturbed circle points
    (t = 0.25·rand + 0.75 scaling both coordinates)."""
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


def _sample_boundary(spline, n_ctrl: int, hsize: float,
                     return_params: bool = False):
    """Sample the closed curve at ≈hsize arc-length spacing; with
    ``return_params`` also the spline parameter of each sample."""
    dense_t = np.linspace(0.0, n_ctrl - 1, 4096, endpoint=False)
    dense = spline(dense_t)
    seg = np.linalg.norm(np.diff(dense, axis=0, append=dense[:1]), axis=1)
    arclen = np.concatenate([[0.0], np.cumsum(seg)])[:-1]
    total = arclen[-1] + seg[-1]
    n_bnd = max(8, int(round(total / hsize)))
    targets = np.linspace(0.0, total, n_bnd, endpoint=False)
    idx = np.clip(np.searchsorted(arclen, targets), 0, len(dense) - 1)
    if return_params:
        return dense[idx], dense_t[idx]
    return dense[idx]


def _interior_points(boundary: np.ndarray, hsize: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Jittered hex lattice clipped to the polygon, away from the boundary."""
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
    # drop points within 0.35·hsize of the boundary polyline
    if len(pts):
        d2 = np.min(np.sum((pts[:, None, :] - boundary[None, :, :]) ** 2,
                           axis=-1), axis=1)
        pts = pts[d2 > (0.35 * hsize) ** 2]
    return pts


def _laplacian_smooth(boundary: np.ndarray, interior: np.ndarray,
                      passes: int = 4) -> np.ndarray:
    """Move each interior vertex to the mean of its Delaunay neighbours
    (boundary fixed), re-triangulating between passes."""
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


def _finalize_mesh(points: np.ndarray, triangles: np.ndarray,
                   n_bnd: int, bnd_tags: np.ndarray) -> Mesh:
    """Drop unused vertices, build boundary mask/tags/loop."""
    used = np.zeros(len(points), bool)
    used[triangles.ravel()] = True
    remap = -np.ones(len(points), np.int64)
    remap[used] = np.arange(used.sum())
    new_points = points[used]
    new_triangles = remap[triangles].astype(np.int32)

    orig_b = np.arange(n_bnd)[used[:n_bnd]]
    loop = remap[orig_b].astype(np.int32)
    bmask = np.zeros(len(new_points), bool)
    bmask[loop] = True
    btag = np.zeros(len(new_points), np.int32)
    btag[loop] = bnd_tags[orig_b]
    return Mesh(points=new_points, triangles=new_triangles,
                boundary_mask=bmask, boundary_tag=btag, boundary_loop=loop)


def _triangulate(boundary: np.ndarray, interior: np.ndarray,
                 bnd_tags: np.ndarray) -> Mesh:
    """Delaunay triangulation of boundary + interior, clipped to the
    polygon."""
    points = np.concatenate([boundary, interior], axis=0)
    tri = Delaunay(points)
    cent = points[tri.simplices].mean(axis=1)
    triangles = tri.simplices[points_in_polygon(boundary, cent)].astype(np.int32)
    return _finalize_mesh(points, triangles, len(boundary), bnd_tags)


def blob_mesh(radius: float = 1.0, hsize: float = 0.08,
              nb_bound_points: int = 10, seed: Optional[int] = None,
              rng: Optional[np.random.Generator] = None,
              tag_dirichlet: int = 101) -> Mesh:
    """One random blob mesh (reference defaults: R=1, hsize=0.08,
    10 boundary control points)."""
    if rng is None:
        rng = np.random.default_rng(seed)
    spline = _boundary_spline(radius, nb_bound_points, rng)
    boundary = _sample_boundary(spline, nb_bound_points, hsize)
    interior = _interior_points(boundary, hsize, rng)
    interior = _laplacian_smooth(boundary, interior)
    return _triangulate(boundary, interior,
                        np.full(len(boundary), tag_dirichlet, np.int32))


def mixed_blob_mesh(radius: float = 1.0, hsize: float = 0.08,
                    nb_bound_points: int = 10, seed: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None,
                    tag_dirichlet: int = 101, tag_neumann: int = 303) -> Mesh:
    """Mixed-BC blob mesh: the boundary splits into 4 arcs by control-point
    quarters, two opposite arcs Dirichlet and the other two Neumann, which
    pair drawn from ``rng``.  A vertex touching a Dirichlet facet is
    Dirichlet, so interface vertices go to Dirichlet.  ``boundary_loop``
    stays CCW: the outward normals depend on it."""
    if rng is None:
        rng = np.random.default_rng(seed)
    spline = _boundary_spline(radius, nb_bound_points, rng)
    boundary, params = _sample_boundary(spline, nb_bound_points, hsize,
                                        return_params=True)
    # facet i joins samples i and i+1; its quarter is its midpoint's
    t_max = float(nb_bound_points - 1)
    p1 = np.roll(params, -1)
    p1 = np.where(p1 < params, p1 + t_max, p1)
    mid = ((params + p1) / 2.0) % t_max
    quarter = np.minimum(mid / t_max * 4.0, 3.999).astype(int)
    sense = int(rng.integers(0, 2))
    facet_is_d = np.isin(quarter, [0, 2] if sense == 1 else [1, 3])
    # vertex i touches facets i-1 and i
    vert_is_d = facet_is_d | np.roll(facet_is_d, 1)
    bnd_tags = np.where(vert_is_d, tag_dirichlet, tag_neumann).astype(np.int32)

    interior = _interior_points(boundary, hsize, rng)
    interior = _laplacian_smooth(boundary, interior)
    return _triangulate(boundary, interior, bnd_tags)


def circle_mesh(radius: float = 1.0, hsize: float = 0.08,
                seed: Optional[int] = None) -> Mesh:
    """Plain circle domain (the growing-geometry benchmark's circle
    generator, tests/special_geo): ≈``hsize``-spaced boundary points on the
    circle, the blob's interior lattice and smoothing, and the Delaunay
    triangles whose centroid lies in the circle."""
    rng = np.random.default_rng(seed)
    n_bnd = max(8, int(round(2 * np.pi * radius / hsize)))
    theta = np.linspace(0, 2 * np.pi, n_bnd, endpoint=False)
    boundary = radius * np.stack([np.cos(theta), np.sin(theta)], axis=1)
    interior = _interior_points(boundary, hsize, rng)
    interior = _laplacian_smooth(boundary, interior)
    points = np.concatenate([boundary, interior], axis=0)
    tri = Delaunay(points)
    cent = points[tri.simplices].mean(axis=1)
    # centroid-in-circle test with tolerance for boundary-chord triangles
    keep = np.linalg.norm(cent, axis=1) <= radius
    triangles = tri.simplices[keep].astype(np.int32)
    bnd_tags = np.full(n_bnd, 101, np.int32)
    return _finalize_mesh(points, triangles, n_bnd, bnd_tags)


def mesh_from_dolfin_h5(path: str, tag_dirichlet: int = 101) -> Mesh:
    """A DOLFIN-HDF5 mesh (the reference's ``build_mesh`` output:
    ``mesh/coordinates``, ``mesh/topology``, ``facet/topology``,
    ``facet/values``; dirichlet/dataset/build_mesh.py:111-115) as a
    ``Mesh``, its vertices on facets tagged ``tag_dirichlet`` the boundary.
    Reads the file with ``h5py``, imported here: a host without it gets an
    ``ImportError`` when it asks for such a mesh, and not before."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"mesh_from_dolfin_h5({path!r}) reads HDF5 with "
                          f"h5py, which this Python does not have") from e

    with h5py.File(path, "r") as f:
        points = np.asarray(f["mesh/coordinates"])[:, :2].astype(np.float64)
        triangles = np.asarray(f["mesh/topology"]).astype(np.int32)
        facets = np.asarray(f["facet/topology"]).astype(np.int64)
        fvals = np.asarray(f["facet/values"]).astype(np.int64)

    n = points.shape[0]
    boundary_mask = np.zeros(n, bool)
    boundary_tag = np.zeros(n, np.int32)
    tagged = np.unique(facets[fvals == tag_dirichlet])
    boundary_mask[tagged] = True
    boundary_tag[tagged] = tag_dirichlet
    return Mesh(points=points, triangles=triangles,
                boundary_mask=boundary_mask, boundary_tag=boundary_tag,
                boundary_loop=None)
