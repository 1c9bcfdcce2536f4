"""Out-of-distribution geometry zoo.

Port of ``psignn_tpu/eval/geometries.py``: the reference's 12 gmsh
generators (``tests/special_geo/mesh_*.py``: square, square with holes,
circle, donut, heart, house, house with windows, car, F1 car and three
free-form outlines) as polygons with holes, triangulated by
``polygon_mesh`` (a hex lattice inside, scipy's Delaunay, triangles kept by
their centroids), every boundary vertex Dirichlet (tag 101).  Each
evaluation FEM-solves its mesh for ground truth (``data.fem``).

The one change: ``matplotlib.path.Path.contains_points`` becomes the port's
``points_in_polygon`` (``data/meshgen.py``), which classifies points off the
boundary as matplotlib does, so the same builders give the JAX package's
meshes array for array, and no matplotlib is needed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.spatial import Delaunay

from ..data.meshgen import Mesh, _interior_points, points_in_polygon


def _resample_closed(poly: np.ndarray, hsize: float) -> np.ndarray:
    """Resample a closed polyline at ≈hsize arc-length spacing."""
    seg = np.linalg.norm(np.roll(poly, -1, axis=0) - poly, axis=1)
    arclen = np.concatenate([[0.0], np.cumsum(seg)])
    total = arclen[-1]
    n = max(8, int(round(total / hsize)))
    t = np.linspace(0, total, n, endpoint=False)
    out = np.empty((n, 2))
    for d in range(2):
        ext = np.concatenate([poly[:, d], poly[:1, d]])
        out[:, d] = np.interp(t, arclen, ext)
    return out


def polygon_mesh(outer: np.ndarray, holes: Sequence[np.ndarray] = (),
                 hsize: float = 0.08, seed: int = 0) -> Mesh:
    """Triangulate a polygon with optional holes.

    All boundary vertices (outer and holes) are tagged Dirichlet (the
    reference zoo applies Dirichlet everywhere, mesh_*.py tag 101).
    """
    rng = np.random.default_rng(seed)
    outer_s = _resample_closed(np.asarray(outer, float), hsize)
    holes_s = [_resample_closed(np.asarray(h, float), hsize) for h in holes]

    interior = _interior_points(outer_s, hsize, rng)
    # drop interior points inside holes or near hole boundaries
    for h in holes_s:
        if len(interior) == 0:
            break
        interior = interior[~points_in_polygon(h, interior)]
        d2 = np.min(np.sum((interior[:, None] - h[None]) ** 2, axis=-1), axis=1)
        interior = interior[d2 > (0.6 * hsize) ** 2]

    boundary = np.concatenate([outer_s] + holes_s, axis=0) if holes_s else outer_s
    points = np.concatenate([boundary, interior], axis=0)
    tri = Delaunay(points)
    cent = points[tri.simplices].mean(axis=1)
    keep = points_in_polygon(outer_s, cent)
    for h in holes_s:
        keep &= ~points_in_polygon(h, cent)
    triangles = tri.simplices[keep].astype(np.int32)

    used = np.zeros(len(points), bool)
    used[triangles.ravel()] = True
    remap = -np.ones(len(points), np.int64)
    remap[used] = np.arange(used.sum())
    n_bnd = len(boundary)
    bmask = np.zeros(int(used.sum()), bool)
    orig_b = np.arange(n_bnd)[used[:n_bnd]]
    bmask[remap[orig_b]] = True
    return Mesh(points=points[used], triangles=remap[triangles].astype(np.int32),
                boundary_mask=bmask,
                boundary_tag=np.where(bmask, 101, 0).astype(np.int32))


# ---------------------------------------------------------------- shape zoo

def _circle(c, r, n=256):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], axis=1)


def square(hsize=0.08, size=2.0, **kw):
    s = size / 2
    outer = np.array([[-s, -s], [s, -s], [s, s], [-s, s]])
    return polygon_mesh(outer, hsize=hsize, **kw)


def square_with_holes(hsize=0.08, size=2.0, **kw):
    s = size / 2
    outer = np.array([[-s, -s], [s, -s], [s, s], [-s, s]])
    holes = [_circle((-s / 2, -s / 2), s / 4), _circle((s / 2, s / 2), s / 4)]
    return polygon_mesh(outer, holes, hsize=hsize, **kw)


def circle(hsize=0.08, radius=1.0, **kw):
    return polygon_mesh(_circle((0, 0), radius), hsize=hsize, **kw)


def donut(hsize=0.08, radius=1.0, **kw):
    return polygon_mesh(_circle((0, 0), radius),
                        [_circle((0, 0), radius * 0.45)], hsize=hsize, **kw)


def heart(hsize=0.08, scale=1.0, **kw):
    t = np.linspace(0, 2 * np.pi, 512, endpoint=False)
    x = 16 * np.sin(t) ** 3
    y = 13 * np.cos(t) - 5 * np.cos(2 * t) - 2 * np.cos(3 * t) - np.cos(4 * t)
    return polygon_mesh(np.stack([x, y], 1) * scale / 16.0, hsize=hsize, **kw)


def house(hsize=0.08, **kw):
    outer = np.array([[-1, -1], [1, -1], [1, 0.4], [0, 1.2], [-1, 0.4]])
    return polygon_mesh(outer, hsize=hsize, **kw)


def house_with_windows(hsize=0.08, **kw):
    outer = np.array([[-1, -1], [1, -1], [1, 0.4], [0, 1.2], [-1, 0.4]])
    win = 0.22
    holes = [np.array([[cx - win, cy - win], [cx + win, cy - win],
                       [cx + win, cy + win], [cx - win, cy + win]])
             for cx, cy in [(-0.5, -0.3), (0.5, -0.3)]]
    return polygon_mesh(outer, holes, hsize=hsize, **kw)


def car(hsize=0.08, **kw):
    body = np.array([
        [-2.0, 0.0], [2.0, 0.0], [2.0, 0.5], [1.2, 0.6], [0.7, 1.1],
        [-0.8, 1.1], [-1.4, 0.6], [-2.0, 0.5]])
    wheels = [_circle((-1.2, 0.0), 0.35), _circle((1.2, 0.0), 0.35)]
    return polygon_mesh(body, wheels, hsize=hsize, **kw)


def f1_car(hsize=0.08, **kw):
    body = np.array([
        [-2.4, 0.0], [2.4, 0.0], [2.4, 0.35], [1.6, 0.35], [1.0, 0.7],
        [0.2, 0.7], [-0.4, 1.0], [-1.2, 1.0], [-1.6, 0.45], [-2.4, 0.45]])
    wheels = [_circle((-1.7, 0.0), 0.3), _circle((1.7, 0.0), 0.3)]
    return polygon_mesh(body, wheels, hsize=hsize, **kw)


def freeform(hsize=0.08, seed=0, **kw):
    """Random smooth blob (the reference's 2-D free-form generators)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, 512, endpoint=False)
    r = np.ones_like(t)
    for k in range(2, 6):
        r += 0.15 / k * (rng.normal() * np.cos(k * t) + rng.normal() * np.sin(k * t))
    return polygon_mesh(np.stack([r * np.cos(t), r * np.sin(t)], 1),
                        hsize=hsize, **kw)


def freeform_spiky(hsize=0.08, seed=3, **kw):
    """Higher-frequency free-form outline (the reference's second 2-D
    free-form family, tests/special_geo/mesh_2d.py: hand-placed spline
    points with sharper curvature than the smooth blob)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, 512, endpoint=False)
    r = np.ones_like(t)
    for k in range(2, 10):
        r += 0.35 / k * (rng.normal() * np.cos(k * t)
                         + rng.normal() * np.sin(k * t))
    r = np.clip(r, 0.45, None)
    return polygon_mesh(np.stack([r * np.cos(t), r * np.sin(t)], 1),
                        hsize=hsize, **kw)


def freeform_bean(hsize=0.08, **kw):
    """Non-convex bean/kidney outline (free-form variant with a concave
    waist, matching the reference zoo's non-star-shaped domains)."""
    t = np.linspace(0, 2 * np.pi, 512, endpoint=False)
    r = 1.0 + 0.35 * np.cos(t) - 0.45 * np.cos(2 * t) * 0.5
    x = r * np.cos(t)
    y = 0.85 * r * np.sin(t) + 0.25 * np.cos(t) ** 2
    return polygon_mesh(np.stack([x, y], 1), hsize=hsize, **kw)


GEOMETRY_BUILDERS = {
    "square": square,
    "square_with_holes": square_with_holes,
    "circle": circle,
    "donut": donut,
    "heart": heart,
    "house": house,
    "house_with_windows": house_with_windows,
    "car": car,
    "f1_car": f1_car,
    "freeform": freeform,
    "freeform_spiky": freeform_spiky,
    "freeform_bean": freeform_bean,
}


def build_geometry(name: str, hsize: float = 0.08, **kw) -> Mesh:
    return GEOMETRY_BUILDERS[name](hsize=hsize, **kw)
