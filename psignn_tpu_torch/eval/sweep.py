"""Growing-geometry sweep — the headline generalisation experiment — and
the geometry zoo and several-initialisations studies.

Port of ``build_data``, ``test_sample``, ``growing_geometry_sweep``,
``geometry_zoo_eval`` and ``test_several_init``
(``psignn_tpu/eval/sweep.py``): for each radius, fresh blob meshes are
FEM-solved for ground truth and every predictor is run and timed on them;
per-radius means (and stds) of the metrics come back, and optionally go
to ``{name}_results.csv``.  The zoo does the same on each shape of
``geometries.GEOMETRY_BUILDERS``; the several-initialisations study
answers one sample from four starting points.  The predictor named
``dss`` answers the DSS form of each mesh's sample (A′, b′), every other
one the Ψ-GNN form, which DS-GPS shares; both forms come from the same FEM
solve, so asking for the DSS form draws no other random numbers.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..data.fem import solve_poisson
from ..data.meshgen import blob_mesh
from ..data.reader import dss_sample_from_fem, psignn_sample_from_fem
from ..graphs import Graph, batch_graphs
from .metrics import errors_batch

SAMPLE_FORMS = {"psignn": psignn_sample_from_fem, "dss": dss_sample_from_fem}


def build_data(mesh, radius: float, rng=None,
               families: Sequence[str] = ("psignn", "dss"),
               pallas: bool = False) -> Dict[str, dict]:
    """FEM-solve one mesh; ``{form: graph sample}`` for each sample form
    in ``families`` (``psignn``, ``dss``), each in reverse Cuthill-McKee
    node order with ``pallas`` (JAX ``sweep.py:28-46``; JAX's
    ``_batch_for_eval`` also attaches its kernels' packings then, which
    every port graph carries)."""
    s = solve_poisson(mesh, radius, rng)
    out = {f: SAMPLE_FORMS[f](s) for f in families}
    if pallas:
        from ..dist.partition import rcm_ordered
        out = {f: rcm_ordered(smp) for f, smp in out.items()}
    return out


def _timed(fn: Callable, graph: Graph):
    """Wall-clock one prediction, synchronising the device on both ends."""
    cuda = graph.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(graph.device)
    t0 = time.perf_counter()
    out = fn(graph)
    if cuda:
        torch.cuda.synchronize(graph.device)
    return out, time.perf_counter() - t0


def test_sample(predictors: Dict[str, Callable], graphs: Dict[str, Graph],
                warmup: bool = True) -> Dict[str, Dict[str, float]]:
    """Run and time each predictor on its graph.

    ``predictors[name](graph)`` returns u or a tuple (u, nstep, lowest,
    prot_break, ...) such as ``psignn_inference``'s."""
    results = {}
    for name, fn in predictors.items():
        g = graphs["dss" if name == "dss" else "psignn"]
        if warmup:
            _timed(fn, g)
        out, dt = _timed(fn, g)
        u = out[0] if isinstance(out, tuple) else out
        m = {k: float(v[0]) for k, v in errors_batch(u, g).items()}
        results[name] = dict(
            mse=m["mse"], res=m["res"], rel=m["rel"],
            nstep=int(out[1]) if isinstance(out, tuple) else -1,
            lowest=float(out[2]) if isinstance(out, tuple) else float("nan"),
            prot_break=float(out[3]) if isinstance(out, tuple) else 0.0,
            time=dt, n_nodes=int(g.n_nodes[0]), n_edges=int(g.n_edges[0]))
    return results


def growing_geometry_sweep(
        predictors: Dict[str, Callable],
        radii: Sequence[float] = (0.6, 1.0, 2.0, 4.0, 5.0),
        n_meshes=3, hsize: float = 0.08, seed: int = 0,
        out_dir: Optional[str] = None, device=None, warmup: bool = True,
        families: Sequence[str] = ("psignn", "dss"), pallas: bool = False
        ) -> Dict[str, Dict[float, Dict[str, float]]]:
    """The radius sweep: ``n_meshes`` (an int, or one count per radius)
    fresh meshes per radius, every predictor on every mesh, means per
    radius.  ``families`` are the sample forms built for each mesh, in
    RCM node order with ``pallas``.  Graphs go to ``device`` (default:
    ``default_device()``)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    acc: Dict[str, Dict[float, List[Dict[str, float]]]] = {
        name: {r: [] for r in radii} for name in predictors}
    if isinstance(n_meshes, int):
        counts = {r: n_meshes for r in radii}
    else:
        counts = {r: int(c) for r, c in zip(radii, n_meshes)}

    for radius in radii:
        for _ in range(counts[radius]):
            mesh = blob_mesh(radius=radius, hsize=hsize, rng=rng)
            data = build_data(mesh, radius, rng, families, pallas)
            graphs = {k: batch_graphs([v], device=device)
                      for k, v in data.items()}
            for name, m in test_sample(predictors, graphs, warmup).items():
                acc[name][radius].append(m)

    summary: Dict[str, Dict[float, Dict[str, float]]] = {}
    for name, per_radius in acc.items():
        summary[name] = {}
        for r, items in per_radius.items():
            keys = items[0].keys()
            summary[name][r] = {k: float(np.mean([it[k] for it in items]))
                                for k in keys}
            summary[name][r].update({k + "_std":
                                     float(np.std([it[k] for it in items]))
                                     for k in keys})

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for name, per_radius in summary.items():
            rs = sorted(per_radius.keys())
            with open(os.path.join(out_dir, f"{name}_results.csv"), "w") as f:
                f.write("metric," + ",".join(str(r) for r in rs) + "\n")
                for metric in ["n_nodes", "mse", "res", "rel", "nstep",
                               "time"]:
                    f.write(metric + "," + ",".join(
                        "{:.6g}".format(per_radius[r][metric]) for r in rs)
                        + "\n")
    return summary


def geometry_zoo_eval(predictors: Dict[str, Callable], hsize: float = 0.08,
                      seed: int = 0, shapes: Optional[Sequence[str]] = None,
                      families: Sequence[str] = ("psignn",), device=None,
                      warmup: bool = True, pallas: bool = False
                      ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Out-of-distribution generalisation over the geometry zoo (the
    reference's ``tests/special_geo`` studies): each shape of ``shapes``
    (default: all, sorted) meshed at ``hsize``, FEM-solved at radius 1
    with ``np.random.default_rng(seed)``'s numbers, and answered by every
    predictor as ``test_sample`` answers it, in RCM node order with
    ``pallas``.  Returns ``{shape: {model: metrics}}``."""
    from .geometries import GEOMETRY_BUILDERS, build_geometry
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    results = {}
    for name in shapes or sorted(GEOMETRY_BUILDERS):
        data = build_data(build_geometry(name, hsize=hsize), 1.0, rng,
                          families, pallas)
        graphs = {k: batch_graphs([v], device=device)
                  for k, v in data.items()}
        results[name] = test_sample(predictors, graphs, warmup)
    return results


def test_several_init(predict_fn: Callable, sample: dict,
                      inits: Sequence[str] = ("zero", "default", "random",
                                              "solution"),
                      seed: int = 0, device=None
                      ) -> Dict[str, Dict[str, float]]:
    """Robustness to the starting point (spec_geo.py:375-409): the sample
    answered from x = 0, from its own x (the Dirichlet initialisation),
    from uniform noise in [−10, 10] (``np.random.default_rng(seed)``'s, as
    JAX draws it) and from the exact solution.  Returns ``{init: {"mse",
    "res"}}``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for mode in inits:
        s = dict(sample)
        x = np.array(s["x"])
        if mode == "zero":
            x = np.zeros_like(x)
        elif mode == "random":
            x = rng.uniform(-10, 10, x.shape).astype(x.dtype)
        elif mode == "solution":
            x = np.array(s["sol"])
        s["x"] = x
        g = batch_graphs([s], device=device)
        res = predict_fn(g)
        u = res[0] if isinstance(res, tuple) else res
        m = errors_batch(u, g)
        out[mode] = dict(mse=float(m["mse"][0]), res=float(m["res"][0]))
    return out
