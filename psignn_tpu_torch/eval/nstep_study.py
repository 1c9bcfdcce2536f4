"""The nstep study: Ψ-GNN's fixed-point iteration counts on the
reference's own gmsh meshes against this repository's mesh generator.

Port of ``psignn_tpu/eval/nstep_study.py``.  One Ψ-GNN checkpoint, with
identical solver settings, answers several right-hand sides on each of

* the reference's gmsh-generated radius-1 meshes (the checked-in
  DOLFIN-HDF5 files of ``tests/special_geo/build_mesh.py``, the generator
  the published sweep used), read by ``mesh_from_dolfin_h5`` when they
  are present under ``registry.REF``, and
* three radius-1 blob meshes and one circle mesh of ``data.meshgen``,

so a gap between this generator's nstep and the published per-radius
means (35 / 67.2) can be told apart from the model and the solver.  JAX's
RCM reordering for its TPU kernels has no counterpart here: ``--pallas``
is accepted and ignored.  The report goes to
``results/eval/nstep_gap_torch.md`` by default, not to JAX's
``docs/nstep_gap.md``, which is the JAX package's record.

    python -m psignn_tpu_torch.eval.nstep_study
    python -m psignn_tpu_torch.eval.nstep_study --device cpu --n_samples 2

Like JAX's, ``main`` runs the reference's checkpoint and prints a skip
line without it; ``study`` takes any Ψ-GNN predictor, such as
``parity.build_predictors(source="trained")["psignn"]``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import resolve_device
from .registry import REF

REF_MESHES = {
    "gmsh_original_r1": os.path.join(
        REF, "tests/special_geo/mesh_files/original/mesh.h5"),
    "gmsh_saved_r1": os.path.join(REF, "tests/special_geo/saved_mesh/mesh.h5"),
}


def eval_mesh(predict, mesh, radius: float, n_samples: int, seed: int,
              device=None):
    """Mean nstep / lowest / MSE / a_ij std over ``n_samples`` right-hand
    sides drawn from ``np.random.default_rng(seed)`` on one fixed mesh,
    each answered on ``device`` (default: the card) by ``predict``, a
    Ψ-GNN predictor returning ``psignn_inference``'s tuple."""
    from ..data.fem import solve_poisson
    from ..data.reader import psignn_sample_from_fem
    from ..graphs import batch_graphs
    from .metrics import errors_batch

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_samples):
        s = psignn_sample_from_fem(solve_poisson(mesh, radius, rng))
        g = batch_graphs([s], device=device)
        u, nstep, lowest = predict(g)[:3]
        m = errors_batch(u, g)
        a_std = float(np.std(np.asarray(s["a_ij"])))
        rows.append(dict(nstep=int(nstep), lowest=float(lowest),
                         mse=float(m["mse"][0]), a_std=a_std))
    out = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    out["nstep_std"] = float(np.std([r["nstep"] for r in rows]))
    out["n_nodes"] = mesh.n_points
    return out


def study(predict, n_samples: int = 8, device=None) -> dict:
    """``eval_mesh`` on JAX ``main``'s meshes: each gmsh mesh of
    ``REF_MESHES`` that exists (seed 0), three radius-1 blob meshes of
    ``default_rng(1)`` (seeds 10–12) and ``circle_mesh(seed=3)`` (seed
    20), all at hsize 0.08."""
    from ..data.meshgen import blob_mesh, circle_mesh, mesh_from_dolfin_h5

    results = {}
    for name, path in REF_MESHES.items():
        if os.path.exists(path):
            results[name] = eval_mesh(predict, mesh_from_dolfin_h5(path),
                                      1.0, n_samples, seed=0, device=device)
    rng = np.random.default_rng(1)
    for i in range(3):
        results[f"ours_blob_r1_{i}"] = eval_mesh(
            predict, blob_mesh(radius=1.0, hsize=0.08, rng=rng), 1.0,
            n_samples, seed=10 + i, device=device)
    results["ours_circle_r1"] = eval_mesh(
        predict, circle_mesh(radius=1.0, hsize=0.08, seed=3), 1.0,
        n_samples, seed=20, device=device)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="psignn_tpu_torch nstep study")
    p.add_argument("--n_samples", type=int, default=8)
    p.add_argument("--fw_thres", type=int, default=600)
    p.add_argument("--fw_tol", type=float, default=1e-5)
    p.add_argument("--out", type=str,
                   default="results/eval/nstep_gap_torch.md")
    p.add_argument("--pallas", type=int, default=0,
                   help="the JAX package's TPU kernels switch: ignored")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from .parity import BASELINE_NSTEP, build_predictors

    preds = build_predictors(args.fw_thres, args.fw_tol, device=args.device)
    if "psignn" not in preds:
        print("reference psignn checkpoint not found; skipping")
        return
    results = study(preds["psignn"], args.n_samples, args.device)

    lines = [
        "# nstep gap root-cause: reference gmsh meshes vs our generator",
        "",
        "Converted reference psignn checkpoint in psignn_tpu_torch, "
        f"identical solver settings (broyden, fw_tol {args.fw_tol}, "
        f"fw_thres {args.fw_thres} — the published protocol's "
        f"spec_geo_2.py:302-303 values), {args.n_samples} RHS draws per "
        f"mesh.  Reference published mean nstep at r=1.0: "
        f"{BASELINE_NSTEP[1.0]} (tests/txtresults/psignn_results.csv:7).",
        "",
        "| mesh | nodes | nstep (mean ± std) | MSE | a_ij std |",
        "|---|---|---|---|---|",
    ]
    for name, r in results.items():
        lines.append("| {} | {} | {:.1f} ± {:.1f} | {:.3e} | {:.4f} |".format(
            name, r["n_nodes"], r["nstep"], r["nstep_std"], r["mse"],
            r["a_std"]))
    lines.append("")
    gm = [r for k, r in results.items() if k.startswith("gmsh")]
    ours = [r for k, r in results.items() if k.startswith("ours")]
    if gm and ours:
        gm_n = float(np.mean([r["nstep"] for r in gm]))
        our_n = float(np.mean([r["nstep"] for r in ours]))
        lines.append(
            "Mean nstep on the reference's own gmsh meshes: {:.1f}; on our "
            "generator: {:.1f}; published reference mean: {:.1f}.".format(
                gm_n, our_n, BASELINE_NSTEP[1.0]))
        lines.append("")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print("wrote", args.out)
    for name, r in results.items():
        print(name, r)


if __name__ == "__main__":
    main()
