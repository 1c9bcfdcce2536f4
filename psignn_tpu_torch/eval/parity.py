"""Parity report: the paper's growing-geometry table from checkpoints run
through this package.

Port of ``psignn_tpu/eval/parity.py``: the reference's checkpoints
(converted by ``compat``) or this repository's trained ones (``results/``)
answer freshly generated meshes at the benchmark radii, and the report
sets the means beside the reference's published numbers (BASELINE.md):

* Ψ-GNN fixed-point iteration counts per radius (35 / 67 / 200 / 520 / 531)
* MSE against the FEM solution per radius and per model family
* DS-GPS and DSS inference at their benchmark k (100 and 30)

As in JAX, every predictor runs a config built afresh, not the
checkpoint's: Broyden at ``fw_tol`` / ``fw_thres`` (the backward cap equal
to the forward's), DS-GPS at k = 100, DSS at k = 30.  The sweep's CSVs go
to ``--csv_dir``, with JAX's comparison figure ``radius_comparison.png``
(``vis.plot_radius_comparison``; matplotlib, imported when it draws).
``--pallas`` puts the sweep's samples in reverse Cuthill-McKee node order
(1 on, 0 off, -1 on for a card and off on the CPU, as JAX's default
follows its backend); the report's protocol line says ``pallas=``.  The
report goes to ``results/eval/PARITY_torch.md`` by default, not to JAX's
``PARITY.md``, which is the JAX package's record.

    python -m psignn_tpu_torch.eval.parity
    python -m psignn_tpu_torch.eval.parity --device cpu --radii 0.6 \\
        --n_meshes 1 --out /tmp/parity.md

It reads the reference's checkpoints only (``CKPTS``, under
``registry.REF``) and prints a skip line without them;
``build_predictors(source="trained")`` serves the trained ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from .. import resolve_device
from .curves import device_name
from .registry import REF, REPO

CKPTS = {
    "psignn": os.path.join(
        REF, "dirichlet/psignn/results/constant_dataset/ckpt/best_model.pt"),
    "dsgps": os.path.join(
        REF, "dirichlet/dsgps/results/constant_dataset/30_ite_gamma_0_9/"
        "ckpt/best_model.pt"),
    "dss": os.path.join(
        REF, "dirichlet/dss/results/dss_results/ckpt/best_model.pt"),
}

BASELINE_MSE = {  # tests/txtresults/*_results.csv row 2 (BASELINE.md)
    "psignn": {0.6: 6.04e-3, 1.0: 7.61e-3, 2.0: 0.702, 4.0: 67.7, 5.0: 177.8},
    "dss": {0.6: 0.0145, 1.0: 0.0318, 2.0: 10.9, 4.0: 200.1, 5.0: 531.6},
    "dsgps": {0.6: 0.0365, 1.0: 0.218, 2.0: 4.00, 4.0: 149.3, 5.0: 442.4},
}
BASELINE_NSTEP = {0.6: 35.0, 1.0: 67.2, 2.0: 199.8, 4.0: 519.8, 5.0: 531.2}

TRAINED_CKPTS = {
    "psignn": os.path.join(REPO, "results/psignn_dirichlet/ckpt/best_model.ckpt"),
    "dsgps": os.path.join(REPO, "results/dsgps_dirichlet/ckpt/best_model.ckpt"),
    "dss": os.path.join(REPO, "results/dss_dirichlet/ckpt/best_model.ckpt"),
}


def predictor_configs(fw_thres: int = 600, fw_tol: float = 1e-5) -> dict:
    """{family: config} of the benchmark, built afresh as JAX builds them
    (``parity.py:91``, ``:97``, ``:102``): the published sweep's Ψ-GNN
    settings are fw_tol 1e-5 / fw_thres 1500 (spec_geo_2.py:302-303), its
    DS-GPS runs k = 100 (spec_geo_2.py:268)."""
    from ..models import DsgpsConfig, DssConfig, PsignnConfig
    return {"psignn": PsignnConfig(solver="broyden", fw_tol=fw_tol,
                                   fw_thres=fw_thres, bw_thres=fw_thres),
            "dsgps": DsgpsConfig(k=100),
            "dss": DssConfig(k=30)}


def build_predictors(fw_thres: int = 600, fw_tol: float = 1e-5,
                     source: str = "reference", device=None) -> dict:
    """{family: predict} for each family whose checkpoint exists, on
    ``device`` (default: the card).  ``source='reference'``: the
    reference's ``.pt`` converted by ``compat`` (the parity protocol);
    ``'trained'``: this repository's trained best checkpoint, through
    ``run_eval.load_predictor`` with overrides that make its config the
    fresh one.  Each ``predict(graph)`` answers as ``load_predictor``'s
    does and carries the config it runs as ``predict.cfg``."""
    from ..models import dsgps_inference, dss_inference, psignn_inference
    from ..weights import FAMILIES
    from .run_eval import load_predictor

    device = resolve_device(device)
    infer = {"psignn": psignn_inference, "dsgps": dsgps_inference,
             "dss": dss_inference}
    preds = {}
    for family, cfg in predictor_configs(fw_thres, fw_tol).items():
        if source == "trained":
            path = TRAINED_CKPTS[family]
            if not os.path.exists(path):
                continue
            predict, _, cfg, _ = load_predictor(
                path, device, overrides=dataclasses.asdict(cfg))
        else:
            path = CKPTS[family]
            if not os.path.exists(path):
                continue
            from ..compat import convert_reference_checkpoint
            params = convert_reference_checkpoint(path, family,
                                                  device="cpu")["params"]
            model = FAMILIES[family][0](cfg, device=device)
            model.load_state_dict(params)
            model.eval()

            def predict(graph, model=model, cfg=cfg, infer=infer[family]):
                return infer(model, graph, cfg)
        predict.cfg = cfg
        preds[family] = predict
    return preds


def write_report(summary, path: str, protocol: str = "", device=None):
    """The per-family tables of a sweep's ``summary`` at ``path``, beside
    the reference's numbers; the text names ``device`` (default: this
    host's first card, or the CPU)."""
    lines = ["# PARITY — checkpoints in psignn_tpu_torch", ""]
    lines.append("Checkpoints (the reference's, converted by "
                 "`psignn_tpu_torch.compat`, or this repository's trained "
                 "ones) run through psignn_tpu_torch's models and solvers "
                 f"on {device_name(device)}, on freshly generated meshes; "
                 "baselines from BASELINE.md.")
    if protocol:
        lines.append("")
        lines.append(protocol)
    lines.append("")
    for name, per_radius in summary.items():
        lines.append(f"## {name}")
        lines.append("")
        lines.append("| radius | nodes | MSE (ours) | MSE (reference) | "
                     "nstep (ours) | nstep (ref) | time (s) |")
        lines.append("|---|---|---|---|---|---|---|")
        for r in sorted(per_radius):
            m = per_radius[r]
            ref_mse = BASELINE_MSE.get(name, {}).get(r, float("nan"))
            ref_ns = BASELINE_NSTEP.get(r, float("nan")) \
                if name == "psignn" else float("nan")
            lines.append(
                "| {:.1f} | {:.0f} | {:.3e} | {:.3e} | {:.1f} | {} | {:.3f} |"
                .format(r, m["n_nodes"], m["mse"], ref_mse, m["nstep"],
                        ref_ns, m["time"]))
        lines.append("")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description="psignn_tpu_torch parity report")
    p.add_argument("--radii", type=float, nargs="+", default=[0.6, 1.0])
    p.add_argument("--n_meshes", type=int, nargs="+", default=[3],
                   help="meshes per radius; one value (applied to all radii)"
                        " or one per radius")
    p.add_argument("--fw_thres", type=int, default=600)
    p.add_argument("--fw_tol", type=float, default=1e-5)
    p.add_argument("--out", type=str,
                   default="results/eval/PARITY_torch.md")
    p.add_argument("--csv_dir", type=str, default="",
                   help="also write {family}_results.csv sweep tables here")
    p.add_argument("--families", type=str, nargs="+",
                   default=["psignn", "dsgps", "dss"])
    p.add_argument("--pallas", type=int, default=-1,
                   help="1: RCM node order (default on a card), 0: mesh "
                        "order (default on the CPU)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from .run_eval import pallas_order
    from .sweep import growing_geometry_sweep

    pallas = pallas_order(args.pallas, args.device)
    preds = build_predictors(args.fw_thres, args.fw_tol, device=args.device)
    preds = {k: v for k, v in preds.items() if k in args.families}
    if not preds:
        print("no reference checkpoints found; skipping")
        return
    fams = ("psignn", "dss") if "dss" in preds else ("psignn",)
    n_meshes = (args.n_meshes[0] if len(args.n_meshes) == 1
                else args.n_meshes)
    summary = growing_geometry_sweep(preds, radii=args.radii,
                                     n_meshes=n_meshes, families=fams,
                                     out_dir=args.csv_dir or None,
                                     device=args.device, pallas=pallas)
    if args.csv_dir:
        from .vis import plot_radius_comparison
        plot_radius_comparison(args.csv_dir,
                               os.path.join(args.csv_dir,
                                            "radius_comparison.png"))
    proto = ("Protocol: radii {} with {} meshes per radius respectively "
             "(reference: tests/test_multiple.py, 3 meshes/radius), "
             "fw_thres {}, fw_tol {}, pallas={}. Times are wall-clock "
             "seconds of one request, synchronised with the device on both "
             "ends, after a warm-up request.".format(
                 args.radii, args.n_meshes, args.fw_thres, args.fw_tol,
                 int(pallas)))
    path = write_report(summary, args.out, protocol=proto,
                        device=resolve_device(args.device))
    print("wrote", path)


if __name__ == "__main__":
    main()
