"""Checkpoint evaluation CLI: the test-split table, the growing-geometry
sweep and the geometry zoo of a Ψ-GNN, DS-GPS or DSS checkpoint on the
GPU.

Port of ``psignn_tpu/eval/run_eval.py`` (``load_predictor``, the test-split
table, ``--sweep`` and ``--zoo``)::

    python -m psignn_tpu_torch.eval.run_eval \\
        --ckpt results/psignn_mixed/ckpt/best_model.ckpt --variant mixed \\
        --path_dataset data/mixed --out results/eval/
    python -m psignn_tpu_torch.eval.run_eval \\
        --ckpt results/dss_dirichlet/ckpt/best_model.ckpt --sweep --zoo

The checkpoint's ``family`` picks the model.  ``--path_dataset`` asks for
the table: the dataset is loaded in the family's sample form (DSS reads
``A_prime``/``b_prime``), split as the trainer splits it at its default
seed (``split_dataset``, which orders DSS's parts train | test | val), and
its test part is answered in batches of ``--batch_size``; the table is
printed and, with ``--out``, written to ``test_metrics.json``.  The JAX
CLI reads ``data/`` unless told otherwise; here the table runs only when a
dataset is named.  ``--sweep`` builds Dirichlet samples (2-column problem
data, no normals; DSS's A′ form as well for a DSS checkpoint), so it takes
a Dirichlet checkpoint only; so does ``--zoo``, which answers each of the
12 shapes of ``geometries`` (hsize 0.08) and, with ``--out``, writes
``geometry_zoo.json``.  ``--pallas`` puts the sweep's and the zoo's
samples in reverse Cuthill-McKee node order, as JAX's switch of the same
name does: 1 on, 0 off, -1 (default) on when the device is a card, off on
the CPU, as JAX's default follows its backend.  The test-split table keeps
the mesh order, as JAX's does.
"""

from __future__ import annotations

import argparse
import json
import os

from .. import resolve_device


def load_predictor(ckpt_path: str, device=None, overrides=None):
    """(predict_fn, family, cfg, model) from a checkpoint of any family,
    Dirichlet or mixed, the JAX package's or one the port trained;
    ``predict_fn(graph)`` returns ``psignn_inference``'s tuple (Ψ-GNN) or
    the solution u (DS-GPS, DSS)."""
    from ..models import dsgps_inference, dss_inference, psignn_inference
    from ..weights import load_model_checkpoint

    family, model, cfg = load_model_checkpoint(
        ckpt_path, resolve_device(device), overrides)
    infer = {"psignn": psignn_inference, "dsgps": dsgps_inference,
             "dss": dss_inference}[family]

    def predict(graph):
        return infer(model, graph, cfg)

    return predict, family, cfg, model


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="psignn_tpu_torch checkpoint eval")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--path_dataset", type=str, default=None,
                   help="dataset whose test split is tabled")
    p.add_argument("--variant", type=str, default="dirichlet",
                   choices=["dirichlet", "mixed"])
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--sweep", action="store_true",
                   help="run the growing-geometry radius sweep (Dirichlet "
                        "checkpoints)")
    p.add_argument("--zoo", action="store_true",
                   help="run the out-of-distribution geometry zoo "
                        "(Dirichlet checkpoints)")
    p.add_argument("--radii", type=float, nargs="+",
                   default=[0.6, 1.0, 2.0, 4.0, 5.0])
    p.add_argument("--n_meshes", type=int, default=3)
    p.add_argument("--pallas", type=int, default=-1,
                   help="1: RCM node order for --sweep and --zoo (default "
                        "on a card), 0: mesh order (default on the CPU)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p


def pallas_order(flag: int, device) -> bool:
    """Whether ``--pallas flag`` asks for RCM order on ``device``: -1
    follows the device, on for a card and off for the CPU (JAX
    ``run_eval.py:71-72``)."""
    return (resolve_device(device).type == "cuda" if flag < 0
            else bool(flag))


def main(argv=None):
    p = get_parser()
    args = p.parse_args(argv)
    if args.path_dataset is None and not (args.sweep or args.zoo):
        p.error("give --path_dataset for the test-split table, --sweep "
                "and/or --zoo")

    predict, family, cfg, _ = load_predictor(args.ckpt, args.device)
    pallas = pallas_order(args.pallas, args.device)
    mode = getattr(cfg, "bc_mode", "dirichlet")     # DSS: Dirichlet only
    if args.path_dataset is not None and mode != args.variant:
        p.error(f"the checkpoint is a {mode} model; its test split "
                f"needs --variant {mode}")
    if (args.sweep or args.zoo) and mode != "dirichlet":
        p.error(f"--sweep and --zoo build Dirichlet samples (2-column "
                f"problem data, no normals); a {mode} checkpoint cannot "
                f"answer them")

    def u_only(graph):
        out = predict(graph)
        return out[0] if isinstance(out, tuple) else out

    if args.path_dataset is not None:
        from ..data.reader import GraphLoader, load_dataset, split_dataset
        from .metrics import evaluate_dataset
        _, _, test = split_dataset(
            load_dataset(args.path_dataset, family=family,
                         variant=args.variant),
            family=family, variant=args.variant)
        loader = GraphLoader(test, batch_size=args.batch_size,
                             device=args.device)
        results = evaluate_dataset(u_only, loader, name=family)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "test_metrics.json"), "w") as f:
                json.dump(results, f, indent=2)

    forms = ("psignn", "dss") if family == "dss" else ("psignn",)
    if args.sweep:
        from .sweep import growing_geometry_sweep
        summary = growing_geometry_sweep(
            {family: predict}, radii=args.radii, n_meshes=args.n_meshes,
            out_dir=args.out or None, device=args.device, families=forms,
            pallas=pallas)
        print(json.dumps(summary, indent=2, default=float))

    if args.zoo:
        from .sweep import geometry_zoo_eval
        zoo = geometry_zoo_eval({family: predict}, families=forms,
                                device=args.device, pallas=pallas)
        print(json.dumps(zoo, indent=2, default=float))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "geometry_zoo.json"), "w") as f:
                json.dump(zoo, f, indent=2, default=float)


if __name__ == "__main__":
    main()
