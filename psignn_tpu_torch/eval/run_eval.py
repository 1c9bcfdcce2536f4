"""Checkpoint evaluation CLI: the growing-geometry sweep of a Ψ-GNN
checkpoint on the GPU.

Port of ``psignn_tpu/eval/run_eval.py`` (``load_predictor`` and
``--sweep``).  The test-split table is not ported yet.

    python -m psignn_tpu_torch.eval.run_eval \\
        --ckpt results/psignn_dirichlet/ckpt/best_model.ckpt --sweep
"""

from __future__ import annotations

import argparse
import json

from .. import resolve_device


def load_predictor(ckpt_path: str, device=None, overrides=None):
    """(predict_fn, family, cfg, model) from a Ψ-GNN checkpoint, the JAX
    package's or one the port trained; ``predict_fn(graph)`` returns
    ``psignn_inference``'s tuple."""
    from ..models import psignn_inference
    from ..weights import load_psignn_checkpoint

    model, cfg = load_psignn_checkpoint(ckpt_path, resolve_device(device),
                                        overrides)

    def predict(graph):
        return psignn_inference(model, graph, cfg)

    return predict, "psignn", cfg, model


def main(argv=None):
    p = argparse.ArgumentParser(description="psignn_tpu_torch checkpoint eval")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--sweep", action="store_true",
                   help="run the growing-geometry radius sweep (required: "
                        "the test-split table is not yet ported)")
    p.add_argument("--radii", type=float, nargs="+",
                   default=[0.6, 1.0, 2.0, 4.0, 5.0])
    p.add_argument("--n_meshes", type=int, default=3)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if not args.sweep:
        p.error("only --sweep is ported; the test-split table is not yet "
                "ported")

    from .sweep import growing_geometry_sweep

    predict, family, _, _ = load_predictor(args.ckpt, args.device)
    summary = growing_geometry_sweep(
        {family: predict}, radii=args.radii, n_meshes=args.n_meshes,
        out_dir=args.out or None, device=args.device)
    print(json.dumps(summary, indent=2, default=float))


if __name__ == "__main__":
    main()
