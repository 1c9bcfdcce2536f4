"""The paper figures from this repository's trained checkpoints: Ψ-GNN and
DS-GPS iterate montages and paper composites, and the training-curve
comparison against the reference.

Port of ``tools/make_figures.py``, with its figures and file names
(``psignn_iter_montage.png``, ``psignn_paper.png``,
``dsgps[_mixed]_iter_montage.png``, ``dsgps[_mixed]_paper.png``,
``training_comparison[_mse].png``).  The iterate traces are computed by
``psignn_trace`` and ``dsgps_trace`` — on the card unless the caller asks
for the CPU, every iterate through the fused message-passing kernel —
and returned as numpy arrays; ``eval.vis`` draws them, with matplotlib,
imported only when it draws.  A host without matplotlib (the card's) can
compute the traces and draws nothing.

The sample is the first validation sample of ``<path_data>/dirichlet``
or ``<path_data>/mixed`` when that dataset exists, as JAX reads
``data/``; otherwise a fresh sample of the data factory
(``factory_sample``).  The figures go to ``results/figures_torch/`` by
default, not to ``docs/figures/``, which holds the JAX package's.

    python -m psignn_tpu_torch.eval.figures --device cpu --out /tmp/fig
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import numpy as np

from .. import resolve_device
from .registry import OUR_CURVES, REF_CURVES, REPO

PSIGNN_CKPT = os.path.join(REPO,
                           "results/psignn_dirichlet/ckpt/best_model.ckpt")
DSGPS_CKPTS = {
    "dirichlet": os.path.join(REPO,
                              "results/dsgps_dirichlet/ckpt/best_model.ckpt"),
    "mixed": os.path.join(REPO, "results/dsgps_mixed/ckpt/best_model.ckpt"),
}
# the Ψ-GNN trace's forward cap (JAX make_figures.py: fw_thres 300)
PSIGNN_FW_THRES = 300


def load_val_sample(path_data: str, family: str, variant: str,
                    idx: int = 0):
    """Sample ``idx`` of the validation split of a dataset directory."""
    from ..data.reader import load_dataset, split_dataset
    samples = load_dataset(path_data, family=family, variant=variant)
    _, val, _ = split_dataset(samples, family=family, variant=variant)
    return val[idx]


def factory_sample(variant: str = "dirichlet", seed: int = 0,
                   radius: float = 1.0, hsize: float = 0.08):
    """One Ψ-GNN / DS-GPS sample of the data factory: the first that
    ``generate_data(seed=seed)`` makes (a blob mesh, with Neumann arcs in
    the mixed variant, and one FEM solve), at the dataset's default size."""
    from ..data.fem import solve_poisson, solve_poisson_mixed
    from ..data.meshgen import blob_mesh, mixed_blob_mesh
    from ..data.reader import psignn_sample_from_fem
    make_mesh, solve = ((mixed_blob_mesh, solve_poisson_mixed)
                        if variant == "mixed" else (blob_mesh, solve_poisson))
    rng = np.random.default_rng(seed)
    mesh = make_mesh(radius=radius, hsize=hsize, rng=rng)
    return psignn_sample_from_fem(solve(mesh, radius, rng), variant=variant)


def figure_sample(path_data: str, family: str, variant: str, idx: int = 0):
    """``load_val_sample`` of ``<path_data>/<variant>`` when it exists,
    else ``factory_sample(variant)``; says which."""
    data = os.path.join(path_data, variant)
    if os.path.isdir(data):
        print(f"sample {idx} of the validation split of {data}")
        return load_val_sample(data, family, variant, idx)
    print(f"no dataset at {data}: a fresh factory sample ({variant})")
    return factory_sample(variant)


def psignn_trace(ckpt: str, sample, device=None,
                 **overrides) -> Dict[str, Any]:
    """The Ψ-GNN checkpoint's Broyden solve of one sample on ``device``
    (default: the card), at the checkpoint's settings but fw_thres
    ``PSIGNN_FW_THRES`` and ``overrides`` (e.g. ``fw_tol``): ``u_trace``
    (nstep, n, 1), ``res_trace`` and ``mse_trace`` (nstep,),
    the decoded iterates and their residuals and MSEs against the FEM
    solution (``psignn_iterative_inference``), ``nstep`` and the
    checkpoint's ``epoch``."""
    from ..graphs import batch_graphs
    from ..models import PsignnConfig, psignn_iterative_inference
    from ..weights import load_jax_checkpoint, model_from_jax
    device = resolve_device(device)
    ck = load_jax_checkpoint(ckpt)
    cfg = PsignnConfig.from_hyperparameters(
        ck["hyperparameters"], **{"fw_thres": PSIGNN_FW_THRES, **overrides})
    model = model_from_jax("psignn", ck["params"], cfg, device)
    out = psignn_iterative_inference(
        model, batch_graphs([sample], device=device), cfg)
    nstep, n = int(out["nstep"]), sample["x"].shape[0]
    tr = {k: v[:nstep].cpu().numpy() for k, v in out["trace"].items()}
    return dict(u_trace=tr["u"][:, :n], res_trace=tr["res"],
                mse_trace=tr["mse"], nstep=nstep, epoch=ck["epoch"])


def dsgps_trace(ckpt: str, sample, device=None) -> Dict[str, Any]:
    """The DS-GPS checkpoint's k steps on one sample on ``device``
    (default: the card): ``u_trace`` (k, n, 1) and ``res`` (k,), the
    decoded iterates U_1 … U_k and their residuals
    (``dsgps_iterative_inference``), the checkpoint's ``variant`` and
    ``epoch``."""
    from ..graphs import batch_graphs
    from ..models import DsgpsConfig, dsgps_iterative_inference
    from ..weights import load_jax_checkpoint, model_from_jax
    device = resolve_device(device)
    ck = load_jax_checkpoint(ckpt)
    cfg = DsgpsConfig.from_hyperparameters(ck["hyperparameters"])
    model = model_from_jax("dsgps", ck["params"], cfg, device)
    tr = dsgps_iterative_inference(
        model, batch_graphs([sample], device=device), cfg)
    n = sample["x"].shape[0]
    return dict(u_trace=tr["u_trace"][:, :n].cpu().numpy(),
                res=tr["res"].cpu().numpy(), variant=cfg.bc_mode,
                epoch=ck["epoch"])


def psignn_figures(out: str, ckpt: str = PSIGNN_CKPT, idx: int = 0,
                   path_data: str = "data", device=None) -> None:
    """The Ψ-GNN iterate montage and paper figure of one Dirichlet
    sample (``figure_sample``)."""
    from .vis import plot_iterative_montage, plot_paper_figure
    s = figure_sample(path_data, "psignn", "dirichlet", idx)
    tr = psignn_trace(ckpt, s, device)
    nstep = tr["nstep"]
    plot_iterative_montage(
        s["pos"], tr["u_trace"], os.path.join(out, "psignn_iter_montage.png"),
        sol=s["sol"], res_trace=tr["res_trace"],
        title=f"Ψ-GNN fixed-point iterates (epoch {tr['epoch']} ckpt, "
              f"nstep {nstep})")
    plot_paper_figure(
        s["pos"], s["tags"], tr["u_trace"], s["sol"],
        os.path.join(out, "psignn_paper.png"), res_trace=tr["res_trace"],
        nstep=nstep, title="Ψ-GNN on a validation mesh (trained ckpt)")
    print("psignn figures done (nstep", nstep, ")")


def dsgps_figures(out: str, ckpt: str = DSGPS_CKPTS["dirichlet"],
                  idx: int = 0, path_data: str = "data",
                  device=None) -> None:
    """The DS-GPS iterate montage and paper figure of one sample of the
    checkpoint's variant, named ``dsgps_*`` (Dirichlet) or
    ``dsgps_mixed_*``."""
    from ..models import DsgpsConfig
    from ..weights import load_jax_checkpoint
    from .vis import plot_iterative_montage, plot_paper_figure
    variant = DsgpsConfig.from_hyperparameters(
        load_jax_checkpoint(ckpt)["hyperparameters"]).bc_mode
    s = figure_sample(path_data, "dsgps", variant, idx)
    tr = dsgps_trace(ckpt, s, device)
    res = tr["res"]
    tag = "dsgps" if variant == "dirichlet" else "dsgps_mixed"
    plot_iterative_montage(
        s["pos"], tr["u_trace"], os.path.join(out, f"{tag}_iter_montage.png"),
        sol=s["sol"], res_trace=res,
        title=f"DS-GPS k-unroll iterates (epoch {tr['epoch']} ckpt)")
    plot_paper_figure(
        s["pos"], s["tags"], tr["u_trace"], s["sol"],
        os.path.join(out, f"{tag}_paper.png"), res_trace=res,
        title=f"DS-GPS ({variant}) on a validation mesh (trained ckpt)")
    print(tag, "figures done (final res", float(res[-1]), ")")


def comparison_figures(out: str) -> None:
    """Validation residual and MSE against the epoch, this repository's
    runs (solid) against the reference's (dashed, where its logs are in
    the checkout)."""
    from .vis import plot_training_comparison
    plot_training_comparison(
        OUR_CURVES, os.path.join(out, "training_comparison.png"),
        ref_runs=REF_CURVES,
        title="Validation residual: this framework (solid) vs reference "
              "(dashed)")
    for key, fname in (("MSE", "training_comparison_mse.png"),):
        plot_training_comparison(
            OUR_CURVES, os.path.join(out, fname), ref_runs=REF_CURVES,
            key=key, title=f"Validation {key}: ours (solid) vs reference "
                           "(dashed)")
    print("comparison figures done")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="psignn_tpu_torch paper figures from the trained "
                    "checkpoints")
    p.add_argument("--out", default="results/figures_torch")
    p.add_argument("--skip", nargs="*", default=[],
                   choices=["psignn", "dsgps", "comparison"])
    p.add_argument("--path_data", default="data",
                   help="holds dirichlet/ and mixed/ datasets (default: "
                        "data); without one, a fresh factory sample")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the traces (default: cuda)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if "comparison" not in args.skip:
        comparison_figures(args.out)
    if "psignn" not in args.skip and os.path.exists(PSIGNN_CKPT):
        psignn_figures(args.out, path_data=args.path_data,
                       device=args.device)
    if "dsgps" not in args.skip:
        for ckpt in DSGPS_CKPTS.values():
            if os.path.exists(ckpt):
                dsgps_figures(args.out, ckpt, path_data=args.path_data,
                              device=args.device)


if __name__ == "__main__":
    main()
