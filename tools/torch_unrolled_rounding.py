"""How far rounding alone moves the port's unrolled families (DSS, DS-GPS
Dirichlet and mixed): their trained checkpoints' inference and one
``unrolled_train_step`` on the 2-mesh batch that ``chip_smoke.py``
compares across devices, in float32 against float64 on the CPU.

    python tools/torch_unrolled_rounding.py

Prints, per case, the largest difference in u (against max|u|), the
largest relative difference of a loss, and the largest difference of a
parameter's gradient, relative to that parameter's gradient norm and to
the step's whole gradient norm.  These size ``chip_smoke.py``'s
GPU-vs-CPU tolerances: two f32 orders of summation differ from each other
by about as much as each differs from f64.  A CPU measurement of
numerics, not of any device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from psignn_tpu_torch.data.fem import (solve_poisson,  # noqa: E402
                                       solve_poisson_mixed)
from psignn_tpu_torch.data.meshgen import (blob_mesh,  # noqa: E402
                                           mixed_blob_mesh)
from psignn_tpu_torch.data.reader import (dss_sample_from_fem,  # noqa: E402
                                          psignn_sample_from_fem)
from psignn_tpu_torch.graphs import batch_graphs  # noqa: E402
from psignn_tpu_torch.models import (dsgps_inference,  # noqa: E402
                                     dss_inference)
from psignn_tpu_torch.train import make_adam, unrolled_train_step  # noqa
from psignn_tpu_torch.weights import load_model_checkpoint  # noqa: E402


def batch(variant: str, form: str, dtype):
    """``chip_smoke.train_graph(CMP_MESHES, 1, ...)``'s meshes, in
    ``dtype``."""
    make, solve = ((mixed_blob_mesh, solve_poisson_mixed)
                   if variant == "mixed" else (blob_mesh, solve_poisson))
    rng = np.random.default_rng(1)
    samples = []
    for _ in range(chip_smoke.CMP_MESHES):
        s = solve(make(radius=1.0, hsize=0.08, rng=rng), 1.0, rng)
        samples.append(dss_sample_from_fem(s) if form == "dss"
                       else psignn_sample_from_fem(s, variant=variant))
    return batch_graphs(samples, device="cpu", dtype=dtype)


def run(ckpt: str, form: str, variant: str, lr: float, dtype):
    family, model, cfg = load_model_checkpoint(ckpt, "cpu")
    if dtype == np.float64:
        model = model.double()
    graph = batch(variant, form, dtype)
    infer = dss_inference if family == "dss" else dsgps_inference
    u = infer(model, graph, cfg).double()
    res = unrolled_train_step(model, make_adam(model, lr), graph, cfg, lr,
                              chip_smoke.UNROLLED_CLIP)
    grads = {k: p.grad.double() for k, p in model.named_parameters()
             if p.grad is not None}
    return u, res.losses, grads


def main() -> None:
    for case, ckpt, form, variant, lr in chip_smoke.UNROLLED_CASES:
        u32, l32, g32 = run(ckpt, form, variant, lr, np.float32)
        u64, l64, g64 = run(ckpt, form, variant, lr, np.float64)
        total = float(torch.sqrt(sum(g.square().sum() for g in g64.values())))
        diff = {k: float((g32[k] - g64[k]).norm()) for k in g64}
        own = {k: diff[k] / max(float(g64[k].norm()), 1e-30) for k in g64}
        print(f"{case}: u {float((u32 - u64).abs().max()):.3g} of max|u| "
              f"{float(u64.abs().max()):.4g}; losses "
              f"{max(abs(l32[k] - l64[k]) / abs(l64[k]) for k in l64):.3g}; "
              f"gradient {max(own.values()):.3g} of its own norm "
              f"({max(own, key=own.get)}), "
              f"{max(diff.values()) / total:.3g} of the whole norm")


if __name__ == "__main__":
    main()
