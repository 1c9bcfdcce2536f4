"""Entry points of the port: one training forward of Ψ-GNN
on one card, and the multi-rank dry run.

The analog of ``__graft_entry__.py``: ``entry`` gives the same tiny
samples (two seeded radius-1 blob meshes at hsize 0.3) and the same
config (Broyden, fw 1e-4 / 40, bw 1e-6 / 40) as its ``entry``;
``dryrun_multichip`` runs ``dist.dryrun`` on N ranks.  Imports no JAX.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

# ``__graft_entry__.entry``'s solver settings
ENTRY_CFG = dict(solver="broyden", fw_tol=1e-4, fw_thres=40, bw_tol=1e-6,
                 bw_thres=40)


def tiny_samples(n_meshes: int = 2, hsize: float = 0.3,
                 seed: int = 0) -> List[dict]:
    """``n_meshes`` seeded radius-1 blob meshes, FEM-solved, as Ψ-GNN
    samples normalised with the reference statistics."""
    from .data.fem import solve_poisson
    from .data.meshgen import blob_mesh
    from .data.reader import psignn_sample_from_fem
    rng = np.random.default_rng(seed)
    return [psignn_sample_from_fem(solve_poisson(
        blob_mesh(radius=1.0, hsize=hsize, rng=rng), 1.0, rng))
        for _ in range(n_meshes)]


def entry(device=None):
    """(fn, example_args): ``fn(model, graph, generator)`` is one training
    forward of a seeded Ψ-GNN (the DEQ solve, its implicit backward
    attached, the losses) returning (the loss the train step minimises,
    u); the arguments live on ``device`` (default the card)."""
    from . import resolve_device
    from .graphs import batch_graphs
    from .models import Psignn, PsignnConfig, psignn_forward
    dev = resolve_device(device)
    cfg = PsignnConfig(**ENTRY_CFG)
    model = Psignn(cfg, generator=torch.Generator().manual_seed(0),
                   device=dev)
    graph = batch_graphs(tiny_samples(), device=dev)

    def fn(model, graph, generator):
        out = psignn_forward(model, graph, cfg, generator, training=True)
        losses = out.losses
        loss = (losses["residual_loss"] + losses["jacobian_loss"]
                + losses["encoder_loss"] + losses["autoencoder_loss"])
        return loss, out.u_final

    return fn, (model, graph, torch.Generator().manual_seed(1))


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Every multi-device path on ``n_devices`` spawned ranks
    (``python -m psignn_tpu_torch.dist.dryrun``); ``device`` as its
    ``--device``: ``cuda`` (rank r on ``cuda:r``), ``cuda:K`` or ``cpu``."""
    from .dist import dryrun
    dryrun.main(["--num_devices", str(n_devices), "--device", device])


if __name__ == "__main__":
    fn, args = entry()
    print("entry loss:", float(fn(*args)[0]))
    dryrun_multichip(torch.cuda.device_count())
