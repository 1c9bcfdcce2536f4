"""Multi-rank dry run of the port's multi-device paths.

The analog of ``__graft_entry__.dryrun_multichip`` (``:57-178``): on N
ranks, with seeded random weights and tiny seeded meshes, run

1. a data-parallel Ψ-GNN train step (implicit gradients, the joint clip,
   the dual Adam), one mesh a rank;
2. the edge-sharded message passing over all N ranks, against the plain
   message passing on each rank;
3. the partitioned solve of one RCM-ordered mesh split over all N ranks,
   against the one process's solve of that mesh;
4. a dp × partition train step (dp 2 when N ≥ 4, else 1).

Each rank returns its losses and checks; the run fails if any is not
finite, the sharded message passing disagrees or the partitioned solve
does.  Run it as

    python -m psignn_tpu_torch.dist.dryrun --num_devices 4 --device cpu

(``--device cuda``: rank r on ``cuda:r`` over NCCL; ``--device cuda:K``:
every rank on card K over gloo).
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from . import multihost

# JAX's dry-run solver settings (``__graft_entry__.py:82-83``)
DRYRUN_CFG = dict(solver="broyden", fw_tol=1e-3, fw_thres=12, bw_tol=1e-4,
                  bw_thres=12)


def _samples(n: int, hsize: float, seed: int, one_mesh: bool = False
             ) -> List[dict]:
    """``n`` seeded blob-mesh samples, or ``n`` right-hand sides on one
    mesh."""
    from ..data.fem import solve_poisson
    from ..data.meshgen import blob_mesh
    from ..data.reader import psignn_sample_from_fem
    rng = np.random.default_rng(seed)
    geo = blob_mesh(radius=1.0, hsize=hsize, rng=rng) if one_mesh else None
    return [psignn_sample_from_fem(solve_poisson(
        geo or blob_mesh(radius=1.0, hsize=hsize, rng=rng), 1.0, rng))
        for _ in range(n)]


def _rcm(sample: dict) -> dict:
    from .partition import apply_node_permutation, rcm_permutation
    return apply_node_permutation(sample, rcm_permutation(
        sample["senders"], sample["receivers"], sample["x"].shape[0]))


def dryrun_multichip(device=None, n_parts=None) -> Dict[str, float]:
    """Every multi-device path once on this rank of an initialised world;
    ``device`` is the rank's device, ``n_parts`` the partition of step 4's
    rows (default: N // dp).  Returns the rank's figures."""
    from .. import resolve_device
    from ..graphs import batch_graphs
    from ..models import Psignn, PsignnConfig
    from ..ops import message_passing
    from ..train import make_optimizers, train_step
    from . import (make_mesh, make_partitioned_train_step,
                   partition_message_passing, partitioned_psignn_inference,
                   stack_graphs, stack_partitioned_graphs)
    from .partition import pad_edges_for_sharding
    device = resolve_device(device)
    n = multihost.world_size()
    cfg = PsignnConfig(**DRYRUN_CFG)

    def model():
        return Psignn(cfg, generator=torch.Generator().manual_seed(0),
                      device=device)

    # 1. data-parallel train step
    mesh = make_mesh(device=device)
    samples = _samples(n, 0.35, 0)
    m = model()
    res = train_step(m, make_optimizers(m, 0.01, 0.05),
                     stack_graphs([[s] for s in samples], mesh), cfg,
                     (0.01, 0.05), 0.1, 1.0,
                     torch.Generator().manual_seed(2 + mesh.rank),
                     mesh=mesh)

    # 2. edge-sharded message passing over every rank
    row = multihost.global_mesh(1, n, device)
    g = batch_graphs(samples[:1], device=device)
    arrs = pad_edges_for_sharding(dict(
        senders=g.senders.cpu().numpy(), receivers=g.receivers.cpu().numpy(),
        edge_attr=g.edge_attr.cpu().numpy(),
        edge_mask=np.ones(len(g.senders), bool)), n)
    h = torch.randn((g.total_nodes, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(4)).to(device)
    phi = m.function.layers[0].phi_to
    with torch.no_grad():
        got = partition_message_passing(row)(
            phi, h, arrs["senders"], arrs["receivers"], arrs["edge_attr"],
            arrs["edge_mask"], "to")
        want = message_passing(phi, h, g, "to")
    mp_err = float((got - want).abs().max())

    # 3. one mesh partitioned over every rank, against one process
    s = _rcm(_samples(1, 0.12, 5)[0])
    pg = stack_partitioned_graphs([s], row)
    inf = partitioned_psignn_inference(model(), pg, cfg, row)
    part = _against_one_process(inf, model(), s, cfg, pg, row.rank, device)

    # 4. dp × partition train step
    dp = 2 if n >= 4 else 1
    parts = n_parts or n // dp
    grid = multihost.global_mesh(dp, parts, device)
    rows = [_rcm(s) for s in _samples(dp, 0.35, 7, one_mesh=True)]
    m = model()
    pres = make_partitioned_train_step(cfg, grid, clip=0.1)(
        m, make_optimizers(m, 0.01, 0.05), stack_partitioned_graphs(rows,
                                                                    grid),
        torch.Generator().manual_seed(8 + grid.rank), 0.01, 0.05)
    ploss, pgnorm = pres.loss, pres.grad_norm

    out = dict(dp_loss=res.loss, dp_grad_norm=res.grad_norm,
               mp_max_abs_err=mp_err, mp_scale=float(want.abs().max()),
               partitioned_nstep=inf.nstep, partitioned_res=inf.residual,
               dp_parts=[dp, parts], partitioned_train_loss=ploss,
               partitioned_train_grad_norm=pgnorm, **part)
    if not all(np.isfinite(v) for v in (res.loss, res.grad_norm, ploss,
                                        pgnorm, inf.residual)):
        raise RuntimeError(f"non-finite dry run: {out}")
    if not mp_err <= 1e-5 * max(1.0, out["mp_scale"]):
        raise RuntimeError(f"edge-sharded message passing disagrees: {out}")
    if not part["partitioned_agrees"]:
        raise RuntimeError(f"the partitioned solve disagrees: {out}")
    return out


def _against_one_process(inf, model, sample: dict, cfg, pg, rank: int,
                         device) -> Dict[str, float]:
    """The partitioned solve ``inf`` (this rank's rows) against the one
    process's solve of the same mesh, within JAX's limits of
    ``tests/test_halo.py:113-151``: |Δnstep| ≤ 1, u within 1e-2 relative
    and 2e-3 absolute, the mesh's residual within 1e-3 relative."""
    from ..graphs import batch_graphs
    from ..models import psignn_inference
    from ..ops import residual_loss
    g = batch_graphs([sample], device=device)
    one = psignn_inference(model, g, cfg)
    residual = float(residual_loss(one.u, g))
    lo = rank * pg.n_loc
    want = one.u[lo:lo + pg.n_loc].cpu().numpy()
    got = inf.u.cpu().numpy()
    u_ok = bool(np.allclose(got[:len(want)], want, rtol=1e-2, atol=2e-3)
                and not got[len(want):].any())
    res_rel = abs(inf.residual - residual) / residual
    return dict(single_nstep=one.nstep, single_res=residual,
                partitioned_u_max_abs_diff=float(
                    np.abs(got[:len(want)] - want).max(initial=0.0)),
                partitioned_agrees=bool(abs(inf.nstep - one.nstep) <= 1
                                        and u_ok and res_rel <= 1e-3))


def _rank(rank: int, n: int, device: str, init: str) -> Dict[str, float]:
    backend = "nccl" if device == "cuda" else "gloo"
    dev = f"cuda:{rank}" if device == "cuda" else device
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
    multihost.initialize(backend, init, n, rank)
    return dryrun_multichip(dev)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num_devices", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="cpu, cuda (rank r on cuda:r) or cuda:K")
    args = p.parse_args(argv)
    init = f"tcp://127.0.0.1:{multihost.free_port()}"
    outs = multihost.spawn(_rank, args.num_devices,
                           (args.num_devices, args.device, init))
    first = outs[0]
    print(f"dryrun_multichip OK on {args.num_devices} ranks: dp loss "
          f"{first['dp_loss']:.4f}, partitioned solve nstep "
          f"{first['partitioned_nstep']} res {first['partitioned_res']:.4f} "
          f"(one process: {first['single_nstep']}, "
          f"{first['single_res']:.4f}; u within "
          f"{max(o['partitioned_u_max_abs_diff'] for o in outs):.2e}), "
          f"partitioned train step ({first['dp_parts'][0]}x"
          f"{first['dp_parts'][1]}) loss {first['partitioned_train_loss']:.4f}"
          f" grad_norm {first['partitioned_train_grad_norm']:.4f}")


if __name__ == "__main__":
    main()
