"""The reference's data-parallel training steps of Ψ-GNN: each global
batch dealt over the ranks as the program deals it, each rank's loss and
gradient at its own shard's equilibrium, and the ranks combined as the
program's all-reduce combines them (``dist.dp.dp_value_and_grad``: the
loss and the gradient are the means of the ranks'), then the joint clip
and both Adams, in plain PyTorch over the checkpoint's JAX-layout
parameters.

A rank's loss and gradient are ``psignn._steps``'s of one step on its
shard with neither clip nor learning rate, so its loss, its adjoint solve
and its Hutchinson probe are those of the single-card reference; the
probe of rank d comes from rank d's own generator.  Imports torch and
numpy, and the reference's own ``common`` and ``psignn``; nothing of the
program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .common import rcm_order
from .psignn import Batch, Model, _adam, _rel, _steps, broyden, leaves, \
    with_leaves


def deal(batch: Sequence[dict], batch_size: int, ranks: int
         ) -> List[List[dict]]:
    """One global batch's samples dealt over ``ranks`` as the program's
    ``data.reader.shard_samples`` deals them: padded with empty samples to
    ``ceil(batch_size / ranks) · ranks`` and dealt round-robin; an empty
    sample adds no node and no edge, so each shard keeps its real samples
    in their order.  A batch shorter than ``ranks`` is repeated first."""
    batch = list(batch)
    if len(batch) < ranks:
        batch = [batch[i % len(batch)] for i in range(ranks)]
    return [batch[d::ranks] for d in range(ranks)]


class Shards:
    """A dealt batch on ``device``: each rank's shard as a ``Batch`` of its
    samples in RCM order (the program's loader orders each sample so), and
    the whole batch, the shards one after another."""

    def __init__(self, shards: Sequence[Sequence[dict]], device):
        ordered = [[rcm_order(s) for s in shard] for shard in shards]
        self.shards = [Batch(s, device) for s in ordered]
        self.whole = Batch([s for shard in ordered for s in shard], device)


def dp_steps(model: Model, batches: Sequence[Shards],
             probes: Sequence[Callable], cfg: dict, tcfg: dict,
             equilibrium: Callable, measured_under=None) -> dict:
    """The data-parallel steps over ``batches`` from the model's
    parameters.  Step t takes rank d's equilibrium from ``equilibrium(t,
    d, g_fw, h0)`` and its probe from ``probes[d](t, shape)``; the step's
    residual is the whole batch's, its h* the ranks' stacked, measured
    under ``measured_under[t − 1]`` (by leaf; without it, the step's own
    parameters).  Returns ``psignn._steps``'s dict: the losses, residuals,
    h* (each a list by rank), parameters at each step's start, the clipped
    first gradient, and the parameters before and after."""
    params = leaves(model.p)
    per_rank = dict(tcfg, gradient_clip=float("inf"), lr_deq=0.0, lr_ae=0.0)
    state: Dict[str, tuple] = {}
    losses, residuals, zs, starts, first_grad = [], [], [], [], None
    for t, batch in enumerate(batches, start=1):
        starts.append({k: p.detach().clone() for k, p in params.items()})
        outs = [_steps(model, [shard], probes[d], cfg, per_rank,
                       lambda _t, g, h0, d=d: equilibrium(t, d, g, h0))
                for d, shard in enumerate(batch.shards)]
        zs.append([o["h_stars"][0] for o in outs])
        with torch.no_grad():
            m = model if measured_under is None else Model(
                with_leaves(model.p, measured_under[t - 1]), model.device,
                model.precision)
            w = batch.whole
            z = torch.cat(zs[-1])
            fz = m.f(z, m.encode(w.x), w.prb, w.dmask, w.edges)
            residuals.append(_rel(fz - z, fz))
        ranks = len(outs)
        grads = {k: sum(o["grad"][k] for o in outs) / ranks for k in params}
        total = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        coef = tcfg["gradient_clip"] / (float(total) + 1e-6)
        if coef < 1:
            grads = {k: g * coef for k, g in grads.items()}
        if first_grad is None:
            first_grad = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for group, lr in (("function", tcfg["lr_deq"]),
                              ("autoencoder", tcfg["lr_ae"])):
                sel = {k: p for k, p in params.items()
                       if k.startswith(group + "/")}
                _adam(sel, grads, state, lr, t)
        losses.append(float(np.mean([o["losses"][0] for o in outs])))
    after = {k: p.detach().clone() for k, p in params.items()}
    return dict(losses=losses, residuals=residuals, h_stars=zs,
                starts=starts, grad=first_grad, before=starts[0], after=after)


def judge_dp_steps(model: Model, batches, h_stars, starts, probes,
                   cfg: dict, tcfg: dict) -> dict:
    """``dp_steps`` at the side's own equilibria: rank d of step t takes
    ``h_stars[t − 1][d]`` and solves no forward fixed point; each step's
    residual is measured under the side's parameters ``starts`` of that
    step (``psignn.judge_steps``'s rule)."""
    dev = model.device
    return dp_steps(model, batches, probes, cfg, tcfg,
                    lambda t, d, _g, _h0: torch.as_tensor(
                        h_stars[t - 1][d], device=dev),
                    measured_under=starts)


def solve_dp_steps(model: Model, batches, probes, cfg: dict, tcfg: dict
                   ) -> dict:
    """``dp_steps`` with each rank's forward fixed point solved here by
    plain Broyden from its encoding (the control)."""
    def solve(_t, _d, g_fw, h0):
        z, _, _ = broyden(g_fw, h0.reshape(-1), cfg["fw_thres"],
                          cfg["fw_tol"])
        return z

    return dp_steps(model, batches, probes, cfg, tcfg, solve)
