"""One training step: forward with losses, backward, joint clip, Adam.

Port of the two steps of ``psignn_tpu/train/trainer.py``:

* ``train_step`` (Ψ-GNN, ``:262-287``, which ``bench.py:156-173`` also
  runs): loss = residual + jac_weight·jacobian + encoder + autoencoder
  (training_class.py:156-159), the implicit backward, the dual Adam; on a
  stacked batch, one solve per graph and losses averaged over the graphs;
* ``unrolled_train_step`` (DS-GPS and DSS, ``:288-296``): loss = the
  model's ``train_loss``, backpropagated through the k-step unroll, one
  Adam.

Given a data-parallel ``mesh`` (``dist.dp.make_mesh``), both steps run on
the rank's shard and average the loss, the loss entries, the gradients
and (Ψ-GNN) the adjoint solve's stats over the ranks in one all-reduce
(``dist.dp.dp_value_and_grad``; JAX ``trainer.py:201-234``) before the
clip and Adam, so every rank takes the same step.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from .. import profiling
from ..deq import SolveStats
from ..dist.dp import dp_value_and_grad
from ..dist.multihost import Mesh
from ..graphs import Graph
from ..models.dsgps import DsgpsConfig, dsgps_forward
from ..models.dss import dss_forward
from ..models.psignn import (Psignn, PsignnConfig, psignn_forward,
                             psignn_forward_stacked)
from .optim import apply_gradients


class StepResult(NamedTuple):
    loss: float
    losses: Dict[str, float]        # the forward's 0-d loss entries
    grad_norm: float                # global norm before the clip
    fw: Optional[SolveStats]        # forward fixed-point solve (Ψ-GNN)
    bw: Optional[SolveStats]        # adjoint solve of the backward (Ψ-GNN)


def _host(loss: torch.Tensor, gnorm: torch.Tensor,
          losses: Dict[str, torch.Tensor]):
    """(loss, grad norm, {name: value} of the 0-d entries), all in one host
    read."""
    losses = {k: v for k, v in losses.items() if v.dim() == 0}
    host = torch.stack([loss.detach(), gnorm.to(loss.dtype)]
                       + [v.detach() for v in losses.values()]).cpu()
    return (float(host[0]), float(host[1]),
            dict(zip(losses, host[2:].tolist())))


def _scalars(means: Dict[str, object]) -> Dict[str, float]:
    """The 0-d entries of the ranks' mean losses (as ``_host`` keeps)."""
    return {k: v for k, v in means.items() if isinstance(v, float)}


def psignn_loss(losses: Dict[str, torch.Tensor],
                jac_weight: float) -> torch.Tensor:
    return (losses["residual_loss"] + jac_weight * losses["jacobian_loss"]
            + losses["encoder_loss"] + losses["autoencoder_loss"])


def train_step(model: Psignn, opts: Sequence[torch.optim.Optimizer],
               graph: Graph, cfg: PsignnConfig, lrs: Sequence[float],
               clip: float, jac_weight: float,
               generator: torch.Generator,
               stacked: bool = False,
               mesh: Optional[Mesh] = None) -> StepResult:
    """One step on ``graph``; ``opts`` and ``lrs`` are (function,
    autoencoder) as ``make_optimizers`` builds them.  ``stacked`` solves
    each graph of the batch on its own (``psignn_forward_stacked``); the
    step's ``fw`` and ``bw`` then hold per-graph arrays.  With ``mesh``,
    ``graph`` is the rank's shard and the step is data-parallel: the
    losses and the solves' (lowest, nstep) are the ranks' means, ``calls``
    the rank's own.  The root span ``train.step`` holds
    ``train.forward``, ``train.backward``, ``train.optim`` and
    ``train.read`` (one device)."""
    with profiling.span("train.step"):
        return _train_step(model, opts, graph, cfg, lrs, clip, jac_weight,
                           generator, stacked, mesh)


def _train_step(model, opts, graph, cfg, lrs, clip, jac_weight, generator,
                stacked, mesh) -> StepResult:
    for opt in opts:
        opt.zero_grad(set_to_none=True)
    forward = psignn_forward_stacked if stacked else psignn_forward
    if mesh is not None:
        if stacked:
            raise ValueError("per-graph solves are not data-parallel (JAX "
                             "refuses --stacked_batch with data parallelism)")
        outs = []

        def loss_fn(m, g):
            outs.append(forward(m, g, cfg, generator, training=True))
            return (psignn_loss(outs[0].losses, jac_weight),
                    outs[0].losses, outs[0].adjoint)

        loss_f, scalars, bw = dp_value_and_grad(loss_fn, mesh, sink=True)(
            model, graph)
        with profiling.span("train.optim"):
            gnorm = apply_gradients(model.parameters(), opts, lrs, clip)
        fw = SolveStats(scalars["fw_lowest"], scalars["fw_nstep"],
                        outs[0].fw.calls)
        return StepResult(loss_f, _scalars(scalars), float(gnorm), fw, bw)
    with profiling.span("train.forward"):
        out = forward(model, graph, cfg, generator, training=True)
        loss = psignn_loss(out.losses, jac_weight)
    with profiling.span("train.backward"):
        loss.backward()
    with profiling.span("train.optim"):
        gnorm = apply_gradients(model.parameters(), opts, lrs, clip)
    with profiling.span("train.read"):
        loss_f, gnorm_f, scalars = _host(loss, gnorm, out.losses)
    return StepResult(loss_f, scalars, gnorm_f, out.fw, out.adjoint.stats)


def unrolled_forward(model, graph: Graph, cfg):
    """The training forward of an unrolled family, picked by its config."""
    forward = dsgps_forward if isinstance(cfg, DsgpsConfig) else dss_forward
    return forward(model, graph, cfg)


def unrolled_train_step(model, opt: torch.optim.Optimizer, graph: Graph,
                        cfg, lr: float, clip: float,
                        mesh: Optional[Mesh] = None) -> StepResult:
    """One DS-GPS or DSS step on ``graph``: ``train_loss`` backpropagated
    through the unroll (one backward kernel launch per message passing on
    the card), the joint clip, one Adam step at ``lr``, one host read.
    With ``mesh``, data-parallel as ``train_step``."""
    opt.zero_grad(set_to_none=True)
    if mesh is not None:
        def loss_fn(m, g):
            out = unrolled_forward(m, g, cfg)
            return out.losses["train_loss"], out.losses

        loss_f, scalars, _ = dp_value_and_grad(loss_fn, mesh)(model, graph)
        gnorm = apply_gradients(model.parameters(), [opt], [lr], clip)
        return StepResult(loss_f, _scalars(scalars), float(gnorm), None,
                          None)
    out = unrolled_forward(model, graph, cfg)
    loss = out.losses["train_loss"]
    loss.backward()
    gnorm = apply_gradients(model.parameters(), [opt], [lr], clip)
    loss_f, gnorm_f, scalars = _host(loss, gnorm, out.losses)
    return StepResult(loss_f, scalars, gnorm_f, None, None)
