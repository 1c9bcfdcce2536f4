"""One Ψ-GNN training step: forward with losses, implicit backward, joint
clip, dual Adam.

Port of the psignn step of ``psignn_tpu/train/trainer.py:262-287``, which
``bench.py:156-173`` also runs: loss = residual + jac_weight·jacobian +
encoder + autoencoder (training_class.py:156-159).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ..deq import SolveStats
from ..graphs import Graph
from ..models.psignn import Psignn, PsignnConfig, psignn_forward
from .optim import apply_gradients


class StepResult(NamedTuple):
    loss: float
    losses: Dict[str, float]        # the nine entries of psignn_forward
    grad_norm: float                # global norm before the clip
    fw: SolveStats                  # forward fixed-point solve
    bw: Optional[SolveStats]        # adjoint solve of the backward


def psignn_loss(losses: Dict[str, torch.Tensor],
                jac_weight: float) -> torch.Tensor:
    return (losses["residual_loss"] + jac_weight * losses["jacobian_loss"]
            + losses["encoder_loss"] + losses["autoencoder_loss"])


def train_step(model: Psignn, opts: Sequence[torch.optim.Optimizer],
               graph: Graph, cfg: PsignnConfig, lrs: Sequence[float],
               clip: float, jac_weight: float,
               generator: torch.Generator) -> StepResult:
    """One step on ``graph``; ``opts`` and ``lrs`` are (function,
    autoencoder) as ``make_optimizers`` builds them."""
    for opt in opts:
        opt.zero_grad(set_to_none=True)
    out = psignn_forward(model, graph, cfg, generator, training=True)
    loss = psignn_loss(out.losses, jac_weight)
    loss.backward()
    gnorm = apply_gradients(model.parameters(), opts, lrs, clip)
    # one host read for every scalar of the step
    host = torch.stack([loss.detach(), gnorm.to(loss.dtype)]
                       + [v.detach() for v in out.losses.values()]).cpu()
    return StepResult(float(host[0]),
                      dict(zip(out.losses, host[2:].tolist())),
                      float(host[1]), out.fw, out.adjoint.stats)
