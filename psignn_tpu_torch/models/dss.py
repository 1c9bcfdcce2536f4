"""DSS: the Deep Statistical Solver baseline, k distinct feed-forward
layers.

Port of ``psignn_tpu/models/dss.py`` (``DssConfig``, ``dss_init``,
``dss_forward``, ``dss_inference``): k layers, each with its own
``phi_to`` / ``phi_from`` edge MLPs ([2D+1, D, D] over the 1-wide
``a_ij_norm`` of the off-diagonal system A′), ``psi`` ([3D+3, D, D] over
[H, mp_to, mp_from, b′_norm]) and ``decoder`` ([D, D, 1]); H₀ = 0, the
update ``H + α·psi(...)`` with a constant α, and the γ-discounted
BC-encoded residual loss ``Σ_t γ^(k−t−1) res_t``.  The JAX package stacks
the layers' parameters on a leading k axis (``weights.dss_params_from_jax``
unstacks them); here they are an ``nn.ModuleList``.  Every message passing
goes through ``ops.message_passing``, so it launches the fused CUDA kernel
on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from ..graphs import Graph
from ..nn import MLP
from ..ops import (dss_residual_loss, dss_residual_loss_stacked,
                   message_passing, mse_masked, mse_masked_stacked)


@dataclasses.dataclass(frozen=True)
class DssConfig:
    latent_dim: int = 10
    k: int = 30
    alpha: float = 1e-3
    gamma: float = 0.9

    @classmethod
    def from_hyperparameters(cls, hp: Dict[str, Any],
                             **overrides) -> "DssConfig":
        """The config of a checkpoint's ``hyperparameters``; ``overrides``
        replace entries."""
        return cls(**{**hp, **overrides})


class DssLayer(nn.Module):
    def __init__(self, cfg: DssConfig, generator=None, device=None):
        super().__init__()
        D = cfg.latent_dim
        self.phi_to = MLP([2 * D + 1, D, D], generator, device)
        self.phi_from = MLP([2 * D + 1, D, D], generator, device)
        self.psi = MLP([3 * D + 3, D, D], generator, device)
        self.decoder = MLP([D, D, 1], generator, device)


class Dss(nn.Module):
    """The k layers (``dss_init``; weights from ``generator``, the JAX
    package draws other numbers)."""

    def __init__(self, cfg: DssConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(DssLayer(cfg, generator, device)
                                    for _ in range(cfg.k))


def discount(gamma: float, k: int, device=None) -> torch.Tensor:
    """(k,) f32 weights γ^(k−t−1) of the per-iteration losses."""
    t = torch.arange(k, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(gamma, dtype=torch.float32, device=device),
                     k - t - 1.0)


def _unroll(model: Dss, graph: Graph, cfg: DssConfig) -> torch.Tensor:
    """(k, N, 1) decoded iterates U_1 … U_k from H₀ = 0."""
    mask = graph.fnode_mask
    h = torch.zeros((graph.total_nodes, cfg.latent_dim), dtype=mask.dtype,
                    device=mask.device)
    us = []
    for layer in model.layers:
        mp_to = message_passing(layer.phi_to, h, graph, "to")
        mp_from = message_passing(layer.phi_from, h, graph, "from")
        corr = layer.psi(torch.cat([h, mp_to, mp_from, graph.b_prime_norm],
                                   dim=-1))
        h = (h + cfg.alpha * corr) * mask
        us.append(layer.decoder(h) * mask)
    return torch.stack(us)


class DssOutput(NamedTuple):
    u_final: torch.Tensor
    losses: Dict[str, torch.Tensor]   # scalars + (k,) per-iteration arrays


def dss_forward(model: Dss, graph: Graph, cfg: DssConfig) -> DssOutput:
    """The unroll with the JAX package's seven losses (dss/model.py:58-104):
    ``train_loss`` (the discounted sum), the last and the initial residual
    and MSE, and the per-iteration residuals and MSEs.  The MSE is against
    ``graph.x``, which the DSS reader sets to the solution."""
    nodes = graph.fnode_mask[:, 0] > 0
    # U₀ = decoder₀(H₀) with H₀ = 0
    u0 = model.layers[0].decoder(torch.zeros(
        (graph.total_nodes, cfg.latent_dim), dtype=graph.x.dtype,
        device=graph.device)) * graph.fnode_mask
    u_stack = _unroll(model, graph, cfg)
    res = dss_residual_loss_stacked(u_stack, graph)
    mse = mse_masked_stacked(u_stack, graph.x, nodes)
    losses = {
        "train_loss": torch.sum(res * discount(cfg.gamma, cfg.k,
                                               graph.device)),
        "residual_loss": res[-1],
        "residual_0": dss_residual_loss(u0, graph),
        "mse_loss": mse[-1],
        "mse_0": mse_masked(u0, graph.x, nodes),
        "res_per_iter": res,
        "mse_per_iter": mse,
    }
    return DssOutput(u_stack[-1], losses)


def dss_inference(model: Dss, graph: Graph, cfg: DssConfig) -> torch.Tensor:
    """(N, 1) the last decoded iterate, without losses or gradients."""
    with torch.no_grad():
        return _unroll(model, graph, cfg)[-1]
