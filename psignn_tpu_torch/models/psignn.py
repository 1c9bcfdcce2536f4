"""Ψ-GNN: deep-equilibrium GNN Poisson solver (Dirichlet variant).

Port of ``psignn_tpu/models/psignn.py`` (``PsignnConfig``, ``psignn_init``,
``encoder_apply``/``decoder_apply``, the Dirichlet branch of
``make_function``, ``psignn_inference``):

* a 1 ↔ latent autoencoder (encoder MLP [1, D, D], decoder MLP [D, D, 1]);
* the update function f_θ: two directional message passings, a sigmoid
  gate on a gated MLP update ``h + α·update``, LayerNorm on the last layer,
  the hard Dirichlet reset ``where(dir_mask > 0, h_initial, h_next)`` and
  ``h * fnode_mask``;
* inference: encode, Broyden fixed point of f_θ, decode.

The mixed variant, the losses and training come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from ..deq import DEQConfig, fixed_point_forward
from ..graphs import Graph
from ..nn import MLP, layer_norm, linear
from ..ops import message_passing

# Hyperparameters of the JAX package's config that only training reads (the
# adjoint solve and the Jacobian loss); dropped when a checkpoint is loaded.
TRAINING_ONLY = ("bw_tol", "bw_thres", "jac_vecs")


@dataclasses.dataclass(frozen=True)
class PsignnConfig:
    latent_dim: int = 10
    n_layers: int = 1
    bc_mode: str = "dirichlet"
    solver: str = "broyden"
    fw_tol: float = 1e-5
    fw_thres: int = 300
    edge_dim: int = 3
    # options of the JAX package that are not ported; accepted so that a
    # JAX checkpoint's hyperparameters load, refused unless at the default
    lowrank_bf16: bool = False
    lowrank_max_rank: int = 0
    ls: bool = False

    def __post_init__(self):
        if self.bc_mode != "dirichlet":
            raise NotImplementedError(
                f"bc_mode '{self.bc_mode}' is not yet ported")
        if self.lowrank_bf16 or self.lowrank_max_rank or self.ls:
            raise NotImplementedError(
                "lowrank_bf16, lowrank_max_rank and ls are not yet ported")

    @classmethod
    def from_hyperparameters(cls, hp: Dict[str, Any],
                             **overrides) -> "PsignnConfig":
        """The config of a JAX checkpoint's ``hyperparameters``, without
        the training-only keys; ``overrides`` replace the rest."""
        kept = {k: v for k, v in hp.items() if k not in TRAINING_ONLY}
        return cls(**{**kept, **overrides})

    @property
    def prb_dim(self) -> int:
        return 2

    @property
    def deq(self) -> DEQConfig:
        return DEQConfig(solver=self.solver, fw_tol=self.fw_tol,
                         fw_thres=self.fw_thres)


class PsignnLayer(nn.Module):
    def __init__(self, cfg: PsignnConfig, generator=None, device=None):
        super().__init__()
        D, E, P = cfg.latent_dim, cfg.edge_dim, cfg.prb_dim
        self.phi_to = MLP([2 * D + E, D, D], generator, device)
        self.phi_from = MLP([2 * D + E, D, D], generator, device)
        self.update = MLP([3 * D + P, D, D], generator, device)


class UpdateFunction(nn.Module):
    """f_θ(h, h_initial, graph) -> h' (the Dirichlet ``make_function``)."""

    def __init__(self, cfg: PsignnConfig, generator=None, device=None):
        super().__init__()
        D, P = cfg.latent_dim, cfg.prb_dim
        self.layers = nn.ModuleList(PsignnLayer(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.alpha = linear(3 * D + P, 1, generator, device)
        self.laynorm = layer_norm(D, device)

    def forward(self, h: torch.Tensor, h_initial: torch.Tensor,
                graph: Graph) -> torch.Tensor:
        last = len(self.layers) - 1
        for k, layer in enumerate(self.layers):
            mp_to = message_passing(layer.phi_to, h, graph, "to")
            mp_from = message_passing(layer.phi_from, h, graph, "from")
            concat = torch.cat([h, mp_to, mp_from, graph.prb_data], dim=-1)
            alpha = torch.sigmoid(self.alpha(concat))
            h_next = h + alpha * layer.update(concat)
            if k == last:
                h_next = self.laynorm(h_next)
            # hard Dirichlet reset, then keep non-node rows at zero
            h = torch.where(graph.dirichlet_mask > 0, h_initial, h_next)
            h = h * graph.fnode_mask
        return h


class Psignn(nn.Module):
    """Autoencoder + update function; ``psignn_init`` in module form
    (weights from ``generator``; the JAX package draws other numbers)."""

    def __init__(self, cfg: PsignnConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        D = cfg.latent_dim
        self.function = UpdateFunction(cfg, generator, device)
        self.encoder = MLP([1, D, D], generator, device)
        self.decoder = MLP([D, D, 1], generator, device)


class PsignnInference(NamedTuple):
    u: torch.Tensor      # (N, 1) decoded solution
    nstep: int           # Broyden step of the best iterate
    lowest: float        # best relative residual of the fixed point
    prot_break: bool     # divergence protection fired


def psignn_inference(model: Psignn, graph: Graph, cfg: PsignnConfig
                     ) -> PsignnInference:
    """Encode, solve the fixed point, decode."""
    with torch.no_grad():
        h_initial = model.encoder(graph.x) * graph.fnode_mask
        out = fixed_point_forward(model.function, h_initial, graph, cfg.deq)
        u = model.decoder(out.result) * graph.fnode_mask
    return PsignnInference(u, out.nstep, out.lowest, out.prot_break)
