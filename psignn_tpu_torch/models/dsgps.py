"""DS-GPS: a GRU-gated recurrent GNN unrolled for k shared-weight steps,
Dirichlet and mixed Dirichlet+Neumann variants.

Port of ``psignn_tpu/models/dsgps.py`` (``DsgpsConfig``, ``dsgps_init``,
``_step``, ``_enc_autoenc_losses``, ``dsgps_forward``,
``dsgps_iterative_inference``, ``dsgps_inference``):

* a step: two message passings (``phi_to``, ``phi_from``), sigmoid gates
  ``z_k`` and ``r_k`` and the tanh ``correction`` (single linear layers
  over [H, mp_to, mp_from, prb_data]), ``H + z·tanh(...)``; the mixed
  variant adds ``phi_neumann`` (``from`` direction) and the ungated
  ``update_neumann`` MLP of [H, mp_neu, prb_data, normal], which
  overwrites the Neumann rows; then the hard Dirichlet reset to H₀;
* per step the γ-discounted residual and the encoder and autoencoder
  losses in one of two semantics: ``freeze`` keeps the value gradients
  and detaches the *parameters* of the other half of the autoencoder,
  ``detach`` detaches the values (``DsgpsConfig.enc_loss_mode``).

The module keeps the JAX tree's names, the declared but unused ``laynorm``
included, so that weights round-trip (``weights.dsgps_params_from_jax``).
Every message passing goes through ``ops.message_passing``, so it launches
the fused CUDA kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..graphs import Graph
from ..nn import MLP, layer_norm
from ..ops import (message_passing, mse_masked, mse_masked_stacked,
                   residual_loss, residual_loss_stacked)
from .dss import discount


@dataclasses.dataclass(frozen=True)
class DsgpsConfig:
    latent_dim: int = 10
    k: int = 30
    gamma: float = 0.9
    bc_mode: str = "dirichlet"
    edge_dim: int = 3
    # mixed only: scale of update_neumann's output layer at init (1.0 is the
    # reference's Xavier draw; about 0.1 starts the ungated Neumann
    # recurrence contractive, JAX dsgps.py:40-47)
    neumann_init_scale: float = 1.0
    # '' = each variant's reference semantics (dirichlet: freeze, mixed:
    # detach); 'freeze' or 'detach' overrides it
    enc_loss_override: str = ""

    def __post_init__(self):
        if self.bc_mode not in ("dirichlet", "mixed"):
            raise ValueError(f"bc_mode must be 'dirichlet' or 'mixed', not "
                             f"{self.bc_mode!r}")
        if self.enc_loss_override not in ("", "freeze", "detach"):
            raise ValueError(f"enc_loss_override must be '', 'freeze' or "
                             f"'detach', not {self.enc_loss_override!r}")

    @classmethod
    def from_hyperparameters(cls, hp: Dict[str, Any],
                             **overrides) -> "DsgpsConfig":
        """The config of a checkpoint's ``hyperparameters``; ``overrides``
        replace entries."""
        return cls(**{**hp, **overrides})

    @property
    def prb_dim(self) -> int:
        return 2 if self.bc_mode == "dirichlet" else 3

    @property
    def enc_loss_mode(self) -> str:
        if self.enc_loss_override:
            return self.enc_loss_override
        return "freeze" if self.bc_mode == "dirichlet" else "detach"


class Autoencoder(nn.Module):
    def __init__(self, D: int, generator=None, device=None):
        super().__init__()
        self.encoder = MLP([1, D, D], generator, device)
        self.decoder = MLP([D, D, 1], generator, device)


class Dsgps(nn.Module):
    """The shared-weight step and the autoencoder (``dsgps_init``; weights
    from ``generator``, the JAX package draws other numbers)."""

    def __init__(self, cfg: DsgpsConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        D, E, P = cfg.latent_dim, cfg.edge_dim, cfg.prb_dim
        self.laynorm = layer_norm(D, device)     # declared, unused
        self.phi_to = MLP([2 * D + E, D, D], generator, device)
        self.phi_from = MLP([2 * D + E, D, D], generator, device)
        self.z_k = MLP([3 * D + P, D], generator, device)
        self.r_k = MLP([3 * D + P, D], generator, device)
        self.correction = MLP([3 * D + P, D], generator, device)
        self.autoencoder = Autoencoder(D, generator, device)
        self.mixed = cfg.bc_mode == "mixed"
        if self.mixed:
            self.phi_neumann = MLP([2 * D + E, D, D], generator, device)
            self.update_neumann = MLP([2 * D + P + 2, D, D], generator,
                                      device)
            with torch.no_grad():
                self.update_neumann.layers[-1].weight.mul_(
                    cfg.neumann_init_scale)

    def step(self, h: torch.Tensor, h0: torch.Tensor,
             graph: Graph) -> torch.Tensor:
        """One gated update (dsgps/model.py:74-89, mixed:80-99)."""
        if self.mixed and (graph.neumann_mask is None
                           or graph.unit_normal_vector is None):
            raise ValueError("the mixed DS-GPS needs a mixed graph: 3-column "
                             "one-hot tags and unit_normal_vector")
        mp_to = message_passing(self.phi_to, h, graph, "to")
        mp_from = message_passing(self.phi_from, h, graph, "from")
        concat = torch.cat([h, mp_to, mp_from, graph.prb_data], dim=-1)
        gate = torch.sigmoid(self.z_k(concat))
        reset = torch.sigmoid(self.r_k(concat))
        corr = torch.tanh(self.correction(torch.cat(
            [reset * h, mp_to, mp_from, graph.prb_data], dim=-1)))
        h_next = h + gate * corr
        if self.mixed:
            mp_neu = message_passing(self.phi_neumann, h, graph, "from")
            upd_neu = self.update_neumann(torch.cat(
                [h, mp_neu, graph.prb_data, graph.unit_normal_vector],
                dim=-1))
            h_next = torch.where(graph.neumann_mask > 0, upd_neu, h_next)
        h_next = torch.where(graph.dirichlet_mask > 0, h0, h_next)
        return h_next * graph.fnode_mask


def _frozen(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """``mlp(x)`` with its parameters detached: the gradient reaches ``x``
    and no parameter of ``mlp``."""
    last = len(mlp.layers) - 1
    for i, lin in enumerate(mlp.layers):
        x = F.linear(x, lin.weight.detach(), lin.bias.detach())
        if i < last:
            x = torch.relu(x)
    return x


def _enc_autoenc_losses(model: Dsgps, cfg: DsgpsConfig, graph: Graph,
                        h: torch.Tensor, u: torch.Tensor):
    """(encoder loss, autoencoder loss) of one step (JAX dsgps.py:121-145)."""
    ae = model.autoencoder
    nodes = graph.fnode_mask[:, 0] > 0
    if cfg.enc_loss_mode == "freeze":
        # mse(enc(dec(H)), H) with the decoder's parameters frozen, and
        # mse(dec(enc(U)), U) with the encoder's; value gradients kept
        # (dsgps/model.py:100-110)
        enc = mse_masked(ae.encoder(_frozen(ae.decoder, h)), h, nodes)
        auto = mse_masked(ae.decoder(_frozen(ae.encoder, u)), u, nodes)
    else:
        # detached values (mixed/dsgps/model.py:108-115)
        u_det, h_det = u.detach(), h.detach()
        enc = mse_masked(ae.encoder(u_det), h_det, nodes)
        auto = mse_masked(ae.decoder(ae.encoder(u_det).detach()), u_det,
                          nodes)
    return enc, auto


def _encode(model: Dsgps, graph: Graph) -> torch.Tensor:
    return model.autoencoder.encoder(graph.x) * graph.fnode_mask


def _decode(model: Dsgps, h: torch.Tensor, graph: Graph) -> torch.Tensor:
    return model.autoencoder.decoder(h) * graph.fnode_mask


class DsgpsOutput(NamedTuple):
    u_final: torch.Tensor
    losses: Dict[str, torch.Tensor]   # scalars + (k,) per-iteration arrays


def dsgps_forward(model: Dsgps, graph: Graph, cfg: DsgpsConfig
                  ) -> DsgpsOutput:
    """The k-step unroll with the JAX package's ten losses: ``train_loss``
    = Σ_t γ^(k−t−1) res_t + enc_t + auto_t, the last and the initial
    residual and MSE, the last encoder, autoencoder and Dirichlet-node
    losses, and the per-iteration residuals and MSEs."""
    nodes = graph.fnode_mask[:, 0] > 0
    h0 = _encode(model, graph)
    h, us, encs, autos = h0, [], [], []
    for _ in range(cfg.k):
        h = model.step(h, h0, graph)
        u = _decode(model, h, graph)
        enc, auto = _enc_autoenc_losses(model, cfg, graph, h, u)
        us.append(u)
        encs.append(enc)
        autos.append(auto)
    u_stack, enc, auto = torch.stack(us), torch.stack(encs), torch.stack(autos)
    res = residual_loss_stacked(u_stack, graph)
    mse = mse_masked_stacked(u_stack, graph.sol, nodes)
    mse_dir = mse_masked_stacked(u_stack, graph.sol,
                                 graph.dirichlet_mask[:, 0] > 0)
    w = discount(cfg.gamma, cfg.k, graph.device)
    losses = {
        "train_loss": torch.sum(res * w + enc + auto),
        "residual_loss": res[-1],
        "residual_0": residual_loss(graph.x, graph),
        "mse_loss": mse[-1],
        "mse_0": mse_masked(graph.x, graph.sol, nodes),
        "encoder_loss": enc[-1],
        "autoencoder_loss": auto[-1],
        "mse_dirichlet": mse_dir[-1],
        "res_per_iter": res,
        "mse_per_iter": mse,
    }
    return DsgpsOutput(u_stack[-1], losses)


def dsgps_iterative_inference(model: Dsgps, graph: Graph, cfg: DsgpsConfig,
                              k: Optional[int] = None) -> Dict[str, Any]:
    """The decoded iterates U_1 … U_k (k defaults to ``cfg.k``) and each
    one's residual and MSE, for the iterate-inspection figures."""
    with torch.no_grad():
        h0 = _encode(model, graph)
        h, us = h0, []
        for _ in range(k or cfg.k):
            h = model.step(h, h0, graph)
            us.append(_decode(model, h, graph))
        u_stack = torch.stack(us)
        return dict(u_trace=u_stack,
                    res=residual_loss_stacked(u_stack, graph),
                    mse=mse_masked_stacked(u_stack, graph.sol,
                                           graph.fnode_mask[:, 0] > 0),
                    initial=graph.x)


def dsgps_inference(model: Dsgps, graph: Graph, cfg: DsgpsConfig,
                    k: Optional[int] = None) -> torch.Tensor:
    """(N, 1) the decoded state after k steps (default ``cfg.k``; the
    growing-geometry study runs k up to 1000), without losses or
    gradients: the spans ``infer`` ⊃ ``infer.encode``, ``infer.unroll``,
    ``infer.decode``."""
    with torch.no_grad(), profiling.span("infer"):
        with profiling.span("infer.encode"):
            h0 = _encode(model, graph)
        h = h0
        with profiling.span("infer.unroll"):
            for _ in range(k or cfg.k):
                h = model.step(h, h0, graph)
        with profiling.span("infer.decode"):
            return _decode(model, h, graph)
