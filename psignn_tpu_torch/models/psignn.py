"""Ψ-GNN: deep-equilibrium GNN Poisson solver, Dirichlet and mixed
Dirichlet+Neumann variants.

Port of ``psignn_tpu/models/psignn.py`` (``PsignnConfig``, ``psignn_init``,
``encoder_apply``/``decoder_apply``, ``make_function``,
``psignn_inference``, ``psignn_forward``):

* a 1 ↔ latent autoencoder (encoder MLP [1, D, D], decoder MLP [D, D, 1]);
* the update function f_θ: two directional message passings, a sigmoid
  gate on a gated MLP update ``h + α·update``, LayerNorm on the last layer,
  the hard Dirichlet reset ``where(dir_mask > 0, h_initial, h_next)`` and
  ``h * fnode_mask``.  The mixed variant (``bc_mode="mixed"``, prb_dim 3)
  adds a third message passing, ``phi_neumann`` in the ``from`` direction
  on the same h, and the ``update_neumann`` MLP of [h, mp_neu, prb_data,
  normal], which overwrites the Neumann rows before the LayerNorm and the
  Dirichlet reset;
* inference: encode, the fixed point of f_θ by the configured solver,
  decode;
* ``psignn_forward``: the training forward with the JAX package's loss
  dictionary (residual, Jacobian, encoder, autoencoder round-trip, and the
  report-only MSEs and solver stats), the DEQ attached with its implicit
  backward;
* ``psignn_forward_stacked``: the same with one DEQ solve per graph of the
  batch and every loss averaged over the graphs (``--stacked_batch``);
* ``psignn_iterative_inference``: the decoded iterate trace with its
  per-iterate metrics;
* ``UpdateFunction.linearize``: f_θ at a point with what its backward
  needs kept, and the explicit VJP v ↦ Jᵀv in h (JAX's ``vjp_fn``) as
  plain tensor operations and the backward kernel, which the adjoint solve
  runs (``deq.deq_attach``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from .. import profiling
from ..deq import (AdjointSolve, DEQConfig, SolveStats, deq_solve,
                   fixed_point_forward)
from ..graphs import Graph
from ..nn import MLP, layer_norm, linear
from ..ops import (message_passing, message_passing_vjp, mse_masked,
                   mse_masked_per_graph, mse_masked_stacked, residual_loss,
                   residual_loss_stacked, residual_per_graph)
from ..solvers import Lanes


@dataclasses.dataclass(frozen=True)
class PsignnConfig:
    latent_dim: int = 10
    n_layers: int = 1
    bc_mode: str = "dirichlet"
    solver: str = "broyden"
    fw_tol: float = 1e-5
    fw_thres: int = 300
    bw_tol: float = 1e-8
    bw_thres: int = 300
    jac_vecs: int = 1                   # Hutchinson probes (model.py:207)
    edge_dim: int = 3
    lowrank_bf16: bool = False          # Broyden's pairs in bfloat16
    lowrank_max_rank: int = 0           # > 0: Broyden's rank memory capped
    ls: bool = False                    # Broyden Armijo line search

    def __post_init__(self):
        if self.bc_mode not in ("dirichlet", "mixed"):
            raise ValueError(f"bc_mode must be 'dirichlet' or 'mixed', not "
                             f"{self.bc_mode!r}")

    @classmethod
    def from_hyperparameters(cls, hp: Dict[str, Any],
                             **overrides) -> "PsignnConfig":
        """The config of a checkpoint's ``hyperparameters`` (the JAX
        package's or the port's); ``overrides`` replace entries."""
        return cls(**{**hp, **overrides})

    @property
    def prb_dim(self) -> int:
        # [f, g] Dirichlet (model.py:50), [f, g, f_neumann] mixed
        return 2 if self.bc_mode == "dirichlet" else 3

    @property
    def deq(self) -> DEQConfig:
        return DEQConfig(solver=self.solver, fw_tol=self.fw_tol,
                         fw_thres=self.fw_thres, bw_tol=self.bw_tol,
                         bw_thres=self.bw_thres, ls=self.ls,
                         lowrank_bf16=self.lowrank_bf16,
                         lowrank_max_rank=self.lowrank_max_rank)


class PsignnLayer(nn.Module):
    def __init__(self, cfg: PsignnConfig, generator=None, device=None):
        super().__init__()
        D, E, P = cfg.latent_dim, cfg.edge_dim, cfg.prb_dim
        self.phi_to = MLP([2 * D + E, D, D], generator, device)
        self.phi_from = MLP([2 * D + E, D, D], generator, device)
        self.update = MLP([3 * D + P, D, D], generator, device)


class UpdateFunction(nn.Module):
    """f_θ(h, h_initial, graph) -> h' (``make_function``).  In the mixed
    variant ``phi_neumann`` and ``update_neumann`` are shared by every
    layer, as in the JAX parameter tree."""

    def __init__(self, cfg: PsignnConfig, generator=None, device=None):
        super().__init__()
        D, E, P = cfg.latent_dim, cfg.edge_dim, cfg.prb_dim
        self.layers = nn.ModuleList(PsignnLayer(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.alpha = linear(3 * D + P, 1, generator, device)
        self.laynorm = layer_norm(D, device)
        self.mixed = cfg.bc_mode == "mixed"
        if self.mixed:
            self.phi_neumann = MLP([2 * D + E, D, D], generator, device)
            self.update_neumann = MLP([2 * D + P + 2, D, D], generator,
                                      device)

    def _check_graph(self, graph: Graph) -> None:
        if self.mixed and (graph.neumann_mask is None
                           or graph.unit_normal_vector is None):
            raise ValueError("the mixed Ψ-GNN needs a mixed graph: 3-column "
                             "one-hot tags and unit_normal_vector")

    def forward(self, h: torch.Tensor, h_initial: torch.Tensor,
                graph: Graph) -> torch.Tensor:
        self._check_graph(graph)
        last = len(self.layers) - 1
        for k, layer in enumerate(self.layers):
            mp_to = message_passing(layer.phi_to, h, graph, "to")
            mp_from = message_passing(layer.phi_from, h, graph, "from")
            concat = torch.cat([h, mp_to, mp_from, graph.prb_data], dim=-1)
            alpha = torch.sigmoid(self.alpha(concat))
            h_next = h + alpha * layer.update(concat)
            if self.mixed:
                # the Neumann branch on the same h overwrites Neumann rows
                mp_neu = message_passing(self.phi_neumann, h, graph, "from")
                upd_neu = self.update_neumann(torch.cat(
                    [h, mp_neu, graph.prb_data, graph.unit_normal_vector],
                    dim=-1))
                h_next = torch.where(graph.neumann_mask > 0, upd_neu, h_next)
            if k == last:
                h_next = self.laynorm(h_next)
            # hard Dirichlet reset, then keep non-node rows at zero
            h = torch.where(graph.dirichlet_mask > 0, h_initial, h_next)
            h = h * graph.fnode_mask
        return h

    def linearize(self, h: torch.Tensor, h_initial: torch.Tensor,
                  graph: Graph) -> Callable[[torch.Tensor], torch.Tensor]:
        """v ↦ Jᵀv, J = ∂f_θ/∂h at ``h`` (JAX's ``vjp_fn`` of f in h).

        Runs f_θ once at ``h``, without autograd, and keeps what its
        backward needs: each layer's input and concat rows, the gate α,
        the update MLPs' ReLU masks, LayerNorm's normalised rows and
        reciprocal standard deviation, and the masks.  The returned VJP is
        plain tensor operations and, for each message passing, the
        backward kernel's ``dh`` (``ops.message_passing_vjp``).  It
        allocates only its own temporaries and reads only tensors that
        exist before it is first called, so a carried solve can capture it
        in a CUDA graph."""
        self._check_graph(graph)
        last = len(self.layers) - 1
        D = h.shape[-1]
        # rows a layer's output passes a cotangent back to: real nodes off
        # the Dirichlet reset (0/1, so the products are exact)
        free = graph.fnode_mask * (graph.dirichlet_mask <= 0).to(h.dtype)
        neu = (graph.neumann_mask > 0).to(h.dtype) if self.mixed else None
        gate_w = self.alpha.weight.detach()                    # (1, C)
        steps = []
        with torch.no_grad():
            h = h.detach().contiguous()
            for k, layer in enumerate(self.layers):
                mp_to = message_passing(layer.phi_to, h, graph, "to")
                mp_from = message_passing(layer.phi_from, h, graph, "from")
                concat = torch.cat([h, mp_to, mp_from, graph.prb_data],
                                   dim=-1)
                alpha = torch.sigmoid(self.alpha(concat))
                upd, upd_vjp = _mlp_linearized(layer.update, concat)
                h_next = h + alpha * upd
                neu_vjp = ln_vjp = None
                if self.mixed:
                    mp_neu = message_passing(self.phi_neumann, h, graph,
                                             "from")
                    upd_neu, neu_vjp = _mlp_linearized(
                        self.update_neumann,
                        torch.cat([h, mp_neu, graph.prb_data,
                                   graph.unit_normal_vector], dim=-1))
                    h_next = torch.where(graph.neumann_mask > 0, upd_neu,
                                         h_next)
                if k == last:
                    h_next, ln_vjp = _layer_norm_linearized(self.laynorm,
                                                            h_next)
                steps.append((layer, h, alpha, upd, upd_vjp, neu_vjp,
                              ln_vjp))
                h = torch.where(graph.dirichlet_mask > 0, h_initial, h_next)
                h = (h * graph.fnode_mask).contiguous()

        def vjp(v: torch.Tensor) -> torch.Tensor:
            for layer, h, alpha, upd, upd_vjp, neu_vjp, ln_vjp in \
                    reversed(steps):
                g = v * free                                 # ∂/∂h_next
                if ln_vjp is not None:
                    g = ln_vjp(g)
                dh = 0.0
                if neu_vjp is not None:                      # Neumann rows
                    d_neu = neu_vjp(g * neu)
                    dh = d_neu[:, :D] + message_passing_vjp(
                        self.phi_neumann, h, graph, "from",
                        d_neu[:, D:2 * D])
                    g = g * (1.0 - neu)
                # h_next = h + α·update(concat), α = σ(alpha(concat))
                d_gate = (torch.sum(g * upd, dim=-1, keepdim=True)
                          * alpha * (1.0 - alpha))
                d_cat = upd_vjp(alpha * g) + d_gate * gate_w
                v = (g + dh + d_cat[:, :D]
                     + message_passing_vjp(layer.phi_to, h, graph, "to",
                                           d_cat[:, D:2 * D])
                     + message_passing_vjp(layer.phi_from, h, graph, "from",
                                           d_cat[:, 2 * D:3 * D]))
            return v

        return vjp


def _mlp_linearized(mlp: MLP, x: torch.Tensor):
    """(mlp(x), g ↦ the VJP in x at x), the ReLU masks kept."""
    last = len(mlp.layers) - 1
    masks = []
    for i, lin in enumerate(mlp.layers):
        x = lin(x)
        if i < last:
            masks.append((x > 0).to(x.dtype))
            x = torch.relu(x)
    weights = [lin.weight.detach() for lin in mlp.layers]

    def vjp(g: torch.Tensor) -> torch.Tensor:
        for i in range(last, -1, -1):
            if i < last:
                g = g * masks[i]
            g = g @ weights[i]
        return g

    return x, vjp


def _layer_norm_linearized(ln: nn.LayerNorm, x: torch.Tensor):
    """(ln(x), g ↦ the VJP in x at x): the normalised rows and the
    reciprocal standard deviation kept (biased variance, ``ln.eps``)."""
    var, mean = torch.var_mean(x, dim=-1, unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + ln.eps)
    xhat = (x - mean) * rstd
    w = ln.weight.detach()

    def vjp(g: torch.Tensor) -> torch.Tensor:
        gx = g * w
        return rstd * (gx - torch.mean(gx, dim=-1, keepdim=True)
                       - xhat * torch.mean(gx * xhat, dim=-1, keepdim=True))

    return xhat * w + ln.bias.detach(), vjp


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
    nstep: int           # solver step of the best (Picard: last) iterate
    lowest: float        # best relative residual of the fixed point
    prot_break: bool     # divergence protection fired


def psignn_inference(model: Psignn, graph: Graph, cfg: PsignnConfig
                     ) -> PsignnInference:
    """Encode, solve the fixed point, decode: the spans ``infer`` ⊃
    ``infer.encode``, ``deq.forward``, ``infer.decode``."""
    with torch.no_grad(), profiling.span("infer"):
        with profiling.span("infer.encode"):
            h_initial = model.encoder(graph.x) * graph.fnode_mask
        out = fixed_point_forward(model.function, h_initial, graph, cfg.deq)
        with profiling.span("infer.decode"):
            u = model.decoder(out.result) * graph.fnode_mask
    return PsignnInference(u, out.nstep, out.lowest, out.prot_break)


class PsignnOutput(NamedTuple):
    u_final: torch.Tensor
    losses: Dict[str, torch.Tensor]   # the nine 0-d entries of the JAX dict
    fw: SolveStats                    # forward solve
    adjoint: AdjointSolve             # backward solve, after backward()


def psignn_forward(model: Psignn, graph: Graph, cfg: PsignnConfig,
                   generator: torch.Generator, training: bool = True
                   ) -> PsignnOutput:
    """Full forward with the loss dictionary (model.py:58-97).

    Training mode attaches the implicit backward; eval mode also estimates
    the spectral radius.  Detaches exactly where the JAX package calls
    ``stop_gradient`` (``models/psignn.py:168-175``)."""
    h_initial = model.encoder(graph.x) * graph.fnode_mask
    out = deq_solve(model.function, h_initial, graph, cfg.deq, generator,
                    compute_sradius=not training, jac_vecs=cfg.jac_vecs)
    h_final = out.new_h_star
    u_final = model.decoder(h_final) * graph.fnode_mask
    nodes = graph.fnode_mask[:, 0] > 0

    res = residual_loss(u_final, graph)
    u_det = u_final.detach()
    h_det = h_final.detach()
    # encoder loss on detached values (model.py:75-79)
    enc_loss = mse_masked(model.encoder(u_det), h_det, nodes)
    # decoder round-trip with a detached encoding (model.py:82)
    auto_loss = mse_masked(model.decoder(model.encoder(u_det).detach()),
                           u_det, nodes)
    mse = mse_masked(u_final, graph.sol, nodes)
    mse_dir = mse_masked(u_final, graph.x, graph.dirichlet_mask[:, 0] > 0)

    def scalar(v):
        return torch.tensor(float(v), dtype=u_final.dtype,
                            device=u_final.device)

    losses = {
        "residual_loss": res,
        "jacobian_loss": out.jac_loss,
        "encoder_loss": enc_loss,
        "autoencoder_loss": auto_loss,
        "mse_loss": mse,
        "mse_dirichlet": mse_dir,
        "fw_lowest": scalar(out.fw.lowest),
        "fw_nstep": scalar(out.fw.nstep),
        "sradius": out.sradius,
    }
    return PsignnOutput(u_final, losses, out.fw, out.adjoint)


def graph_lanes(graph: Graph) -> Lanes:
    """One solver lane per graph of the concatenated batch."""
    return Lanes(graph.graph_id, graph.n_nodes.tolist())


def psignn_forward_stacked(model: Psignn, graph: Graph, cfg: PsignnConfig,
                           generator: torch.Generator, training: bool = True
                           ) -> PsignnOutput:
    """``psignn_forward`` with one DEQ solve per graph (JAX
    ``psignn_forward_stacked``, ``models/psignn.py:195-233``): each mesh
    stops at its own tolerance, the adjoint solve runs per graph too, and
    every loss is a per-graph loss averaged over the graphs, not the
    batch's node-weighted one.  The graphs stay concatenated: f_θ runs once
    per iteration on the whole batch, through the same kernels, and the
    solvers keep one lane per graph (``solvers.Lanes``).  ``fw`` and the
    adjoint stats hold (G,) arrays; ``losses["fw_nstep_per_graph"]`` is
    the (G,) tensor of the forward solves' steps."""
    lanes = graph_lanes(graph)
    h_initial = model.encoder(graph.x) * graph.fnode_mask
    out = deq_solve(model.function, h_initial, graph, cfg.deq, generator,
                    compute_sradius=not training, jac_vecs=cfg.jac_vecs,
                    lanes=lanes)
    h_final = out.new_h_star
    u_final = model.decoder(h_final) * graph.fnode_mask
    nodes = graph.fnode_mask[:, 0] > 0

    u_det = u_final.detach()
    h_det = h_final.detach()

    def mse(a, b, mask):
        return mse_masked_per_graph(a, b, mask, graph)

    per_graph = {
        "residual_loss": residual_per_graph(u_final, graph),
        "jacobian_loss": out.jac_loss,
        "encoder_loss": mse(model.encoder(u_det), h_det, nodes),
        "autoencoder_loss": mse(model.decoder(model.encoder(u_det).detach()),
                                u_det, nodes),
        "mse_loss": mse(u_final, graph.sol, nodes),
        "mse_dirichlet": mse(u_final, graph.x, graph.dirichlet_mask[:, 0] > 0),
        "fw_lowest": torch.as_tensor(out.fw.lowest, dtype=u_final.dtype,
                                     device=u_final.device),
        "fw_nstep": torch.as_tensor(out.fw.nstep, dtype=u_final.dtype,
                                    device=u_final.device),
        "sradius": out.sradius,
    }
    losses = {k: torch.mean(v) for k, v in per_graph.items()}
    losses["fw_nstep_per_graph"] = per_graph["fw_nstep"]
    return PsignnOutput(u_final, losses, out.fw, out.adjoint)


def psignn_iterative_inference(model: Psignn, graph: Graph,
                               cfg: PsignnConfig) -> Dict[str, Any]:
    """The decoded iterate trace of one solve (JAX
    ``psignn_iterative_inference``, ``models/psignn.py:261-295``): every
    entry of the solver's trace (unvisited ones included, as JAX returns
    them) decoded, with its residual, MSE against the FEM solution, and the
    MSE on the Dirichlet and on the interior nodes; ``initial`` holds the
    same for the raw initial condition x (iterate 0 of the reference).
    Returns ``{"initial", "trace", "nstep", "trace_len"}``."""
    with torch.no_grad():
        h_initial = model.encoder(graph.x) * graph.fnode_mask
        out = fixed_point_forward(model.function, h_initial, graph, cfg.deq,
                                  keep_trace=True)
        bmask = graph.dirichlet_mask[:, 0] > 0
        imask = (~bmask) & (graph.fnode_mask[:, 0] > 0)
        nodes = graph.fnode_mask[:, 0] > 0
        U = model.decoder(out.trace) * graph.fnode_mask      # (K, N, 1)

        def metrics(U, stacked):
            mse = mse_masked_stacked if stacked else mse_masked
            res = (residual_loss_stacked(U, graph) if stacked
                   else residual_loss(U, graph))
            return dict(res=res, mse=mse(U, graph.sol, nodes),
                        bound_mse=mse(U, graph.sol, bmask),
                        inter_mse=mse(U, graph.sol, imask), u=U)

        return dict(initial=metrics(graph.x, False),
                    trace=metrics(U, True), nstep=out.nstep,
                    trace_len=out.trace_len)
