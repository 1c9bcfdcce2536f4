"""Graph ops: directional message passing, SpMV residual, masked means.

Port of ``psignn_tpu/ops.py`` (``message_passing``, ``spmv``,
``masked_mean``, ``mse_masked``, ``residual_loss``, ``residual_per_graph``,
``mse_per_graph``, their masked per-graph means (the losses of the
stacked forward), the stacked per-iteration losses of the unrolled models
and DSS's BC-encoded residual), and ``message_passing_vjp``, the
explicit cotangent of ``h`` that f_θ's ``linearize`` needs (JAX takes it
by ``jax.vjp``).  Reference semantics:

* ``Phi_to`` aggregates at receivers with x_i = receiver features,
  ``Phi_from`` at senders with x_i = sender features;
* message passing drops self-loops, the SpMV residual keeps the diagonal;
* means divide by true node counts;
* DSS's residual is the BC-encoded form over the off-diagonal system A′
  (``a_ij`` of a DSS graph): ``(1−B1)(−B0) + B1(u−B2) + Σ_j a′_ij (u_j −
  u_i)`` with ``b_prime = [B0, B1, B2]``.
"""

from __future__ import annotations

import torch

from .graphs import Graph
from .kernels import fused_mp
from .kernels.fused_mp import fused_message_passing
from .nn import MLP


def _edge_mlp(mlp: MLP, graph: Graph, direction: str):
    """(csr, first layer, second layer) of a message passing."""
    if direction == "to":
        csr = graph.mp_to
    elif direction == "from":
        csr = graph.mp_from
    else:
        raise ValueError(direction)
    if len(mlp.layers) != 2:
        raise ValueError("message passing takes a 2-layer edge MLP")
    return (csr, *mlp.layers)


def message_passing(mlp: MLP, h: torch.Tensor, graph: Graph,
                    direction: str) -> torch.Tensor:
    """One directional aggregation (Phi_to / Phi_from) of the 2-layer edge
    MLP ``mlp``.  The fused kernel's wrapper picks the CUDA kernel or the
    plain version by the device of ``h``."""
    csr, l1, l2 = _edge_mlp(mlp, graph, direction)
    return fused_message_passing(l1.weight, l1.bias, l2.weight, l2.bias, h,
                                 csr)


def message_passing_vjp(mlp: MLP, h: torch.Tensor, graph: Graph,
                        direction: str, g: torch.Tensor) -> torch.Tensor:
    """(N, D) cotangent of ``h`` of ``message_passing`` for the output
    cotangent ``g``, without autograd: ``dh`` of the backward kernel
    (``fused_mp.fused_mp_vjp``; the plain version on the CPU)."""
    csr, l1, l2 = _edge_mlp(mlp, graph, direction)
    return fused_mp.fused_mp_vjp(
        l1.weight.detach(), l1.bias.detach(), l2.weight.detach(),
        l2.bias.detach(), h, csr, g.contiguous())[4]


def spmv(graph: Graph, u: torch.Tensor) -> torch.Tensor:
    """(N, k) sparse ``A @ u`` over the COO edges, diagonal included:
    out[i] = Σ_j A[i, j] u[j]."""
    vals = graph.a_ij * u[graph.receivers]
    out = torch.zeros((graph.total_nodes, u.shape[1]), dtype=u.dtype,
                      device=u.device)
    return out.index_add_(0, graph.senders, vals)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over the rows where ``mask`` is set, all columns.
    A 1-D mask selects rows; an (N, w) mask selects entries."""
    m = mask.to(x.dtype)[:, None] if mask.dim() == 1 else mask.to(x.dtype)
    denom = torch.sum(m) * (x.shape[-1] if mask.dim() == 1 else 1)
    return torch.sum(x * m) / denom


def mse_masked(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
    return masked_mean(torch.square(a - b), mask)


def residual_loss(u: torch.Tensor, graph: Graph) -> torch.Tensor:
    """mean((A u − b)²) over the nodes."""
    r = spmv(graph, u) - graph.b
    return mse_masked(r, torch.zeros_like(r), graph.fnode_mask[:, 0] > 0)


def per_graph_sum(x: torch.Tensor, graph: Graph) -> torch.Tensor:
    """(G,) sum of the per-node values ``x`` (N,) over each graph."""
    out = torch.zeros(graph.num_graphs, dtype=x.dtype, device=x.device)
    return out.index_add_(0, graph.graph_id, x)


def _per_graph_mean(x: torch.Tensor, graph: Graph) -> torch.Tensor:
    return per_graph_sum(x, graph) / graph.n_nodes.to(x.dtype)


def residual_per_graph(u: torch.Tensor, graph: Graph) -> torch.Tensor:
    """(G,) per-graph mean squared residual."""
    return _per_graph_mean(torch.square(spmv(graph, u) - graph.b)[:, 0], graph)


def mse_per_graph(a: torch.Tensor, b: torch.Tensor, graph: Graph
                  ) -> torch.Tensor:
    """(G,) per-graph mean squared difference."""
    return _per_graph_mean(torch.square(a - b)[:, 0], graph)


def masked_mean_per_graph(x: torch.Tensor, mask: torch.Tensor,
                          graph: Graph) -> torch.Tensor:
    """(G,) ``masked_mean`` over each graph's own rows where the (N,)
    ``mask`` is set, all columns."""
    m = mask.to(x.dtype)
    num = per_graph_sum(torch.sum(x * m[:, None], dim=1), graph)
    return num / (per_graph_sum(m, graph) * x.shape[-1])


def mse_masked_per_graph(a: torch.Tensor, b: torch.Tensor,
                         mask: torch.Tensor, graph: Graph) -> torch.Tensor:
    """(G,) ``mse_masked`` of each graph."""
    return masked_mean_per_graph(torch.square(a - b), mask, graph)


def mse_masked_stacked(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
    """(k,) MSE of each leading slice of ``a`` (k, N, w) against ``b``
    (N, w) over the rows where ``mask`` (N,) is set."""
    m = mask.to(a.dtype)[:, None]
    num = torch.sum(torch.square(a - b[None]) * m[None], dim=(1, 2))
    return num / (torch.sum(m) * a.shape[-1])


def _stacked(U: torch.Tensor) -> torch.Tensor:
    """(k, N, 1) iterates as the (N, k) channels of one sweep."""
    return U[..., 0].T


def _per_iteration_mse(r: torch.Tensor, graph: Graph) -> torch.Tensor:
    """(k,) mean square over the nodes of each column of ``r`` (N, k)."""
    return mse_masked_stacked(r.T[..., None], torch.zeros_like(r[:, :1]),
                              graph.fnode_mask[:, 0] > 0)


def residual_loss_stacked(U: torch.Tensor, graph: Graph) -> torch.Tensor:
    """(k,) mean((A u_t − b)²) of the k iterates ``U`` (k, N, 1) of an
    unrolled model, as the k channels of one SpMV."""
    return _per_iteration_mse(spmv(graph, _stacked(U)) - graph.b, graph)


def _flux(graph: Graph, u: torch.Tensor) -> torch.Tensor:
    """(N, k) Σ_j a′_ij (u_j − u_i) over the edges of A′."""
    vals = graph.a_ij * (u[graph.receivers] - u[graph.senders])
    out = torch.zeros((graph.total_nodes, u.shape[1]), dtype=u.dtype,
                      device=u.device)
    return out.index_add_(0, graph.senders, vals)


def dss_residual_vector(u: torch.Tensor, graph: Graph) -> torch.Tensor:
    """(N, k) BC-encoded residual of ``u`` (N, k): interior rows (B1 = 0)
    give −B0 + Σ_j a′_ij (u_j − u_i), Dirichlet rows (B1 = 1, no edges in
    A′) give u − B2."""
    b0, b1, b2 = graph.b_prime.split(1, dim=1)
    return (1.0 - b1) * (-b0) + b1 * (u - b2) + _flux(graph, u)


def dss_residual_loss(u: torch.Tensor, graph: Graph) -> torch.Tensor:
    """Mean square of the BC-encoded residual over the nodes."""
    r = dss_residual_vector(u, graph)
    return mse_masked(r, torch.zeros_like(r), graph.fnode_mask[:, 0] > 0)


def dss_residual_loss_stacked(U: torch.Tensor, graph: Graph) -> torch.Tensor:
    """(k,) BC-encoded residual losses of the iterates ``U`` (k, N, 1) in
    one sweep with k channels."""
    return _per_iteration_mse(dss_residual_vector(_stacked(U), graph), graph)
