"""Graph ops: directional message passing, SpMV residual, masked means.

Port of ``psignn_tpu/ops.py`` (``message_passing``, ``spmv``,
``masked_mean``, ``mse_masked``, ``residual_loss``, ``residual_per_graph``,
``mse_per_graph``).  Reference semantics:

* ``Phi_to`` aggregates at receivers with x_i = receiver features,
  ``Phi_from`` at senders with x_i = sender features;
* message passing drops self-loops, the SpMV residual keeps the diagonal;
* means divide by true node counts.
"""

from __future__ import annotations

import torch

from .graphs import Graph
from .kernels.fused_mp import fused_message_passing
from .nn import MLP


def message_passing(mlp: MLP, h: torch.Tensor, graph: Graph,
                    direction: str) -> torch.Tensor:
    """One directional aggregation (Phi_to / Phi_from) of the 2-layer edge
    MLP ``mlp``.  The fused kernel's wrapper picks the CUDA kernel or the
    plain version by the device of ``h``."""
    if direction == "to":
        csr = graph.mp_to
    elif direction == "from":
        csr = graph.mp_from
    else:
        raise ValueError(direction)
    if len(mlp.layers) != 2:
        raise ValueError("message passing takes a 2-layer edge MLP")
    l1, l2 = mlp.layers
    return fused_message_passing(l1.weight, l1.bias, l2.weight, l2.bias, h,
                                 csr)


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
