"""Per-graph error metrics.

Port of ``errors_batch`` (``psignn_tpu/eval/metrics.py``), Ψ-GNN form:
for each graph of a batch the mean squared residual, the normalised
residual ‖Au−b‖/‖b‖, the MSE against the FEM solution, the relative L2
error ‖u−sol‖/‖sol‖ and the MSE on Dirichlet nodes.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..graphs import Graph
from ..ops import per_graph_sum, spmv


def errors_batch(u: torch.Tensor, graph: Graph) -> Dict[str, torch.Tensor]:
    """(G,) per-graph metrics: res, res_norm, mse, rel, mse_bound."""
    residual = spmv(graph, u) - graph.b
    counts = graph.n_nodes.to(u.dtype)

    res_sq = per_graph_sum(torch.square(residual)[:, 0], graph)
    b_sq = per_graph_sum(torch.square(graph.b)[:, 0], graph)
    err = torch.square(u - graph.sol)[:, 0]
    err_sq = per_graph_sum(err, graph)
    sol_sq = per_graph_sum(torch.square(graph.sol)[:, 0], graph)
    bmask = graph.dirichlet_mask[:, 0]
    berr = per_graph_sum(err * bmask, graph)
    bcount = per_graph_sum(bmask, graph)

    return dict(res=res_sq / counts,
                res_norm=torch.sqrt(res_sq) / torch.sqrt(b_sq),
                mse=err_sq / counts,
                rel=torch.sqrt(err_sq) / torch.sqrt(sol_sq),
                mse_bound=berr / torch.clamp(bcount, min=1.0))
