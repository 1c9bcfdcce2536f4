"""Per-graph error metrics and the test-set table.

Port of ``errors_batch``, ``evaluate_dataset`` and ``metrics_table``
(``psignn_tpu/eval/metrics.py``): for each graph of a batch the mean
squared residual, the normalised residual ‖Au−b‖/‖b‖, the MSE against the
FEM solution, the relative L2 error ‖u−sol‖/‖sol‖ and the MSE on Dirichlet
nodes; then the dataset's means and stds in a printed table.  A DSS graph
(one carrying ``b_prime``) takes the BC-encoded residual over A′ and
normalises it by ‖B0 + B2‖, as the reference's DSS branch does
(tests/test_func_dirichlet.py:26-48, 89-91).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from ..graphs import Graph
from ..ops import dss_residual_vector, per_graph_sum, spmv


def errors_batch(u: torch.Tensor, graph: Graph) -> Dict[str, torch.Tensor]:
    """(G,) per-graph metrics: res, res_norm, mse, rel, mse_bound."""
    if graph.b_prime is not None:
        residual = dss_residual_vector(u, graph)
        rhs = graph.b_prime[:, 0:1] + graph.b_prime[:, 2:3]
    else:
        residual = spmv(graph, u) - graph.b
        rhs = graph.b
    counts = graph.n_nodes.to(u.dtype)

    res_sq = per_graph_sum(torch.square(residual)[:, 0], graph)
    b_sq = per_graph_sum(torch.square(rhs)[:, 0], graph)
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


def evaluate_dataset(predict_fn: Callable, loader, name: str = "model",
                     verbose: bool = True) -> Dict[str, float]:
    """Means and stds over every graph of ``loader`` of ``errors_batch``,
    with ``predict_fn(graph) -> u`` (test_func.py:68-120); prints the
    table when ``verbose``."""
    acc: Dict[str, List[float]] = {}
    for graph in loader:
        for k, v in errors_batch(predict_fn(graph), graph).items():
            acc.setdefault(k, []).extend(v.cpu().tolist())
    out = {}
    for k, v in acc.items():
        out[k + "_mean"] = float(np.mean(v))
        out[k + "_std"] = float(np.std(v))
    if verbose:
        print(metrics_table({name: out}))
    return out


def metrics_table(results: Dict[str, Dict[str, float]]) -> str:
    """Plain-text table of the means (test_func.py:119-120)."""
    headers = ["Name", "Residual", "ResidualNorm", "MSE", "Rel", "MSEBound"]
    keys = ["res_mean", "res_norm_mean", "mse_mean", "rel_mean",
            "mse_bound_mean"]
    rows = [headers]
    for name, m in results.items():
        rows.append([name] + ["{:.3e}".format(m.get(k, float("nan")))
                              for k in keys])
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(headers))]
    lines = []
    for i, r in enumerate(rows):
        lines.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
        if i == 0:
            lines.append("-" * (sum(widths) + 2 * len(widths)))
    return "\n".join(lines)
