"""Plain reference of a mixed Dirichlet–Neumann Ψ-GNN request: the
encoder, the mixed update function f_θ, the decoder, and a plain Broyden
solve of the fixed point, in PyTorch over the checkpoint's JAX-layout
parameters.

f_θ is mnastorg/PSI-GNN ``mixed/psignn/model.py:213-244``: beside the
Dirichlet layer's two message passings (``phi_to``, ``phi_from``), its
gate and its gated update, a third message passing ``phi_neumann`` in the
``from`` direction on the same h, and the ``update_neumann`` MLP of
[h, mp_neumann, prb_data, unit_normal_vector], which overwrites the
Neumann rows; then the LayerNorm (last layer) and the hard Dirichlet
reset, in that order.  Departures from that file:

* the parameters are the checkpoint's tree (the JAX package's layout, a
  linear layer's weight (in, out)), in which ``phi_neumann`` and
  ``update_neumann`` sit beside the layers and serve each of them; the
  published model has one layer, so the two agree;
* a node sums its messages by ``index_add_`` (PyTorch Geometric's "add"
  aggregation), self-loops dropped as there;
* the control's fixed point is plain Broyden without line search (the
  configured ``ls`` is false), as ``psignn.broyden``.

The sample is the mixed one of ``benchlib/gen_mixed.py``: one-hot tags
[interior, dirichlet, neumann], prb_data [f, g, f_neumann], the
normalised unit normals.  ``judge``, ``aggregate`` and the numbers are
``psignn``'s: the residual of the program's z* under this f_θ and
encoding, its gap to the program's reported residual, and the decoder's
gap at z*.  Imports torch and numpy, and the reference's own
``common`` and ``psignn``; nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .common import Edges, layer_norm, linear, message_passing, mlp
from .psignn import _rel, aggregate, broyden  # noqa: F401  (the cell's)
from . import psignn


class Nodes:
    """A mixed sample's node tensors on ``device``: x (N, 1), prb_data
    (N, 3), the Dirichlet and Neumann masks (N, 1) and the normals
    (N, 2)."""

    def __init__(self, sample: Dict[str, np.ndarray], device):
        def t(a, w):
            return torch.as_tensor(np.asarray(a, np.float32).reshape(-1, w),
                                   device=device)
        tags = t(sample["tags"], 3)
        self.x = t(sample["x"], 1)
        self.prb = t(sample["prb_data"], 3)
        self.dmask = tags[:, 1:2]
        self.nmask = tags[:, 2:3]
        self.normals = t(sample["unit_normal_vector"], 2)


class Model(psignn.Model):
    """The checkpoint's mixed Ψ-GNN, on ``device``."""

    def f(self, h: torch.Tensor, h0: torch.Tensor, nodes: Nodes,
          edges: Edges) -> torch.Tensor:
        fn, pr = self.p["function"], self.precision
        last = len(fn["layers"]) - 1
        for k, layer in enumerate(fn["layers"]):
            mp_to = message_passing(layer["phi_to"], h, edges, "to", pr)
            mp_from = message_passing(layer["phi_from"], h, edges, "from", pr)
            concat = torch.cat([h, mp_to, mp_from, nodes.prb], -1)
            alpha = torch.sigmoid(linear(fn["alpha"], concat, pr))
            h_next = h + alpha * mlp(layer["update"], concat, pr)
            mp_neu = message_passing(fn["phi_neumann"], h, edges, "from", pr)
            upd_neu = mlp(fn["update_neumann"], torch.cat(
                [h, mp_neu, nodes.prb, nodes.normals], -1), pr)
            h_next = torch.where(nodes.nmask > 0, upd_neu, h_next)
            if k == last:
                h_next = layer_norm(fn["laynorm"], h_next)
            h = torch.where(nodes.dmask > 0, h0, h_next)
        return h


def judge(model: Model, sample: Dict[str, np.ndarray], answer: dict,
          cfg: dict) -> Dict[str, float]:
    """``psignn.judge``'s numbers of one mixed request; ``answer`` holds
    the program's ``z`` (N, D) and ``u`` (N,) in mesh order and the
    residual it ``reported``."""
    dev, z, u = model.device, answer["z"], answer["u"]
    with torch.no_grad():
        nodes = Nodes(sample, dev)
        edges = Edges(sample, dev)
        h0 = model.encode(nodes.x)
        zt = torch.as_tensor(np.asarray(z, np.float32), device=dev)
        fz = model.f(zt, h0, nodes, edges)
        res = _rel(fz - zt, fz)
        u_ref = model.decode(zt)[:, 0].cpu().numpy().astype(np.float64)
    scale = max(float(np.max(np.abs(u_ref))), 1e-6)
    return dict(nodes=int(zt.shape[0]), residual=res,
                residual_gap=abs(res - float(answer["reported"])),
                decode_gap=float(np.max(np.abs(np.asarray(u, np.float64)
                                               - u_ref)) / scale))


def solve(model: Model, sample: Dict[str, np.ndarray], fw_tol: float,
          fw_thres: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """A request answered by the reference itself: (z*, u, residual) in
    mesh order (the control)."""
    dev = model.device
    with torch.no_grad():
        nodes = Nodes(sample, dev)
        edges = Edges(sample, dev)
        h0 = model.encode(nodes.x)
        shape = h0.shape

        def g(v):
            h = v.reshape(shape)
            return (model.f(h, h0, nodes, edges) - h).reshape(-1)

        z, res, _ = broyden(g, h0.reshape(-1), fw_thres, fw_tol)
        z = z.reshape(shape)
        u = model.decode(z)[:, 0]
    return z.cpu().numpy(), u.cpu().numpy(), res


def request_flops(cfg: dict, n: int, e: int, fw_calls: int,
                  mp_flops) -> float:
    """Model operations of one request: ``fw_calls`` evaluations of f_θ
    (per layer three message passings at ``mp_flops(n, e)``, the
    Dirichlet branch's node MLP, gate and update, the Neumann MLP and its
    overwrite, and the LayerNorm and reset), the encoder and the
    decoder."""
    D, P = cfg["latent_dim"], 3
    c = 3 * D + P
    node = (2 * c * 1 + 4              # alpha linear, sigmoid
            + 2 * c * D + 2 * D * D + D  # update MLP and its ReLU
            + 3 * D)                   # h + α·update, Dirichlet reset
    cn = 2 * D + P + 2
    neumann = 2 * cn * D + D + 2 * D * D + D   # update_neumann, overwrite
    f_call = cfg["n_layers"] * (3 * mp_flops(n, e) + n * (node + neumann)) \
        + n * 8 * D
    autoenc = n * (2 * 1 * D + D + 2 * D * D) + n * (2 * D * D + D + 2 * D)
    return fw_calls * f_call + autoenc
