"""Batched mesh graphs as torch tensors on one device.

Port of ``PaddedGraph`` / ``batch_graphs`` (``psignn_tpu/graphs.py``).  The
JAX package pads every batch to bucketed capacities because XLA needs
static shapes; PyTorch runs eagerly, so a batch here is the plain
concatenation of its samples and every row is real.  The masks the model
reads (``fnode_mask``, ``dirichlet_mask``, and ``neumann_mask`` in the
mixed variant) are built once per batch.  The widths of ``tags`` and
``prb_data`` come from the samples: 1 and 2 in the Dirichlet variant, a
3-column one-hot [interior, dirichlet, neumann] and 3 in the mixed one,
which also carries ``unit_normal_vector``.  A DSS graph holds the
off-diagonal system A′ (its ``a_ij``), the BC-encoded right-hand side
``b_prime`` and their normalised forms; its message passing reads the 1-wide
``a_ij_norm`` where the other families read the 3-wide ``edge_attr``
(JAX ``graphs.py:220-223``).

Conventions as in the JAX package: ``senders[e], receivers[e]`` are the
COO row/col of the e-th nonzero of A, so ``A[senders, receivers] = a_ij``.
Message passing drops self-loops; the SpMV residual keeps the diagonal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import profiling, resolve_device
from .kernels.fused_mp import MPCsr, pack_csr


@dataclasses.dataclass(frozen=True)
class Graph:
    """A batch of mesh graphs, concatenated (no padding)."""
    # --- node data (N rows) ---
    x: torch.Tensor               # (N, 1) initial condition (0 inside, b on Dirichlet)
    b: torch.Tensor               # (N, 1) right-hand side of A u = b
    sol: torch.Tensor             # (N, 1) FEM solution (reporting only)
    prb_data: torch.Tensor        # (N, 2|3) normalised [f, g(, f_neumann)]
    tags: torch.Tensor            # (N, 1) 1 on Dirichlet nodes, or (N, 3) one-hot
    pos: torch.Tensor             # (N, 2) vertex coordinates
    fnode_mask: torch.Tensor      # (N, 1) float, 1 on real nodes (all, unpadded)
    dirichlet_mask: torch.Tensor  # (N, 1) float, 1 on Dirichlet nodes
    graph_id: torch.Tensor        # (N,) int64 graph of each node
    # --- edge data (E rows, COO over the nonzeros of A) ---
    senders: torch.Tensor         # (E,) int64 row index i
    receivers: torch.Tensor       # (E,) int64 col index j
    a_ij: torch.Tensor            # (E, 1) A[i, j]
    edge_attr: torch.Tensor       # (E, 3) normalised [dx, dy, |d|]
    # --- per graph ---
    n_nodes: torch.Tensor         # (G,) int64
    n_edges: torch.Tensor         # (G,) int64
    # --- CSR packings for the fused message-passing kernels ---
    mp_to: MPCsr                  # aggregation at receivers
    mp_from: MPCsr                # aggregation at senders (mp_to.reverse())
    num_graphs: int = 1
    # --- mixed variant only ---
    neumann_mask: Optional[torch.Tensor] = None        # (N, 1) float
    unit_normal_vector: Optional[torch.Tensor] = None  # (N, 2) normalised
    # --- DSS only ---
    a_ij_norm: Optional[torch.Tensor] = None     # (E, 1) normalised A′[i, j]
    b_prime: Optional[torch.Tensor] = None       # (N, 3) [B0, B1, B2]
    b_prime_norm: Optional[torch.Tensor] = None  # (N, 3) normalised

    @property
    def total_nodes(self) -> int:
        """Node count across the batch (every row is real)."""
        return self.x.shape[0]

    @property
    def mp_edge_mask(self) -> torch.Tensor:
        """(E,) bool: edges that message passing uses (self-loops removed)."""
        return self.senders != self.receivers

    @property
    def device(self) -> torch.device:
        return self.x.device


# widths of the optional per-sample fields (mixed normals, DSS system)
OPTIONAL_WIDTHS = {"unit_normal_vector": 2, "a_ij_norm": 1, "b_prime": 3,
                   "b_prime_norm": 3}


def batch_graphs(samples: Sequence[Dict[str, np.ndarray]], device=None,
                 dtype=np.float32) -> Graph:
    """Concatenate per-sample numpy dicts (``data.reader`` format) into one
    Graph on ``device`` (default: ``default_device()``).  Index arrays are
    per-sample local and are offset here.  The span ``graph.batch`` holds
    ``graph.csr`` (``pack_csr``) and a ``graph.copy`` for each array
    copied to ``device``."""
    with profiling.span("graph.batch"):
        return _batch_graphs(samples, resolve_device(device), dtype)


def _batch_graphs(samples: Sequence[Dict[str, np.ndarray]],
                  device: torch.device, dtype) -> Graph:
    def cat(key, width, dt=dtype):
        return np.concatenate([np.asarray(s[key], dt).reshape(-1, width)
                               for s in samples])

    n_nodes = np.array([s["x"].shape[0] for s in samples], np.int64)
    n_edges = np.array([s["senders"].shape[0] for s in samples], np.int64)
    node_off = np.concatenate([[0], np.cumsum(n_nodes)[:-1]])
    senders = np.concatenate([np.asarray(s["senders"], np.int64) + o
                              for s, o in zip(samples, node_off)])
    receivers = np.concatenate([np.asarray(s["receivers"], np.int64) + o
                                for s, o in zip(samples, node_off)])
    total = int(n_nodes.sum())

    def width(key):
        a = np.asarray(samples[0][key])
        return a.reshape(a.shape[0], -1).shape[1]

    tags = cat("tags", width("tags"))
    edge_attr = cat("edge_attr", 3)
    # the optional fields every sample carries
    optional = {k: cat(k, w) for k, w in OPTIONAL_WIDTHS.items()
                if all(k in s for s in samples)}
    # Dirichlet variant: tags == 1; mixed: one-hot column 1 (column 0 is
    # the interior flag there)
    dcol = 0 if tags.shape[1] == 1 else 1

    def t(a):
        with profiling.span("graph.copy"):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    extra = {k: t(v) for k, v in optional.items()}
    if tags.shape[1] == 3:
        extra["neumann_mask"] = t((tags[:, 2:3] == 1).astype(dtype))
    mp_to = pack_csr(senders, receivers,
                     optional.get("a_ij_norm", edge_attr), total, "to",
                     device=device)
    return Graph(
        x=t(cat("x", 1)), b=t(cat("b", 1)), sol=t(cat("sol", 1)),
        prb_data=t(cat("prb_data", width("prb_data"))), tags=t(tags),
        pos=t(cat("pos", 2)), fnode_mask=t(np.ones((total, 1), dtype)),
        dirichlet_mask=t((tags[:, dcol:dcol + 1] == 1).astype(dtype)),
        graph_id=t(np.repeat(np.arange(len(samples)), n_nodes)),
        senders=t(senders), receivers=t(receivers),
        a_ij=t(cat("a_ij", 1)), edge_attr=t(edge_attr),
        n_nodes=t(n_nodes), n_edges=t(n_edges),
        mp_to=mp_to, mp_from=mp_to.reverse(), num_graphs=len(samples),
        **extra)
