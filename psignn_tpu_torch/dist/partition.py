"""Single-graph partition parallelism: edge-sharded message passing and
SpMV, the RCM halo partition, and the halo exchange.

Port of ``psignn_tpu/dist/partition.py`` and of the RCM helpers of
``psignn_tpu/kernels/fused_mp.py:41-70`` (the port's own copies, numpy and
scipy only):

* ``partition_message_passing`` / ``partition_spmv`` — each rank takes a
  contiguous shard of the (padded) edges, runs the CUDA forward kernel on a
  CSR of its shard over the full ``h`` (self-loops and padded edges
  masked), and the partial aggregations are summed over the row.  The op
  is differentiable as JAX's is: the inputs are replicated and their
  gradients summed over the row, so every rank holds the full gradient.
* ``build_halo_partition`` — after RCM every edge joins nodes within
  ``halo`` positions, so a 1-D node partition of ``n_loc`` rows needs only
  the ``halo`` rows of each neighbour.  Its arrays are JAX's, bit for bit
  (the packing is vectorised; its order is the JAX loop's).
* ``halo_exchange`` — an autograd op: each rank's ``(n_loc, D)`` rows
  become its window ``[left halo | n_loc | right halo]``.  Its backward
  sends each halo row's cotangent back to the rank that owns the row,
  where it is added (JAX gets this from the transpose of ``ppermute``),
  and is itself differentiable (its backward is the exchange again), as
  the Hutchinson loss's second-order backward needs.
* ``halo_message_passing`` — directional message passing over one rank's
  window: the CUDA kernel on a CSR of the rank's edges in window
  coordinates, aggregation rows at ``[halo, halo + n_loc)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.fused_mp import MPCsr, fused_message_passing, pack_csr
from .multihost import Mesh


# ------------------------------------------------------------ RCM ordering

def rcm_permutation(senders: np.ndarray, receivers: np.ndarray,
                    n_nodes: int) -> np.ndarray:
    """Reverse-Cuthill-McKee node order (old indices in new order) of the
    symmetrised pattern (JAX ``kernels/fused_mp.py:41-57``: Dirichlet rows
    of A are identity rows, and RCM's BFS cannot leave such sinks)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    rows = np.concatenate([senders, receivers])
    cols = np.concatenate([receivers, senders])
    A = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                      shape=(n_nodes, n_nodes)).tocsr()
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))


def apply_node_permutation(sample: Dict[str, np.ndarray],
                           perm: np.ndarray) -> Dict[str, np.ndarray]:
    """A sample's node arrays (first axis of length N) permuted by
    ``perm`` and its edge endpoints remapped (JAX ``fused_mp.py:60-70``)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    out = dict(sample)
    n = len(perm)
    for k, v in sample.items():
        if k in ("senders", "receivers"):
            out[k] = inv[np.asarray(v)].astype(np.int32)
        elif hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1 \
                and v.shape[0] == n:
            out[k] = np.asarray(v)[perm]
    return out


def rcm_ordered(sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``sample`` with its nodes in reverse Cuthill-McKee order, as JAX
    puts each sample in that order before its fused kernels
    (``reader.py:288-295``, ``bench.py:99-104``)."""
    return apply_node_permutation(sample, rcm_permutation(
        sample["senders"], sample["receivers"], sample["x"].shape[0]))


# ------------------------------------------------------- edge-sharded ops

def pad_edges_for_sharding(arrs: dict, n_devices: int) -> dict:
    """Pad the 1-D / 2-D edge arrays so the edge count divides
    ``n_devices``; padded entries get mask False and index 0."""
    e = arrs["senders"].shape[0]
    pad = (-e) % n_devices
    if pad == 0:
        return dict(arrs)
    out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
           for k, v in arrs.items()}
    out["edge_mask"][e:] = False
    return out


def _shard(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of ``n`` edges (``P(axis)``)."""
    if n % mesh.parts:
        raise ValueError(f"{n} edges do not split over {mesh.parts} ranks; "
                         "pad them (pad_edges_for_sharding)")
    per = n // mesh.parts
    return slice(mesh.part_index * per, (mesh.part_index + 1) * per)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def partition_message_passing(mesh: Mesh):
    """The edge-sharded directional message passing of the row.

    Returns ``mp(mlp, h, senders, receivers, edge_attr, edge_mask,
    direction)``: ``mlp`` a 2-layer edge MLP, ``h`` (N, D) and the MLP
    replicated, the edge arrays the full (padded) ones; each rank keeps
    its contiguous shard.  The result is the (N, D) aggregation of
    ``ops.message_passing`` on every rank."""

    def mp(mlp, h, senders, receivers, edge_attr, edge_mask, direction):
        sel = _shard(mesh, len(senders))
        csr = pack_csr(_np(senders)[sel], _np(receivers)[sel],
                       _np(edge_attr)[sel], h.shape[0], direction,
                       edge_mask=_np(edge_mask)[sel], device=h.device)
        l1, l2 = mlp.layers
        w1, b1, w2, b2 = (mesh.replicate(t) for t in
                          (l1.weight, l1.bias, l2.weight, l2.bias))
        local = fused_message_passing(w1, b1, w2, b2, mesh.replicate(h),
                                      csr)
        return mesh.reduce(local)

    return mp


def partition_spmv(mesh: Mesh):
    """The edge-sharded sparse ``A @ u`` (full COO, diagonal included) of
    the row: ``spmv(u, senders, receivers, a_ij, edge_mask)`` with ``u``
    replicated and each rank keeping its shard of the edges."""

    def spmv(u, senders, receivers, a_ij, edge_mask):
        sel = _shard(mesh, len(senders))
        s = torch.as_tensor(_np(senders)[sel], dtype=torch.int64,
                            device=u.device)
        r = torch.as_tensor(_np(receivers)[sel], dtype=torch.int64,
                            device=u.device)
        m = torch.as_tensor(_np(edge_mask)[sel], device=u.device)
        a = torch.as_tensor(_np(a_ij)[sel], device=u.device)
        u = mesh.replicate(u)
        vals = a * u[r] * m[:, None].to(u.dtype)
        out = torch.zeros_like(u).index_add_(0, s, vals)
        return mesh.reduce(out)

    return spmv


# ---------------------------------------------------------- halo partition

def _pack_partition_edges(agg: np.ndarray, oth_idx: np.ndarray,
                          ea: np.ndarray, part: np.ndarray,
                          n_parts: int, n_loc: int) -> dict:
    """One edge set packed into (n_parts, e_cap) rows keyed by the
    aggregation partition, in edge order within each partition (JAX
    ``partition.py:104-127``; its loop, vectorised).  ``oth_idx`` is the
    already-localised source index."""
    counts = np.bincount(part, minlength=n_parts)
    e_cap = max(8, int(-(-counts.max() // 8) * 8))
    agg_l = np.zeros((n_parts, e_cap), np.int32)
    oth_l = np.zeros((n_parts, e_cap), np.int32)
    ea_p = np.zeros((n_parts, e_cap, ea.shape[1]), np.float32)
    mask = np.zeros((n_parts, e_cap), np.float32)
    order = np.argsort(part, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    p = part[order]
    k = np.arange(len(order)) - starts[p]
    agg_l[p, k] = agg[order] - p * n_loc
    oth_l[p, k] = oth_idx[order]
    ea_p[p, k] = ea[order]
    mask[p, k] = 1.0
    return dict(agg_local=agg_l, oth_local=oth_l, edge_attr=ea_p, mask=mask)


def build_halo_partition(senders: np.ndarray, receivers: np.ndarray,
                         edge_attr: np.ndarray, n_nodes: int,
                         n_parts: int, halo: Optional[int] = None,
                         split_interior: bool = False) -> dict:
    """The 1-D node partition of an RCM-ordered graph with its halo
    metadata (JAX ``partition.py:130-185``): ``n_loc`` rows a part
    (rounded up to 8), ``halo`` = the bandwidth rounded up to 8, and each
    direction's edges packed per aggregation part with aggregation indices
    local to the part and source indices local to the window ``[left halo
    | local | right halo]``; with ``split_interior``, ``{"int", "bnd"}``
    packs (interior sources indexed into the local block)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    bw = int(np.abs(senders - receivers).max()) if len(senders) else 1
    n_loc = -(-n_nodes // n_parts)
    n_loc = -(-n_loc // 8) * 8
    halo = halo or -(-bw // 8) * 8
    if halo > n_loc:
        raise ValueError(f"halo {halo} exceeds partition size {n_loc}; "
                         "use fewer parts or re-order nodes (RCM)")
    keep = senders != receivers
    s, r = senders[keep], receivers[keep]
    ea = np.asarray(edge_attr)[keep]
    out = {"n_loc": n_loc, "halo": halo, "n_parts": n_parts,
           "n_nodes_pad": n_loc * n_parts}
    for direction in ("to", "from"):
        agg = r if direction == "to" else s
        oth = s if direction == "to" else r
        part = agg // n_loc
        ext = oth - (part * n_loc - halo)      # window index
        if len(ext) and not ((ext >= 0) & (ext < n_loc + 2 * halo)).all():
            raise ValueError("edge exceeds halo window; increase halo")
        if split_interior:
            interior = (oth // n_loc) == part
            out[direction] = {
                "int": _pack_partition_edges(
                    agg[interior], (oth - part * n_loc)[interior],
                    ea[interior], part[interior], n_parts, n_loc),
                "bnd": _pack_partition_edges(
                    agg[~interior], ext[~interior], ea[~interior],
                    part[~interior], n_parts, n_loc),
            }
        else:
            out[direction] = _pack_partition_edges(agg, ext, ea, part,
                                                   n_parts, n_loc)
    return out


def window_csr(senders: np.ndarray, receivers: np.ndarray,
               edge_attr: np.ndarray, part: int, n_loc: int, halo: int,
               direction: str, device=None) -> MPCsr:
    """The CSR of part ``part``'s edges of one direction over its window of
    ``n_loc + 2·halo`` rows: the edges aggregating at a row of the part,
    both endpoints moved by the same affine map as JAX's
    ``_shard_mp_blocks`` (``partitioned.py:86-115``), so that self-loops
    stay self-loops (and are dropped).  Aggregation rows fall in
    ``[halo, halo + n_loc)``."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    agg = r if direction == "to" else s
    sel = agg // n_loc == part
    shift = part * n_loc - halo
    return pack_csr(s[sel] - shift, r[sel] - shift,
                    np.asarray(edge_attr)[sel], n_loc + 2 * halo, direction,
                    device=device)


# ------------------------------------------------------------ halo exchange

def _exchange(h: torch.Tensor, mesh: Mesh, halo: int) -> torch.Tensor:
    """(n_loc, D) rows → the (n_loc + 2·halo, D) window; the rows beyond
    the row's ends are zero."""
    sends = [(peer, strip) for peer, strip in
             ((mesh.left, h[:halo]), (mesh.right, h[-halo:]))
             if peer is not None]
    got = iter(mesh.exchange(sends, h[:halo]))
    zero = h.new_zeros((halo,) + tuple(h.shape[1:]))
    left = next(got) if mesh.left is not None else zero
    right = next(got) if mesh.right is not None else zero
    return torch.cat([left, h, right])


def _return(g_ext: torch.Tensor, mesh: Mesh, halo: int) -> torch.Tensor:
    """The transpose of ``_exchange``: the window's cotangent (n_loc +
    2·halo, D) → the rows' (n_loc, D), each halo strip's cotangent sent
    back to the rank that owns it and added to its rows."""
    n_loc = g_ext.shape[0] - 2 * halo
    g = g_ext[halo:halo + n_loc].clone()
    sends = [(peer, strip) for peer, strip in
             ((mesh.left, g_ext[:halo]), (mesh.right, g_ext[-halo:]))
             if peer is not None]
    got = iter(mesh.exchange(sends, g_ext[:halo]))
    if mesh.left is not None:
        g[:halo] += next(got)
    if mesh.right is not None:
        g[-halo:] += next(got)
    return g


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, mesh, halo):
        ctx.mesh, ctx.halo = mesh, halo
        return _exchange(h, mesh, halo)

    @staticmethod
    def backward(ctx, g_ext):
        return _HaloReturn.apply(g_ext, ctx.mesh, ctx.halo), None, None


class _HaloReturn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g_ext, mesh, halo):
        ctx.mesh, ctx.halo = mesh, halo
        return _return(g_ext, mesh, halo)

    @staticmethod
    def backward(ctx, g):
        return _HaloExchange.apply(g, ctx.mesh, ctx.halo), None, None


def halo_exchange(h: torch.Tensor, mesh: Mesh, halo: int) -> torch.Tensor:
    """This rank's window ``[left halo | h | right halo]`` of the row: the
    neighbours' ``halo`` boundary rows, zero beyond the row's ends
    (JAX ``partitioned.py:_halo_exchange``).  Differentiable to any
    order."""
    if mesh.parts == 1:
        zero = h.new_zeros((halo,) + tuple(h.shape[1:]))
        return torch.cat([zero, h, zero])
    return _HaloExchange.apply(h, mesh, halo)


def window_message_passing(mlp, h_ext: torch.Tensor, csr: MPCsr,
                           halo: int, n_loc: int) -> torch.Tensor:
    """(n_loc, D) aggregation at the rank's rows of the window ``h_ext``
    through the fused kernel (``csr`` from ``window_csr``)."""
    l1, l2 = mlp.layers
    out = fused_message_passing(l1.weight, l1.bias, l2.weight, l2.bias,
                                h_ext, csr)
    return out[halo:halo + n_loc]


def halo_message_passing(mesh: Mesh):
    """Directional message passing over a halo partition (JAX
    ``halo_message_passing``): ``mp(mlp, h, part, direction)`` with ``h``
    this rank's (n_loc, D) rows and ``part`` the output of
    ``build_halo_partition`` (each rank reads its own row of the packs).
    Two neighbour strips of ``halo`` rows travel per call."""

    def mp(mlp, h, part, direction):
        n_loc, halo = part["n_loc"], part["halo"]
        ed = part[direction]
        p = mesh.part_index
        m = ed["mask"][p] > 0
        agg = ed["agg_local"][p][m].astype(np.int64) + halo
        oth = ed["oth_local"][p][m].astype(np.int64)
        snd, rcv = (oth, agg) if direction == "to" else (agg, oth)
        csr = pack_csr(snd, rcv, ed["edge_attr"][p][m], n_loc + 2 * halo,
                       direction, device=h.device)
        return window_message_passing(mlp, halo_exchange(h, mesh, halo),
                                      csr, halo, n_loc)

    return mp
