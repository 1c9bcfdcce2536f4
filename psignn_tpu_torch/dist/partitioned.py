"""The partitioned Ψ-GNN solve and train step: one large mesh split over
the ranks of a row.

Port of ``psignn_tpu/dist/partitioned.py``:

* the nodes of one RCM-ordered mesh are split into ``n_parts`` blocks of
  ``n_loc`` rows (``dist.partition.build_halo_partition``); each rank of a
  row holds one block (``build_partitioned_graph``) and a CSR of each
  direction's edges over its window ``[halo | n_loc | halo]``
  (``window_csr``: JAX's ``_shard_mp_blocks`` map, not padded to 128);
* the update function f_θ runs per rank on its rows with one halo exchange
  per layer feeding all of the layer's aggregations, which run the CUDA
  forward kernel on the window (``make_partitioned_function``); its VJP
  runs the backward kernel on the window, and the halo rows' cotangents
  travel back to their owners through the exchange's backward;
* the fixed-point solver runs on each rank's block with the row's
  ``reduce`` hook (``Mesh.reduce``): its norms and products are global,
  so the partitioned solve takes the single-device solve's steps up to
  f32 summation order;
* the residual ``mean((A u − b)²)`` is a partitioned SpMV: the window's
  off-diagonal entries plus the local diagonal, its sums reduced.

dp × partition: each dp row solves its own graph, and its exchanges and
reductions stay inside the row's group, so the rows need not take equal
trips: each stops on its own.  ``sync=True`` makes every rank of the world
step until all have stopped (JAX's frozen carries), for an ``f`` that does
need it.  The losses are the rows' (replicated within a row); a train
step sums the parameters' partial gradients over the world and divides by
the number of rows (``dist.dp.dp_value_and_grad``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..deq import (SolveStats, _solver_kwargs, deq_attach_dist,
                   jac_loss_probe, solve_stats)
from ..kernels.fused_mp import MPCsr
from ..solvers import get_solver
from .multihost import Mesh
from .partition import (build_halo_partition, halo_exchange, window_csr,
                        window_message_passing)


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Part ``part`` of one mesh split into ``n_parts`` blocks: node rows
    (n_loc, w) on one device, the window CSRs of both directions, and the
    SpMV's off-diagonal entries of A aggregated at the part's rows (A's
    rows), their sources indexed into the window."""
    x: torch.Tensor
    b: torch.Tensor
    sol: torch.Tensor
    prb_data: torch.Tensor
    dir_mask: torch.Tensor          # (n_loc, 1) float
    node_mask: torch.Tensor         # (n_loc, 1) float, 0 on padded rows
    diag: torch.Tensor              # (n_loc, 1) diagonal of A
    mp_to: MPCsr                    # over the window, aggregation at receivers
    mp_from: MPCsr                  # over the window, aggregation at senders
    spmv_row: torch.Tensor          # (E_p,) int64 local row of each entry
    spmv_col: torch.Tensor          # (E_p,) int64 window column
    spmv_val: torch.Tensor          # (E_p, 1) a_ij
    n_loc: int
    halo: int
    n_parts: int
    part: int
    n_nodes: int
    unit_normal_vector: Optional[torch.Tensor] = None
    neu_mask: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.x.device


def _part_nodes(arr, n_parts: int, n_loc: int) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 1:
        arr = arr[:, None]
    out = np.zeros((n_parts * n_loc, arr.shape[1]), np.float32)
    out[: arr.shape[0]] = arr
    return out.reshape(n_parts, n_loc, arr.shape[1])


def partition_arrays(sample: Dict[str, np.ndarray], n_parts: int,
                     halo: Optional[int] = None) -> Dict:
    """Every part's arrays of one RCM-ordered Ψ-GNN sample, as the fields of
    JAX's ``build_partitioned_graph`` (``partitioned.py:118-175``): node
    arrays (n_parts, n_loc, w), the split ``to`` / ``from`` packs, the SpMV
    pack (off-diagonal a_ij aggregated at senders), ``n_loc`` and
    ``halo``."""
    s = np.asarray(sample["senders"])
    r = np.asarray(sample["receivers"])
    n_nodes = int(np.asarray(sample["x"]).shape[0])
    part = build_halo_partition(s, r, np.asarray(sample["edge_attr"]),
                                n_nodes, n_parts, halo=halo,
                                split_interior=True)
    n_loc, halo_w = part["n_loc"], part["halo"]
    spart = build_halo_partition(s, r, np.asarray(sample["a_ij"]),
                                 n_nodes, n_parts, halo=halo_w)
    a = np.asarray(sample["a_ij"]).reshape(-1)
    diag = np.zeros((n_nodes,), np.float32)
    on_diag = s == r
    diag[s[on_diag]] = a[on_diag]
    tags = np.asarray(sample["tags"]).reshape(n_nodes, -1)
    if tags.shape[1] == 1:
        dir_mask, neu_mask = (tags[:, 0] == 1).astype(np.float32), None
    else:
        dir_mask = (tags[:, 1] == 1).astype(np.float32)
        neu_mask = (tags[:, 2] == 1).astype(np.float32)
    node_mask = np.ones((n_nodes,), np.float32)

    def pn(a):
        return _part_nodes(a, n_parts, n_loc)

    out = dict(x=pn(sample["x"]), b=pn(sample["b"]), sol=pn(sample["sol"]),
               prb_data=pn(sample["prb_data"]),
               dir_mask=pn(dir_mask * node_mask), node_mask=pn(node_mask),
               diag=pn(diag), mp_to=part["to"], mp_from=part["from"],
               spmv=spart["from"], n_loc=n_loc, halo=halo_w,
               n_parts=n_parts, n_nodes=n_nodes)
    if "unit_normal_vector" in sample:
        out["unit_normal_vector"] = pn(sample["unit_normal_vector"])
    if neu_mask is not None:
        out["neu_mask"] = pn(neu_mask)
    return out


def build_partitioned_graph(sample: Dict[str, np.ndarray], n_parts: int,
                            part: int, halo: Optional[int] = None,
                            device=None) -> PartitionedGraph:
    """Part ``part`` of one RCM-ordered Ψ-GNN sample (reader format; order
    it with ``rcm_permutation`` + ``apply_node_permutation`` first, so that
    the halo is O(√N)) on ``device`` (default: ``default_device()``)."""
    device = resolve_device(device)
    arr = partition_arrays(sample, n_parts, halo)
    n_loc, halo_w = arr["n_loc"], arr["halo"]
    s = np.asarray(sample["senders"])
    r = np.asarray(sample["receivers"])
    ea = np.asarray(sample["edge_attr"])
    sp = arr["spmv"]
    m = sp["mask"][part] > 0

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    nodes = {k: t(arr[k][part]) for k in
             ("x", "b", "sol", "prb_data", "dir_mask", "node_mask", "diag",
              "unit_normal_vector", "neu_mask") if k in arr}
    return PartitionedGraph(
        **nodes,
        mp_to=window_csr(s, r, ea, part, n_loc, halo_w, "to", device),
        mp_from=window_csr(s, r, ea, part, n_loc, halo_w, "from", device),
        spmv_row=t(sp["agg_local"][part][m], torch.int64),
        spmv_col=t(sp["oth_local"][part][m], torch.int64),
        spmv_val=t(sp["edge_attr"][part][m]),
        n_loc=n_loc, halo=halo_w, n_parts=n_parts, part=part,
        n_nodes=arr["n_nodes"])


def stack_partitioned_graphs(samples, mesh: Mesh, halo: Optional[int] = None
                             ) -> PartitionedGraph:
    """This rank's share of JAX's ``stack_partitioned_graphs`` over the dp
    rows: part ``mesh.part_index`` of ``samples[mesh.dp_index]``, on the
    mesh's device.  Each rank builds only its own; the rows need not share
    a shape."""
    if len(samples) != mesh.dp:
        raise ValueError(f"{len(samples)} graphs for {mesh.dp} dp rows")
    return build_partitioned_graph(samples[mesh.dp_index], mesh.parts,
                                   mesh.part_index, halo, mesh.device)


def unpartition(arr: np.ndarray, n_nodes: int) -> np.ndarray:
    """(n_parts, n_loc, w) → (n_nodes, w): the parts' rows gathered (on
    the host) in node order, the padding dropped."""
    arr = np.asarray(arr)
    return arr.reshape(-1, arr.shape[-1])[:n_nodes]


# ------------------------------------------------------------- local ops

def make_partitioned_function(cfg, mesh: Mesh) -> Callable:
    """The rank's Ψ-GNN update function ``f(function, h, h_initial, pg)``
    (``models.psignn.UpdateFunction`` on its rows): one halo exchange per
    layer feeds the layer's two aggregations (three mixed), each the CUDA
    kernel over the window."""
    mixed = cfg.bc_mode == "mixed"

    def f(fn, h, h_initial, pg: PartitionedGraph):
        n_loc, halo = pg.n_loc, pg.halo
        last = len(fn.layers) - 1
        for k, layer in enumerate(fn.layers):
            h_ext = halo_exchange(h, mesh, halo)
            mp_to = window_message_passing(layer.phi_to, h_ext, pg.mp_to,
                                           halo, n_loc)
            mp_from = window_message_passing(layer.phi_from, h_ext,
                                             pg.mp_from, halo, n_loc)
            concat = torch.cat([h, mp_to, mp_from, pg.prb_data], dim=-1)
            alpha = torch.sigmoid(fn.alpha(concat))
            h_next = h + alpha * layer.update(concat)
            if mixed:
                mp_neu = window_message_passing(fn.phi_neumann, h_ext,
                                                pg.mp_from, halo, n_loc)
                upd_neu = fn.update_neumann(torch.cat(
                    [h, mp_neu, pg.prb_data, pg.unit_normal_vector], dim=-1))
                h_next = torch.where(pg.neu_mask > 0, upd_neu, h_next)
            if k == last:
                h_next = fn.laynorm(h_next)
            h = torch.where(pg.dir_mask > 0, h_initial, h_next)
            h = h * pg.node_mask
        return h

    return f


def partitioned_residual_local(u: torch.Tensor, u_ext: torch.Tensor,
                               pg: PartitionedGraph, reduce: Callable
                               ) -> torch.Tensor:
    """mean((A u − b)²) over the mesh's real nodes from the rank's rows:
    the window's off-diagonal entries plus the local diagonal."""
    off = torch.zeros_like(u).index_add_(
        0, pg.spmv_row, pg.spmv_val * u_ext[pg.spmv_col])
    r = off + pg.diag * u - pg.b
    num, den = reduce(torch.stack([torch.sum(torch.square(r) * pg.node_mask),
                                   torch.sum(pg.node_mask)]))
    return num / den


class PartitionedInference(NamedTuple):
    u: torch.Tensor      # (n_loc, 1) the rank's rows of the decoded solution
    nstep: int
    lowest: float
    residual: float      # of the whole mesh
    calls: int           # evaluations of f_θ
    rel_trace: np.ndarray  # (fw_thres,) each step's relative residual


def make_partitioned_inference(cfg, mesh: Mesh, sync: bool = False
                               ) -> Callable:
    """``fn(model, pg) -> PartitionedInference``: encoder, the fixed point
    with the row's ``reduce`` (and with ``sync``, the world's), decoder,
    the mesh's residual."""
    f = make_partitioned_function(cfg, mesh)
    solver = get_solver(cfg.solver)
    kw = _solver_kwargs(cfg.deq)

    def fn(model, pg: PartitionedGraph) -> PartitionedInference:
        with torch.no_grad():
            h0 = model.encoder(pg.x) * pg.node_mask
            out = solver(lambda h: f(model.function, h, h0, pg), h0,
                         threshold=cfg.fw_thres, eps=cfg.fw_tol,
                         reduce=mesh.reduce,
                         sync=mesh.sync if sync else None, **kw)
            u = model.decoder(out.result) * pg.node_mask
            res = partitioned_residual_local(
                u, halo_exchange(u, mesh, pg.halo), pg, mesh.reduce)
        return PartitionedInference(u, out.nstep, out.lowest, float(res),
                                    out.calls, out.rel_trace.numpy())

    return fn


def partitioned_psignn_inference(model, pg: PartitionedGraph, cfg,
                                 mesh: Mesh, sync: bool = False
                                 ) -> PartitionedInference:
    """One partitioned request: every rank of the row calls it with its
    part; each gets its rows of u and the shared nstep, lowest and
    residual.  Loops should build ``make_partitioned_inference`` once."""
    return make_partitioned_inference(cfg, mesh, sync)(model, pg)


def partitioned_psignn_inference_dp(model, pg: PartitionedGraph, cfg,
                                    mesh: Mesh, sync: bool = False
                                    ) -> PartitionedInference:
    """dp × partition (JAX ``partitioned_psignn_inference_dp``): each dp
    row of ``mesh`` solves its own graph, partitioned over the row; the
    row's exchanges and reductions stay in its group, so each row stops
    on its own, at JAX's per-row nstep.  ``sync=True`` keeps every rank
    stepping until all rows have stopped (JAX's frozen carries)."""
    return partitioned_psignn_inference(model, pg, cfg, mesh, sync)


# ------------------------------------------------------------ training step

def make_partitioned_loss(cfg, mesh: Mesh, jac_weight: float = 1.0,
                          sync: bool = False) -> Callable:
    """``loss_fn(model, pg, v) -> (loss, aux, adjoint, fw)``: the Ψ-GNN
    training loss of the rank's row (``models.psignn.psignn_forward``'s,
    with the explicit Hutchinson probe ``v``, the rank's (n_loc, D) rows),
    each of its means global over the row.  The DEQ's adjoint solve runs
    with the row's hooks (``deq_attach_dist``); ``adjoint`` is its
    ``AdjointSolve``, ``fw`` the rank's forward ``SolveStats``.
    Differentiate each rank's loss, then sum the
    parameters' gradients over the world and divide by ``mesh.dp``
    (``dp_value_and_grad`` does)."""
    f = make_partitioned_function(cfg, mesh)
    solver = get_solver(cfg.solver)
    kw = _solver_kwargs(cfg.deq)
    red = mesh.reduce
    syn = mesh.sync if sync else None

    def loss_fn(model, pg: PartitionedGraph, v: torch.Tensor):
        def fun(h, h_initial, g):
            return f(model.function, h, h_initial, g)

        def enc(x):
            return model.encoder(x) * pg.node_mask

        def dec(h):
            return model.decoder(h) * pg.node_mask

        h0 = enc(pg.x)
        with torch.no_grad():
            h0d = h0.detach()
            out_fw = solver(lambda h: fun(h, h0d, pg), h0d,
                            threshold=cfg.fw_thres, eps=cfg.fw_tol,
                            reduce=red, sync=syn, **kw)
        h_star = out_fw.result
        new_h, adjoint = deq_attach_dist(fun, cfg.deq, red, syn, h_star, h0,
                                         pg)
        u = dec(new_h)
        res = partitioned_residual_local(u, halo_exchange(u, mesh, pg.halo),
                                         pg, red)
        n_real = red(torch.sum(pg.node_mask))
        D = new_h.shape[-1]
        jac = jac_loss_probe(fun, h_star, h0, pg, v, denom=n_real * D,
                             reduce=red)
        u_det, h_det = u.detach(), new_h.detach()

        def mm(a, b, w):
            return red(torch.sum(torch.square(a - b) * pg.node_mask)) \
                / (n_real * w)

        enc_loss = mm(enc(u_det), h_det, D)
        auto_loss = mm(dec(enc(u_det).detach()), u_det, 1)
        mse = mm(u_det, pg.sol, 1)
        loss = res + jac_weight * jac + enc_loss + auto_loss
        scalar = u.new_tensor
        aux = {"residual_loss": res, "jacobian_loss": jac,
               "encoder_loss": enc_loss, "autoencoder_loss": auto_loss,
               "mse_loss": mse, "fw_nstep": scalar(float(out_fw.nstep)),
               "fw_lowest": scalar(float(out_fw.lowest))}
        return loss, aux, adjoint, solve_stats(out_fw)

    return loss_fn


def make_partitioned_train_step(cfg, mesh: Mesh, jac_weight: float = 1.0,
                                clip: float = 0.1, sync: bool = False
                                ) -> Callable:
    """The partitioned Ψ-GNN train step (JAX ``make_partitioned_train_step``):
    ``step(model, opts, pg, generator, lr_deq, lr_ae) -> StepResult``
    (``train.step``'s).  The rank's Hutchinson probe comes from its own
    ``generator``; the loss and aux are averaged over the dp rows and the
    gradients summed over the world and averaged over the rows, in one
    all-reduce; then the joint clip and the dual Adam (``opts`` from
    ``train.make_optimizers``), identical on every rank.  The forward and
    adjoint solves' (lowest, nstep) are averaged over the ranks, their
    ``calls`` are the rank's own."""
    from ..train.step import StepResult, _scalars
    from .dp import dp_train_step
    loss_fn = make_partitioned_loss(cfg, mesh, jac_weight, sync)
    fws = []

    def tracked(model, pg, v):
        out = loss_fn(model, pg, v)
        fws.append(out[3])
        return out

    dp_step = dp_train_step(tracked, mesh, sink=True)

    def step(model, opts, pg: PartitionedGraph, generator: torch.Generator,
             lr_deq: float, lr_ae: float):
        v = torch.randn((pg.n_loc, cfg.latent_dim), generator=generator,
                        device=generator.device).to(pg.device)
        fws.clear()
        loss, aux, gnorm, bw = dp_step(model, opts, (pg, v),
                                       (lr_deq, lr_ae), clip)
        fw = SolveStats(aux["fw_lowest"], aux["fw_nstep"], fws[0].calls)
        return StepResult(loss, _scalars(aux), gnorm, fw, bw)

    return step
