"""Rank workers of the port's multi-rank tests (``test_torch_dist.py``,
``test_torch_partition.py``, ``test_torch_partitioned.py``).

A spawned rank imports this module by name, so it imports torch, numpy
and the port only: never JAX, the JAX package or the tests' conftest.
``run`` joins a gloo group through a file in the test's temporary
directory and runs a list of jobs, each a function below by name with its
keyword arguments; the parent (``multihost.spawn``) gets each rank's list
of results.  Inputs and results are numpy arrays and Python values.
"""

import os

import numpy as np
import torch

from psignn_tpu_torch.dist import multihost

# each rank of a test runs on 1 thread: the suite runs 6 test workers
THREADS = 1
# seconds a spawned test run may take before its ranks are killed
TIMEOUT = 120


def spawn(tmp_path, world: int, jobs, timeout: float = TIMEOUT):
    """Each rank's results of ``jobs`` on a fresh gloo world of ``world``
    ranks (rendezvous file under ``tmp_path``)."""
    path = os.path.join(str(tmp_path), f"rendezvous_{world}_{os.getpid()}")
    return multihost.spawn(run, world, (world, path, jobs), timeout=timeout)


def run(rank: int, world: int, path: str, jobs):
    torch.set_num_threads(THREADS)
    # the ranks of a test share one host: gloo on its loopback interface
    # needs no name resolution of the host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    multihost.initialize("gloo", f"file://{path}", world, rank)
    return [globals()[name](**kw) for name, kw in jobs]


def _psignn(params, hp, **over):
    from psignn_tpu_torch.models import PsignnConfig
    from psignn_tpu_torch.weights import psignn_from_jax
    cfg = PsignnConfig.from_hyperparameters(hp, **over)
    return psignn_from_jax(params, cfg, "cpu"), cfg


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------- partition

def edge_sharded(h, mlp_params, senders, receivers, edge_attr, edge_mask,
                 a_ij, u, dp, parts):
    """Edge-sharded message passing (both directions, with the gradient of
    a seeded projection w.r.t. h and the first weight) and SpMV."""
    from psignn_tpu_torch.dist import partition_message_passing, partition_spmv
    from psignn_tpu_torch.nn import MLP
    from psignn_tpu_torch.weights import _ToTorch
    mesh = multihost.global_mesh(dp, parts, "cpu")
    conv = _ToTorch()
    conv.mlp("m", mlp_params)
    mlp = MLP([len(mlp_params[0]["w"]), *(p["w"].shape[1]
                                          for p in mlp_params)])
    mlp.load_state_dict({k[2:]: v for k, v in conv.sd.items()})
    out = {}
    mp = partition_message_passing(mesh)
    proj = torch.from_numpy(np.cos(np.arange(h.size, dtype=np.float32))
                            .reshape(h.shape))
    for direction in ("to", "from"):
        ht = torch.from_numpy(h).requires_grad_()
        mlp.zero_grad()
        got = mp(mlp, ht, senders, receivers, edge_attr, edge_mask,
                 direction)
        torch.sum(got * proj).backward()
        out[direction] = (_np(got), _np(ht.grad),
                          _np(mlp.layers[0].weight.grad))
    spmv = partition_spmv(mesh)
    out["spmv"] = _np(spmv(torch.from_numpy(u), senders, receivers, a_ij,
                           edge_mask))
    return out


def halo_mp(h_parts, mlp_params, part, parts):
    """``halo_message_passing`` of this rank's rows, both directions, and
    the gradient of a seeded projection w.r.t. the rank's rows."""
    from psignn_tpu_torch.dist.partition import halo_message_passing
    from psignn_tpu_torch.nn import MLP
    from psignn_tpu_torch.weights import _ToTorch
    mesh = multihost.global_mesh(1, parts, "cpu")
    conv = _ToTorch()
    conv.mlp("m", mlp_params)
    mlp = MLP([len(mlp_params[0]["w"]), *(p["w"].shape[1]
                                          for p in mlp_params)])
    mlp.load_state_dict({k[2:]: v for k, v in conv.sd.items()})
    mp = halo_message_passing(mesh)
    h = torch.from_numpy(h_parts[mesh.part_index])
    proj = torch.sin(torch.arange(h.numel(), dtype=torch.float32)
                     .reshape(h.shape) + mesh.part_index)
    out = {}
    for direction in ("to", "from"):
        ht = h.clone().requires_grad_()
        got = mp(mlp, ht, part, direction)
        torch.sum(got * proj).backward()
        out[direction] = (_np(got), _np(ht.grad))
    return out


# ---------------------------------------------------------- partitioned

def partitioned_inference(samples, params, hp, dp, parts, sync=False,
                          over=None):
    """This rank's ``partitioned_psignn_inference_dp`` of
    ``samples[dp_index]``: (part, u rows, nstep, lowest, residual, calls)."""
    from psignn_tpu_torch.dist import (partitioned_psignn_inference_dp,
                                       stack_partitioned_graphs)
    mesh = multihost.global_mesh(dp, parts, "cpu")
    model, cfg = _psignn(params, hp, **(over or {}))
    pg = stack_partitioned_graphs(samples, mesh)
    out = partitioned_psignn_inference_dp(model, pg, cfg, mesh, sync=sync)
    return (mesh.dp_index, mesh.part_index, _np(out.u), out.nstep,
            out.lowest, out.residual, out.calls)


def partitioned_loss(samples, probes, params, hp, dp, parts, over):
    """The rank's ``make_partitioned_loss`` with the explicit probe
    ``probes[dp_index][part_index]``: loss and aux averaged over the rows
    and the gradients of ``dp_value_and_grad`` (a state dict)."""
    from psignn_tpu_torch.dist import (dp_value_and_grad,
                                       make_partitioned_loss,
                                       stack_partitioned_graphs)
    mesh = multihost.global_mesh(dp, parts, "cpu")
    model, cfg = _psignn(params, hp, **over)
    pg = stack_partitioned_graphs(samples, mesh)
    v = torch.from_numpy(probes[mesh.dp_index][mesh.part_index])
    vag = dp_value_and_grad(make_partitioned_loss(cfg, mesh), mesh,
                            sink=True)
    loss, aux, bw = vag(model, pg, v)
    return (loss, aux, tuple(bw),
            {n: _np(p.grad) for n, p in model.named_parameters()})


def partitioned_train(samples, params, hp, dp, parts, over, steps,
                      jac_weight):
    """``steps`` partitioned train steps: each step's (loss, grad norm,
    backward nstep), and a digest of the final parameters."""
    from psignn_tpu_torch.dist import (make_partitioned_train_step,
                                       stack_partitioned_graphs)
    from psignn_tpu_torch.train import make_optimizers
    mesh = multihost.global_mesh(dp, parts, "cpu")
    model, cfg = _psignn(params, hp, **over)
    pg = stack_partitioned_graphs(samples, mesh)
    opts = make_optimizers(model, 0.01, 0.05)
    step = make_partitioned_train_step(cfg, mesh, jac_weight, clip=0.1)
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    hist = []
    for _ in range(steps):
        res = step(model, opts, pg, gen, 0.01, 0.05)
        hist.append((res.loss, res.grad_norm, res.bw.nstep))
    digest = float(sum(torch.sum(p.detach().double() ** 2)
                       for p in model.parameters()))
    return hist, digest


def fail_mid_solve(samples, params, hp, dp, parts):
    """A partitioned solve in which rank 1's update function raises at
    its fifth call, while its peers wait in the next exchange."""
    from psignn_tpu_torch.dist import (partitioned, stack_partitioned_graphs)
    mesh = multihost.global_mesh(dp, parts, "cpu")
    model, cfg = _psignn(params, hp)
    pg = stack_partitioned_graphs(samples, mesh)
    real = partitioned.make_partitioned_function

    def failing(cfg_, mesh_):
        f = real(cfg_, mesh_)
        calls = [0]

        def g(*a):
            calls[0] += 1
            if mesh.rank == 1 and calls[0] == 5:
                raise RuntimeError("rank 1 fails on purpose")
            return f(*a)
        return g

    partitioned.make_partitioned_function = failing
    partitioned.partitioned_psignn_inference_dp(model, pg, cfg, mesh)


# ---------------------------------------------------------------- solvers

def solver_hooks(name, problems, split, sync, threshold, eps, kw):
    """A fixed point of ``x ↦ tanh(M x + c)`` (x flattened) per dp row:
    with ``split``
    the rows' state is split over the row (each rank evaluates its block,
    gathering the whole x), the solver given the row's ``reduce``; with
    ``sync`` the world's any().  Returns the rank's result rows and the
    stats."""
    import torch.distributed as dist
    from psignn_tpu_torch import solvers
    parts = 2 if split else 1
    mesh = multihost.global_mesh(parts=parts, device="cpu")
    M, c, x0 = (torch.from_numpy(a) for a in problems[mesh.dp_index])
    n = x0.shape[0] // parts
    rows = slice(mesh.part_index * n, (mesh.part_index + 1) * n)

    def f(x):
        if parts > 1:
            full = [torch.empty_like(x) for _ in range(parts)]
            dist.all_gather(full, x.contiguous(), group=mesh.part_group)
            x = torch.cat(full)
        return torch.tanh(x.reshape(-1) @ M.T + c).reshape(x.shape)[rows]

    out = solvers.get_solver(name)(
        f, x0[rows], threshold=threshold, eps=eps,
        reduce=mesh.reduce if split else None,
        sync=mesh.sync if sync else None, **kw)
    return (_np(out.result), out.nstep, out.lowest, out.calls,
            _np(out.rel_trace))


# --------------------------------------------------------------------- dp

def dp_grads(family, params, hp, shards, probe_cols=10):
    """``dp_value_and_grad`` of one family's training loss on the rank's
    shard: (loss, aux, gradients, backward stats).  Ψ-GNN's Hutchinson
    probe is a function of node positions, as in the JAX test."""
    from psignn_tpu_torch import deq
    from psignn_tpu_torch.dist import dp_value_and_grad, stack_graphs
    from psignn_tpu_torch.models import (psignn_forward, DsgpsConfig,
                                         DssConfig)
    from psignn_tpu_torch.train.step import psignn_loss, unrolled_forward
    from psignn_tpu_torch.weights import model_from_jax
    mesh = multihost.global_mesh(device="cpu")
    graph = stack_graphs(shards, mesh)
    if family == "psignn":
        model, cfg = _psignn(params, hp)

        def probe_estimate(f, hs, hi, g, gen, vecs=1, denom=None,
                           lanes=None):
            pos = g.pos
            cols = torch.arange(probe_cols, dtype=pos.dtype)
            v = torch.sin(37.0 * pos[:, :1] + 11.0 * pos[:, 1:2]
                          + cols[None, :])
            return deq.jac_loss_probe(f, hs, hi, g, v, denom, lanes)

        deq.jac_loss_estimate = probe_estimate

        def loss_fn(m, g):
            out = psignn_forward(m, g, cfg, torch.Generator().manual_seed(0))
            return psignn_loss(out.losses, 1.0), out.losses, out.adjoint
    else:
        cfg = (DsgpsConfig if family == "dsgps" else DssConfig)(**hp)
        model = model_from_jax(family, params, cfg, "cpu")

        def loss_fn(m, g):
            out = unrolled_forward(m, g, cfg)
            return out.losses["train_loss"], out.losses
    vag = dp_value_and_grad(loss_fn, mesh, sink=family == "psignn")
    loss, aux, bw = vag(model, graph)
    return (loss, aux, None if bw is None else tuple(bw)[:2],
            {n: _np(p.grad) for n, p in model.named_parameters()
             if p.grad is not None})


def loader_shards(samples, batch_size, seed):
    """The rank's batches of a shuffled epoch and of a plain one: each
    batch's per-graph node counts and x; then those of ``shard_stacked``
    of the last (short) plain batch."""
    from psignn_tpu_torch.data.reader import GraphLoader
    from psignn_tpu_torch.dist import make_mesh, shard_stacked
    out = []
    for shuffle in (True, False):
        loader = GraphLoader(samples, batch_size=batch_size, shuffle=shuffle,
                             seed=seed, device="cpu",
                             n_devices=multihost.world_size(),
                             rank=multihost.rank())
        out.append([(g.n_nodes.tolist(), _np(g.x)) for g in loader])
    last = len(samples) // batch_size * batch_size
    g = shard_stacked(samples[last:], batch_size, make_mesh(device="cpu"))
    out.append((g.n_nodes.tolist(), _np(g.x)))
    return out


# -------------------------------------------------------------------- cli

def cli_runs(runs):
    """``cli.main`` once per argument list, this process joining the
    torchrun-style world the launcher set up (``RANK``/``WORLD_SIZE``);
    returns rank 0's view of each run's results directory."""
    from psignn_tpu_torch.cli.main import main
    os.environ["RANK"] = str(multihost.rank())
    os.environ["WORLD_SIZE"] = str(multihost.world_size())
    for argv in runs:
        main(argv)
    return multihost.rank()


def spike_reload(argv, roots):
    """``cli.main`` joined as ``cli_runs`` joins it, each rank with its own
    ``--path_results`` (``roots[rank]``), as ranks on two hosts each see
    only their own disk; from epoch 1 on, every validation residual is
    made 1000 times larger, so that the spike guard reloads the best
    checkpoint, which rank 0 alone wrote.  Returns the rank's parameters
    after the run."""
    from psignn_tpu_torch.cli.main import main
    from psignn_tpu_torch.train.trainer import Trainer
    rank = multihost.rank()
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(multihost.world_size())
    held = []
    real = Trainer.validation_loop

    def spiked(self, epoch):
        real(self, epoch)
        held[:] = [self]
        if epoch >= 1:
            self.hist_val["residual_loss"][-1] *= 1e3

    Trainer.validation_loop = spiked
    try:
        main([*argv, "--path_results", roots[rank]])
    finally:
        Trainer.validation_loop = real
    return {n: _np(p) for n, p in held[0].model.named_parameters()}


def dryrun(n_parts):
    from psignn_tpu_torch.dist.dryrun import dryrun_multichip
    return dryrun_multichip(device="cpu", n_parts=n_parts)
