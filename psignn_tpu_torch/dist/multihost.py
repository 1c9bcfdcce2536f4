"""Process groups, rank launch and the collectives of the port's
multi-device paths.

Port of ``psignn_tpu/dist/multihost.py``.  JAX runs one process over a
``Mesh`` of devices and compiles ``shard_map`` collectives; the port runs
one process per rank, each owning one device, and the mesh's axes become
process groups of ``torch.distributed``:

* ``initialize`` — ``init_process_group``: a no-op for one process,
  idempotent otherwise; it reads torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` / ``MASTER_PORT`` or takes explicit arguments;
* ``global_mesh`` — this rank's place in a dp × parts layout (rank
  ``r = dp_index · parts + part_index``, JAX's ``reshape(dp, parts)``) with
  the process group of its partition row and the collectives the solvers
  and losses call (``Mesh.reduce``, ``Mesh.sync``);
* ``is_coordinator`` — rank 0, the one that writes logs and checkpoints;
* ``spawn`` — runs a function on N ranks in spawned processes and ends the
  whole run when one rank fails or the time runs out.

Every group has an explicit backend: NCCL with rank r on ``cuda:r``, or
gloo on the CPU and wherever several ranks share one card (NCCL refuses
two ranks on one GPU).  gloo's point-to-point ops take CPU tensors only,
so a gloo group whose tensors live on a card stages them through the host,
explicitly (``Mesh.stage``), in its all-reduces as in its halo exchanges.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Join the process group; returns whether one exists afterwards.

    A no-op when the group exists already, and when the world is one
    process (``WORLD_SIZE`` unset or 1) and no ``init_method`` is given.
    Missing arguments come from torchrun's environment (``RANK``,
    ``WORLD_SIZE``; ``init_method`` defaults to ``env://``, which reads
    ``MASTER_ADDR`` / ``MASTER_PORT``).  ``backend`` defaults to gloo."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return False
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    dist.init_process_group(backend or "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """Rank 0 (a single process is its own coordinator)."""
    return rank() == 0


def _all_reduce(t: torch.Tensor, group, stage: bool) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group`` (through the host when
    ``stage``)."""
    if stage:
        out = t.detach().cpu()
        dist.all_reduce(out, group=group)
        return out.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _SumOverGroup(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the identity — every
    rank's loss is the same replicated value, so each rank differentiates
    through its own partial only, and the caller sums the parameters'
    gradients over the ranks once (``dist.dp.dp_value_and_grad``)."""

    @staticmethod
    def forward(ctx, t, group, stage):
        return _all_reduce(t, group, stage)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: the identity on a replicated input.  Backward: the sum of
    the ranks' cotangents, so that the input's gradient is complete on
    every rank (the transpose of ``_SumOverGroup``)."""

    @staticmethod
    def forward(ctx, t, group, stage):
        ctx.group, ctx.stage = group, stage
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _SumOverGroup.apply(g, ctx.group, ctx.stage), None, None


class Mesh:
    """This rank's place in a dp × parts layout of the world's ranks: dp
    rows of ``parts`` ranks, row i holding ranks ``[i·parts, (i+1)·parts)``
    (``partitioned`` solves one graph per row, its nodes split over the
    row; plain data parallelism is parts = 1).  ``device`` is the rank's
    device.  Every rank must build the mesh, in the same order, because
    the row groups are created collectively.  Without a process group the
    mesh is the single rank 1 × 1 and every collective is the identity;
    a row of one rank reduces nothing (``reduce`` is the identity)."""

    def __init__(self, dp: int, parts: int, device):
        world = world_size()
        if dp * parts != world:
            raise ValueError(f"a {dp} × {parts} mesh needs {dp * parts} "
                             f"ranks, the world has {world}")
        self.dp, self.parts = dp, parts
        self.rank = rank()
        self.device = torch.device(device)
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        self.dp_index, self.part_index = divmod(self.rank, parts)
        self.part_group = None            # None: the whole world
        if 1 < parts < world:
            for i in range(dp):
                group = dist.new_group(list(range(i * parts,
                                                  (i + 1) * parts)))
                if i == self.dp_index:
                    self.part_group = group
        row = self.dp_index * parts
        self.left = row + self.part_index - 1 if self.part_index > 0 else None
        self.right = (row + self.part_index + 1
                      if self.part_index < parts - 1 else None)

    @property
    def world(self) -> int:
        return self.dp * self.parts

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over this rank's partition row: the solvers' and
        losses' ``reduce`` hook (``jax.lax.psum(·, "x")``).  Differentiable:
        its backward is the identity (``_SumOverGroup``)."""
        if self.parts == 1:
            return t
        return _SumOverGroup.apply(t, self.part_group, self.stage)

    def replicate(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, replicated over the row, whose gradient sums the row's
        cotangents (``_CopyToGroup``)."""
        if self.parts == 1:
            return t
        return _CopyToGroup.apply(t, self.part_group, self.stage)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the whole world (not differentiable); a world
        of one rank in a process group still goes through its backend."""
        if self.backend is None:
            return t
        return _all_reduce(t, None, self.stage)

    def sync(self, go: bool) -> bool:
        """Whether any rank of the world goes on: the solvers' ``sync``
        hook, for an ``f`` whose collectives span more than one row."""
        if self.backend is None:
            return bool(go)
        flag = torch.tensor([1.0 if go else 0.0])
        if self.backend == "nccl":
            flag = flag.to(self.device)
        dist.all_reduce(flag)
        return bool(flag.item() > 0)

    def broadcast(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank of the world."""
        if self.backend is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=0,
            device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index or 0])
        elif self.backend is not None:
            dist.barrier()

    def exchange(self, sends: Sequence[tuple], recv_like: torch.Tensor
                 ) -> List[torch.Tensor]:
        """Point-to-point exchange with the row's neighbours: each
        ``(peer, tensor)`` of ``sends`` goes to the global rank ``peer``,
        and one tensor shaped like ``recv_like`` comes back from each of
        those peers, in the order of ``sends``.  A gloo group on a card
        stages every strip through the host."""
        if not sends:
            return []
        dev = recv_like.device
        host = self.stage
        ops, bufs = [], []
        for peer, t in sends:
            t = t.detach().contiguous()
            if host:
                t = t.cpu()
            buf = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                              device="cpu" if host else dev)
            ops.append(dist.P2POp(dist.isend, t, peer))
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            bufs.append(buf)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [b.to(dev) for b in bufs] if host else bufs


def global_mesh(dp: Optional[int] = None, parts: int = 1,
                device=None) -> Mesh:
    """The mesh of the whole world: ``dp`` rows (default: world / parts)
    of ``parts`` ranks on this rank's ``device`` (``resolve_device``: the
    card unless the caller names the CPU)."""
    world = world_size()
    if dp is None:
        if world % parts:
            raise ValueError(f"{parts} parts do not divide {world} ranks")
        dp = world // parts
    return Mesh(dp, parts, resolve_device(device))


# --------------------------------------------------------------- launching

def free_port() -> int:
    """A TCP port of localhost that is free now (for ``tcp://`` init)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, rank_: int, nprocs: int, tasks,
               results) -> None:
    # the host's cores shared out: every rank at the default thread count
    # would oversubscribe them (two ranks' CPU steps on an 8-core host ran
    # 80 times slower so)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    try:
        out = fn(rank_, *tasks.get())
    except BaseException:
        results.put(("error", rank_, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put(("ok", rank_, out))


def spawn(fn: Callable, nprocs: int, args: tuple = (),
          timeout: Optional[float] = None) -> list:
    """``fn(rank, *args)`` for each rank in ``nprocs`` spawned processes;
    returns their results in rank order.

    ``fn`` must be importable by name (module level) and its result
    picklable; it initialises its own process group.  Each rank gets
    ``cpu_count // nprocs`` threads (``fn`` may set others).  When a rank
    raises or dies, or ``timeout`` seconds pass, every other rank is
    terminated and a ``RuntimeError`` carries the failing rank's traceback
    — a rank waiting in a collective for a peer that is gone would
    otherwise wait for ever."""
    ctx = multiprocessing.get_context("spawn")
    tasks, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, tasks, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    # the arguments go through a queue, written by its own thread: a large
    # argument of the Process itself would hold each start() until that
    # rank had imported its modules, starting the ranks one by one
    for _ in procs:
        tasks.put(args)
    deadline = None if timeout is None else time.monotonic() + timeout
    done = {}
    try:
        while len(done) < nprocs:
            try:
                kind, r, payload = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(f"ranks {sorted(set(range(nprocs)) - set(done))} "
                                       f"did not finish within {timeout} s")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {r} failed:\n{payload}")
            done[r] = payload
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        # arguments a dead rank never read must not hold this process at
        # its exit, waiting to flush them
        tasks.cancel_join_thread()
        tasks.close()
    return [done[r] for r in range(nprocs)]
