"""Data parallelism over batched graphs on ``torch.distributed``.

Port of ``psignn_tpu/dist/dp.py``.  JAX stacks one graph a device on a
leading axis, shards it over a 1-D mesh and differentiates through
``shard_map`` (``pmean`` on the loss and aux, the psum autodiff inserts on
the parameters' cotangent).  Here each rank is one process with the same
model; it builds only its own shard of each batch (``shard_stacked``, the
loader's ``_build_sharded`` dealing), runs the loss and ``backward()`` on
it, and one all-reduce of a flat buffer sums the gradients, the loss, the
aux values and the adjoint solve's (lowest, nstep) over the world
(``dp_value_and_grad``).  ``DistributedDataParallel`` is not used: DS-GPS's
unused ``laynorm`` holds no gradient in the port, which it would refuse,
and it cannot carry the backward solve's stats.

Span (``profiling.span``, recorded under a profiler): ``dp.allreduce``,
the all-reduce of the flat buffer and the host's read of its means, so
the rank's wait for the slowest rank is in it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .. import profiling
from ..deq import SolveStats
from ..graphs import Graph, batch_graphs
from .multihost import Mesh, global_mesh


def make_mesh(n_devices: int = 0, device=None) -> Mesh:
    """The 1-D data-parallel mesh of the world (``n_devices`` = 0: every
    rank; otherwise it must equal the world size); ``device`` is this
    rank's device."""
    mesh = global_mesh(parts=1, device=device)
    if n_devices and n_devices != mesh.world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of "
                         f"{mesh.world} ranks")
    return mesh


def shard_stacked(chunk: Sequence[dict], batch_size: int, mesh: Mesh
                  ) -> Graph:
    """This rank's shard of one batch of samples, dealt as the JAX
    loader's ``_build_sharded`` deals it (``data.reader.shard_samples``),
    batched on the rank's device."""
    from ..data.reader import shard_samples
    return stack_graphs(shard_samples(chunk, batch_size, mesh.dp), mesh)


def stack_graphs(per_device: Sequence[Sequence[dict]], mesh: Mesh) -> Graph:
    """The rank's entry of JAX's stack of per-device graphs: its own
    samples, batched on its device (each rank builds only its own)."""
    if len(per_device) != mesh.dp:
        raise ValueError(f"{len(per_device)} shards for {mesh.dp} ranks")
    return batch_graphs(per_device[mesh.dp_index], device=mesh.device)


def dp_value_and_grad(loss_fn: Callable, mesh: Mesh, sink: bool = False):
    """``vag(model, *inputs) -> (loss, aux, bw)``, data-parallel.

    ``loss_fn(model, *inputs)`` returns ``(loss, aux)`` on the rank's
    shard — ``aux`` a dict of tensors — or, with ``sink``,
    ``(loss, aux, adjoint)`` with the ``deq.AdjointSolve`` of its DEQ.
    Each rank runs ``backward()``; then ONE all-reduce of a flat buffer
    sums the parameters' gradients, the loss, the aux values and the
    adjoint's (lowest, nstep) over the world.  The gradients are divided by
    ``mesh.dp`` and written back to ``.grad``; the rest is divided by the
    world size (JAX's ``pmean``; a dp × partition row holds its loss on
    each of its ranks, and its gradient is the sum of its ranks' partials).
    Returns the means on the host (floats, arrays for aux entries that
    are not 0-d) and, with ``sink``, ``bw`` = SolveStats(mean lowest, mean
    nstep, this rank's calls)."""

    def vag(model, *inputs) -> Tuple[float, Dict[str, object],
                                     Optional[SolveStats]]:
        out = loss_fn(model, *inputs)
        loss, aux = out[0], out[1]
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        vals = {k: torch.as_tensor(v, device=loss.device).detach()
                .to(loss.dtype) for k, v in aux.items()}
        extra = []
        if sink:
            stats = out[2].stats
            extra = [float(stats.lowest), float(stats.nstep)]
        # the count of gradients: every rank must send the same buffer
        tail = loss.new_tensor([*extra, float(len(params))])
        n = sum(p.numel() for p in params)
        with profiling.span("dp.allreduce"):
            flat = mesh.all_reduce(torch.cat(
                [p.grad.reshape(-1) for p in params]
                + [loss.detach().reshape(1)]
                + [v.reshape(-1) for v in vals.values()] + [tail]))
            host = (flat[n:] / mesh.world).cpu().numpy()
        i = 0
        for p in params:
            p.grad.copy_(flat[i:i + p.numel()].view_as(p) / mesh.dp)
            i += p.numel()
        if round(float(host[-1])) != len(params):
            raise RuntimeError("ranks differ in which parameters have "
                               "gradients")
        means, i = {}, 1
        for k, v in vals.items():
            got = host[i:i + v.numel()]
            means[k] = float(got[0]) if v.dim() == 0 else got.reshape(v.shape)
            i += v.numel()
        bw = SolveStats(float(host[i]), float(host[i + 1]), stats.calls) \
            if sink else None
        return float(host[0]), means, bw

    return vag


def dp_train_step(loss_fn: Callable, mesh: Mesh, sink: bool = False):
    """The full data-parallel step: ``step(model, opts, inputs, lrs,
    clip) -> (loss, aux, grad_norm, bw)`` runs ``dp_value_and_grad`` on
    ``inputs`` (a tuple), then the joint global-norm clip and each
    optimizer's step, identical on every rank."""
    from ..train.optim import apply_gradients
    vag = dp_value_and_grad(loss_fn, mesh, sink)

    def step(model, opts, inputs: tuple, lrs, clip: float):
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        loss, aux, bw = vag(model, *inputs)
        gnorm = apply_gradients(model.parameters(), opts, lrs, clip)
        return loss, aux, float(gnorm), bw

    return step
