"""Faults planted in the program under the harness in the mixed sweep
(``psignn_mixed.sweep``) and the data-parallel training cell
(``psignn_dirichlet.train_dp4``), shared by the CPU tests
(``test_faults_mixed_dp.py``) and the readings on the card
(``readings_mixed_dp.py``).  ``planted(name)`` is a context in which the
program runs with fault ``name``:

* ``neumann_skipped``: the Dirichlet f_θ on the mixed graph (no third
  message passing, no Neumann update);
* ``neumann_kept``: the Neumann branch computed, its rows never written
  over the Dirichlet branch's;
* ``normals_unpermuted``: the request's node order applied to every node
  array but the normals, which stay in mesh order;
* ``rank_grad_not_reduced``: rank 0's gradient not all-reduced: it
  takes part in the all-reduce and steps on its own shard's gradient;
* ``loss_summed``: the loss and its entries summed over the ranks, not
  averaged (the gradients averaged);
* ``rank_dies``: rank 2 raises at its third training step, while the
  other ranks wait for it in the step's all-reduce.

The training faults act inside each rank: the data-parallel loop enters
``planted(name)`` there (``train_dp.run``'s ``plant``, as
``PLANT(name)``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

PLANT_MODULE = "benchmark.tests.faults_mixed_dp"
MIXED = ("neumann_skipped", "neumann_kept", "normals_unpermuted")
DP = ("rank_grad_not_reduced", "loss_summed", "rank_dies")


def PLANT(name: str) -> tuple:
    """``train_dp.run``'s ``plant`` of fault ``name``."""
    return (PLANT_MODULE, "planted", (name,))


@contextlib.contextmanager
def _swap(obj, name: str, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


def _neumann_skipped():
    from psignn_tpu_torch.models.psignn import UpdateFunction
    real = UpdateFunction.forward

    def dirichlet_only(self, h, h_initial, graph):
        self.mixed = False
        try:
            return real(self, h, h_initial, graph)
        finally:
            self.mixed = True

    return _swap(UpdateFunction, "forward", dirichlet_only)


def _neumann_kept():
    from psignn_tpu_torch.models.psignn import UpdateFunction
    real = UpdateFunction.forward

    def never_written(self, h, h_initial, graph):
        graph = dataclasses.replace(
            graph, neumann_mask=graph.neumann_mask * 0.0)
        return real(self, h, h_initial, graph)

    return _swap(UpdateFunction, "forward", never_written)


def _normals_unpermuted():
    from psignn_tpu_torch.dist import partition
    real = partition.rcm_ordered

    def ordered(sample):
        out = real(sample)
        if "unit_normal_vector" in sample:
            out = dict(out, unit_normal_vector=np.asarray(
                sample["unit_normal_vector"]))
        return out

    return _swap(partition, "rcm_ordered", ordered)


def _rank_grad_not_reduced():
    import psignn_tpu_torch.train.step as step
    real = step.dp_value_and_grad

    def planted_vag(loss_fn, mesh, sink=False):
        vag = real(loss_fn, mesh, sink)

        def own_gradient(model, *inputs):
            if mesh.rank != 0:
                return vag(model, *inputs)
            # the flat buffer starts with every parameter's gradient
            n = sum(p.numel() for p in model.parameters())
            reduce = mesh.all_reduce

            def keep_own(t):
                out = reduce(t).clone()
                out[:n] = t[:n] * mesh.dp
                return out

            mesh.all_reduce = keep_own
            try:
                return vag(model, *inputs)
            finally:
                del mesh.all_reduce
        return own_gradient

    return _swap(step, "dp_value_and_grad", planted_vag)


def _loss_summed():
    import psignn_tpu_torch.train.step as step
    real = step.dp_value_and_grad

    def planted_vag(loss_fn, mesh, sink=False):
        vag = real(loss_fn, mesh, sink)

        def summed(model, *inputs):
            loss, aux, bw = vag(model, *inputs)
            return (loss * mesh.world,
                    {k: v * mesh.world for k, v in aux.items()}, bw)
        return summed

    return _swap(step, "dp_value_and_grad", planted_vag)


def _rank_dies():
    import psignn_tpu_torch.train.step as step
    import torch.distributed as dist
    real = step.train_step
    calls = [0]

    def dies(*args, **kw):
        calls[0] += 1
        if dist.get_rank() == 2 and calls[0] == 3:
            raise RuntimeError("planted: rank 2 fails its third step")
        return real(*args, **kw)

    return _swap(step, "train_step", dies)


def planted(name: str):
    """A context in which the program runs with fault ``name``."""
    return {"neumann_skipped": _neumann_skipped,
            "neumann_kept": _neumann_kept,
            "normals_unpermuted": _normals_unpermuted,
            "rank_grad_not_reduced": _rank_grad_not_reduced,
            "loss_summed": _loss_summed,
            "rank_dies": _rank_dies}[name]()
