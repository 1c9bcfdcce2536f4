"""Faults planted in the program under the harness, shared by the CPU
tests (``test_faults.py``) and the readings on the card
(``readings.py``).  ``planted(name)`` plants one:

* ``fw_tol=<x>``, ``fw_thres=<n>``: the Ψ-GNN forward solve stopped other
  than the configuration states (a looser tolerance, fewer steps), its
  answer and residual reported honestly: a request's solve and a
  training step's alike; ``fw_tol=<x>@step<k>``: the same from the k-th
  forward solve of the process on (a training run's k-th step of its
  first pass); ``fw_thres=<n>@step<k>only``: the k-th solve alone (a
  stall the configured Broyden can meet on one step of a sound run);
* ``state_unchanged``: a training step that clips its gradients and
  leaves the parameters as they were;
* ``half_batch``: each training batch built from its first half of
  samples alone, the losses the means over those;
* ``leaf_double``: a training step that moves one parameter leaf twice
  as far as its optimizer says.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _swap(obj, name: str, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def _changed_stop(change: dict, first: int = 1, last: int = None):
    """The request path (``models.psignn``) and the training step's
    ``deq.deq_solve`` (``deq``) each call the forward solve by its own
    module's name; the stop changes from the ``first``-th call on, up to
    the ``last``-th where given."""
    import psignn_tpu_torch.deq as deq
    import psignn_tpu_torch.models.psignn as m
    real = deq.fixed_point_forward
    calls = [0]

    def changed(f, h_init, graph, cfg, **kw):
        calls[0] += 1
        if first <= calls[0] <= (last or calls[0]):
            cfg = cfg._replace(**change)
        return real(f, h_init, graph, cfg, **kw)

    with _swap(m, "fixed_point_forward", changed), \
            _swap(deq, "fixed_point_forward", changed):
        yield


def _state_unchanged():
    import torch
    import psignn_tpu_torch.train.step as step

    def clip_only(params, opts, lrs, clip):
        return torch.nn.utils.clip_grad_norm_(list(params), clip)

    return _swap(step, "apply_gradients", clip_only)


def _half_batch():
    from psignn_tpu_torch.data.reader import GraphLoader
    real = GraphLoader._build

    def first_half(self, sel):
        return real(self, sel[:max(1, len(sel) // 2)])

    return _swap(GraphLoader, "_build", first_half)


def _leaf_double():
    import psignn_tpu_torch.train.step as step
    real = step.apply_gradients

    def doubled(params, opts, lrs, clip):
        params = list(params)
        before = params[0].detach().clone()
        out = real(params, opts, lrs, clip)
        params[0].data.add_(params[0].detach() - before)
        return out

    return _swap(step, "apply_gradients", doubled)


def planted(name: str):
    """A context in which the program runs with fault ``name``."""
    if "=" in name:
        change, _, first = name.partition("@step")
        key, value = change.split("=")
        only = first.endswith("only")
        first = int(first.removesuffix("only") or 1)
        return _changed_stop({key: int(value) if key.endswith("thres")
                              else float(value)}, first,
                             first if only else None)
    return {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
            "leaf_double": _leaf_double}[name]()
