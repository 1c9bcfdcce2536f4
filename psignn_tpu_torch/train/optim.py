"""Optimizers and schedulers with the reference trainer's semantics.

Port of ``psignn_tpu/train/optim.py``:

* Ψ-GNN: two Adams, one over the DEQ update function and one over the
  autoencoder (``dirichlet/psignn/training_class.py:52-58``); DS-GPS and
  DSS: one Adam over every parameter (dsgps/training_class.py:49-51).
  ``torch.optim.Adam`` with eps 1e-8 is the JAX package's Adam
  (``optax.scale_by_adam``, bias-corrected, then ``p - lr·u``);
* the global-norm clip over ALL parameters jointly before both steps
  (training_class.py:163): ``clip_grad_norm_``'s scale
  ``min(1, max_norm / (total + 1e-6))``;
* ``PlateauScheduler``, the port's own copy of the JAX package's host-side
  ReduceLROnPlateau.  ``torch.optim.lr_scheduler.ReduceLROnPlateau`` is not
  used: it skips a cut smaller than its ``eps`` of 1e-8, the JAX scheduler
  does not.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Sequence, Tuple

import torch

ADAM_EPS = 1e-8


def make_optimizers(model, lr_deq: float, lr_ae: float
                    ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """(Adam over ``model.function``, Adam over encoder + decoder)."""
    ae = list(model.encoder.parameters()) + list(model.decoder.parameters())
    return (torch.optim.Adam(model.function.parameters(), lr=lr_deq,
                             eps=ADAM_EPS),
            torch.optim.Adam(ae, lr=lr_ae, eps=ADAM_EPS))


def make_adam(model, lr: float) -> torch.optim.Adam:
    """One Adam over every parameter of ``model`` (DS-GPS, DSS)."""
    return torch.optim.Adam(model.parameters(), lr=lr, eps=ADAM_EPS)


def apply_gradients(params: Iterable[torch.nn.Parameter],
                    opts: Sequence[torch.optim.Optimizer],
                    lrs: Sequence[float], clip: float) -> torch.Tensor:
    """Clip the gradients of ``params`` by their joint global norm, then
    step each optimizer at its learning rate; returns the norm before the
    clip."""
    total = torch.nn.utils.clip_grad_norm_(list(params), clip)
    for opt, lr in zip(opts, lrs):
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    return total


@dataclasses.dataclass
class PlateauScheduler:
    """Host-side ReduceLROnPlateau (mode='min'): patience 10, relative
    threshold 1e-4, no cooldown."""

    lr: float
    factor: float = 0.5
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        for k, v in d.items():
            setattr(self, k, v)
