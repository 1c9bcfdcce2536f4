"""Checkpoints: the running/best/final pickles of the trainer.

Port of ``psignn_tpu/train/checkpoint.py``, in its format: one pickled
dict of numpy arrays and plain containers, written atomically.  ``params``
are in the JAX tree layout (``weights.params_to_jax``), so
``weights.load_psignn_checkpoint`` and ``eval.run_eval.load_predictor``
read a checkpoint the port trained as they read one of the JAX package.
The port's optimizer and scheduler state sit under ``torch_optim``
(``optimizer_state_to_numpy`` / ``optimizer_state_from_numpy``).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

from ..weights import load_jax_checkpoint


def save_checkpoint(state: Dict[str, Any], dirname: str, name: str) -> str:
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, f"{name}.ckpt")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint dict; numpy and plain containers only."""
    return load_jax_checkpoint(path)


def _map_tensors(obj, fn, kind):
    if isinstance(obj, kind):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn, kind) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn, kind) for v in obj)
    return obj


def optimizer_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """``Optimizer.state_dict()`` with every tensor as a numpy array."""
    return _map_tensors(state, lambda t: t.detach().cpu().numpy(),
                        torch.Tensor)


def optimizer_state_from_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: numpy arrays back to (CPU) tensors, which
    ``Optimizer.load_state_dict`` moves to the parameters' device."""
    return _map_tensors(state, lambda a: torch.from_numpy(np.array(a)),
                        np.ndarray)
