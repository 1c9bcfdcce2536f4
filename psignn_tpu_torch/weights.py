"""JAX parameter trees and ``psignn_tpu`` checkpoints → port modules.

``params_from_jax`` (and its inverse ``params_to_jax``) owns the layout
change: a JAX linear layer is ``{"w": (fan_in, fan_out), "b": (fan_out,)}``
while ``nn.Linear.weight`` is (out, in).  ``load_jax_checkpoint`` reads a
``.ckpt`` pickle without jax or optax installed: the format written by
``psignn_tpu/train/checkpoint.py``, which the port's trainer also writes
(``train/checkpoint.py``).
"""

from __future__ import annotations

import importlib.util
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import resolve_device
from .models.psignn import Psignn, PsignnConfig


# the mixed variant's extra MLPs of the update function (psignn_init:83-85)
NEUMANN = ("phi_neumann", "update_neumann")


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Ψ-GNN JAX parameter tree, Dirichlet or mixed (``psignn_init``
    layout, leaves anything ``np.asarray`` takes) as a ``Psignn`` state
    dict on the CPU.  Parameters of a variant not yet ported are refused,
    not dropped."""
    sd: Dict[str, torch.Tensor] = {}

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = tensor(p["w"]).T.contiguous()
        sd[f"{prefix}.bias"] = tensor(p["b"])

    def mlp(prefix, layers):
        for i, p in enumerate(layers):
            lin(f"{prefix}.layers.{i}", p)

    fn = tree["function"]
    extra = set(fn) - {"layers", "alpha", "laynorm", *NEUMANN}
    if extra:
        raise NotImplementedError(
            f"parameters {sorted(extra)} belong to a variant not yet ported")
    for k, layer in enumerate(fn["layers"]):
        for name in ("phi_to", "phi_from", "update"):
            mlp(f"function.layers.{k}.{name}", layer[name])
    for name in NEUMANN:
        if name in fn:
            mlp(f"function.{name}", fn[name])
    lin("function.alpha", fn["alpha"])
    sd["function.laynorm.weight"] = tensor(fn["laynorm"]["scale"])
    sd["function.laynorm.bias"] = tensor(fn["laynorm"]["bias"])
    mlp("encoder", tree["autoencoder"]["encoder"])
    mlp("decoder", tree["autoencoder"]["decoder"])
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A ``Psignn`` state dict as a JAX parameter tree of numpy arrays (the
    ``psignn_init`` layout), the inverse of ``params_from_jax``."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in state_dict.items()}

    def lin(prefix):
        return {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T),
                "b": sd[f"{prefix}.bias"]}

    def mlp(prefix):
        n = 0
        while f"{prefix}.layers.{n}.weight" in sd:
            n += 1
        return [lin(f"{prefix}.layers.{i}") for i in range(n)]

    layers = []
    while f"function.layers.{len(layers)}.phi_to.layers.0.weight" in sd:
        k = len(layers)
        layers.append({name: mlp(f"function.layers.{k}.{name}")
                       for name in ("phi_to", "phi_from", "update")})
    function = {
        "layers": layers,
        "alpha": lin("function.alpha"),
        "laynorm": {"scale": sd["function.laynorm.weight"],
                    "bias": sd["function.laynorm.bias"]},
    }
    for name in NEUMANN:
        if f"function.{name}.layers.0.weight" in sd:
            function[name] = mlp(f"function.{name}")
    return {
        "function": function,
        "autoencoder": {"encoder": mlp("encoder"), "decoder": mlp("decoder")},
    }


def psignn_from_jax(tree: Dict[str, Any], cfg: PsignnConfig,
                    device=None) -> Psignn:
    """A ``Psignn`` on ``device`` holding the JAX tree's weights."""
    model = Psignn(cfg, device=resolve_device(device))
    model.load_state_dict(params_from_jax(tree))
    return model.eval()


class _OptaxState(tuple):
    """Inert stand-in for optax's optimizer-state classes: keeps the
    constructor arguments and nothing else."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args)

    def __setstate__(self, state):
        pass


class _CheckpointUnpickler(pickle.Unpickler):
    """Resolves numpy classes; maps optax's to ``_OptaxState``; refuses the
    rest (a checkpoint holds numpy arrays and plain containers)."""

    def find_class(self, module: str, name: str):
        if module == "optax" or module.startswith("optax."):
            return _OptaxState
        if module.startswith("numpy._core") and \
                importlib.util.find_spec("numpy._core") is None:
            module = "numpy.core" + module[len("numpy._core"):]
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}, which is not a numpy or "
            f"optax class")


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint dict: ``params`` (nested dicts/lists of numpy arrays),
    ``hyperparameters``, ``family`` and the trainer's bookkeeping."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def load_psignn_checkpoint(path: str, device=None,
                           overrides: Optional[Dict[str, Any]] = None):
    """(model, cfg) from a Ψ-GNN checkpoint, the JAX package's or one the
    port's trainer wrote; ``overrides`` replace hyperparameters (e.g.
    ``fw_thres``)."""
    ckpt = load_jax_checkpoint(path)
    if ckpt.get("family", "psignn") != "psignn":
        raise NotImplementedError(f"family '{ckpt['family']}' is not yet ported")
    cfg = PsignnConfig.from_hyperparameters(ckpt["hyperparameters"],
                                            **(overrides or {}))
    return psignn_from_jax(ckpt["params"], cfg, device), cfg
