"""JAX parameter trees and ``psignn_tpu`` checkpoints → port modules.

``params_from_jax`` (Ψ-GNN), ``dsgps_params_from_jax`` and
``dss_params_from_jax``, and their inverses ``*_to_jax``, own the layout
change: a JAX linear layer is ``{"w": (fan_in, fan_out), "b": (fan_out,)}``
while ``nn.Linear.weight`` is (out, in); DSS's JAX tree also stacks its k
layers on a leading axis of every leaf.  ``load_jax_checkpoint`` reads a
``.ckpt`` pickle without jax or optax installed: the format written by
``psignn_tpu/train/checkpoint.py``, which the port's trainer also writes
(``train/checkpoint.py``); ``load_model_checkpoint`` builds the model of
any family from one.
"""

from __future__ import annotations

import importlib.util
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import resolve_device
from .models.dsgps import Dsgps, DsgpsConfig
from .models.dss import Dss, DssConfig
from .models.psignn import Psignn, PsignnConfig


# the mixed variant's extra MLPs of the update function (psignn_init:83-85)
NEUMANN = ("phi_neumann", "update_neumann")


# the MLPs of a DS-GPS tree besides the autoencoder (dsgps_init:72-89)
DSGPS_MLPS = ("phi_to", "phi_from", "z_k", "r_k", "correction")
# the MLPs of each DSS layer (dss_init:43-50)
DSS_MLPS = ("phi_to", "phi_from", "psi", "decoder")


class _ToTorch:
    """Writes JAX-layout leaves into a state dict of CPU tensors."""

    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def lin(self, prefix, p):
        self.sd[f"{prefix}.weight"] = _tensor(p["w"]).T.contiguous()
        self.sd[f"{prefix}.bias"] = _tensor(p["b"])

    def mlp(self, prefix, layers):
        for i, p in enumerate(layers):
            self.lin(f"{prefix}.layers.{i}", p)

    def norm(self, prefix, p):
        self.sd[f"{prefix}.weight"] = _tensor(p["scale"])
        self.sd[f"{prefix}.bias"] = _tensor(p["bias"])


class _ToJax:
    """Reads a state dict back into JAX-layout numpy leaves."""

    def __init__(self, state_dict: Dict[str, torch.Tensor]):
        self.sd = {k: v.detach().cpu().numpy().astype(np.float32)
                   for k, v in state_dict.items()}

    def has(self, prefix) -> bool:
        return f"{prefix}.layers.0.weight" in self.sd

    def lin(self, prefix):
        return {"w": np.ascontiguousarray(self.sd[f"{prefix}.weight"].T),
                "b": self.sd[f"{prefix}.bias"]}

    def mlp(self, prefix):
        n = 0
        while f"{prefix}.layers.{n}.weight" in self.sd:
            n += 1
        return [self.lin(f"{prefix}.layers.{i}") for i in range(n)]

    def norm(self, prefix):
        return {"scale": self.sd[f"{prefix}.weight"],
                "bias": self.sd[f"{prefix}.bias"]}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _refuse_extra(tree: Dict[str, Any], known) -> None:
    extra = set(tree) - set(known)
    if extra:
        raise NotImplementedError(
            f"parameters {sorted(extra)} belong to a variant not yet ported")


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Ψ-GNN JAX parameter tree, Dirichlet or mixed (``psignn_init``
    layout, leaves anything ``np.asarray`` takes) as a ``Psignn`` state
    dict on the CPU.  Parameters of a variant not yet ported are refused,
    not dropped."""
    out = _ToTorch()
    fn = tree["function"]
    _refuse_extra(fn, {"layers", "alpha", "laynorm", *NEUMANN})
    for k, layer in enumerate(fn["layers"]):
        for name in ("phi_to", "phi_from", "update"):
            out.mlp(f"function.layers.{k}.{name}", layer[name])
    for name in NEUMANN:
        if name in fn:
            out.mlp(f"function.{name}", fn[name])
    out.lin("function.alpha", fn["alpha"])
    out.norm("function.laynorm", fn["laynorm"])
    out.mlp("encoder", tree["autoencoder"]["encoder"])
    out.mlp("decoder", tree["autoencoder"]["decoder"])
    return out.sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A ``Psignn`` state dict as a JAX parameter tree of numpy arrays (the
    ``psignn_init`` layout), the inverse of ``params_from_jax``."""
    sd = _ToJax(state_dict)
    layers = []
    while sd.has(f"function.layers.{len(layers)}.phi_to"):
        k = len(layers)
        layers.append({name: sd.mlp(f"function.layers.{k}.{name}")
                       for name in ("phi_to", "phi_from", "update")})
    function = {
        "layers": layers,
        "alpha": sd.lin("function.alpha"),
        "laynorm": sd.norm("function.laynorm"),
    }
    for name in NEUMANN:
        if sd.has(f"function.{name}"):
            function[name] = sd.mlp(f"function.{name}")
    return {
        "function": function,
        "autoencoder": {"encoder": sd.mlp("encoder"),
                        "decoder": sd.mlp("decoder")},
    }


def dsgps_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A DS-GPS JAX parameter tree, Dirichlet or mixed (``dsgps_init``
    layout) as a ``Dsgps`` state dict on the CPU, ``laynorm`` and, when
    present, the Neumann MLPs included."""
    out = _ToTorch()
    _refuse_extra(tree, {"laynorm", "autoencoder", *DSGPS_MLPS, *NEUMANN})
    out.norm("laynorm", tree["laynorm"])
    for name in DSGPS_MLPS + NEUMANN:
        if name in tree:
            out.mlp(name, tree[name])
    for name in ("encoder", "decoder"):
        out.mlp(f"autoencoder.{name}", tree["autoencoder"][name])
    return out.sd


def dsgps_params_to_jax(state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, Any]:
    """A ``Dsgps`` state dict as a JAX parameter tree of numpy arrays, the
    inverse of ``dsgps_params_from_jax``."""
    sd = _ToJax(state_dict)
    tree = {"laynorm": sd.norm("laynorm")}
    for name in DSGPS_MLPS + NEUMANN:
        if sd.has(name):
            tree[name] = sd.mlp(name)
    tree["autoencoder"] = {name: sd.mlp(f"autoencoder.{name}")
                           for name in ("encoder", "decoder")}
    return tree


def dss_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A DSS JAX parameter tree (``dss_init``: every leaf stacked on a
    leading k axis) as a ``Dss`` state dict of k layers on the CPU."""
    out = _ToTorch()
    _refuse_extra(tree, {"layers"})
    layers = tree["layers"]
    _refuse_extra(layers, DSS_MLPS)
    k = np.asarray(layers["psi"][0]["w"]).shape[0]
    for t in range(k):
        for name in DSS_MLPS:
            out.mlp(f"layers.{t}.{name}",
                    [{"w": np.asarray(p["w"])[t], "b": np.asarray(p["b"])[t]}
                     for p in layers[name]])
    return out.sd


def dss_params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A ``Dss`` state dict as a JAX parameter tree of numpy arrays with
    the k layers restacked, the inverse of ``dss_params_from_jax``."""
    sd = _ToJax(state_dict)
    k = 0
    while sd.has(f"layers.{k}.psi"):
        k += 1
    layers = {}
    for name in DSS_MLPS:
        per_layer = [sd.mlp(f"layers.{t}.{name}") for t in range(k)]
        layers[name] = [{key: np.stack([lay[i][key] for lay in per_layer])
                         for key in ("w", "b")}
                        for i in range(len(per_layer[0]))]
    return {"layers": layers}


# family → (model, config, tree → state dict, state dict → tree)
FAMILIES = {
    "psignn": (Psignn, PsignnConfig, params_from_jax, params_to_jax),
    "dsgps": (Dsgps, DsgpsConfig, dsgps_params_from_jax, dsgps_params_to_jax),
    "dss": (Dss, DssConfig, dss_params_from_jax, dss_params_to_jax),
}


def model_from_jax(family: str, tree: Dict[str, Any], cfg,
                   device=None) -> torch.nn.Module:
    """The ``family``'s model on ``device`` holding the JAX tree's
    weights, in eval mode."""
    model_cls, _, from_jax, _ = FAMILIES[family]
    model = model_cls(cfg, device=resolve_device(device))
    model.load_state_dict(from_jax(tree))
    return model.eval()


def psignn_from_jax(tree: Dict[str, Any], cfg: PsignnConfig,
                    device=None) -> Psignn:
    """A ``Psignn`` on ``device`` holding the JAX tree's weights."""
    return model_from_jax("psignn", tree, cfg, device)


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


def load_model_checkpoint(path: str, device=None,
                          overrides: Optional[Dict[str, Any]] = None):
    """(family, model, cfg) from a checkpoint of any family, the JAX
    package's or one the port's trainer wrote, by its ``family`` entry;
    ``overrides`` replace hyperparameters (e.g. ``fw_thres`` or ``k``)."""
    ckpt = load_jax_checkpoint(path)
    family = ckpt.get("family", "psignn")
    if family not in FAMILIES:
        raise ValueError(f"{path}: unknown family {family!r}")
    cfg = FAMILIES[family][1].from_hyperparameters(ckpt["hyperparameters"],
                                                   **(overrides or {}))
    return family, model_from_jax(family, ckpt["params"], cfg, device), cfg


def load_psignn_checkpoint(path: str, device=None,
                           overrides: Optional[Dict[str, Any]] = None):
    """(model, cfg) from a Ψ-GNN checkpoint, the JAX package's or one the
    port's trainer wrote; ``overrides`` replace hyperparameters (e.g.
    ``fw_thres``)."""
    family, model, cfg = load_model_checkpoint(path, device, overrides)
    if family != "psignn":
        raise ValueError(f"{path} holds a {family} model, not a Ψ-GNN")
    return model, cfg
