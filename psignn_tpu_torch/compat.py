"""Reference checkpoints: a reference ``.pt`` ``state_dict`` → port models.

Port of ``psignn_tpu/compat.py``.  The reference (mnastorg/PSI-GNN) is
PyTorch too and its ``nn.Linear`` weights are (out, in), as the port's,
so converting is a remap of the ``state_dict``'s keys, without
transposes: the reference's ``Sequential`` MLPs (``<prefix>.0`` and
``<prefix>.2``, a ReLU at 1) become the port's ``MLP.layers.0`` and
``.1``, and DSS's ``*_list.<i>`` its ``layers.<i>``.

Ψ-GNN checkpoints pickle a solver *function* of the reference's
``utilities.solver`` module inside ``hyperparameters``;
``load_reference_checkpoint`` unpickles them against a stub of that
module, which it keeps to itself: a ``utilities`` module already imported
(the JAX package's stub, or another) is neither used nor replaced.
"""

from __future__ import annotations

import dataclasses
import pickle
import types
from typing import Any, Dict

import torch

from . import resolve_device
from .models import (Dsgps, DsgpsConfig, Dss, DssConfig, Psignn,
                     PsignnConfig)

# the reference's solver functions that a Ψ-GNN checkpoint may name
_SOLVER_NAMES = ("broyden", "anderson", "forward_iteration", "newton")


def _stub_solver(*args, **kwargs):
    """Stands in for each reference solver function; never called."""
    raise NotImplementedError("a reference solver stub is not callable")


class _ReferenceUnpickler(pickle.Unpickler):
    """Resolves ``utilities.solver.<fn>`` to the stub and everything else
    as ``torch.load`` does."""

    def find_class(self, module: str, name: str):
        if module == "utilities.solver" and name in _SOLVER_NAMES:
            return _stub_solver
        return super().find_class(module, name)


# the ``pickle_module`` torch.load takes: it reads ``__name__`` (to tell
# dill apart) and unpickles with ``Unpickler``
_REFERENCE_PICKLE = types.SimpleNamespace(
    __name__="psignn_tpu_torch.compat", Unpickler=_ReferenceUnpickler,
    load=pickle.load)


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """``torch.load`` of a reference checkpoint on the CPU (``weights_only``
    off: it pickles more than tensors), with the reference's solver
    functions resolved to stubs."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_REFERENCE_PICKLE)


def _mlp(sd, src: str, dst: str, indices=(0, 2)) -> Dict[str, torch.Tensor]:
    """The reference ``Sequential`` at ``src`` (Linear layers at
    ``indices``) as the port's ``MLP`` at ``dst``."""
    out = {}
    for i, j in enumerate(indices):
        for p in ("weight", "bias"):
            out[f"{dst}.layers.{i}.{p}"] = sd[f"{src}.{j}.{p}"]
    return out


def _pair(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    """A reference ``nn.Linear`` or ``LayerNorm`` at ``src`` as ``dst``."""
    return {f"{dst}.{p}": sd[f"{src}.{p}"] for p in ("weight", "bias")}


def _float32(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to(torch.float32).clone() for k, v in sd.items()}


def _autoencoder(sd, dst: str) -> Dict[str, torch.Tensor]:
    return {**_mlp(sd, "autoencoder.encoder.mlp.mlp", f"{dst}encoder"),
            **_mlp(sd, "autoencoder.decoder.mlp.mlp", f"{dst}decoder")}


def convert_dsgps(sd, bc_mode: str = "dirichlet") -> Dict[str, torch.Tensor]:
    """ModelDSGPS ``state_dict`` → ``Dsgps`` state dict
    (``dirichlet/dsgps/model.py:27-46``)."""
    out = {**_pair(sd, "laynorm", "laynorm"),
           **_mlp(sd, "phi_to.mlp.mlp", "phi_to"),
           **_mlp(sd, "phi_from.mlp.mlp", "phi_from"),
           **_mlp(sd, "z_k.mlp", "z_k", (0,)),
           **_mlp(sd, "r_k.mlp", "r_k", (0,)),
           **_mlp(sd, "correction.mlp", "correction", (0,)),
           **_autoencoder(sd, "autoencoder.")}
    if bc_mode == "mixed":
        out.update(_mlp(sd, "phi_neumann.mlp.mlp", "phi_neumann"))
        out.update(_mlp(sd, "update_neumann.mlp", "update_neumann"))
    return _float32(out)


def convert_dss(sd, k: int) -> Dict[str, torch.Tensor]:
    """DeepStatisticalSolver ``state_dict`` → ``Dss`` state dict of its
    ``k`` layers (``dirichlet/dss/model.py:34-55``)."""
    out = {}
    for i in range(k):
        for name in ("phi_to", "phi_from", "psi", "decoder"):
            out.update(_mlp(sd, f"{name}_list.{i}.mlp.mlp",
                            f"layers.{i}.{name}"))
    return _float32(out)


def convert_psignn(sd, n_layers: int = 1,
                   bc_mode: str = "dirichlet") -> Dict[str, torch.Tensor]:
    """ModelDEQDSS ``state_dict`` → ``Psignn`` state dict
    (``dirichlet/psignn/model.py:28-54, 263-277``)."""
    f = "deqdss.f"
    out = {}
    for kk in range(n_layers):
        dst = f"function.layers.{kk}"
        out.update(_mlp(sd, f"{f}.phi_to_list.{kk}.mlp.mlp", f"{dst}.phi_to"))
        out.update(_mlp(sd, f"{f}.phi_from_list.{kk}.mlp.mlp",
                        f"{dst}.phi_from"))
        out.update(_mlp(sd, f"{f}.update_list.{kk}.mlp", f"{dst}.update"))
    out.update(_pair(sd, f"{f}.alpha.0", "function.alpha"))
    out.update(_pair(sd, f"{f}.laynorm", "function.laynorm"))
    if bc_mode == "mixed":
        out.update(_mlp(sd, f"{f}.phi_neumann.mlp.mlp",
                        "function.phi_neumann"))
        out.update(_mlp(sd, f"{f}.update_neumann.mlp",
                        "function.update_neumann"))
    out.update(_autoencoder(sd, ""))
    return _float32(out)


# family → (model, config)
_FAMILIES = {"psignn": (Psignn, PsignnConfig), "dsgps": (Dsgps, DsgpsConfig),
             "dss": (Dss, DssConfig)}


def convert_reference_checkpoint(path: str, family: str,
                                 bc_mode: str = "dirichlet",
                                 device=None) -> Dict[str, Any]:
    """Load and convert in one step: ``params`` (the port's state dict),
    ``model`` (the family's port model holding it, in eval mode, on
    ``device``, default the card), ``config`` (its config: the
    hyperparameters it has a field for, and ``bc_mode``),
    ``hyperparameters`` (the checkpoint's scalar entries) and
    ``torch_ckpt`` (the loaded checkpoint)."""
    if family not in _FAMILIES:
        raise ValueError(family)
    ck = load_reference_checkpoint(path)
    sd = ck["state_dict"]
    hp = {k: v for k, v in ck.get("hyperparameters", {}).items()
          if isinstance(v, (int, float, str, bool))}
    if family == "dsgps":
        params = convert_dsgps(sd, bc_mode)
    elif family == "dss":
        params = convert_dss(sd, int(hp.get("k", 30)))
    else:
        params = convert_psignn(sd, int(hp.get("n_layers", 1)), bc_mode)
    model_cls, cfg_cls = _FAMILIES[family]
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    known = {k: v for k, v in hp.items() if k in fields}
    if "bc_mode" in fields:
        known["bc_mode"] = bc_mode
    cfg = cfg_cls(**known)
    model = model_cls(cfg, device=resolve_device(device))
    model.load_state_dict(params)
    return {"params": params, "model": model.eval(), "config": cfg,
            "hyperparameters": hp, "torch_ckpt": ck}
