"""Plain building blocks of the reference models: the checkpoint reader,
linear layers and MLPs over JAX-layout parameters, LayerNorm and the
directional message passing, in plain PyTorch.

Everything computes in float32 with TF32 off, or, given
``precision="tf32"``, with every matmul's operands rounded to TF32's
10-bit mantissa first (what a tensor core does to float32 operands; the
products are summed in float32): the control of the benchmark's
comparison.  Inside ``FixedOrder()`` every sum of rows into nodes (an
``index_add_``, the backward of a gather) takes PyTorch's deterministic
kernels, so a judge repeated from its seed gives the same bits.  Imports
torch, numpy and (for a node order) scipy, nothing of the program.
"""

from __future__ import annotations

import importlib.util
import pickle
from typing import Any, Dict

import numpy as np
import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class FixedOrder:
    """A context with PyTorch's deterministic algorithms on inside, as
    they were after.  On the card ``index_add_`` and the backward of
    ``x[index]`` otherwise add a node's rows by atomics, in an order that
    changes each call.  ``warn_only``: cuBLAS asks for
    ``CUBLAS_WORKSPACE_CONFIG`` before its first call, which the program
    has made by then; it warns."""

    def __enter__(self):
        self.was = (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.was[0],
                                           warn_only=self.was[1])


class _Inert(tuple):
    """Stands in for the optimizer-state classes a checkpoint pickles."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args)

    def __setstate__(self, state):
        pass


class _Unpickler(pickle.Unpickler):
    """numpy classes resolved, optax's made inert, anything else refused."""

    def find_class(self, module: str, name: str):
        if module == "optax" or module.startswith("optax."):
            return _Inert
        if module.startswith("numpy._core") and \
                importlib.util.find_spec("numpy._core") is None:
            module = "numpy.core" + module[len("numpy._core"):]
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}")


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint dict (``params``: nested dicts and lists of numpy
    arrays in JAX layout, ``hyperparameters``, ``family``, ...)."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def to_device(tree, device) -> Any:
    """The parameter tree with every array a float32 tensor of its own on
    ``device`` (a copy: training updates it in place)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest on TF32's 10-bit mantissa (float32
    storage)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return rounded.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return tf32(a) @ tf32(b)
    if precision != "f32":
        raise ValueError(precision)
    return a @ b


def linear(p, x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w + b`` with ``p = {"w": (in, out), "b": (out,)}``."""
    return matmul(x, p["w"], precision) + p["b"]


def mlp(layers, x: torch.Tensor, precision: str) -> torch.Tensor:
    """Linear layers with ReLU between them and none after the last."""
    for i, p in enumerate(layers):
        x = linear(p, x, precision)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def layer_norm(p, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance, eps 1e-5."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * p["scale"] + p["bias"]


class Edges:
    """A mesh's edges as message passing reads them: the nonzeros of A
    without the diagonal.  ``to`` aggregates at receivers (x_i the
    receiver), ``from`` at senders."""

    def __init__(self, sample: Dict[str, np.ndarray], device):
        s = np.asarray(sample["senders"], np.int64)
        r = np.asarray(sample["receivers"], np.int64)
        keep = s != r
        self.senders = torch.as_tensor(s[keep], device=device)
        self.receivers = torch.as_tensor(r[keep], device=device)
        self.edge_attr = torch.as_tensor(
            np.asarray(sample["edge_attr"], np.float32)[keep], device=device)
        self.n = int(np.asarray(sample["x"]).shape[0])


def message_passing(layers, h: torch.Tensor, edges: Edges, direction: str,
                    precision: str) -> torch.Tensor:
    """Σ over a node's edges of the edge MLP of [x_i, x_j, edge_attr]."""
    if direction == "to":
        agg, oth = edges.receivers, edges.senders
    elif direction == "from":
        agg, oth = edges.senders, edges.receivers
    else:
        raise ValueError(direction)
    msg = mlp(layers, torch.cat([h[agg], h[oth], edges.edge_attr], -1),
              precision)
    out = torch.zeros(edges.n, msg.shape[1], dtype=msg.dtype,
                      device=h.device)
    return out.index_add_(0, agg, msg)


def node_tensors(sample: Dict[str, np.ndarray], device):
    """(x, prb_data, dirichlet mask) of a Dirichlet sample as (N, ·)
    float32 tensors."""
    def t(a, w):
        return torch.as_tensor(np.asarray(a, np.float32).reshape(-1, w),
                               device=device)
    x = t(sample["x"], 1)
    prb = t(sample["prb_data"], 2)
    dmask = t(sample["tags"], 1)
    return x, prb, dmask


def rcm_order(sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``sample`` with its nodes in reverse Cuthill-McKee order of the
    symmetrised pattern (scipy's), edge endpoints renumbered: the node
    order a training batch is built in, which pairs each node with its
    Hutchinson probe."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    n = sample["x"].shape[0]
    s, r = np.asarray(sample["senders"]), np.asarray(sample["receivers"])
    a = sp.coo_matrix((np.ones(2 * len(s)), (np.concatenate([s, r]),
                                             np.concatenate([r, s]))),
                      shape=(n, n)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    out = {}
    for k, v in sample.items():
        v = np.asarray(v)
        if k in ("senders", "receivers"):
            out[k] = inv[v].astype(np.int32)
        elif v.ndim >= 1 and v.shape[0] == n:
            out[k] = v[perm]
        else:
            out[k] = v
    return out
