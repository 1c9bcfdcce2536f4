"""Fused message passing: the CSR edge packing, the CUDA kernel's wrapper
and its plain PyTorch version.

The contract is ``psignn_tpu.kernels.fused_mp.mp_from_blocks`` (whose
counterpart here is ``mp_from_csr``): for each
aggregation node, the 2-layer edge MLP of ``[x_i, x_j, edge_attr]`` summed
over its edges (self-loops and masked edges excluded).  On the TPU the
edges were packed into 128-node blocks with RCM windows for one-hot MXU
matmuls; here they are packed as a CSR by aggregation node
(``pack_csr``), which the CUDA kernel walks row by row
(``csrc/fused_mp_fwd.cu``).

``fused_message_passing`` picks by device: a CPU tensor goes through the
plain version ``mp_from_csr``; a CUDA tensor launches the kernel or
raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import build

KERNEL = "fused_mp_fwd"

# Kernel launches since the last reset; incremented only where the CUDA
# kernel is launched.  ``chip_smoke.py`` zeroes it around the main path.
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class MPCsr:
    """Edges of one direction, stably sorted by aggregation node."""
    row_ptr: torch.Tensor    # (n_rows + 1,) int32 offsets into the edge arrays
    oth: torch.Tensor        # (E,) int32 the other endpoint of each edge
    edge_attr: torch.Tensor  # (E, edge_dim) float32

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.oth.shape[0]


def pack_csr(senders: np.ndarray, receivers: np.ndarray,
             edge_attr: np.ndarray, n_nodes: int, direction: str,
             edge_mask=None, device=None) -> MPCsr:
    """CSR packing of ``pack_mp_blocks`` without TPU blocks or windows.

    ``direction='to'`` aggregates at receivers (x_i = receiver), ``'from'``
    at senders.  Self-loops and masked edges are dropped; the stable sort
    keeps each row's edges in COO order."""
    if direction not in ("to", "from"):
        raise ValueError(direction)
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    keep = senders != receivers
    if edge_mask is not None:
        keep &= np.asarray(edge_mask, bool)
    agg = (receivers if direction == "to" else senders)[keep]
    oth = (senders if direction == "to" else receivers)[keep]
    ea = np.asarray(edge_attr, np.float32)[keep]
    order = np.argsort(agg, kind="stable")
    oth, ea = oth[order], ea[order]
    row_ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(agg, minlength=n_nodes), out=row_ptr[1:])
    if n_nodes >= 2 ** 31 or len(agg) >= 2 ** 31:
        raise ValueError("CSR indices exceed int32")
    return MPCsr(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)).to(device),
        oth=torch.from_numpy(oth.astype(np.int32)).to(device),
        edge_attr=torch.from_numpy(np.ascontiguousarray(ea)).to(device))


def mp_from_csr(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor, h: torch.Tensor, csr: MPCsr) -> torch.Tensor:
    """Plain PyTorch version: gather, edge MLP, ``index_add_``.

    Weights are in ``nn.Linear`` layout: ``w1`` (Dh, 2D + edge_dim),
    ``w2`` (D_out, Dh).  Differentiable; runs on any device."""
    rows = torch.arange(csr.n_rows, device=h.device)
    agg = torch.repeat_interleave(rows, csr.row_ptr.diff().long(),
                                  output_size=csr.n_edges)
    feats = torch.cat([h[agg], h[csr.oth.long()], csr.edge_attr], dim=-1)
    msg = torch.relu(feats @ w1.T + b1) @ w2.T + b2
    out = torch.zeros(h.shape[0], w2.shape[0], dtype=msg.dtype,
                      device=h.device)
    return out.index_add_(0, agg, msg)


def fused_message_passing(w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor, h: torch.Tensor,
                          csr: MPCsr) -> torch.Tensor:
    """(N, D_out) fused message passing of ``h`` (N, D) over ``csr``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if h.device.type == "cpu":
        return mp_from_csr(w1, b1, w2, b2, h, csr)
    if h.device.type != "cuda":
        raise ValueError(f"fused_mp: unsupported device {h.device}")
    return _fused_mp_cuda(w1, b1, w2, b2, h, csr)


@functools.cache
def _kernel_fn():
    fn = build.load(KERNEL).psignn_fused_mp_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"fused_mp: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"fused_mp: {name} is {t.dtype}, needs {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_mp: {name} has shape {tuple(t.shape)}, "
                         f"needs {shape}")
    if t.device != device:
        raise ValueError(f"fused_mp: {name} on {t.device}, h on {device}")
    if not t.is_contiguous():
        raise ValueError(f"fused_mp: {name} is not contiguous")


def _fused_mp_cuda(w1, b1, w2, b2, h, csr: MPCsr) -> torch.Tensor:
    global LAUNCHES
    if h.dim() != 2:
        raise ValueError(f"fused_mp: h must be (N, D), got {tuple(h.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (w1, b1, w2, b2, h)):
        raise RuntimeError("fused_mp: the CUDA forward kernel has no backward "
                           "yet; call it under torch.no_grad()")
    n, d = h.shape
    dh = w1.shape[0]
    d_out = w2.shape[0]
    e = csr.n_edges
    edge_dim = csr.edge_attr.shape[1] if csr.edge_attr.dim() == 2 else -1
    if not (1 <= d <= 32 and 1 <= dh <= 32 and 1 <= d_out <= 32
            and 1 <= edge_dim <= 8):
        raise ValueError(f"fused_mp: widths D={d} Dh={dh} D_out={d_out} "
                         f"edge_dim={edge_dim} outside the kernel's range")
    f32, i32, dev = torch.float32, torch.int32, h.device
    _check("h", h, f32, (n, d), dev)
    _check("w1", w1, f32, (dh, 2 * d + edge_dim), dev)
    _check("b1", b1, f32, (dh,), dev)
    _check("w2", w2, f32, (d_out, dh), dev)
    _check("b2", b2, f32, (d_out,), dev)
    _check("row_ptr", csr.row_ptr, i32, (n + 1,), dev)
    _check("oth", csr.oth, i32, (e,), dev)
    _check("edge_attr", csr.edge_attr, f32, (e, edge_dim), dev)

    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"fused_mp: tensors on {dev} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")

    out = torch.empty((n, d_out), dtype=f32, device=dev)
    rc = _kernel_fn()(
        h.data_ptr(), csr.row_ptr.data_ptr(), csr.oth.data_ptr(),
        csr.edge_attr.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        n, d, dh, d_out, edge_dim, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_mp: kernel launch failed, cudaError {rc}")
    LAUNCHES += 1
    return out
