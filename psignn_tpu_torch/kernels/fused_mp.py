"""Fused message passing: the CSR edge packing, the CUDA kernels' wrappers,
their plain PyTorch versions and the autograd wiring.

The contract is ``psignn_tpu.kernels.fused_mp.mp_from_blocks`` (whose
counterpart here is ``mp_from_csr``): for each
aggregation node, the 2-layer edge MLP of ``[x_i, x_j, edge_attr]`` summed
over its edges (self-loops and masked edges excluded).  On the TPU the
edges were packed into 128-node blocks with RCM windows for one-hot MXU
matmuls; here they are packed as a CSR by aggregation node
(``pack_csr``), which the CUDA kernels walk row by row
(``csrc/fused_mp_fwd.cu``, ``csrc/fused_mp_bwd.cu``, and
``csrc/fused_mp_jvp.cu``, the tangent, which has no TPU counterpart).

``fused_message_passing`` picks by device: a CPU tensor goes through the
plain version ``mp_from_csr`` (differentiated by autograd); a CUDA tensor
goes through ``_FusedMP``, whose forward launches the forward kernel and
whose backward launches the backward kernel, or raises.  There is no
fallback.  As in the JAX package (``fused_mp.py:248-265``), the backward
is itself differentiable: its first-order values come from the kernel and
its own derivatives from differentiating the plain VJP ``mp_vjp_from_csr``,
which the Hutchinson Jacobian loss needs.

Forward-mode AD (Newton-Krylov's Jacobian-vector products) goes through
the same Functions: ``_FusedMP.jvp`` launches the JVP kernel for a tangent
of ``h`` (``fused_mp_jvp``; plain version ``mp_jvp_from_csr``), and
``_FusedMPVjp.jvp``, the VJP being linear in its cotangent ``g``, launches
the backward kernel for a tangent of ``g``.  A tangent of the weights
raises: no path needs one.  As for any ``autograd.Function``, the primal
is computed by ``forward``, so a JVP through a call launches the forward
kernel and the JVP kernel once each.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from . import build
from .. import profiling

KERNEL = "fused_mp_fwd"
KERNEL_BWD = "fused_mp_bwd"
KERNEL_JVP = "fused_mp_jvp"

# Kernel launches since the last reset; each is incremented only where its
# CUDA kernel is launched.  ``chip_smoke.py`` zeroes them around the main
# path.
LAUNCHES = 0
BWD_LAUNCHES = 0
JVP_LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class MPCsr:
    """Edges of one direction, stably sorted by aggregation node, and the
    same edges sorted by their other endpoint (the opposite direction's
    packing), which the backward kernel walks to sum per source node."""
    row_ptr: torch.Tensor        # (n_rows + 1,) int32 offsets into the edges
    oth: torch.Tensor            # (E,) int32 the other endpoint of each edge
    edge_attr: torch.Tensor      # (E, edge_dim) float32
    rev_row_ptr: torch.Tensor    # (n_rows + 1,) the same, by other endpoint
    rev_oth: torch.Tensor        # (E,) int32 the aggregation node
    rev_edge_attr: torch.Tensor  # (E, edge_dim) float32

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.oth.shape[0]

    def reverse(self) -> "MPCsr":
        """The opposite direction's packing (the same tensors, swapped)."""
        return MPCsr(self.rev_row_ptr, self.rev_oth, self.rev_edge_attr,
                     self.row_ptr, self.oth, self.edge_attr)


def _rows(agg: np.ndarray, oth: np.ndarray, ea: np.ndarray, n_nodes: int,
          device):
    order = np.argsort(agg, kind="stable")
    row_ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(agg, minlength=n_nodes), out=row_ptr[1:])
    return (torch.from_numpy(row_ptr.astype(np.int32)).to(device),
            torch.from_numpy(oth[order].astype(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(ea[order])).to(device))


def pack_csr(senders: np.ndarray, receivers: np.ndarray,
             edge_attr: np.ndarray, n_nodes: int, direction: str,
             edge_mask=None, device=None) -> MPCsr:
    """CSR packing of ``pack_mp_blocks`` without TPU blocks or windows.

    ``direction='to'`` aggregates at receivers (x_i = receiver), ``'from'``
    at senders.  Self-loops and masked edges are dropped; the stable sort
    keeps each row's edges in COO order.  ``reverse()`` of the result is
    the packing of the other direction.  The span ``graph.csr``."""
    if direction not in ("to", "from"):
        raise ValueError(direction)
    with profiling.span("graph.csr"):
        senders = np.asarray(senders, np.int64)
        receivers = np.asarray(receivers, np.int64)
        keep = senders != receivers
        if edge_mask is not None:
            keep &= np.asarray(edge_mask, bool)
        agg = (receivers if direction == "to" else senders)[keep]
        oth = (senders if direction == "to" else receivers)[keep]
        ea = np.asarray(edge_attr, np.float32)[keep]
        if n_nodes >= 2 ** 31 or len(agg) >= 2 ** 31:
            raise ValueError("CSR indices exceed int32")
        return MPCsr(*_rows(agg, oth, ea, n_nodes, device),
                     *_rows(oth, agg, ea, n_nodes, device))


def _edge_rows(csr: MPCsr, device) -> torch.Tensor:
    """(E,) int64 aggregation row of each edge, from ``row_ptr``."""
    rows = torch.arange(csr.n_rows, device=device)
    return torch.repeat_interleave(rows, csr.row_ptr.diff().long(),
                                   output_size=csr.n_edges)


def mp_from_csr(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor, h: torch.Tensor, csr: MPCsr) -> torch.Tensor:
    """Plain PyTorch version: gather, edge MLP, ``index_add_``.

    Weights are in ``nn.Linear`` layout: ``w1`` (Dh, 2D + edge_dim),
    ``w2`` (D_out, Dh).  Differentiable; runs on any device."""
    agg = _edge_rows(csr, h.device)
    feats = torch.cat([h[agg], h[csr.oth.long()], csr.edge_attr], dim=-1)
    msg = torch.relu(feats @ w1.T + b1) @ w2.T + b2
    out = torch.zeros(h.shape[0], w2.shape[0], dtype=msg.dtype,
                      device=h.device)
    return out.index_add_(0, agg, msg)


def mp_vjp_from_csr(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, h: torch.Tensor, csr: MPCsr,
                    g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward: the VJP of ``mp_from_csr``
    with output cotangent ``g`` (N, D_out), as (dw1, db1, dw2, db2, dh) in
    the layouts of (w1, b1, w2, b2, h).  Written out edge by edge (pre,
    ReLU mask, dpre) as the kernel computes it; differentiable."""
    d = h.shape[1]
    agg = _edge_rows(csr, h.device)
    oth = csr.oth.long()
    feats = torch.cat([h[agg], h[oth], csr.edge_attr], dim=-1)
    pre = feats @ w1.T + b1
    dmsg = g[agg]                                         # (E, D_out)
    dw2 = dmsg.T @ torch.relu(pre)
    db2 = dmsg.sum(0)
    dpre = (dmsg @ w2) * (pre > 0).to(pre.dtype)          # (E, Dh)
    dw1 = dpre.T @ feats
    db1 = dpre.sum(0)
    dfeats = dpre @ w1
    dh = torch.zeros_like(h).index_add_(0, agg, dfeats[:, :d])
    dh = dh.index_add_(0, oth, dfeats[:, d:2 * d])
    return dw1, db1, dw2, db2, dh


def mp_jvp_from_csr(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, h: torch.Tensor, csr: MPCsr,
                    v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the tangent: the derivative of
    ``mp_from_csr`` in ``h`` along the direction ``v`` (N, D), as (N, D_out).
    Per edge, W2·(1[pre > 0] ⊙ W1·[v_i; v_j; 0]), summed at the aggregation
    node: the edge features, ``b1`` and ``b2`` carry no tangent."""
    d = h.shape[1]
    agg = _edge_rows(csr, h.device)
    oth = csr.oth.long()
    pre = torch.cat([h[agg], h[oth], csr.edge_attr], dim=-1) @ w1.T + b1
    dpre = torch.cat([v[agg], v[oth]], dim=-1) @ w1[:, :2 * d].T
    dmsg = (dpre * (pre > 0).to(pre.dtype)) @ w2.T
    out = torch.zeros(h.shape[0], w2.shape[0], dtype=dmsg.dtype,
                      device=h.device)
    return out.index_add_(0, agg, dmsg)


def fused_message_passing(w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor, h: torch.Tensor,
                          csr: MPCsr) -> torch.Tensor:
    """(N, D_out) fused message passing of ``h`` (N, D) over ``csr``.

    CPU tensors take the plain version; CUDA tensors launch the kernels
    (the backward one when autograd differentiates the call)."""
    if h.device.type == "cpu":
        return mp_from_csr(w1, b1, w2, b2, h, csr)
    if h.device.type != "cuda":
        raise ValueError(f"fused_mp: unsupported device {h.device}")
    return _FusedMP.apply(w1, b1, w2, b2, h, csr)


def fused_mp_vjp(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, h: torch.Tensor, csr: MPCsr,
                 g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(dw1, db1, dw2, db2, dh): the VJP of ``fused_message_passing`` for
    the output cotangent ``g``.  CPU tensors take the plain version; CUDA
    tensors launch the backward kernel."""
    if h.device.type == "cpu":
        return mp_vjp_from_csr(w1, b1, w2, b2, h, csr, g)
    if h.device.type != "cuda":
        raise ValueError(f"fused_mp: unsupported device {h.device}")
    return _fused_mp_bwd_cuda(w1, b1, w2, b2, h, csr, g)


def fused_mp_jvp(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, h: torch.Tensor, csr: MPCsr,
                 v: torch.Tensor) -> torch.Tensor:
    """(N, D_out) tangent of ``fused_message_passing`` in ``h`` along
    ``v``.  CPU tensors take the plain version; CUDA tensors launch the JVP
    kernel."""
    if h.device.type == "cpu":
        return mp_jvp_from_csr(w1, b1, w2, b2, h, csr, v)
    if h.device.type != "cuda":
        raise ValueError(f"fused_mp: unsupported device {h.device}")
    return _fused_mp_jvp_cuda(w1, b1, w2, b2, h, csr, v)


def _no_weight_tangent(*tangents) -> None:
    if any(t is not None for t in tangents):
        raise NotImplementedError(
            "fused_mp: forward-mode AD takes a tangent of h (of g for the "
            "VJP) only, not of the weights")


class _FusedMP(torch.autograd.Function):
    """Forward kernel; its backward is ``_FusedMPVjp`` (the backward
    kernel), its forward-mode rule the JVP kernel."""

    @staticmethod
    def forward(ctx, w1, b1, w2, b2, h, csr):
        ctx.csr = csr
        ctx.set_materialize_grads(False)     # an absent tangent stays None
        ctx.save_for_backward(w1, b1, w2, b2, h)
        ctx.save_for_forward(w1, b1, w2, b2, h)
        return _fused_mp_cuda(w1, b1, w2, b2, h, csr)

    @staticmethod
    def backward(ctx, g):
        w1, b1, w2, b2, h = ctx.saved_tensors
        return (*_FusedMPVjp.apply(w1, b1, w2, b2, h, g.contiguous(),
                                   ctx.csr), None)

    @staticmethod
    def jvp(ctx, dw1, db1, dw2, db2, dh, _):
        _no_weight_tangent(dw1, db1, dw2, db2)
        w1, b1, w2, b2, h = ctx.saved_tensors
        return fused_mp_jvp(w1, b1, w2, b2, h, ctx.csr, dh.contiguous())


class _FusedMPVjp(torch.autograd.Function):
    """Backward kernel; its own backward differentiates the plain VJP.  The
    VJP is linear in ``g``, so its tangent along ``dg`` is the backward
    kernel applied to ``dg``."""

    @staticmethod
    def forward(ctx, w1, b1, w2, b2, h, g, csr):
        ctx.csr = csr
        ctx.set_materialize_grads(False)     # an absent tangent stays None
        ctx.save_for_backward(w1, b1, w2, b2, h, g)
        ctx.save_for_forward(w1, b1, w2, b2, h)
        return fused_mp_vjp(w1, b1, w2, b2, h, csr, g)

    @staticmethod
    def backward(ctx, *cotangents):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = mp_vjp_from_csr(*inputs[:5], ctx.csr, inputs[5])
        cotangents = [torch.zeros_like(o) if c is None else c
                      for o, c in zip(outs, cotangents)]
        grads = torch.autograd.grad(outs, inputs, cotangents,
                                    allow_unused=True,
                                    create_graph=torch.is_grad_enabled())
        return (*grads, None)

    @staticmethod
    def jvp(ctx, dw1, db1, dw2, db2, dh, dg, _):
        _no_weight_tangent(dw1, db1, dw2, db2, dh)
        w1, b1, w2, b2, h = ctx.saved_tensors
        return fused_mp_vjp(w1, b1, w2, b2, h, ctx.csr, dg.contiguous())


# ctypes signatures of the C entry points (csrc/*.cu): a pointer or the
# stream is c_void_p, an int c_int (tests/test_torch_fused_mp_abi.py reads
# the sources and holds these to them).
FWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
BWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
JVP_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# Blocks of the backward's first two passes at most (4 per SM of an H100):
# the rows are walked with a fixed stride, so the partial sums, and with
# them the result's bits, depend only on the shapes.
BWD_MAX_BLOCKS = 528


@functools.cache
def _kernel_fn():
    fn = build.load(KERNEL).psignn_fused_mp_fwd
    fn.argtypes = FWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel_fn():
    fn = build.load(KERNEL_BWD).psignn_fused_mp_bwd
    fn.argtypes = BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _jvp_kernel_fn():
    fn = build.load(KERNEL_JVP).psignn_fused_mp_jvp
    fn.argtypes = JVP_ARGTYPES
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


def _check_call(w1, b1, w2, b2, h, csr: MPCsr):
    """Widths (d, dh, d_out, edge_dim) of a kernel call, after checking
    every operand's type, shape, device and contiguity."""
    if h.dim() != 2:
        raise ValueError(f"fused_mp: h must be (N, D), got {tuple(h.shape)}")
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
    return d, dh, d_out, edge_dim


def _fused_mp_cuda(w1, b1, w2, b2, h, csr: MPCsr) -> torch.Tensor:
    global LAUNCHES
    d, dh, d_out, edge_dim = _check_call(w1, b1, w2, b2, h, csr)
    n = h.shape[0]
    out = torch.empty((n, d_out), dtype=torch.float32, device=h.device)
    rc = _kernel_fn()(
        h.data_ptr(), csr.row_ptr.data_ptr(), csr.oth.data_ptr(),
        csr.edge_attr.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        n, d, dh, d_out, edge_dim, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_mp: kernel launch failed, cudaError {rc}")
    LAUNCHES += 1
    return out


def _fused_mp_bwd_cuda(w1, b1, w2, b2, h, csr: MPCsr, g):
    """The backward kernel: dh and every parameter gradient, the dense
    products included, come out of its three passes."""
    global BWD_LAUNCHES
    d, dh, d_out, edge_dim = _check_call(w1, b1, w2, b2, h, csr)
    n, e, dev = h.shape[0], csr.n_edges, h.device
    f32, i32 = torch.float32, torch.int32
    _check("g", g, f32, (n, d_out), dev)
    _check("rev_row_ptr", csr.rev_row_ptr, i32, (n + 1,), dev)
    _check("rev_oth", csr.rev_oth, i32, (e,), dev)
    _check("rev_edge_attr", csr.rev_edge_attr, f32, (e, edge_dim), dev)

    k_in = 2 * d + edge_dim
    n_params = dh * k_in + dh + d_out * dh + d_out
    base, gw, dha = (torch.empty((n, dh), dtype=f32, device=dev)
                     for _ in range(3))
    dh_out = torch.empty((n, d), dtype=f32, device=dev)
    partials = torch.empty((BWD_MAX_BLOCKS, n_params), dtype=f32, device=dev)
    params = torch.empty(n_params, dtype=f32, device=dev)
    rc = _bwd_kernel_fn()(
        h.data_ptr(), g.data_ptr(), csr.row_ptr.data_ptr(),
        csr.oth.data_ptr(), csr.edge_attr.data_ptr(),
        csr.rev_row_ptr.data_ptr(), csr.rev_oth.data_ptr(),
        csr.rev_edge_attr.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), base.data_ptr(), gw.data_ptr(), dha.data_ptr(),
        dh_out.data_ptr(),
        partials.data_ptr(), params.data_ptr(),
        n, d, dh, d_out, edge_dim, BWD_MAX_BLOCKS,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_mp: backward kernel launch failed, "
                           f"cudaError {rc}")
    BWD_LAUNCHES += 1
    sizes = (dh * k_in, dh, d_out * dh, d_out)
    dw1, db1, dw2, db2 = params.split(sizes)
    return dw1.view(dh, k_in), db1, dw2.view(d_out, dh), db2, dh_out


def _fused_mp_jvp_cuda(w1, b1, w2, b2, h, csr: MPCsr, v) -> torch.Tensor:
    """The JVP kernel: the tangent along ``v``, one write per row."""
    global JVP_LAUNCHES
    d, dh, d_out, edge_dim = _check_call(w1, b1, w2, b2, h, csr)
    n = h.shape[0]
    _check("v", v, torch.float32, (n, d), h.device)
    out = torch.empty((n, d_out), dtype=torch.float32, device=h.device)
    rc = _jvp_kernel_fn()(
        h.data_ptr(), v.data_ptr(), csr.row_ptr.data_ptr(),
        csr.oth.data_ptr(), csr.edge_attr.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), out.data_ptr(),
        n, d, dh, d_out, edge_dim, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_mp: JVP kernel launch failed, "
                           f"cudaError {rc}")
    JVP_LAUNCHES += 1
    return out
