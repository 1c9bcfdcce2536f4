"""The port's host runtime: ctypes bindings of ``kernels/csrc/psignncore.cpp``.

Port of ``psignn_tpu/native.py``, with its entry points, arguments,
defaults, dtypes, shapes and errors: P1 stiffness assembly as COO triplets,
the load vector from quadrature values, a Jacobi-preconditioned CG solve of
an SPD CSR system, reverse Cuthill-McKee ordering, and the edge-block
packing of the JAX package's TPU kernel (the port's kernels read a CSR).

The library is the port's own copy of the C++ source, built at first use
by ``kernels/build.py`` with the host's C++ compiler (``$CXX``, else
``g++``) into ``kernels/build/``; nothing is built at import.  There is no
fallback inside this module: when the library cannot be built,
``available()`` is False and every entry point raises the ``RuntimeError``
that carries the compiler's command and output.  The scipy/numpy
counterparts are ``data/fem.py`` (``assemble_p1``, ``apply_dirichlet``)
and ``dist/partition.py`` (``rcm_permutation``); callers choose between
them.  No path of the port calls this module.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from .kernels import build

LIBRARY = "psignncore"

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64

# (argtypes, restype) of each extern "C" function of psignncore.cpp
SIGNATURES = {
    "assemble_p1_coo": ([_f64p, _i64, _i32p, _i64, _i32p, _i32p, _f64p],
                        None),
    "assemble_load": ([_f64p, _i32p, _i64, _f64p, _f64p, _f64p, _i64, _f64p],
                      None),
    "solve_cg": ([_i64p, _i32p, _f64p, _i64, _f64p, _f64p, ctypes.c_double,
                  ctypes.c_int32], ctypes.c_int32),
    "rcm_order": ([_i64p, _i32p, _i64, _i32p], None),
    "pack_mp_blocks_core": ([_i32p, _i32p, _i64, _i64, _i64, _i64, _i32p,
                             _i32p, _f32p, _i32p, _i64p], ctypes.c_int32),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every signature set; raises the
    ``RuntimeError`` of ``kernels.build`` when it cannot be built."""
    lib = build.load(LIBRARY)
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _indices(name: str, idx: np.ndarray, n: int) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"{name} holds indices outside [0, {n})")


def _mesh(pts, tris) -> Tuple[np.ndarray, np.ndarray]:
    pts = np.ascontiguousarray(pts, np.float64)
    tris = np.ascontiguousarray(tris, np.int32)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"pts has shape {pts.shape}, needs (npts, 2)")
    if tris.ndim != 2 or tris.shape[1] != 3:
        raise ValueError(f"tris has shape {tris.shape}, needs (ntri, 3)")
    _indices("tris", tris, len(pts))
    return pts, tris


def _csr(indptr, indices, n: int) -> Tuple[np.ndarray, np.ndarray]:
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    if indptr.shape != (n + 1,) or indptr[0] != 0 \
            or np.any(np.diff(indptr) < 0) or indptr[-1] > len(indices):
        raise ValueError(f"indptr is not a CSR row pointer of {n} rows "
                         f"over {len(indices)} entries")
    _indices("indices", indices[:indptr[-1]], n)
    return indptr, indices


def assemble_p1_coo(pts: np.ndarray, tris: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, vals) COO triplets of the P1 stiffness matrix, 9 per
    triangle: int32, int32, float64."""
    lib = _lib()
    pts, tris = _mesh(pts, tris)
    ntri = len(tris)
    rows = np.empty(9 * ntri, np.int32)
    cols = np.empty(9 * ntri, np.int32)
    vals = np.empty(9 * ntri, np.float64)
    lib.assemble_p1_coo(pts, len(pts), tris, ntri, rows, cols, vals)
    return rows, cols, vals


def assemble_load(pts: np.ndarray, tris: np.ndarray, fq: np.ndarray,
                  lam: np.ndarray, w: np.ndarray, npts: int) -> np.ndarray:
    """The (npts,) float64 load vector: ``fq`` (ntri, nq) source values at
    the quadrature points, ``lam`` (nq, 3) their barycentric coordinates,
    ``w`` (nq,) the weights."""
    lib = _lib()
    pts, tris = _mesh(pts, tris)
    _indices("tris", tris, npts)
    fq = np.ascontiguousarray(fq, np.float64)
    lam = np.ascontiguousarray(lam, np.float64)
    w = np.ascontiguousarray(w, np.float64)
    nq = lam.shape[0]
    if fq.shape != (len(tris), nq) or lam.shape != (nq, 3) \
            or w.shape != (nq,):
        raise ValueError(f"fq {fq.shape}, lam {lam.shape}, w {w.shape}: "
                         f"need ({len(tris)}, nq), (nq, 3), (nq,)")
    b = np.zeros(npts, np.float64)
    lib.assemble_load(pts, tris, len(tris), fq, lam, w, nq, b)
    return b


def solve_cg(indptr, indices, data, b, tol=1e-12, maxiter=10000):
    """Jacobi-CG solve of an SPD CSR system; returns (x, iterations).
    Raises ``RuntimeError`` when it does not converge in ``maxiter``."""
    lib = _lib()
    n = len(b)
    indptr, indices = _csr(indptr, indices, n)
    data = np.ascontiguousarray(data, np.float64)
    if len(data) != len(indices):
        raise ValueError(f"data has {len(data)} entries, indices "
                         f"{len(indices)}")
    x = np.zeros(n, np.float64)
    it = lib.solve_cg(indptr, indices, data, n,
                      np.ascontiguousarray(b, np.float64), x, tol, maxiter)
    if it < 0:
        raise RuntimeError("CG did not converge")
    return x, int(it)


def rcm_order(indptr, indices, n) -> np.ndarray:
    """Reverse Cuthill-McKee order of a structurally symmetric CSR pattern:
    ``perm[k]`` (int32) is the old index of the node at position k."""
    lib = _lib()
    indptr, indices = _csr(indptr, indices, n)
    perm = np.empty(n, np.int32)
    lib.rcm_order(indptr, indices, n, perm)
    return perm


def pack_mp_blocks_core(agg, oth, n_node_cap, block_n, e_cap):
    """Native edge-block packing; returns (agg_local, oth_global, mask,
    win_start, max_need) or raises ``ValueError`` if e_cap is too small.
    The edges are filtered (no self loops, none masked) and sorted by
    ``agg``; the outputs are trimmed to the live blocks."""
    lib = _lib()
    agg = np.ascontiguousarray(agg, np.int32)
    oth = np.ascontiguousarray(oth, np.int32)
    if len(oth) != len(agg):
        raise ValueError(f"agg has {len(agg)} edges, oth {len(oth)}")
    n_blocks = n_node_cap // block_n
    _indices("agg", agg, n_blocks * block_n)
    agg_local = np.zeros((n_blocks, e_cap), np.int32)
    oth_global = np.zeros((n_blocks, e_cap), np.int32)
    mask = np.zeros((n_blocks, e_cap), np.float32)
    win_start = np.zeros(n_blocks, np.int32)
    fill = np.zeros(n_blocks, np.int64)
    need = lib.pack_mp_blocks_core(
        agg, oth, len(agg), n_node_cap, block_n, e_cap, agg_local,
        oth_global, mask, win_start, fill)
    if need < 0:
        raise ValueError("e_cap too small for block packing")
    # live-block grid: drop trailing all-padding blocks, as the JAX
    # package's Python pack (pack_mp_blocks) sizes its kernel grid by the
    # last aggregation node that has edges
    live = np.nonzero(fill)[0]
    n_live = max(1, int(live[-1]) + 1) if len(live) else 1
    return (agg_local[:n_live], oth_global[:n_live], mask[:n_live],
            win_start[:n_live], int(need))
