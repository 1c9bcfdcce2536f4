"""The port's host runtime (``psignn_tpu_torch/native.py``, its own build of
``kernels/csrc/psignncore.cpp``) against the JAX package's
(``psignn_tpu/native.py`` and ``native/libpsignncore.so``) and against the
port's scipy/numpy path, on the same numpy meshes; then the host route of
``kernels/build.py``."""

import ctypes
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from psignn_tpu import native as jax_native
from psignn_tpu.kernels.fused_mp import BLOCK_N, pack_mp_blocks
from psignn_tpu_torch import native
from psignn_tpu_torch.data.fem import _QP, _QW, apply_dirichlet, assemble_p1
from psignn_tpu_torch.data.meshgen import blob_mesh
from psignn_tpu_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
# tests/test_native.py's mesh, and a finer one four times its area
MESHES = {"r1_h0.2": dict(radius=1.0, hsize=0.2, seed=17),
          "r2_h0.1": dict(radius=2.0, hsize=0.1, seed=17)}
# The two libraries compile the same C++ at the same flags, but maybe with
# other compilers for other CPUs (-march=native), which may contract a
# product and a sum into one FMA elsewhere: floats are held to a tolerance,
# integers exactly.  COO values within ASM_TOL · max|vals| of JAX's; the
# assembled matrix within ASM_TOL of assemble_p1's (entries of order 1).
ASM_TOL = 1e-12
# the load vector: tests/test_native.py:44's tolerance
LOAD_RTOL, LOAD_ATOL = 1e-12, 1e-14
# CG (relative residual 1e-12) against spsolve: tests/test_native.py:69's;
# against JAX's build of the same loop, tighter; the iteration counts may
# differ by one where a contracted FMA moves the last residual across tol
CG_RTOL, CG_ATOL = 1e-7, 1e-9
CG_JAX_RTOL, CG_JAX_ATOL = 1e-9, 1e-11
CG_ITER_SLACK = 1
PUBLIC = ("available", "assemble_p1_coo", "assemble_load", "solve_cg",
          "rcm_order", "pack_mp_blocks_core")


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh(request):
    return blob_mesh(**MESHES[request.param])


def _source(x, y):
    return 1.0 + x ** 2 - 2 * y


def _stiffness(mesh):
    return assemble_p1(mesh, lambda x, y: np.zeros_like(x))[0].tocsr()


def test_public_names_match_jax():
    for name in PUBLIC:
        assert inspect.signature(getattr(native, name)) == \
            inspect.signature(getattr(jax_native, name)), name
    assert jax_native.available() and native.available()


def _c_signatures():
    """{function: (return type, [parameter types])} of psignncore.cpp."""
    text = build.source(native.LIBRARY).read_text()
    sigs = {}
    for ret, name, params in re.findall(
            r"^(void|int32_t) (\w+)\(([^)]*)\)", text, re.M):
        sigs[name] = (ret, [" ".join(p.split()[:-1])
                            for p in params.split(",")])
    return sigs


C_TYPES = {"const double*": np.float64, "double*": np.float64,
           "const int32_t*": np.int32, "int32_t*": np.int32,
           "const int64_t*": np.int64, "int64_t*": np.int64,
           "float*": np.float32, "int64_t": ctypes.c_int64,
           "int32_t": ctypes.c_int32, "double": ctypes.c_double}


@pytest.mark.parametrize("name", sorted(native.SIGNATURES))
def test_argtypes_match_the_c_signature(name):
    """Each ctypes signature against the source's ``extern "C"`` one (a
    wrong width would corrupt the call), and against JAX's bindings."""
    ret, params = _c_signatures()[name]
    argtypes, restype = native.SIGNATURES[name]
    assert restype is (None if ret == "void" else ctypes.c_int32)
    assert len(argtypes) == len(params)
    for got, param in zip(argtypes, params):
        want = C_TYPES[param]
        if param.endswith("*"):
            assert got._dtype_ == np.dtype(want), param
        else:
            assert got is want, param
    fn = getattr(jax_native._load(), name)
    assert fn.argtypes == argtypes
    assert getattr(native._lib(), name).argtypes == argtypes


def test_assemble_p1_coo(mesh):
    rows, cols, vals = native.assemble_p1_coo(mesh.points, mesh.triangles)
    want = jax_native.assemble_p1_coo(mesh.points, mesh.triangles)
    n_coo = 9 * len(mesh.triangles)
    for got, ref, dtype in zip((rows, cols, vals), want,
                               (np.int32, np.int32, np.float64)):
        assert got.dtype == ref.dtype == dtype and got.shape == (n_coo,)
    np.testing.assert_array_equal(rows, want[0])
    np.testing.assert_array_equal(cols, want[1])
    assert np.abs(vals - want[2]).max() <= ASM_TOL * np.abs(want[2]).max()
    A = sp.coo_matrix((vals, (rows, cols)),
                      shape=(mesh.n_points, mesh.n_points)).tocsr()
    A.sum_duplicates()
    assert abs(_stiffness(mesh) - A).max() < ASM_TOL


def test_assemble_load(mesh):
    _, b_py = assemble_p1(mesh, _source)
    lam = np.stack([1.0 - _QP[:, 0] - _QP[:, 1], _QP[:, 0], _QP[:, 1]], 1)
    p0, p1, p2 = (mesh.points[mesh.triangles[:, i]] for i in range(3))
    xq = (lam[None, :, 0:1] * p0[:, None] + lam[None, :, 1:2] * p1[:, None]
          + lam[None, :, 2:3] * p2[:, None])
    fq = _source(xq[..., 0], xq[..., 1])
    args = (mesh.points, mesh.triangles, fq, lam, _QW, mesh.n_points)
    b = native.assemble_load(*args)
    b_jax = jax_native.assemble_load(*args)
    assert b.dtype == np.float64 and b.shape == (mesh.n_points,)
    np.testing.assert_allclose(b, b_jax, rtol=LOAD_RTOL, atol=LOAD_ATOL)
    np.testing.assert_allclose(b, b_py, rtol=LOAD_RTOL, atol=LOAD_ATOL)


def _reduced(mesh):
    """The interior-eliminated system of tests/test_native.py's CG test
    (A_II u_I = b_I - A_IB g) and spsolve's answer on its interior."""
    A, b = assemble_p1(mesh, lambda x, y: np.full_like(x, -4.0))
    bidx = np.where(mesh.boundary_mask)[0]
    g = mesh.points[bidx, 0] ** 2 + mesh.points[bidx, 1] ** 2
    Ad, bd = apply_dirichlet(A.copy(), b.copy(), bidx, g)
    want = spla.spsolve(Ad.tocsc(), bd)
    iidx = np.where(~mesh.boundary_mask)[0]
    A_II = A[iidx][:, iidx].tocsr()
    rhs = b[iidx] - A[iidx][:, bidx] @ g
    return (A_II.indptr.astype(np.int64), A_II.indices, A_II.data, rhs), \
        want[iidx]


def test_solve_cg(mesh):
    system, want = _reduced(mesh)
    x, iters = native.solve_cg(*system, tol=1e-12)
    x_jax, iters_jax = jax_native.solve_cg(*system, tol=1e-12)
    assert x.dtype == np.float64 and x.shape == want.shape
    assert iters > 0 and isinstance(iters, int)
    np.testing.assert_allclose(x, want, rtol=CG_RTOL, atol=CG_ATOL)
    np.testing.assert_allclose(x, x_jax, rtol=CG_JAX_RTOL, atol=CG_JAX_ATOL)
    assert abs(iters - iters_jax) <= CG_ITER_SLACK
    # the defaults are JAX's (tol 1e-12, maxiter 10000)
    x_default, iters_default = native.solve_cg(*system)
    assert iters_default == iters
    np.testing.assert_array_equal(x_default, x)


def test_solve_cg_raises_when_not_converged(mesh):
    system, _ = _reduced(mesh)
    for module in (native, jax_native):
        with pytest.raises(RuntimeError, match="CG did not converge"):
            module.solve_cg(*system, maxiter=1)


def test_rcm_order(mesh):
    A = _stiffness(mesh)
    n = mesh.n_points
    perm = native.rcm_order(A.indptr.astype(np.int64), A.indices, n)
    assert perm.dtype == np.int32 and perm.shape == (n,)
    np.testing.assert_array_equal(
        perm, jax_native.rcm_order(A.indptr.astype(np.int64), A.indices, n))
    np.testing.assert_array_equal(np.sort(perm), np.arange(n))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    coo = A.tocoo()
    bw_after = np.abs(inv[coo.row] - inv[coo.col]).max()
    assert bw_after <= np.abs(coo.row - coo.col).max()
    assert bw_after < n // 4


def _edges(mesh):
    """tests/test_native.py's packing inputs: the stiffness pattern's
    edges, JAX's ``pack_mp_blocks`` of them, and the filtered, sorted
    (agg, oth) the native packer takes."""
    s, r, _ = sp.find(_stiffness(mesh))
    s, r = s.astype(np.int32), r.astype(np.int32)
    ea = np.random.default_rng(0).normal(size=(len(s), 3)).astype(np.float32)
    n_cap = -(-mesh.n_points // 256) * 256
    py = pack_mp_blocks(s, r, ea, np.ones(len(s), bool), n_cap, "to")
    keep = s != r
    agg, oth = r[keep], s[keep]
    order = np.argsort(agg, kind="stable")
    return py, agg[order], oth[order], n_cap


def test_pack_mp_blocks_core(mesh):
    py, agg, oth, n_cap = _edges(mesh)
    e_cap = py.agg_local.shape[1]
    got = native.pack_mp_blocks_core(agg, oth, n_cap, BLOCK_N, e_cap)
    want = jax_native.pack_mp_blocks_core(agg, oth, n_cap, BLOCK_N, e_cap)
    al, og, mask, ws, need = got
    np.testing.assert_array_equal(al, np.asarray(py.agg_local))
    np.testing.assert_array_equal(mask, np.asarray(py.mask))
    np.testing.assert_array_equal(ws, np.asarray(py.win_start))
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert need == want[4] and isinstance(need, int)


def test_pack_mp_blocks_core_raises_when_e_cap_too_small(mesh):
    _, agg, oth, n_cap = _edges(mesh)
    fill = int(np.bincount(agg // BLOCK_N).max())
    native.pack_mp_blocks_core(agg, oth, n_cap, BLOCK_N, fill)
    for module in (native, jax_native):
        with pytest.raises(ValueError, match="e_cap too small"):
            module.pack_mp_blocks_core(agg, oth, n_cap, BLOCK_N, fill - 1)


def test_entry_points_refuse_out_of_range_indices(mesh):
    """The C loops index without bounds: the bindings check first."""
    tris = mesh.triangles.copy()
    tris[0, 0] = mesh.n_points
    with pytest.raises(ValueError, match="tris"):
        native.assemble_p1_coo(mesh.points, tris)
    A = _stiffness(mesh)
    with pytest.raises(ValueError, match="indptr"):
        native.rcm_order(A.indptr[:-1].astype(np.int64), A.indices,
                         mesh.n_points)
    _, agg, oth, n_cap = _edges(mesh)
    with pytest.raises(ValueError, match="agg"):
        native.pack_mp_blocks_core(agg + n_cap, oth, n_cap, BLOCK_N, 4096)


def test_second_build_compiles_nothing():
    first = build.build(native.LIBRARY)
    again = build.build(native.LIBRARY)
    assert again.path == first.path and again.seconds == 0.0
    assert first.path.parent == build.BUILD_DIR
    assert "psignn_tpu_torch/kernels/build/" in \
        (ROOT / ".gitignore").read_text().splitlines()


def test_library_path_follows_flags_compiler_and_cpu(monkeypatch):
    path = build.library_path(native.LIBRARY)
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ["-g"])
    flagged = build.library_path(native.LIBRARY)
    monkeypatch.undo()
    monkeypatch.setenv("CXX", "clang++")
    compiler = build.library_path(native.LIBRARY)
    monkeypatch.undo()
    monkeypatch.setattr(build, "host_cpu", lambda: {"flags": "sse2"})
    cpu = build.library_path(native.LIBRARY)
    assert len({path, flagged, compiler, cpu}) == 4
    assert flagged.parent == path.parent == build.BUILD_DIR


def test_build_never_writes_into_native(monkeypatch, tmp_path):
    """A fresh build lands in ``build.BUILD_DIR``; the JAX package's
    ``native/`` (its source, Makefile and committed library) is left as
    it was."""
    before = {p.name: p.read_bytes() for p in (ROOT / "native").iterdir()}
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    res = build.build(native.LIBRARY)
    assert res.seconds > 0 and res.path.parent == tmp_path / "build"
    assert ROOT / "native" not in res.path.parents
    assert {p.name: p.read_bytes()
            for p in (ROOT / "native").iterdir()} == before


@pytest.fixture
def fresh_library(monkeypatch, tmp_path):
    """An empty build directory and no library loaded, restored after."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    native._lib.cache_clear()
    yield
    native._lib.cache_clear()


def test_missing_compiler_raises_with_its_command(fresh_library,
                                                  monkeypatch, tmp_path):
    cxx = str(tmp_path / "no-such-g++")
    monkeypatch.setenv("CXX", cxx)
    assert not native.available()
    with pytest.raises(RuntimeError) as err:
        native.assemble_p1_coo([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]],
                               [[0, 1, 2]])
    assert cxx in str(err.value) and "-march=native" in str(err.value)
    assert "psignncore.cpp" in str(err.value)


def test_failed_build_raises_with_compiler_output(fresh_library,
                                                  monkeypatch):
    monkeypatch.setattr(build, "CXX_FLAGS",
                        build.CXX_FLAGS + ["-fno-such-option"])
    with pytest.raises(RuntimeError) as err:
        native.rcm_order(np.zeros(2, np.int64), np.zeros(0, np.int32), 1)
    message = str(err.value)
    assert message.count("-fno-such-option") >= 2   # command and output
    assert "failed (" in message
    assert not list(build.BUILD_DIR.glob("*.so"))
