"""The ctypes boundary of the CUDA kernels, checked without ``nvcc``: each
entry point's ``argtypes`` constant in ``kernels/fused_mp.py`` against the
``extern "C"`` signature in ``kernels/csrc/*.cu`` (a pointer or the stream
is ``c_void_p``, an ``int`` is ``c_int``; an int passed where a pointer is
expected would cut the pointer to 32 bits), and each wrapper's call against
those constants, with the library replaced by a recorder."""

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from psignn_tpu_torch.kernels import build
from psignn_tpu_torch.kernels import fused_mp as fm

ENTRY_POINTS = {"psignn_fused_mp_fwd": ("FWD_ARGTYPES", "_kernel_fn"),
                "psignn_fused_mp_bwd": ("BWD_ARGTYPES", "_bwd_kernel_fn")}
SIGNATURE = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _c_signatures():
    """{entry point: [ctypes type per parameter]} of every csrc source."""
    sigs = {}
    for src in sorted(build.SRC_DIR.glob("*.cu")):
        for name, params in SIGNATURE.findall(src.read_text()):
            kinds = []
            for param in params.split(","):
                param = " ".join(param.split())
                if "*" in param:
                    kinds.append(ctypes.c_void_p)
                elif re.fullmatch(r"(const )?int \w+", param):
                    kinds.append(ctypes.c_int)
                else:
                    raise AssertionError(f"{src.name}: {name}: {param!r}")
            sigs[name] = kinds
    return sigs


def test_every_entry_point_has_argtypes():
    assert set(_c_signatures()) == set(ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_argtypes_match_the_c_signature(name, monkeypatch):
    const, loader = ENTRY_POINTS[name]
    want = _c_signatures()[name]
    assert getattr(fm, const) == want
    # the loader sets exactly that constant on the library's function
    fn = types.SimpleNamespace()
    monkeypatch.setattr(build, "load",
                        lambda kernel: types.SimpleNamespace(**{name: fn}))
    assert getattr(fm, loader).__wrapped__() is fn
    assert fn.argtypes == want and fn.restype is ctypes.c_int


def _recorder(argtypes, calls):
    """A stand-in for the library function: checks each argument against
    its ctypes kind and records the call."""
    def fn(*args):
        assert len(args) == len(argtypes)
        for a, kind in zip(args, argtypes):
            assert isinstance(a, int)
            if kind is ctypes.c_int:
                assert ctypes.c_int(a).value == a
        calls.append(args)
        return 0
    return fn


def _inputs(n=13, d=10, edge_dim=3, seed=0):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n - 3, 60), rng.integers(0, n - 3, 60)
    csr = fm.pack_csr(s, r, rng.normal(size=(60, edge_dim)), n, "to")
    gen = torch.Generator().manual_seed(seed)
    w1 = torch.randn(d, 2 * d + edge_dim, generator=gen)
    b1, w2, b2 = (torch.randn(d, generator=gen),
                  torch.randn(d, d, generator=gen), torch.randn(d, generator=gen))
    h, g = torch.randn(n, d, generator=gen), torch.randn(n, d, generator=gen)
    return w1, b1, w2, b2, h, csr, g


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' calls into the (recorded) libraries, and every tensor
    they allocate with ``torch.empty``."""
    calls, shapes = {"fwd": [], "bwd": []}, []
    monkeypatch.setattr(fm, "_kernel_fn",
                        lambda: _recorder(fm.FWD_ARGTYPES, calls["fwd"]))
    monkeypatch.setattr(fm, "_bwd_kernel_fn",
                        lambda: _recorder(fm.BWD_ARGTYPES, calls["bwd"]))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=12345))
    empty = torch.empty

    def tracked(*size, **kw):
        t = empty(*size, **kw)
        shapes.append(tuple(t.shape))
        return t
    monkeypatch.setattr(torch, "empty", tracked)
    monkeypatch.setattr(fm, "LAUNCHES", 0)
    monkeypatch.setattr(fm, "BWD_LAUNCHES", 0)
    return calls, shapes


def test_forward_wrapper_call(recorded):
    calls, _ = recorded
    w1, b1, w2, b2, h, csr, _ = _inputs()
    out = fm._fused_mp_cuda(w1, b1, w2, b2, h, csr)
    (args,) = calls["fwd"]
    assert args[9:14] == (13, 10, 10, 10, 3) and args[14] == 12345
    assert args[8] == out.data_ptr() and out.shape == (13, 10)
    assert fm.LAUNCHES == 1


def test_backward_wrapper_call(recorded):
    """One call, the widths and the block cap as ints, no scratch of size
    E, and every output a view of the kernel's outputs in the layouts of
    (w1, b1, w2, b2, h)."""
    calls, shapes = recorded
    w1, b1, w2, b2, h, csr, g = _inputs()
    dw1, db1, dw2, db2, dh = fm._fused_mp_bwd_cuda(w1, b1, w2, b2, h, csr, g)
    (args,) = calls["bwd"]
    assert args[17:] == (13, 10, 10, 10, 3, fm.BWD_MAX_BLOCKS, 12345)
    assert fm.BWD_LAUNCHES == 1
    assert csr.n_edges not in {x for s in shapes for x in s}
    n_params = 10 * 23 + 10 + 10 * 10 + 10
    params = args[16]
    assert [t.shape for t in (dw1, db1, dw2, db2)] == [
        w1.shape, b1.shape, w2.shape, b2.shape]
    assert dw1.data_ptr() == params and dw1.is_contiguous()
    assert db2.data_ptr() == params + 4 * (n_params - 10)
    assert dh.shape == h.shape and dh.data_ptr() == args[14]
    assert (fm.BWD_MAX_BLOCKS, n_params) in shapes
