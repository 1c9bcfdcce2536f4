"""Broyden's rank memory in the port (``max_rank``'s ring and bfloat16
storage of the pairs), the Ψ-GNN options that set it, and
``--precision bfloat16``'s data, against the JAX package on the CPU.

Below the cap the capped solver is full memory bit for bit.  Past it the
ring is held against JAX's ``broyden`` as JAX's own test sets it up
(``tests/test_solvers.py:186-200``: ``_LR_BLOCK`` patched to 8,
``max_rank`` 16, threshold 400).  Trace tolerances: f32 sums in other
orders agree to 1e-4 through step 24 and to 2e-3 through step 36 of that
problem, then drift (the iteration turns chaotic near its floor); pairs
rounded to bfloat16 drift from step 10 (5e-3 by step 16), so they are
compared over the first 16 steps and by their answers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import fem_sample, load_trained
from psignn_tpu import solvers as jsolvers
from psignn_tpu.data.reader import load_dataset as jax_load_dataset
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models import psignn_inference as jax_psignn_inference
from psignn_tpu_torch import deq, solvers
from psignn_tpu_torch.data.generate import add_dss_variable, generate_data
from psignn_tpu_torch.data.reader import load_dataset
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import PsignnConfig, psignn_inference
from psignn_tpu_torch.weights import psignn_from_jax

DTYPES = {"f32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


def make_linear(n=12, d=4, rho=0.6, seed=0):
    """f(x) = M x + c with spectral radius rho, as tests/test_solvers.py's,
    for both packages, and its fixed point."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n * d, n * d)).astype(np.float32)
    M *= rho / max(abs(np.linalg.eigvals(M)))
    c = rng.normal(size=(n * d,)).astype(np.float32)
    xstar = np.linalg.solve(np.eye(n * d) - M, c).reshape(n, d)
    Mj, cj = jnp.asarray(M), jnp.asarray(c)
    Mt, ct = torch.from_numpy(M), torch.from_numpy(c)
    return ((lambda x: (Mj @ x.reshape(-1) + cj).reshape(n, d)),
            (lambda x: (Mt @ x.reshape(-1) + ct).reshape(n, d)),
            xstar, (n, d))


@pytest.fixture
def small_block(monkeypatch):
    """Both packages' rank block patched to 8 pairs."""
    monkeypatch.setattr(jsolvers, "_LR_BLOCK", 8)
    monkeypatch.setattr(solvers, "_LR_BLOCK", 8)


@pytest.mark.parametrize("threshold,max_rank,cap", [
    (531, 640, 531), (531, 128, 128), (531, 32, 128), (300, 256, 256),
    (300, 0, 300), (100, 129, 100)])
def test_rank_cap_rounds_up_to_the_block(threshold, max_rank, cap):
    """``R_cap = min(T, ceil(max_rank / 128) · 128)`` (JAX
    ``solvers.py:403``); 0 is full memory."""
    assert solvers.rank_cap(threshold, max_rank) == cap


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_below_the_cap_is_full_memory_bit_for_bit(dtype):
    """The problem of JAX's ``test_broyden_max_rank_converges`` at eps
    1e-6 stops before step 256: no pair is evicted from the 256-pair ring,
    and every iterate, residual and count equals full memory's exactly,
    with f32 or bfloat16 pairs."""
    _, tf, _, shape = make_linear(rho=0.9, seed=3)
    lo = DTYPES[dtype][0]
    full = solvers.broyden(tf, torch.zeros(shape), threshold=300, eps=1e-6,
                           lowrank_dtype=lo, keep_trace=True)
    capped = solvers.broyden(tf, torch.zeros(shape), threshold=300, eps=1e-6,
                             lowrank_dtype=lo, keep_trace=True, max_rank=256)
    assert 16 < full.trace_len - 1 < 256 and full.lowest < 1e-6
    assert (capped.nstep, capped.trace_len, capped.calls, capped.lowest) == \
        (full.nstep, full.trace_len, full.calls, full.lowest)
    for k in ("result", "trace", "rel_trace", "abs_trace"):
        assert torch.equal(getattr(capped, k), getattr(full, k)), k


def test_ring_wraps_and_matches_jax(small_block):
    """Cap 16 pairs (``_LR_BLOCK`` 8): the ring wraps from step 17.  The
    same steps as JAX's at eps 1e-5, residual traces within 2e-4 through
    step 24 and 2e-3 through step 36, the answer within 2e-5 of JAX's and
    4e-5 of x*."""
    jf, tf, xstar, shape = make_linear(n=12, d=4, rho=0.95, seed=4)
    want = jsolvers.broyden(jf, jnp.zeros(shape), threshold=400, eps=1e-5,
                            max_rank=16)
    got = solvers.broyden(tf, torch.zeros(shape), threshold=400, eps=1e-5,
                          max_rank=16)
    assert got.nstep == int(want.nstep) > 16
    assert got.trace_len == int(want.trace_len)
    rel, jrel = got.rel_trace.numpy(), np.asarray(want.rel_trace)
    np.testing.assert_allclose(rel[:24], jrel[:24], rtol=2e-4)
    np.testing.assert_allclose(rel[:36], jrel[:36], rtol=2e-3)
    np.testing.assert_allclose(got.result.numpy(), np.asarray(want.result),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.result.numpy(), xstar, rtol=0, atol=4e-5)
    assert not got.prot_break


@pytest.mark.parametrize("max_rank", [0, 16])
def test_bf16_pairs_match_jax(small_block, max_rank):
    """Pairs stored in bfloat16, full memory (JAX's
    ``test_broyden_bf16_lowrank_converges`` problem) and in the wrapped
    ring: u and vᵀ rounded on store, the right-hand sides rounded before
    each product, f32 sums.  Residual traces within 5e-3 of JAX's over the
    first 16 steps; both reach eps, and the answer is x* within 1e-3 (bf16
    keeps about 3 digits of each pair)."""
    rho, seed, eps = (0.9, 2, 1e-7) if max_rank == 0 else (0.95, 4, 1e-6)
    jf, tf, xstar, shape = make_linear(rho=rho, seed=seed)
    want = jsolvers.broyden(jf, jnp.zeros(shape), threshold=400, eps=eps,
                            max_rank=max_rank, lowrank_dtype=jnp.bfloat16)
    got = solvers.broyden(tf, torch.zeros(shape), threshold=400, eps=eps,
                          max_rank=max_rank, lowrank_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.rel_trace.numpy()[:16],
                               np.asarray(want.rel_trace)[:16], rtol=5e-3)
    assert got.lowest < eps and float(want.lowest) < eps
    assert got.result.dtype == torch.float32
    np.testing.assert_allclose(got.result.numpy(), xstar, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.result.numpy(), np.asarray(want.result),
                               rtol=0, atol=1e-3)


def test_rank_options_reach_broyden_only(monkeypatch):
    """``lowrank_bf16`` and ``lowrank_max_rank`` become Broyden's
    ``lowrank_dtype`` and ``max_rank`` (JAX ``deq.py:59-67``); Anderson
    takes neither."""
    cfg = deq.DEQConfig(lowrank_bf16=True, lowrank_max_rank=64, ls=True)
    assert deq._solver_kwargs(cfg) == dict(lowrank_dtype=torch.bfloat16,
                                           max_rank=64, ls=True)
    assert deq._solver_kwargs(cfg._replace(solver="anderson")) == {}
    assert deq._solver_kwargs(deq.DEQConfig()) == {}


@pytest.fixture(scope="module")
def trained_small():
    params, hp = load_trained()
    s = fem_sample(0, hsize=0.2)
    return params, hp, jax_batch_graphs([s]), batch_graphs([s], device="cpu")


@pytest.mark.parametrize("bf16", [False, True])
def test_psignn_inference_with_capped_memory_matches_jax(
        trained_small, small_block, bf16):
    """Ψ-GNN inference (the trained weights, a small mesh) with an
    8-pair ring (``lowrank_max_rank`` 8, block 8), optionally bfloat16:
    at fw_tol 1e-4, reached before f32 order matters, the same step as
    JAX and u within 5e-4 of max|u|; the best residual within 2 % with f32
    pairs, and under fw_tol in both with bfloat16 ones (their last step's
    residual moves by 15 % between the two packages' roundings)."""
    params, hp, jg, tg = trained_small
    over = dict(fw_tol=1e-4, fw_thres=200, lowrank_max_rank=8,
                lowrank_bf16=bf16)
    jcfg = JaxPsignnConfig(**{**hp, **over})
    cfg = PsignnConfig.from_hyperparameters(hp, **over)
    ju, jn, jlow = jax_psignn_inference(params, jg, jcfg)
    got = psignn_inference(psignn_from_jax(params, cfg, "cpu"), tg, cfg)
    assert got.nstep == int(jn) > 8
    if bf16:
        assert max(got.lowest, float(jlow)) < 1e-4
    else:
        np.testing.assert_allclose(got.lowest, float(jlow), rtol=2e-2)
    n = tg.total_nodes
    ju = np.asarray(ju)[:n]
    np.testing.assert_allclose(got.u.numpy(), ju, rtol=0,
                               atol=5e-4 * np.abs(ju).max())


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bf16data"))
    generate_data(path, n_mesh=2, n_samples=2, hsize=0.25, seed=5,
                  verbose=False)
    add_dss_variable(path)
    return path


@pytest.mark.parametrize("family", ["psignn", "dss"])
def test_bfloat16_dataset_matches_jax(dataset, family):
    """``load_dataset(precision="bfloat16")`` gives the JAX loader's
    ``dtype=bfloat16`` samples, widened to f32, value for value, every
    field: the matrix values ``a_ij`` stay f32 as JAX's ``_coo`` keeps
    them, everything else is rounded, DSS's ``b_prime_norm`` from the
    rounded b′ as JAX computes it.  The rounding is not a no-op."""
    got = load_dataset(dataset, family=family, precision="bfloat16")
    want = jax_load_dataset(dataset, family=family, dtype=jnp.bfloat16)
    full = load_dataset(dataset, family=family)
    assert len(got) == len(want) == 4
    for g, w, f in zip(got, want, full):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == f[k].dtype, k
            np.testing.assert_array_equal(
                g[k], np.asarray(w[k]).astype(g[k].dtype), err_msg=k)
        np.testing.assert_array_equal(g["a_ij"], f["a_ij"])
        key = "prb_data" if family == "psignn" else "b_prime_norm"
        assert not np.array_equal(g[key], f[key])
    with pytest.raises(ValueError):
        load_dataset(dataset, precision="float16")
