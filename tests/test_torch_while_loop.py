"""The carried loop (``loop="while"``) of the port's Broyden and Picard
against the JAX package's ``lax.while_loop`` solvers and against the
port's own host loop, on the CPU, where ``loop.run_while`` steps the same
body eagerly in chunks (the card replays the chunks as CUDA graphs).

Tolerances, with their reasons:

* against JAX, those of ``tests/test_torch_solvers.py`` and
  ``tests/test_torch_lowrank.py`` for the same problems: f32 sums in
  another order, grown over the secant updates;
* against the host loop, the first 4 iterates within 1e-6: the carried
  products run over whole zeroed rank blocks, as JAX's do, so their sums
  take another order than the host loop's over the live rows alone, and
  differ by f32 round-off; step counts are compared on the contractive
  linear problems, whose stop lies well above the f32 floor;
* ``CHUNK`` against 1, and the frozen iterations after a stop: bit for
  bit (a frozen step writes every carry entry back as it was).

Run as a script, the file prints two witnesses of Broyden's chaos that
``chip_smoke.py``'s rules rest on (``order_witness``, ``table_witness``):
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_while_loop.py
order [seed ...]`` (about 12 minutes a seed) or ``... table``.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import fem_sample, load_trained
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu import solvers as jsolvers
from psignn_tpu.deq import fixed_point_forward as jax_fixed_point_forward
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models.psignn import encoder_apply, make_function
from psignn_tpu_torch import bench, deq, loop, solvers
from psignn_tpu_torch.deq import DEQConfig, fixed_point_forward
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import PsignnConfig
from psignn_tpu_torch.weights import psignn_from_jax

RESULT_FIELDS = ("result", "rel_trace", "abs_trace", "trace")


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


def assert_same(a, b):
    """Two results equal bit for bit (NaN where NaN), every field but the
    loop's counts."""
    assert (a.nstep, a.prot_break, a.trace_len) == \
        (b.nstep, b.prot_break, b.trace_len)
    np.testing.assert_array_equal(a.lowest, b.lowest)
    for k in RESULT_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=k)


# ------------------------------------------------------- against JAX


@pytest.mark.parametrize("stop_mode", ["rel", "abs"])
@pytest.mark.parametrize("rho,seed,eps", [(0.6, 0, 1e-5), (0.9, 2, 1e-4),
                                          (0.8, 5, 1e-5)])
def test_broyden_linear_matches_jax(rho, seed, eps, stop_mode):
    """The same steps as JAX's, lowest and traces (padding included)
    within 2e-2, the iterate trace within 2e-5, the answer x*."""
    jf, tf, xstar, shape = make_linear(rho=rho, seed=seed)
    if stop_mode == "abs":
        eps = eps * 10
    want = jsolvers.broyden(jf, jnp.zeros(shape), threshold=200, eps=eps,
                            stop_mode=stop_mode, keep_trace=True)
    got = solvers.broyden(tf, torch.zeros(shape), threshold=200, eps=eps,
                          stop_mode=stop_mode, keep_trace=True, loop="while")
    assert got.nstep == int(want.nstep)
    assert got.trace_len == int(want.trace_len)
    assert got.prot_break is False and not bool(want.prot_break)
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=2e-2)
    np.testing.assert_allclose(got.rel_trace.numpy(),
                               np.asarray(want.rel_trace), rtol=2e-2)
    np.testing.assert_allclose(got.abs_trace.numpy(),
                               np.asarray(want.abs_trace), rtol=2e-2)
    assert got.trace.shape == want.trace.shape
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.result.numpy(), xstar, rtol=2e-3,
                               atol=2e-3)
    assert got.graphs == 0 and got.capture_s == 0.0


def test_broyden_tanh_matches_jax():
    rng = np.random.default_rng(3)
    n, d = 10, 5
    W = rng.normal(size=(n * d, n * d)).astype(np.float32) * 0.3
    b = rng.normal(size=(n * d,)).astype(np.float32)
    Wj, bj = jnp.asarray(W), jnp.asarray(b)
    Wt, bt = torch.from_numpy(W), torch.from_numpy(b)

    def jf(x):
        return jnp.tanh(Wj @ x.reshape(-1) + bj).reshape(n, d)

    def tf(x):
        return torch.tanh(Wt @ x.reshape(-1) + bt).reshape(n, d)

    want = jsolvers.broyden(jf, jnp.zeros((n, d)), threshold=200, eps=1e-5)
    got = solvers.broyden(tf, torch.zeros(n, d), threshold=200, eps=1e-5,
                          loop="while")
    assert abs(got.nstep - int(want.nstep)) <= 2
    assert got.lowest < 1e-5 and float(want.lowest) < 1e-5
    x = got.result
    np.testing.assert_allclose(tf(x).numpy(), x.numpy(), atol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(want.result), atol=1e-4)


@pytest.mark.parametrize("cubic", [False, True])
def test_broyden_divergence_protection_matches_jax(cubic):
    """g(x) = x² + 1 (or 10x³ + 1) has no root near the start: the
    divergence guard stops both at the same step with the best iterate,
    and the unvisited trace entries carry the lowest value."""
    def f(x):
        return x + 1 + (10 * x ** 3 if cubic else x ** 2)

    x0 = np.linspace(-1, 1, 8).reshape(8, 1).astype(np.float32)
    want = jsolvers.broyden(f, jnp.asarray(x0), threshold=60, eps=1e-6,
                            stop_mode="abs")
    got = solvers.broyden(f, torch.from_numpy(x0), threshold=60, eps=1e-6,
                          stop_mode="abs", loop="while")
    assert got.prot_break is True and bool(want.prot_break)
    assert got.trace_len == int(want.trace_len) < 61
    assert got.nstep == int(want.nstep)
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=1e-3)
    np.testing.assert_allclose(got.result.numpy(), np.asarray(want.result),
                               rtol=5e-3, atol=1e-5)
    visited = got.trace_len - 1
    assert torch.all(got.abs_trace[visited:] == np.float32(got.lowest))
    np.testing.assert_allclose(got.rel_trace.numpy(),
                               np.asarray(want.rel_trace), rtol=5e-3)


def test_broyden_plateau_break_matches_jax():
    """A constant residual δ = 2⁻¹⁰ between eps and 3·eps: the masked
    last-30 window stops both at step 31, the first iterate the best."""
    def f(x):
        return x + 2.0 ** -10

    x0 = np.zeros((4, 2), np.float32)
    want = jsolvers.broyden(f, jnp.asarray(x0), threshold=100, eps=2e-3,
                            stop_mode="abs")
    got = solvers.broyden(f, torch.from_numpy(x0), threshold=100, eps=2e-3,
                          stop_mode="abs", loop="while")
    assert got.trace_len == int(want.trace_len) == 32
    assert got.nstep == int(want.nstep) == 1
    assert not got.prot_break and not bool(want.prot_break)
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=1e-6)
    np.testing.assert_allclose(got.abs_trace.numpy(),
                               np.asarray(want.abs_trace), rtol=1e-5)
    np.testing.assert_allclose(got.rel_trace.numpy(),
                               np.asarray(want.rel_trace), rtol=1e-5)


def test_broyden_scrubs_nonfinite_updates_as_jax():
    """A map returning NaN for part of the state: the rank-1 factors are
    scrubbed, the solve keeps its best finite iterate, as JAX's does."""
    def tf(x):
        return torch.where(x > 1.5, torch.full_like(x, float("nan")),
                           0.5 * x + 1.0)

    def jf(x):
        return jnp.where(x > 1.5, jnp.nan, 0.5 * x + 1.0)

    want = jsolvers.broyden(jf, jnp.zeros((6, 2)), threshold=40, eps=1e-6)
    got = solvers.broyden(tf, torch.zeros(6, 2), threshold=40, eps=1e-6,
                          loop="while")
    assert np.isfinite(got.lowest) and torch.isfinite(got.result).all()
    assert got.nstep == int(want.nstep)
    assert got.trace_len == int(want.trace_len)
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=1e-3)
    np.testing.assert_allclose(got.result.numpy(), np.asarray(want.result),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("rho,seed,eps", [(0.6, 0, 1e-6), (0.9, 2, 1e-5)])
def test_picard_linear_matches_jax(rho, seed, eps):
    """Picard's last iterate at the same step as JAX's, its trace of
    iterates within 2e-5, the step-norm traces within 2e-2 (‖z_prev − z‖
    cancels to a few f32 ulps of z near eps)."""
    jf, tf, xstar, shape = make_linear(rho=rho, seed=seed)
    want = jsolvers.picard(jf, jnp.zeros(shape), threshold=300, eps=eps,
                           keep_trace=True)
    got = solvers.picard(tf, torch.zeros(shape), threshold=300, eps=eps,
                         keep_trace=True, loop="while")
    assert got.nstep == int(want.nstep)
    assert got.trace_len == int(want.trace_len)
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=2e-2)
    for k in ("rel_trace", "abs_trace"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=2e-2,
                                   err_msg=k)
    assert got.trace.shape == want.trace.shape == (302,) + shape
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace),
                               rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got.trace[got.trace_len - 1].numpy(),
                                  got.result.numpy())
    np.testing.assert_allclose(got.result.numpy(), xstar, rtol=1e-3,
                               atol=1e-3)


def test_picard_stops_at_threshold_and_ignores_stop_mode():
    jf, tf, _, shape = make_linear(rho=0.9, seed=1)
    for mode in ("rel", "abs"):
        want = jsolvers.picard(jf, jnp.zeros(shape), threshold=7, eps=0.0,
                               stop_mode=mode)
        got = solvers.picard(tf, torch.zeros(shape), threshold=7, eps=0.0,
                             stop_mode=mode, loop="while")
        assert got.nstep == int(want.nstep) == 7 and got.calls == 8
        np.testing.assert_allclose(got.rel_trace.numpy(),
                                   np.asarray(want.rel_trace), rtol=1e-5)


def test_ring_wraps_and_matches_jax(small_block):
    """Cap 16 pairs in blocks of 8: the ring wraps from step 17, its slot
    a device index.  The same steps as JAX's at eps 1e-5, residual traces
    within 2e-4 through step 24 and 2e-3 through step 36, the answer
    within 2e-5 of JAX's (test_torch_lowrank's), and as close to x* as
    JAX's is, to that 2e-5: the stop at eps 1e-5 leaves 3.6e-5 of error
    in JAX's own answer on this problem."""
    jf, tf, xstar, shape = make_linear(n=12, d=4, rho=0.95, seed=4)
    want = jsolvers.broyden(jf, jnp.zeros(shape), threshold=400, eps=1e-5,
                            max_rank=16)
    got = solvers.broyden(tf, torch.zeros(shape), threshold=400, eps=1e-5,
                          max_rank=16, loop="while")
    assert got.nstep == int(want.nstep) > 16
    assert got.trace_len == int(want.trace_len)
    rel, jrel = got.rel_trace.numpy(), np.asarray(want.rel_trace)
    np.testing.assert_allclose(rel[:24], jrel[:24], rtol=2e-4)
    np.testing.assert_allclose(rel[:36], jrel[:36], rtol=2e-3)
    np.testing.assert_allclose(got.result.numpy(), np.asarray(want.result),
                               rtol=0, atol=2e-5)
    jax_err = np.abs(np.asarray(want.result) - xstar).max()
    np.testing.assert_allclose(got.result.numpy(), xstar, rtol=0,
                               atol=jax_err + 2e-5)
    assert not got.prot_break


@pytest.mark.parametrize("max_rank", [0, 16])
def test_bf16_pairs_match_jax(small_block, max_rank):
    """Pairs stored in bfloat16, full memory and the wrapped ring: the
    residual traces within 5e-3 of JAX's over the first 16 steps, both
    reach eps, and the answer is x* within 1e-3 (test_torch_lowrank's)."""
    rho, seed, eps = (0.9, 2, 1e-7) if max_rank == 0 else (0.95, 4, 1e-6)
    jf, tf, xstar, shape = make_linear(rho=rho, seed=seed)
    want = jsolvers.broyden(jf, jnp.zeros(shape), threshold=400, eps=eps,
                            max_rank=max_rank, lowrank_dtype=jnp.bfloat16)
    got = solvers.broyden(tf, torch.zeros(shape), threshold=400, eps=eps,
                          max_rank=max_rank, lowrank_dtype=torch.bfloat16,
                          loop="while")
    np.testing.assert_allclose(got.rel_trace.numpy()[:16],
                               np.asarray(want.rel_trace)[:16], rtol=5e-3)
    assert got.lowest < eps and float(want.lowest) < eps
    np.testing.assert_allclose(got.result.numpy(), xstar, rtol=0, atol=1e-3)


# ---------------------------------------------------- against the host loop


@pytest.mark.parametrize("solver", ["broyden", "picard"])
@pytest.mark.parametrize("rho,seed,eps", [(0.6, 0, 1e-5), (0.9, 2, 1e-5),
                                          (0.95, 4, 1e-6)])
def test_carried_matches_host_loop(solver, rho, seed, eps):
    """The first 4 iterates within 1e-6, the same steps on these
    contractive problems, one host read a chunk and one at the end (the
    host loop: one an iteration)."""
    _, tf, _, shape = make_linear(rho=rho, seed=seed)
    run = getattr(solvers, solver)
    host, carried = (run(tf, torch.zeros(shape), threshold=300, eps=eps,
                         keep_trace=True, loop=lp) for lp in ("host", "while"))
    np.testing.assert_allclose(carried.trace[:5].numpy(),
                               host.trace[:5].numpy(), rtol=0, atol=1e-6)
    assert (carried.nstep, carried.trace_len) == (host.nstep, host.trace_len)
    steps = carried.trace_len - (2 if solver == "picard" else 1)
    chunks = -(-steps // loop.CHUNK)
    assert carried.host_reads == chunks + 1
    assert host.host_reads == steps + (1 if solver == "picard" else 0)
    assert carried.calls == 1 + chunks * loop.CHUNK >= host.calls


def test_default_route_on_the_cpu_is_the_host_loop():
    """``loop=None`` on a CPU tensor runs the host loop: its numbers are
    those of ``loop="host"`` bit for bit."""
    _, tf, _, shape = make_linear(rho=0.9, seed=2)
    for run in (solvers.broyden, solvers.picard):
        a = run(tf, torch.zeros(shape), threshold=100, eps=1e-5,
                keep_trace=True)
        b = run(tf, torch.zeros(shape), threshold=100, eps=1e-5,
                keep_trace=True, loop="host")
        assert_same(a, b)
        assert a.calls == b.calls and a.host_reads == b.host_reads


@pytest.mark.parametrize("device,opts,want", [
    ("cuda", {}, "while"), ("cpu", {}, "host"), ("meta", {}, "host"),
    ("cuda", {"ls": True}, "host"), ("cuda", {"lanes": True}, "host"),
    ("cuda", {"reduce": True}, "host"), ("cuda", {"sync": True}, "host")])
def test_resolve_loop_routes_by_device_and_option(device, opts, want):
    """None: the carried loop on a CUDA tensor unless an option it does
    not carry is set, the host loop otherwise."""
    x0 = types.SimpleNamespace(device=torch.device(device))
    assert solvers.resolve_loop("broyden", None, x0, **opts) == want


@pytest.mark.parametrize("option", ["ls", "lanes", "reduce", "sync"])
def test_carried_loop_refuses_options_it_does_not_carry(option):
    _, tf, _, shape = make_linear()
    x0 = torch.zeros(shape)
    kw = {"ls": dict(ls=True),
          "lanes": dict(lanes=solvers.Lanes(torch.zeros(12, dtype=torch.long),
                                            [12])),
          "reduce": dict(reduce=lambda t: t),
          "sync": dict(sync=lambda go: go)}[option]
    with pytest.raises(NotImplementedError, match=option):
        solvers.broyden(tf, x0, threshold=10, loop="while", **kw)
    if option != "ls":
        with pytest.raises(NotImplementedError, match=option):
            solvers.picard(tf, x0, threshold=10, loop="while", **kw)
    # by default the option takes the host loop by name, without failing
    out = solvers.broyden(tf, x0, threshold=10, **kw)
    assert out.graphs == 0 and out.host_reads >= 1
    with pytest.raises(ValueError, match="loop"):
        solvers.broyden(tf, x0, threshold=10, loop="graph")


# ------------------------------------------------------ the chunk schedule


def test_chunks_never_span_two_keys_nor_the_threshold():
    """Each step runs with its own key (on the card, the graph of that
    key: no graph spans two keys); chunks of at most ``chunk`` steps, the
    last one cut at T; one read of ``done`` a chunk."""
    seen = []
    carry = {"done": torch.zeros((), dtype=torch.bool)}
    stats = loop.run_while(lambda c, static: seen.append(static), carry, 23,
                           chunk=5, key=lambda k: k // 8)
    assert stats == loop.LoopStats(23, 5, 0, 0.0)
    assert seen == [k // 8 for k in range(23)]


def test_run_while_stops_at_the_chunk_that_sets_done():
    carry = {"done": torch.zeros((), dtype=torch.bool), "n": [0]}

    def body(c, _):
        c["n"][0] += 1
        if c["n"][0] == 7:
            c["done"].fill_(True)

    stats = loop.run_while(body, carry, 100, chunk=4)
    assert (stats.steps, stats.host_reads, carry["n"][0]) == (8, 2, 8)


@pytest.mark.parametrize("block,chunk", [(8, 4), (8, 3), (4, 16)])
def test_broyden_chunks_follow_the_rank_blocks(monkeypatch, block, chunk):
    """Each step's products read the blocks holding rows 0..k, whatever
    the chunk, a chunk that spans a block boundary too, and the iterates
    are those of one step a chunk, bit for bit."""
    monkeypatch.setattr(solvers, "_LR_BLOCK", block)
    _, tf, _, shape = make_linear(rho=0.95, seed=4)
    keys = []
    real = solvers._broyden_body

    def spy(c, nblk, **kw):
        keys.append((int(c["nstep"]), nblk))
        real(c, nblk, **kw)

    monkeypatch.setattr(solvers, "_broyden_body", spy)
    monkeypatch.setattr(loop, "CHUNK", chunk)
    got = solvers.broyden(tf, torch.zeros(shape), threshold=29, eps=0.0,
                          keep_trace=True, loop="while")
    assert [n for _, n in keys] == [min(k // block + 1, -(-29 // block))
                                    for k, _ in keys]
    assert [k for k, _ in keys] == list(range(29))
    monkeypatch.setattr(loop, "CHUNK", 1)
    keys.clear()
    assert_same(got, solvers.broyden(tf, torch.zeros(shape), threshold=29,
                                     eps=0.0, keep_trace=True, loop="while"))


@pytest.mark.parametrize("solver", ["broyden", "picard"])
@pytest.mark.parametrize("T", [37, 16, 5])
def test_calls_at_eps_zero_are_threshold_plus_one(solver, T):
    """At eps 0 the solve runs to the threshold: f evaluated exactly
    T + 1 times, T not a multiple of ``CHUNK`` included (the last chunk
    is cut to the steps that are left)."""
    _, tf, _, shape = make_linear(rho=0.9, seed=1)
    out = getattr(solvers, solver)(tf, torch.zeros(shape), threshold=T,
                                   eps=0.0, loop="while")
    assert out.calls == T + 1
    assert out.host_reads == -(-T // loop.CHUNK) + 1
    assert out.trace_len == T + (2 if solver == "picard" else 1)


# ---------------------------------------------------------------- freezing


@pytest.mark.parametrize("solver", ["broyden", "picard"])
@pytest.mark.parametrize("case", ["linear", "prot", "plateau"])
def test_a_stop_mid_chunk_freezes_the_carry(monkeypatch, solver, case):
    """A solve that stops inside a chunk runs the chunk to its end, and
    returns the carry of its stopping step bit for bit: the same result as
    chunks of one step, which stop right there."""
    if case == "linear":
        _, f, _, shape = make_linear(rho=0.9, seed=2)
        x0, kw = torch.zeros(shape), dict(threshold=300, eps=1e-5)
    elif case == "prot":
        def f(x):
            return x + 1 + x ** 2
        x0 = torch.linspace(-1, 1, 8).reshape(8, 1)
        kw = dict(threshold=60, eps=1e-6)
    else:
        def f(x):
            return x + 2.0 ** -10
        x0 = torch.zeros(4, 2)
        kw = dict(threshold=100, eps=2e-3)
    if solver == "broyden" and case != "linear":
        kw["stop_mode"] = "abs"
    run = getattr(solvers, solver)
    monkeypatch.setattr(loop, "CHUNK", 16)
    chunked = run(f, x0, keep_trace=True, loop="while", **kw)
    monkeypatch.setattr(loop, "CHUNK", 1)
    single = run(f, x0, keep_trace=True, loop="while", **kw)
    assert_same(chunked, single)
    assert single.calls <= chunked.calls < single.calls + 16


# ---------------------------------------------------------------- Ψ-GNN


@pytest.fixture(scope="module")
def trained_small():
    """The trained Dirichlet Ψ-GNN and one small mesh (~90 nodes) in both
    packages' forms."""
    params, hp = load_trained()
    s = fem_sample(0, hsize=0.2)
    return (params, hp, jax.tree.map(jnp.asarray, params),
            jax_batch_graphs([s]), batch_graphs([s], device="cpu"))


def _solve_both(trained_small, **over):
    params, hp, jp, jg, tg = trained_small
    jcfg = JaxPsignnConfig(**{**hp, **over})
    cfg = PsignnConfig.from_hyperparameters(hp, **over)
    model = psignn_from_jax(params, cfg, "cpu")
    jh0 = encoder_apply(jp["autoencoder"], jg.x) * jg.fnode_mask
    want = jax_fixed_point_forward(make_function(jcfg), jp["function"], jh0,
                                   jg, jcfg.deq, keep_trace=True)
    with torch.no_grad():
        h0 = model.encoder(tg.x) * tg.fnode_mask
    got = fixed_point_forward(model.function, h0, tg, cfg.deq,
                              keep_trace=True, loop="while")
    return model, tg, got, want


def test_psignn_first_iterates_match_jax_deq_forward(trained_small):
    """The first 20 Broyden iterates of f_θ at fw_tol 0 and their
    residuals against JAX's DEQ forward (test_torch_psignn's tolerances:
    f32 round-off over 20 secant updates, and rel's cancellation floor)."""
    _, tg, got, want = _solve_both(trained_small, fw_tol=0.0, fw_thres=20)
    n = tg.total_nodes
    assert got.trace_len == int(want.trace_len) == 21 and got.calls == 21
    np.testing.assert_allclose(got.trace.numpy(),
                               np.asarray(want.trace)[:, :n], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.rel_trace.numpy(),
                               np.asarray(want.rel_trace), rtol=1e-3,
                               atol=1e-6)


def test_psignn_solve_matches_jax_deq_forward(trained_small):
    """A full solve at fw_tol 1e-4, reached before the plateau: nstep
    within 2 and lowest within 5 % of JAX's (test_torch_psignn's), both
    under the tolerance; the fixed points agree to 1e-3 and each is one
    of f_θ to its residual."""
    model, tg, got, want = _solve_both(trained_small, fw_tol=1e-4)
    n = tg.total_nodes
    assert abs(got.nstep - int(want.nstep)) <= 2
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=0.05)
    assert got.lowest < 1e-4 and not got.prot_break
    np.testing.assert_allclose(got.result.numpy(),
                               np.asarray(want.result)[:n], rtol=0,
                               atol=1e-3)


def test_deq_adjoint_keeps_the_host_loop(monkeypatch):
    """The forward solve follows the route (None), the adjoint solve of
    an f without ``linearize`` is asked for the host loop: its f is an
    autograd VJP (f_θ's own: ``test_torch_adjoint.py``)."""
    asked = []
    real = solvers.broyden

    def spy(*args, **kw):
        asked.append(kw.get("loop"))
        return real(*args, **kw)

    monkeypatch.setitem(solvers.SOLVERS, "broyden", spy)
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32) * 0.3)
    W.requires_grad_()

    def f(h, h_init, graph):
        return torch.tanh(h @ W + 0.3 * h_init)

    h0 = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
    cfg = DEQConfig(fw_tol=1e-6, fw_thres=50, bw_tol=1e-8, bw_thres=50)
    out = fixed_point_forward(f, h0, None, cfg)
    new_h, adjoint = deq.deq_attach(f, cfg, out.result, h0, None)
    new_h.sum().backward()
    assert asked == [None, "host"] and adjoint.stats.calls > 1


# --------------------------------------------------------------- the bench


@pytest.mark.parametrize("lp", ["while", "host"])
def test_bench_inference_reports_its_loop(monkeypatch, lp):
    """The inference line names the loop its solve took, its host reads
    and graphs (none on the CPU); 4 iterations at fw_tol 0 either way, the
    answers within 1e-6 of the host loop's (4 iterates, products in two
    orders).  The loop is the route's: "while" is had on the CPU by
    sending the route's default there."""
    if lp == "while":
        real = solvers.resolve_loop
        monkeypatch.setattr(
            solvers, "resolve_loop",
            lambda name, lp_, x0, **kw: real(name, lp_ or "while", x0, **kw))
    small = dict(radius=1.0, hsize=0.3)
    line, out = bench.inference("cpu", 4, **small, reps=1)
    d = line["detail"]
    assert d["loop"] == lp and d["iters"] == 4 == out.calls - 1
    assert d["graphs"] == 0 and d["capture_s"] == 0.0
    assert d["host_reads"] == (2 if lp == "while" else 4)
    graph = bench.build_big_graph(**small, device="cpu",
                                  rcm=bench.bench_rcm())[0]
    cfg = bench.headline_config(4)
    host = bench.headline_solve(bench.headline_model(cfg, "cpu"), graph,
                                cfg, loop="host")
    np.testing.assert_allclose(out.result.numpy(), host.result.numpy(),
                               rtol=0, atol=1e-6)


def test_bench_loop_option_is_the_inference_mode_s(capsys):
    """The loop is no option of the bench, in any mode: the inference
    mode takes the route (the card's carried loop), and ``--loop`` is
    refused."""
    for mode in ("inference", "train"):
        with pytest.raises(SystemExit):
            bench.main(["--mode", mode, "--device", "cpu", "--loop", "host"])
        assert "unrecognized arguments: --loop" in capsys.readouterr().err


# ------------------------------------------------------------- witnesses


def _psignn_answer(model, cfg, graph, lp: str):
    """(SolverResult, decoded u) of the Ψ-GNN request by ``lp``'s loop."""
    with torch.no_grad():
        h0 = model.encoder(graph.x) * graph.fnode_mask
        out = fixed_point_forward(model.function, h0, graph, cfg.deq,
                                  loop=lp)
        return out, model.decoder(out.result) * graph.fnode_mask


def order_witness(seeds=(0, 1, 2, 3), radius: float = 5.0) -> None:
    """Print, for the sweep mesh at ``radius`` that each seed's rng draws
    (seed 0: the smoke's order request), JAX's DEQ forward (its Broyden)
    and the port's carried and host loops on the CPU, at mesh and at RCM
    order, at the smoke's ``CMP_OVERRIDES`` (fw 1e-7 / 800): nstep,
    lowest, whether the divergence guard fired, physics residual and MSE
    of each answer, and each solver's residual and u gap between the two
    orders."""
    import chip_smoke
    from psignn_tpu_torch.data.meshgen import blob_mesh
    from psignn_tpu_torch.eval.metrics import errors_batch
    from psignn_tpu_torch.eval.sweep import build_data
    params, hp = load_trained()
    over = chip_smoke.CMP_OVERRIDES
    jcfg = JaxPsignnConfig(**{**hp, **over})
    cfg = PsignnConfig.from_hyperparameters(hp, **over)
    jp = jax.tree.map(jnp.asarray, params)
    model = psignn_from_jax(params, cfg, "cpu")
    for seed in seeds:
        rng = np.random.default_rng(seed)
        for r in chip_smoke.SWEEP_RADII:
            mesh = blob_mesh(radius=r, hsize=0.08, rng=rng)
            sample = build_data(mesh, r, rng, ("psignn",))["psignn"]
            if r == radius:
                break
        (rsample,), perm = chip_smoke.node_orders([sample])
        rows = {}
        for order, s in (("mesh", sample), ("rcm", rsample)):
            tg, jg = batch_graphs([s], device="cpu"), jax_batch_graphs([s])
            n = tg.total_nodes
            for solver in ("jax", "while", "host"):
                if solver == "jax":
                    jh0 = encoder_apply(jp["autoencoder"], jg.x) \
                        * jg.fnode_mask
                    out = jax_fixed_point_forward(make_function(jcfg),
                                                  jp["function"], jh0, jg,
                                                  jcfg.deq)
                    with torch.no_grad():
                        h = torch.tensor(np.asarray(out.result)[:n])
                        u = model.decoder(h) * tg.fnode_mask
                    nstep, lowest = int(out.nstep), float(out.lowest)
                    prot = bool(out.prot_break)
                else:
                    res, u = _psignn_answer(model, cfg, tg, solver)
                    nstep, lowest, prot = res.nstep, res.lowest, \
                        res.prot_break
                m = errors_batch(u, tg)
                u = u[:, 0].numpy()
                if order == "rcm":       # row i is row perm[i] of mesh's
                    u = u[np.argsort(perm)]
                rows[order, solver] = (float(m["res"][0]), u)
                print(json.dumps(dict(
                    seed=seed, radius=radius, order=order, solver=solver,
                    threads=torch.get_num_threads(),
                    nstep=nstep, lowest=lowest, reached=lowest < cfg.fw_tol,
                    prot_break=prot,
                    res=float(m["res"][0]), mse=float(m["mse"][0]))),
                    flush=True)
        for solver in ("jax", "while", "host"):
            (ra, ua), (rb, ub) = rows["mesh", solver], rows["rcm", solver]
            print(json.dumps(dict(
                seed=seed, radius=radius, solver=solver,
                res_rel_diff=abs(rb - ra) / ra,
                u_rel_diff=float(np.linalg.norm(ub - ua)
                                 / np.linalg.norm(ua)))), flush=True)


def table_witness(threads=(1, 4, None)) -> None:
    """Print the ``operations`` phase's Ψ-GNN table row on the CPU: the
    factory's data at the smoke's ``OPS_DATA`` (3 × 30, seed 1234), its
    test split in one batch, the trained Ψ-GNN at its checkpoint's fw_tol
    (1e-5) and at ``FIGURE_CONVERGED_TOL`` (1e-7), by the host and the
    carried loop, on each count of torch ``threads`` (None: this
    process's own): nstep, mean MSE and mean residual."""
    import tempfile

    import chip_smoke
    from psignn_tpu_torch.data.generate import generate_data
    from psignn_tpu_torch.data.reader import (GraphLoader, load_dataset,
                                              split_dataset)
    from psignn_tpu_torch.eval.metrics import errors_batch
    from psignn_tpu_torch.weights import load_psignn_checkpoint
    own = torch.get_num_threads()
    with tempfile.TemporaryDirectory() as tmp:
        generate_data(tmp, n_mesh=int(chip_smoke.OPS_DATA["N_MESH"]),
                      n_samples=int(chip_smoke.OPS_DATA["N_SAMPLES"]),
                      variant="dirichlet", verbose=False)
        _, _, test = split_dataset(load_dataset(tmp))
    batch = next(iter(GraphLoader(test, batch_size=len(test),
                                  device="cpu")))
    for t in threads:
        torch.set_num_threads(own if t is None else t)
        for tol in (None, chip_smoke.FIGURE_CONVERGED_TOL):
            over = None if tol is None else dict(fw_tol=tol)
            model, cfg = load_psignn_checkpoint(chip_smoke.CKPT, "cpu", over)
            for lp in ("host", "while"):
                out, u = _psignn_answer(model, cfg, batch, lp)
                m = errors_batch(u, batch)
                print(json.dumps(dict(
                    threads=torch.get_num_threads(), fw_tol=cfg.fw_tol,
                    loop=lp, n_test=len(test), nstep=out.nstep,
                    lowest=out.lowest, mse_mean=float(m["mse"].mean()),
                    res_mean=float(m["res"].mean()))), flush=True)
    torch.set_num_threads(own)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_while_loop.py
    #     order [seed ...] | table
    import sys
    if sys.argv[1:2] == ["table"]:
        table_witness()
    else:
        order_witness(tuple(int(a) for a in sys.argv[2:]) or (0, 1, 2, 3))
