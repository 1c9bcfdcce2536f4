"""The port's data parallelism, solver hooks, rank launch and CLI on gloo
ranks on the CPU, against the JAX package (``psignn_tpu/dist/dp.py``,
``solvers.py``'s ``reduce`` / ``sync``, the sharded loader) on the
conftest's virtual devices.

One spawned world of 2 ranks (``_torch_dist``) runs every port case:
``dp_value_and_grad`` of DS-GPS, DSS and Ψ-GNN on two shards, the
sharded loader, the solvers with their hooks, and one CLI epoch of each
family joined to the world as torchrun would start it.

Limits: DS-GPS and DSS as JAX's ``tests/test_dist.py:29-61`` (loss within
1e-5, gradients within 1e-4 relative and 1e-6 absolute); Ψ-GNN, whose
forward and adjoint solves each package runs to its own fixed point, as
``tests/test_torch_stacked.py`` (losses within 1e-3, each gradient within
1e-2 as a relative norm, the averaged adjoint nstep within 1 of the
sink's).  Solver hooks: the same steps, results within 1e-5, each step's
residual within 1e-3 relative or 1e-4 of the first (f32 summation order
moves the small residuals of the last steps)."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import _torch_dist
from _torch_parity import (dss_sample, fem_sample, grad_rel,
                           jax_dsgps_params, jax_dss_params, load_trained)
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu import deq as jdeq
from psignn_tpu import solvers as jsolvers
from psignn_tpu.data.reader import GraphLoader as JaxGraphLoader
from psignn_tpu.dist import dp_value_and_grad as jax_dp_value_and_grad
from psignn_tpu.dist import make_mesh as jax_make_mesh
from psignn_tpu.dist import shard_stacked as jax_shard_stacked
from psignn_tpu.dist import stack_graphs as jax_stack_graphs
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import DsgpsConfig as JaxDsgpsConfig
from psignn_tpu.models import DssConfig as JaxDssConfig
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models import dsgps_forward as jax_dsgps_forward
from psignn_tpu.models import dss_forward as jax_dss_forward
from psignn_tpu.models import psignn_forward as jax_psignn_forward
from psignn_tpu_torch.cli.main import main
from psignn_tpu_torch.data.generate import add_dss_variable, generate_data
from psignn_tpu_torch.dist import multihost
from psignn_tpu_torch.train import load_checkpoint
from psignn_tpu_torch.weights import FAMILIES

K = 3
REACHABLE = dict(fw_tol=1e-4, fw_thres=200, bw_tol=1e-6, bw_thres=300)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
PSIGNN_LOSS_RTOL, PSIGNN_GRAD_REL = 1e-3, 1e-2
SOLVER_RTOL, TRACE_RTOL, TRACE_ATOL = 1e-5, 1e-3, 1e-4
FAST_FLAGS = ["--fw_tol", "1e-3", "--fw_thres", "25", "--bw_tol", "1e-5",
              "--bw_thres", "25", "--device", "cpu", "--max_epochs", "1",
              "--batch_size", "3", "--k", "3", "--val_sradius", "0"]


# two epochs with the spike guard at patience 1 (``spike_reload`` makes
# epoch 1's validation residual spike)
SPIKE_ARGV = [*FAST_FLAGS, "--num_devices", "2", "--max_epochs", "2",
              "--spike_guard", "--spike_factor", "2", "--spike_patience",
              "1"]


def probe(pos, xp):
    """The Hutchinson probe both packages compute from node positions
    (``tests/test_torch_stacked.py``)."""
    cols = xp.arange(10, dtype=pos.dtype)
    return xp.sin(37.0 * pos[:, :1] + 11.0 * pos[:, 1:2] + cols[None, :])


# ------------------------------------------------------------ the world

# (name, JAX family, port family) of the dp cases
DP_CASES = ("dsgps", "dss", "psignn")
# solver-hook problems: (name, solver, kwargs, split over 2 ranks, sync)
SOLVER_CASES = (("broyden_split", "broyden", {}, True, False),
                ("broyden_ls_split", "broyden", {"ls": True}, True, False),
                ("anderson_split", "anderson", {}, True, False),
                ("picard_split", "picard", {}, True, False),
                ("broyden_rows", "broyden", {}, False, False),
                ("broyden_rows_sync", "broyden", {}, False, True),
                ("broyden_ls_rows_sync", "broyden", {"ls": True}, False,
                 True),
                ("anderson_rows_sync", "anderson", {}, False, True))
N_STATE, THRESHOLD, EPS = 24, 60, 1e-6


def _problem(seed: int, rho: float, overshoot: bool = False):
    """(M, c, x0) of x ↦ tanh(M x + c) with spectral radius ``rho`` on a
    (N_STATE, 2) state; ``overshoot`` makes M = −2.5·I, whose full steps
    the Armijo search must shorten (from −3.5·I on, a search that accepts
    a vanishing step can stall a solve, at a step that f32 order moves)."""
    rng = np.random.default_rng(seed)
    n = 2 * N_STATE
    M = rng.normal(size=(n, n)).astype(np.float32)
    M *= rho / max(abs(np.linalg.eigvals(M)))
    if overshoot:
        M = -2.5 * np.eye(n, dtype=np.float32)
    c = rng.normal(size=(n,)).astype(np.float32)
    x0 = np.zeros((N_STATE, 2), np.float32)
    return M.astype(np.float32), c, x0


def _problems(name):
    """The problem of each dp row (a split problem: the same on both)."""
    if name == "broyden_ls_rows_sync":    # one row searches, one does not
        return [_problem(1, 0.5, overshoot=True), _problem(3, 0.9)]
    if name.startswith("broyden_ls"):
        return [_problem(1, 0.5, overshoot=True)] * 2
    if name.endswith("split"):
        return [_problem(1, 0.8)] * 2
    return [_problem(2, 0.3), _problem(3, 0.9)]


def _dp_inputs():
    rng = np.random.default_rng(11)
    params, hp = load_trained()
    return {
        "dsgps": (jax_dsgps_params(rng, False), dict(k=K),
                  [[fem_sample(s, hsize=0.3)] for s in (0, 1)]),
        "dss": (jax_dss_params(rng, K), dict(k=K, alpha=0.5),
                [[dss_sample(s, hsize=0.3)] for s in (0, 1)]),
        "psignn": (params, {**hp, **REACHABLE},
                   [[fem_sample(s, hsize=0.3) for s in pair]
                    for pair in ((2, 3), (4, 5))]),
    }


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    path = str(root / "dirichlet")
    generate_data(path, n_mesh=2, n_samples=5, hsize=0.3, seed=21,
                  verbose=False)
    add_dss_variable(path)
    return root, path


@pytest.fixture(scope="module")
def world(tmp_path_factory, datasets):
    dp = _dp_inputs()
    loader_samples = [fem_sample(s, hsize=0.4) for s in range(7)]
    root, data = datasets
    runs = {fam: ["--family", fam, "--path_dataset", data,
                  "--path_results", str(root / f"joined_{fam}"),
                  "--num_devices", "2", *FAST_FLAGS]
            for fam in ("psignn", "dsgps", "dss")}
    jobs = [("dp_grads", dict(family=f, params=dp[f][0], hp=dp[f][1],
                              shards=dp[f][2])) for f in DP_CASES]
    jobs.append(("loader_shards", dict(samples=loader_samples, batch_size=4,
                                       seed=3)))
    jobs += [("solver_hooks", dict(name=solver, problems=_problems(name),
                                   split=split, sync=sync,
                                   threshold=THRESHOLD, eps=EPS, kw=kw))
             for name, solver, kw, split, sync in SOLVER_CASES]
    jobs.append(("cli_runs", dict(runs=list(runs.values()))))
    spike = dict(argv=SPIKE_ARGV + ["--path_dataset", data],
                 roots=[str(root / f"spike_host{r}") for r in range(2)])
    jobs.append(("spike_reload", spike))
    t0 = time.monotonic()
    ranks = _torch_dist.spawn(tmp_path_factory.mktemp("rdv"), 2, jobs)
    names = list(DP_CASES) + ["loader"] + [c[0] for c in SOLVER_CASES] + \
        ["cli", "spike"]
    out = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
    return dict(out=out, dp=dp, loader_samples=loader_samples, runs=runs,
                spike=spike, root=root, seconds=time.monotonic() - t0)


# ----------------------------------------------------------------- dp

def _jax_dp(family, params, hp, shards):
    """JAX's ``dp_value_and_grad`` on a 2-device mesh over the same
    shards: (loss, aux, grads as a port state dict, sink or None)."""
    mesh = jax_make_mesh(2)
    node_cap = max(sum(s["x"].shape[0] for s in sh) for sh in shards) + 8
    edge_cap = max(sum(len(s["senders"]) for s in sh) for sh in shards) + 8
    per_dev = [jax_batch_graphs(sh, n_node_cap=node_cap, n_edge_cap=edge_cap)
               for sh in shards]
    stacked = jax_shard_stacked(jax_stack_graphs(per_dev), mesh)
    p = jax.tree.map(jnp.asarray, params)
    if family == "psignn":
        cfg = JaxPsignnConfig(**hp)

        def loss_fn(q, g, r, sink):
            l = jax_psignn_forward(q, g, cfg, r, bw_sink=sink).losses
            return (l["residual_loss"] + l["jacobian_loss"]
                    + l["encoder_loss"] + l["autoencoder_loss"]), l

        real = jdeq.jac_loss_estimate
        jdeq.jac_loss_estimate = (
            lambda f, q, hs, hi, g, rng, vecs=1, denom=None:
            jdeq.jac_loss_probe(f, q, hs, hi, g, probe(g.pos, jnp), denom))
        try:
            loss, aux, grads, sink = jax.jit(jax_dp_value_and_grad(
                loss_fn, mesh, sink_dim=2))(p, stacked,
                                            jax.random.PRNGKey(0))
        finally:
            jdeq.jac_loss_estimate = real
    else:
        cfg = (JaxDsgpsConfig if family == "dsgps" else JaxDssConfig)(**hp)
        fwd = jax_dsgps_forward if family == "dsgps" else jax_dss_forward

        def loss_fn(q, g, r):
            l = fwd(q, g, cfg).losses
            return l["train_loss"], l

        loss, aux, grads = jax.jit(jax_dp_value_and_grad(loss_fn, mesh))(
            p, stacked, jax.random.PRNGKey(0))
        sink = None
    to_port = FAMILIES[family][2]
    return float(loss), aux, to_port(grads), sink


@pytest.mark.parametrize("family", DP_CASES)
def test_dp_value_and_grad_matches_jax(world, family):
    """Loss, every aux entry and every gradient of the port's two ranks
    against JAX's data-parallel value-and-grad on two devices; both ranks
    hold the same averaged values."""
    params, hp, shards = world["dp"][family]
    jloss, jaux, jgrads, jsink = _jax_dp(family, params, hp, shards)
    results = world["out"][family]
    psignn = family == "psignn"
    for loss, aux, bw, grads in results:
        np.testing.assert_allclose(
            loss, jloss, rtol=PSIGNN_LOSS_RTOL if psignn else LOSS_RTOL)
        for k, v in aux.items():
            want = np.asarray(jaux[k])
            if psignn and k in ("fw_nstep",):
                assert abs(v - float(want)) <= 1, (k, v, want)
                continue
            if psignn and k in ("fw_lowest", "sradius"):
                continue      # each package's own stopping residual
            np.testing.assert_allclose(
                v, want, rtol=PSIGNN_LOSS_RTOL if psignn else LOSS_RTOL,
                atol=1e-8 if psignn else 0, err_msg=k)
        assert set(grads) == {k for k in jgrads if k in grads}
        for name, g in grads.items():
            if psignn:
                assert grad_rel(g, jgrads[name].numpy()) < PSIGNN_GRAD_REL, \
                    name
            else:
                np.testing.assert_allclose(g, jgrads[name].numpy(),
                                           rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                           err_msg=name)
        if psignn:          # the adjoint solves' stats, as JAX's sink
            lowest, nstep = bw
            assert lowest < REACHABLE["bw_tol"] and \
                float(jsink[0]) < REACHABLE["bw_tol"]
            assert abs(nstep - float(jsink[1])) <= 1, (bw, jsink)
        else:
            assert bw is None
    for other in results[1:]:
        assert other[0] == results[0][0]
        for name, g in other[3].items():
            np.testing.assert_array_equal(g, results[0][3][name])


def test_dsgps_unused_laynorm_gets_no_gradient(world):
    """DS-GPS's declared but unused ``laynorm`` holds no gradient on any
    rank, and the flat all-reduce leaves it out (no DDP)."""
    for _, _, _, grads in world["out"]["dsgps"]:
        assert not any(k.startswith("laynorm") for k in grads)


# ------------------------------------------------------------- loader

def test_sharded_loader_matches_jax(world):
    """Rank d's batches are JAX's shard d of the same batches: 7 samples
    in batches of 4 over 2 ranks (the short batch padded with an empty
    sample), shuffled and not; ``dist.shard_stacked`` deals a batch
    alike."""
    samples = world["loader_samples"]
    for e, shuffle in enumerate((True, False)):
        jl = JaxGraphLoader(samples, batch_size=4, shuffle=shuffle, seed=3,
                            n_devices=2)
        jbatches = list(jl)
        for d, rank in enumerate(world["out"]["loader"]):
            got = rank[e]
            assert len(got) == len(jbatches) == 2
            for (n_nodes, x), jg in zip(got, jbatches):
                want_n = np.asarray(jg.n_nodes[d]).tolist()
                assert n_nodes == want_n
                np.testing.assert_array_equal(
                    x, np.asarray(jg.x[d])[:sum(want_n)])
    real = sum(n for rank in world["out"]["loader"] for n_nodes, _ in rank[0]
               for n in n_nodes)
    assert real == sum(s["x"].shape[0] for s in samples)
    # dp.shard_stacked deals one batch as the loader does
    for rank in world["out"]["loader"]:
        assert rank[2][0] == rank[1][-1][0]
        np.testing.assert_array_equal(rank[2][1], rank[1][-1][1])


# ------------------------------------------------------------ solvers

def _jax_solver_rows(name, solver, kw, split, sync):
    """JAX's solver on two devices with the same hooks: ``split`` one
    problem over a 2-device 'x' axis (``reduce`` = psum, f gathering x);
    else two problems on a 2-device 'dp' axis, with ``sync`` the psum'd
    any()."""
    problems = _problems(name)
    fn = jsolvers.get_solver(solver)
    devices = np.array(jax.devices()[:2])
    if split:
        M, c, x0 = (jnp.asarray(a) for a in problems[0])
        n = x0.shape[0] // 2

        def local(x):
            def f(xl):
                full = jax.lax.all_gather(xl, "x", tiled=True)
                y = jnp.tanh(full.reshape(-1) @ M.T + c).reshape(full.shape)
                i = jax.lax.axis_index("x")
                return jax.lax.dynamic_slice_in_dim(y, i * n, n)
            out = fn(f, x, threshold=THRESHOLD, eps=EPS,
                     reduce=lambda s: jax.lax.psum(s, "x"), **kw)
            return (out.result, out.nstep[None], out.lowest[None],
                    out.rel_trace[None])

        run = shard_map(local, mesh=JaxMesh(devices, ("x",)),
                        in_specs=P("x"),
                        out_specs=(P("x"), P("x"), P("x"), P("x")),
                        check_vma=False)
        res, nstep, lowest, trace = jax.jit(run)(x0)
        return [(np.asarray(res), int(nstep[0]), float(lowest[0]),
                 np.asarray(trace[0]))]
    Ms, cs, x0s = (jnp.stack([jnp.asarray(p[i]) for p in problems])
                   for i in range(3))

    def local(M, c, x):
        M, c, x = M[0], c[0], x[0]
        f = lambda y: jnp.tanh(y.reshape(-1) @ M.T + c).reshape(y.shape)
        hooks = {}
        if sync:
            hooks["sync"] = lambda b: jax.lax.psum(b.astype(jnp.int32),
                                                   "dp") > 0
        out = fn(f, x, threshold=THRESHOLD, eps=EPS, **hooks, **kw)
        return (out.result[None], out.nstep[None], out.lowest[None],
                out.rel_trace[None])

    run = shard_map(local, mesh=JaxMesh(devices, ("dp",)),
                    in_specs=(P("dp"), P("dp"), P("dp")),
                    out_specs=(P("dp"),) * 4, check_vma=False)
    res, nstep, lowest, trace = jax.jit(run)(Ms, cs, x0s)
    return [(np.asarray(res[i]), int(nstep[i]), float(lowest[i]),
             np.asarray(trace[i])) for i in range(2)]


def _same_trace(got, want):
    np.testing.assert_allclose(got, want, rtol=TRACE_RTOL,
                               atol=TRACE_ATOL * abs(want[0]))


@pytest.mark.parametrize("case", SOLVER_CASES, ids=lambda c: c[0])
def test_solver_hooks_match_jax(world, case):
    """``reduce``: one problem split over two ranks, each evaluating its
    block, against JAX's solver in ``shard_map`` with ``reduce`` = psum —
    the same steps, result and residual trace.  ``sync``: two problems,
    one a rank, against JAX's frozen carries: each rank's own answer, and
    with ``sync`` both ranks evaluate f as often as the slower one
    (without it, each stops on its own)."""
    name, solver, kw, split, sync = case
    want = _jax_solver_rows(name, solver, kw, split, sync)
    got = world["out"][name]
    if split:
        res = np.concatenate([r[0] for r in got])
        wres, wn, wlow, wtrace = want[0]
        for r in got:      # both halves hold the problem's stats
            assert r[1] == wn, (r[1], wn)
            _same_trace(r[4][:wn], wtrace[:wn])
        np.testing.assert_allclose(res, wres, rtol=SOLVER_RTOL, atol=1e-6)
        return
    for r, (wres, wn, wlow, wtrace) in zip(got, want):
        assert r[1] == wn, (r[1], wn)
        np.testing.assert_allclose(r[0], wres, rtol=SOLVER_RTOL, atol=1e-6)
        _same_trace(r[4][:wn], wtrace[:wn])
    calls = [r[3] for r in got]
    if sync:
        assert calls[0] == calls[1], calls
    else:
        assert calls[0] != calls[1], calls


def test_solvers_refuse_lanes_with_hooks():
    from psignn_tpu_torch import solvers
    lanes = solvers.Lanes(torch.zeros(4, dtype=torch.int64), [4])
    for name in ("broyden", "anderson", "picard"):
        with pytest.raises(NotImplementedError, match="reduce or sync"):
            solvers.get_solver(name)(lambda x: x, torch.zeros(4, 1),
                                     lanes=lanes, reduce=lambda t: t)


# --------------------------------------------------------------- the CLI

def _lines(path):
    with open(path) as f:
        return f.read().strip().splitlines()


def test_cli_joined_runs_train_every_family(world):
    """``--num_devices 2`` in a launch of two processes (torchrun's
    ``RANK`` / ``WORLD_SIZE``): one epoch of Ψ-GNN, DS-GPS and DSS,
    logged and checkpointed once, by rank 0."""
    assert [r for r in world["out"]["cli"]] == [0, 1]
    for fam, argv in world["runs"].items():
        out = argv[argv.index("--path_results") + 1]
        ck = load_checkpoint(os.path.join(out, "ckpt", "final_model.ckpt"))
        assert ck["family"] == fam
        assert all(np.isfinite(v) for v in ck["hist_val"]["loss"])
        logs = os.path.join(out, "logs")
        assert "Number of devices used : 2 (cpu)" in \
            open(os.path.join(logs, "model_config.csv")).read()
        # 6 train samples in batches of 3: two steps, each logged once
        n = 3 if fam == "psignn" else 1
        assert len(_lines(os.path.join(logs, "forward_iteration.csv"))) == n
        metrics = "\n".join(_lines(os.path.join(logs, "train_metrics.csv")))
        assert metrics.count("Validation Epoch 0") == 1


def test_spike_guard_reloads_rank_0s_checkpoint_on_every_rank(world):
    """The spike guard of a data-parallel run whose ranks do not share a
    disk: rank 0 reads its best checkpoint and every rank takes it, so the
    ranks' models stay the same (and equal that checkpoint)."""
    rank0, rank1 = world["out"]["spike"]
    host0, host1 = world["spike"]["roots"]
    assert not os.path.exists(host1)          # rank 1 wrote nothing
    log = open(os.path.join(host0, "logs", "train_metrics.csv")).read()
    assert "SPIKE GUARD" in log
    best = load_checkpoint(os.path.join(host0, "ckpt", "best_model.ckpt"))
    want = FAMILIES["psignn"][2](best["params"])
    assert rank0.keys() == rank1.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(rank1[name], rank0[name])
        np.testing.assert_array_equal(rank0[name], np.asarray(want[name]))


def test_cli_spawns_ranks(tmp_path, datasets, capsys, monkeypatch):
    """``--num_devices 2 --device cpu`` from one process: the command
    spawns two gloo ranks; rank 0 alone writes; a second call resumes."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")    # as _torch_dist.run
    _, data = datasets
    out = str(tmp_path / "run")
    main(["--path_dataset", data, "--path_results", out,
          "--num_devices", "2", *FAST_FLAGS])
    assert "Training finished" in capsys.readouterr().out
    logs = os.path.join(out, "logs")
    assert len(_lines(os.path.join(logs, "backward_iteration.csv"))) == 3
    ck = load_checkpoint(os.path.join(out, "ckpt", "running_model.ckpt"))
    assert len(ck["hist_val"]["loss"]) == 1
    main(["--path_dataset", data, "--path_results", out,
          "--num_devices", "2", *FAST_FLAGS, "--max_epochs", "2",
          "--resume", os.path.join(out, "ckpt", "running_model.ckpt")])
    ck = load_checkpoint(os.path.join(out, "ckpt", "final_model.ckpt"))
    assert len(ck["hist_val"]["loss"]) == 2


@pytest.mark.parametrize("flags,message", [
    (["--num_devices", "2", "--stacked_batch"], "exclude each other"),
    (["--num_devices", "0"], "every local GPU"),
    (["--num_devices", "-1"], "negative"),
    (["--num_devices", "2", "--device", "mps"], "give cpu, cuda")],
    ids=["stacked", "zero_on_cpu", "negative", "device"])
def test_cli_refuses_layouts_it_cannot_run(tmp_path, datasets, capsys,
                                           flags, message):
    """Exit 2 before anything is written: per-graph solves with several
    ranks (as JAX), ``0`` (every GPU) with ``--device cpu``, a negative
    count, a device that is neither the CPU nor a card."""
    _, data = datasets
    argv = ["--path_dataset", data, "--path_results", str(tmp_path / "x"),
            "--device", "cpu", *flags]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


# ------------------------------------------------------- multihost, dryrun

def test_initialize_is_a_noop_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize(world_size=1) is False
    assert multihost.is_coordinator()
    mesh = multihost.global_mesh(device="cpu")
    assert (mesh.dp, mesh.parts, mesh.rank, mesh.world) == (1, 1, 0, 1)
    t = torch.arange(3.0)
    assert mesh.reduce(t) is t and mesh.all_reduce(t) is t
    assert mesh.sync(True) and not mesh.sync(False)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        multihost.global_mesh(2, 2, "cpu")


@pytest.mark.parametrize("make", ["global_mesh", "make_mesh"])
def test_mesh_without_a_device_needs_cuda(monkeypatch, make):
    """A mesh whose caller names no device is on the card, as every entry
    point is: without CUDA it raises instead of putting the data on the
    CPU."""
    from psignn_tpu_torch.dist import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = multihost.global_mesh if make == "global_mesh" else make_mesh
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build()
    assert build(device="cpu").device == torch.device("cpu")


def test_spawn_returns_results_in_rank_order_and_dryrun(tmp_path):
    """The dry run of every multi-device path on 4 ranks (dp 2 × parts 2
    for its partitioned train step), each rank's figures finite and its
    partitioned solve within JAX's limits of the one process's."""
    outs = _torch_dist.spawn(tmp_path, 4, [("dryrun", dict(n_parts=2))])
    for rank in outs:
        (fig,) = rank
        assert fig["dp_parts"] == [2, 2]
        assert np.isfinite(fig["partitioned_train_loss"])
        assert fig["mp_max_abs_err"] <= 1e-5 * max(1.0, fig["mp_scale"])
        assert fig["partitioned_agrees"]
        assert abs(fig["partitioned_nstep"] - fig["single_nstep"]) <= 1
    # every rank holds the same averaged loss and the same solve
    assert len({r[0]["dp_loss"] for r in outs}) == 1
    assert len({r[0]["partitioned_nstep"] for r in outs}) == 1
