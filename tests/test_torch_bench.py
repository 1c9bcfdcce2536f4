"""The port's benchmark (``psignn_tpu_torch.bench``) against the JAX repo's
``bench.py`` on the CPU, at small sizes: the workload builders, the
4-iteration headline solve, each mode's JSON line, the train mode's
restart of every rep, the partitioned solve on 2 gloo ranks, the pause of
the port's trainers, the refusal without CUDA, and
``scripts/torch/solo_epoch.sh`` on stand-in trainers."""

import ast
import functools
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
import chip_smoke
from _torch_parity import kernel_route, load_trained
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu import deq as jdeq
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models import psignn_forward as jax_psignn_forward
from psignn_tpu.models import psignn_init
from psignn_tpu.models.psignn import encoder_apply, make_function
from psignn_tpu_torch import bench, deq
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.ops import residual_loss
from psignn_tpu_torch.weights import psignn_from_jax
from test_torch_scripts import _stand_in, _state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLO = os.path.join(ROOT, "scripts", "torch", "solo_epoch.sh")
# the small headline mesh and batch of these tests
SMALL = dict(radius=1.0, hsize=0.3)
ITERS = 4
# each mode's detail keys beyond bench.py's (but pallas_mp): the port's
# measurement keys, and the mode's own
PORT_KEYS = {"launches", "device_s", "busy", "card"}
MODE_KEYS = {"inference": {"rcm", "loop", "host_reads", "graphs",
                           "capture_s"},
             "train": {"ckpt", "steps", "rcm"},
             "partition": {"backend"}}
METRICS = {"inference": "psignn_fixed_point_edges_per_s",
           "train": "psignn_train_step_seconds",
           "partition": "psignn_partitioned_fixed_point_edges_per_s"}
EPOCH_LINE = ("\nTraining Epoch {} finished, took current epoch 1.00s, "
              "cumulative time 1.00s")


def jax_lines():
    """{metric: (top keys, detail keys)} of every JSON line ``bench.py``
    prints, read from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    out = {}
    for call in ast.walk(tree):
        if isinstance(call, ast.Call) and getattr(call.func, "attr",
                                                  "") == "dumps":
            line = call.args[0]
            keys = [k.value for k in line.keys]
            values = dict(zip(keys, line.values))
            out[values["metric"].value] = (
                set(keys), {k.value for k in values["detail"].keys})
    return out


# ------------------------------------------------------------ workloads


@pytest.mark.parametrize("rcm", [False, True])
def test_build_big_graph_matches_jax(rcm):
    """The headline builder, in mesh order and in JAX's RCM order
    (``pallas=True``): equal node and edge counts, and every array of the
    graph equal to JAX's real rows (``test_torch_data.py`` holds the data
    path to exact equality)."""
    graph, sample, n_nodes, n_edges = bench.build_big_graph(
        **SMALL, device="cpu", rcm=rcm)
    jg, j_nodes, j_edges = jbench.build_big_graph(**SMALL, pallas=rcm)
    assert (n_nodes, n_edges) == (j_nodes, j_edges)
    assert (graph.total_nodes, graph.senders.shape[0]) == (n_nodes, n_edges)
    for k in ("x", "b", "sol", "prb_data", "tags", "pos", "fnode_mask",
              "dirichlet_mask"):
        np.testing.assert_array_equal(getattr(graph, k).numpy(),
                                      np.asarray(getattr(jg, k))[:n_nodes],
                                      k)
    for k in ("senders", "receivers", "a_ij", "edge_attr", "mp_edge_mask"):
        np.testing.assert_array_equal(getattr(graph, k).numpy(),
                                      np.asarray(getattr(jg, k))[:n_edges],
                                      k)
    np.testing.assert_array_equal(sample["x"], np.asarray(jg.x)[:n_nodes])


def test_train_batch_matches_jax_loop():
    """``train_batch``'s meshes are ``bench_train_step``'s loop
    (``bench.py:132-141``: one generator seeded 0, radius-1 blob meshes),
    here 3 meshes at hsize 0.3; with ``rcm`` each in the order JAX's loop
    gives it (``rcm_permutation`` + ``apply_node_permutation``)."""
    from psignn_tpu.data.fem import solve_poisson
    from psignn_tpu.data.meshgen import blob_mesh
    from psignn_tpu.data.reader import psignn_sample_from_fem
    from psignn_tpu.kernels import rcm_permutation
    from psignn_tpu.kernels.fused_mp import apply_node_permutation
    rng = np.random.default_rng(0)
    want = []
    for _ in range(3):
        mesh = blob_mesh(radius=1.0, hsize=0.3, rng=rng)
        want.append(psignn_sample_from_fem(solve_poisson(mesh, 1.0, rng)))
    got = bench.train_samples(3, hsize=0.3)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], k)
    graph = bench.train_batch(3, hsize=0.3, device="cpu")
    assert graph.total_nodes == sum(len(w["x"]) for w in want)
    assert graph.num_graphs == 3
    ordered = [apply_node_permutation(w, rcm_permutation(
        w["senders"], w["receivers"], len(w["x"]))) for w in want]
    rgraph = bench.train_batch(3, hsize=0.3, device="cpu", rcm=True)
    jg = jax_batch_graphs(ordered)
    n, e = rgraph.total_nodes, rgraph.senders.shape[0]
    for k in ("x", "pos", "senders", "receivers", "edge_attr"):
        want_k = np.asarray(getattr(jg, k))
        np.testing.assert_array_equal(
            getattr(rgraph, k).numpy(),
            want_k[:n] if want_k.shape[0] == jg.x.shape[0] else want_k[:e], k)


def test_reference_numbers_are_jax_s():
    assert bench.REF_EDGES_PER_S == jbench.REF_EDGES_PER_S
    assert bench.REF_TRAIN_STEP_S == jbench.REF_TRAIN_STEP_S


# ---------------------------------------------------------------- modes


@pytest.mark.parametrize("rcm", [False, True])
def test_inference_matches_jax(rcm):
    """4 Broyden iterations at fw_tol 0 from JAX's random parameters
    (``psignn_init`` of key 0, carried across by ``params_from_jax``)
    against ``encoder_apply`` + ``fixed_point_forward`` as
    ``bench.py:300-316`` composes them, on the mesh in its order and in
    RCM order (JAX's ``pallas=True`` graph, its message passing XLA's):
    iterate within rtol/atol 1e-5 (``ROADMAP.md``: 4 iterates come before
    Broyden's f32 chaos)."""
    jcfg = JaxPsignnConfig(solver="broyden", fw_tol=0.0, fw_thres=ITERS)
    params = psignn_init(jax.random.PRNGKey(0), jcfg)
    jg, _, _ = jbench.build_big_graph(**SMALL, pallas=rcm)
    h0 = encoder_apply(params["autoencoder"], jg.x) * jg.fnode_mask
    jout = jdeq.fixed_point_forward(make_function(jcfg), params["function"],
                                    h0, jg, jcfg.deq)
    model = psignn_from_jax(jax.tree.map(np.asarray, params),
                            bench.headline_config(ITERS), "cpu").eval()
    line, out = bench.inference("cpu", ITERS, **SMALL, model=model, rcm=rcm)
    assert line["detail"]["rcm"] is rcm
    n = line["detail"]["n_nodes"]
    np.testing.assert_allclose(out.result.numpy(),
                               np.asarray(jout.result)[:n], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.lowest, float(jout.lowest), rtol=1e-5)
    assert line["detail"]["iters"] == ITERS == out.calls - 1


@pytest.mark.parametrize("mode", tuple(MODE_KEYS))
def test_main_prints_one_line_of_bench_py_keys(mode, monkeypatch, capsys):
    """``main`` on the CPU (each mode at a small size): exactly one stdout
    line, with ``bench.py``'s metric and keys for the mode (its detail
    keys but ``pallas_mp``) plus the port's."""
    small = dict(train=dict(n_meshes=2, hsize=0.3)).get(
        mode, dict(iters=ITERS, **SMALL))
    monkeypatch.setitem(bench.MODES, mode,
                        functools.partial(bench.MODES[mode], **small))
    argv = ["--mode", mode, "--device", "cpu"]
    if mode == "partition":
        argv += ["--num_devices", "2"]
    bench.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    top, detail = jax_lines()[METRICS[mode]]
    assert line["metric"] == METRICS[mode]
    assert set(line) == top
    assert set(line["detail"]) == (detail - {"pallas_mp"}) | PORT_KEYS \
        | MODE_KEYS[mode]
    assert {line["detail"][k] for k in ("device_s", "busy", "card")} \
        == {None}
    assert np.isfinite(line["value"]) and line["value"] > 0


def test_train_mode_restarts_every_rep(monkeypatch):
    """Train mode on 2 small meshes, the kernels routed through counted
    plain versions and both packages' Hutchinson probe made from node
    positions: every rep starts from the checkpoint (equal fw_nstep and
    loss), launches as ``chip_smoke.expected_launches`` counts them, and
    the loss within 1e-4 (relative) of JAX's ``psignn_forward`` on the same
    batch and weights, the tolerance ``test_torch_train.py`` holds the
    losses to."""
    def probe(pos, xp):
        cols = xp.arange(10, dtype=pos.dtype)
        return xp.sin(37.0 * pos[:, :1] + 11.0 * pos[:, 1:2] + cols[None, :])

    kernel_route(monkeypatch)
    monkeypatch.setattr(
        deq, "jac_loss_estimate",
        lambda f, hs, hi, g, gen, vecs=1, denom=None, lanes=None:
        deq.jac_loss_probe(f, hs, hi, g, probe(g.pos, torch), denom, lanes))
    line, outs = bench.train("cpu", n_meshes=2, hsize=0.3)
    steps = line["detail"]["steps"]
    assert len({st["fw"][1] for st in steps}) == 1
    assert len({st["loss"] for st in steps}) == 1
    assert line["detail"]["fw_nstep"] == steps[0]["fw"][1]
    _, cfg, _ = bench.trained_model("cpu", bench.TRAIN_OVERRIDES)
    for res, st in zip(outs, steps):
        want = chip_smoke.expected_launches(res, cfg)
        assert (st["launches"]["fused_mp_fwd"],
                st["launches"]["fused_mp_bwd"]) == want
    # the smoke's checks of the line, given the device time the CPU lacks
    line["detail"].update(device_s=0.5, busy=0.5)
    metric = "psignn_train_step_seconds"
    assert chip_smoke.bench_problems("bench_train", metric, line) == []
    steps[1]["launches"]["fused_mp_bwd"] += 2
    assert chip_smoke.bench_problems("bench_train", metric, line)

    params, hp = load_trained()
    jcfg = JaxPsignnConfig(**{**hp, **bench.TRAIN_OVERRIDES})
    jg = jax_batch_graphs(bench.train_samples(2, hsize=0.3))
    monkeypatch.setattr(
        jdeq, "jac_loss_estimate",
        lambda f, p, hs, hi, g, rng, vecs=1, denom=None: jdeq.jac_loss_probe(
            f, p, hs, hi, g, probe(g.pos, jnp), denom))
    losses = jax_psignn_forward(jax.tree.map(jnp.asarray, params), jg, jcfg,
                                jax.random.PRNGKey(0)).losses
    want = float(losses["residual_loss"] + bench.TRAIN_JAC_WEIGHT
                 * losses["jacobian_loss"] + losses["encoder_loss"]
                 + losses["autoencoder_loss"])
    np.testing.assert_allclose(line["detail"]["loss"], want, rtol=1e-4)


@pytest.mark.parametrize("mode,env,want", [
    ("inference", None, True), ("inference", "0", False),
    ("train", None, True), ("train", "0", False), ("train", "1", True)])
def test_modes_order_as_bench_py_reads_its_switch(mode, env, want,
                                                  monkeypatch):
    """The inference and train modes build RCM-ordered meshes unless
    ``PSIGNN_TPU_BENCH_PALLAS`` is set to anything but ``1``, as
    ``bench.py:284`` reads it: the builder is asked for that order, every
    sample goes through ``rcm_ordered`` exactly when it is RCM, and the
    line's ``detail.rcm`` says which."""
    if env is None:
        monkeypatch.delenv("PSIGNN_TPU_BENCH_PALLAS", raising=False)
    else:
        monkeypatch.setenv("PSIGNN_TPU_BENCH_PALLAS", env)
    ordered = []
    real = bench.rcm_ordered
    monkeypatch.setattr(bench, "rcm_ordered",
                        lambda s: ordered.append(len(s["x"])) or real(s))
    if mode == "inference":
        line, _ = bench.inference("cpu", ITERS, **SMALL, reps=1)
        n_samples = 1
    else:
        kernel_route(monkeypatch)
        line, _ = bench.train("cpu", n_meshes=2, hsize=0.3, reps=1)
        n_samples = 2
    assert line["detail"]["rcm"] is want
    assert len(ordered) == (n_samples if want else 0)
    assert sum(ordered) in (0, line["detail"]["n_nodes"])


def test_partition_matches_one_process():
    """Partition mode on 2 gloo CPU ranks at 4 iterations: the mesh's
    physics residual within 1e-5 (relative) of the inference mode's solve
    of the same RCM-ordered mesh in one process (the same arithmetic in
    other f32 sums)."""
    line, ranks = bench.partition("cpu", 2, iters=ITERS, **SMALL)
    d = line["detail"]
    assert d["n_devices"] == 2 and d["backend"] == "gloo"
    assert d["iters"] == ITERS and len(ranks) == 2
    sample = bench.rcm_ordered(bench.headline_sample(**SMALL))
    graph = batch_graphs([sample], device="cpu")
    cfg = bench.headline_config(ITERS)
    model = bench.headline_model(cfg, "cpu")
    out = bench.headline_solve(model, graph, cfg)
    with torch.no_grad():
        u = model.decoder(out.result) * graph.fnode_mask
        single = float(residual_loss(u, graph))
    np.testing.assert_allclose(d["residual"], single, rtol=1e-5)
    assert (d["n_nodes"], d["n_edges"]) == (graph.total_nodes,
                                            graph.senders.shape[0])


@pytest.mark.parametrize("mode", tuple(MODE_KEYS))
def test_main_needs_cuda(mode, monkeypatch, capsys):
    """Without CUDA and without ``--device cpu`` every mode raises before
    it builds anything: no fall-back to the CPU or the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench.main([] if mode == "inference" else ["--mode", mode])
    assert capsys.readouterr().out == ""


# -------------------------------------------------------- quiet the card


def _alive(pid: int) -> bool:
    return _state(pid) not in ("gone", "Z", "X")


def _states(pids, stopped: bool, timeout: float = 10.0) -> list:
    """Each PID's state once all are stopped (T), or all are not, or the
    timeout has passed: a signal reaches a busy process a little later."""
    deadline = time.monotonic() + timeout
    while True:
        states = [_state(p) for p in pids]
        if all((st == "T") == stopped for st in states) \
                or time.monotonic() > deadline:
            return states
        time.sleep(0.05)


def test_pause_trainers_stops_port_trainers_and_their_ranks(tmp_path):
    """A port trainer and its child, registered in ``<tmp>/torch/port/``,
    are stopped for the block and resumed after; a JAX trainer and a PID
    whose command line names neither are left running; the signal
    handlers are restored."""
    port, kid = _stand_in(tmp_path / "torch", "port", child=True)
    jax_run, _ = _stand_in(tmp_path, "jax", module="psignn_tpu.cli.main")
    other, _ = _stand_in(tmp_path, "other", module="something.else")
    handler = signal.getsignal(signal.SIGTERM)
    try:
        with bench.pause_trainers(str(tmp_path), settle_s=0.0) as paused:
            assert sorted(paused) == sorted([port.pid, kid])
            assert _states((port.pid, kid), True) == ["T", "T"]
            assert "T" not in (_state(jax_run.pid), _state(other.pid))
            assert signal.getsignal(signal.SIGTERM) is not handler
        assert "T" not in _states((port.pid, kid), False)
        assert signal.getsignal(signal.SIGTERM) is handler
        with bench.pause_trainers(str(tmp_path / "none")) as paused:
            assert paused == []
    finally:
        for p in (port, jax_run, other):
            p.kill()
            p.wait()
        if _alive(kid):
            os.kill(kid, signal.SIGKILL)


def _solo(target, tmp_path, timeout="60"):
    return subprocess.Popen(
        ["bash", SOLO, str(target), timeout],
        env=dict(os.environ, RESULTS=str(tmp_path), POLL_S="0.2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_solo_epoch_needs_a_log(tmp_path):
    proc = _solo(tmp_path / "missing", tmp_path)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 1 and "no " in out


def test_solo_epoch_times_two_epochs_with_the_rest_paused(tmp_path):
    """The target's two new epoch lines end the wait (exit 0, both
    printed) while another port trainer and its child stay stopped; the
    target itself runs on; everything is resumed at the end.  With no new
    epoch it gives up after its timeout (exit 2)."""
    target, _ = _stand_in(tmp_path / "torch", "target")
    other, kid = _stand_in(tmp_path, "other", child=True)
    log = tmp_path / "torch" / "target" / "logs" / "train_metrics.csv"
    log.write_text("Train Metrics" + EPOCH_LINE.format(0))
    try:
        proc = _solo(tmp_path / "torch" / "target", tmp_path)
        deadline = time.monotonic() + 30
        while "waiting" not in (proc.stdout.readline() or "waiting"):
            assert time.monotonic() < deadline
        assert _states((other.pid, kid), True) == ["T", "T"]
        assert _state(target.pid) != "T"
        with open(log, "a") as f:
            f.write(EPOCH_LINE.format(1))
        time.sleep(0.5)
        assert proc.poll() is None and _state(other.pid) == "T"
        with open(log, "a") as f:
            f.write(EPOCH_LINE.format(2))
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert "Epoch 1 finished" in out and "Epoch 2 finished" in out
        assert "T" not in _states((other.pid, kid), False)
        proc = _solo(tmp_path / "torch" / "target", tmp_path, timeout="1")
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 2 and "timeout" in out
        assert "T" not in _states((other.pid, kid), False)
    finally:
        for p in (target, other):
            p.kill()
            p.wait()
        if _alive(kid):
            os.kill(kid, signal.SIGKILL)
