"""Benchmark of the port's hot path: the JAX repo's ``bench.py`` on the card.

    python -m psignn_tpu_torch.bench [--mode inference|train|partition]
                                     [--device cuda|cuda:K|cpu]
                                     [--num_devices N]

Three modes, each ``bench.py``'s workload and JSON line:

* ``inference`` (default, ``bench.py:263-339``) — the reference's largest
  headline workload: 531 Broyden iterations at fw_tol 0 (the full
  threshold) on the radius-5 blob mesh (hsize 0.08, seed 0: 11,214 nodes,
  76,353 COO edges with the diagonal) with random weights from seed 0;
  ``edges/s = iters · 2 · n_edges / wall``, best of 3 after a warm-up.
  The solve runs Broyden's carried loop on the card (CUDA graphs, one
  host read a chunk; ``solvers``) and its host loop on the CPU.
* ``train`` (``bench.py:110-200``) — one implicit-gradient train step
  (DEQ forward, adjoint backward, Hutchinson Jacobian loss, clip 0.1,
  dual Adam 0.01 / 0.05) on 50 radius-1 meshes (24,782 nodes) at fw 1e-5 /
  500, bw 1e-8 / 500.  ``bench.py`` loads the reference's own trained
  ``.pt`` through ``compat``; that file is not in the repository, so the
  weights are the JAX package's trained checkpoint ``CKPT``, named in the
  line's ``detail.ckpt``.  Each timed step starts from the same weights
  with fresh optimizers (JAX discards the updated state; the port's step
  updates the model in place), restored outside the timed window.
* ``partition`` (``bench.py:203-260``) — the partitioned solve of the
  RCM-ordered headline mesh, one rank a device (``--num_devices``,
  default every local card): NCCL with rank r on ``cuda:r``, or gloo with
  every rank on ``--device cuda:K`` or on the CPU.

The inference and train modes put each mesh's nodes in reverse
Cuthill-McKee order, as ``bench.py`` does by default
(``PSIGNN_TPU_BENCH_PALLAS`` unset or ``1``; ``bench.py:99-104, 136-141,
284``); ``PSIGNN_TPU_BENCH_PALLAS`` set to anything else gives the mesh
order.  The variable selects the order only: the hand-written CUDA
kernels are the card's one route.  Without CUDA the bench raises unless
``--device cpu`` is given (the tests; gloo ranks on the CPU take the
place of ``PSIGNN_TPU_BENCH_CPU8``).  The port's trainers are paused
around the run (``pause_trainers``).

stdout carries exactly one line, the JSON object ``{"metric", "value",
"unit", "vs_baseline", "detail"}``; everything else goes to stderr.
``detail`` holds ``bench.py``'s keys (but ``pallas_mp``) and: ``rcm``
(inference, train) — whether the meshes were in RCM order;
``launches`` — each kernel's launches in the timed run (the last of the
best-of reps; partition: summed over the ranks); ``device_s`` — the
device's kernel time in one profiled run after the timed ones (partition:
rank 0's); ``busy`` — ``device_s`` over the best unprofiled wall;
``card`` — ``nvidia-smi``'s name and power limit.  On the CPU these three
are None.  The inference line also holds the solve's ``loop`` ("while"
or "host"), and of the timed run's solve its ``host_reads``, the CUDA
``graphs`` it captured and their ``capture_s``, seconds inside the
timed wall: a request pays them.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import resolve_device
from .dist.partition import rcm_ordered

# The reference's numbers on Turing GPUs (BASELINE.md).  Inference: its
# radius-5 sweep runs 531.2 Broyden iterations over ~77,588 edges in
# 3.18 s on one Turing GPU.  Training: its Ψ-GNN epoch of 120 batches
# takes 360 s on two Turing GPUs.
REF_EDGES_PER_S = 531.2 * 2 * 77_588 / 3.18  # ≈ 25.9e6
REF_TRAIN_STEP_S = 360.0 / 120
EPOCH_STEPS = 120

HEADLINE_ITERS = 531
REPS = 3
CKPT = "results/psignn_dirichlet/ckpt/best_model.ckpt"
TRAIN_MESHES = 50
TRAIN_OVERRIDES = dict(fw_tol=1e-5, fw_thres=500, bw_tol=1e-8, bw_thres=500)
TRAIN_LRS = (0.01, 0.05)
TRAIN_CLIP = 0.1
TRAIN_JAC_WEIGHT = 1.0
# the Hutchinson probes' seeds: the warm-up's, then rep i's is 8 + i
WARMUP_SEED = 7
REP_SEED = 8
# seconds the partition mode's ranks may take before they are terminated
PARTITION_TIMEOUT = 900
# trainers of the port, as their command lines name them
TRAINER_MATCH = "psignn_tpu_torch.cli.main"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("fused_mp_fwd", "fused_mp_bwd", "fused_mp_jvp")


# ------------------------------------------------------------- workloads

def headline_sample(radius: float = 5.0, hsize: float = 0.08,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """The headline mesh's Ψ-GNN sample: a seeded blob mesh, FEM-solved."""
    from .data.fem import solve_poisson
    from .data.meshgen import blob_mesh
    from .data.reader import psignn_sample_from_fem
    rng = np.random.default_rng(seed)
    mesh = blob_mesh(radius=radius, hsize=hsize, rng=rng)
    return psignn_sample_from_fem(solve_poisson(mesh, radius, rng))


def bench_rcm() -> bool:
    """The order ``bench.py`` reads from ``PSIGNN_TPU_BENCH_PALLAS``: RCM
    unless it is set to anything but ``1`` (``bench.py:284``)."""
    return os.environ.get("PSIGNN_TPU_BENCH_PALLAS", "1") == "1"


def build_big_graph(radius: float = 5.0, hsize: float = 0.08, seed: int = 0,
                    device=None, rcm: bool = False):
    """(graph, sample, n_nodes, n_edges) of the headline mesh, in reverse
    Cuthill-McKee order with ``rcm`` (``bench.py:99-104``), else in its
    mesh order; ``n_edges`` counts the COO entries of A, the diagonal
    included."""
    from .graphs import batch_graphs
    sample = headline_sample(radius, hsize, seed)
    if rcm:
        sample = rcm_ordered(sample)
    graph = batch_graphs([sample], device=device)
    return (graph, sample, int(sample["x"].shape[0]),
            int(sample["senders"].shape[0]))


def train_samples(n_meshes: int = TRAIN_MESHES, seed: int = 0,
                  hsize: float = 0.08, variant: str = "dirichlet",
                  form: str = "psignn") -> list:
    """The training batch's samples: seeded radius-1 blob meshes
    (mixed-BC ones for ``variant='mixed'``), FEM-solved; ``form='dss'``
    gives the same Dirichlet meshes and solves in DSS's A′ form."""
    from .data.fem import solve_poisson, solve_poisson_mixed
    from .data.meshgen import blob_mesh, mixed_blob_mesh
    from .data.reader import dss_sample_from_fem, psignn_sample_from_fem
    make, solve = ((mixed_blob_mesh, solve_poisson_mixed)
                   if variant == "mixed" else (blob_mesh, solve_poisson))
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(n_meshes):
        mesh = make(radius=1.0, hsize=hsize, rng=rng)
        s = solve(mesh, 1.0, rng)
        samples.append(dss_sample_from_fem(s) if form == "dss"
                       else psignn_sample_from_fem(s, variant=variant))
    return samples


def train_batch(n_meshes: int = TRAIN_MESHES, seed: int = 0,
                hsize: float = 0.08, device=None, rcm: bool = False):
    """The train mode's batch: ``train_samples`` in one graph, each sample
    in reverse Cuthill-McKee order with ``rcm`` (``bench.py:136-141``)."""
    from .graphs import batch_graphs
    samples = train_samples(n_meshes, seed, hsize)
    if rcm:
        samples = [rcm_ordered(s) for s in samples]
    return batch_graphs(samples, device=device)


def headline_config(iters: int = HEADLINE_ITERS):
    from .models import PsignnConfig
    return PsignnConfig(solver="broyden", fw_tol=0.0, fw_thres=iters)


def headline_model(cfg, device):
    """The headline's Ψ-GNN with random weights from seed 0."""
    from .models import Psignn
    return Psignn(cfg, generator=torch.Generator().manual_seed(0),
                  device=device).eval()


def headline_solve(model, graph, cfg, loop: Optional[str] = None):
    """Encoder, then the fixed point of f_θ (``bench.py:300-304``) by the
    solver's ``loop`` (None: its route)."""
    from .deq import fixed_point_forward
    with torch.no_grad():
        h0 = model.encoder(graph.x) * graph.fnode_mask
        return fixed_point_forward(model.function, h0, graph, cfg.deq,
                                   loop=loop)


def trained_model(device, overrides=None, ckpt: str = CKPT):
    """(model, cfg, initial state dict) of a trained checkpoint of any
    family; a relative ``ckpt`` is read from the checkout."""
    from .weights import load_model_checkpoint
    _, model, cfg = load_model_checkpoint(os.path.join(ROOT, ckpt), device,
                                          overrides)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    return model, cfg, init


def step_from(model, cfg, init, graph, seed: int = WARMUP_SEED,
              stacked: bool = False):
    """(StepResult, seconds) of one ``train_step`` from the state ``init``
    with fresh optimizers and probes from ``seed``, timed by the host
    clock around the step alone; ``stacked`` solves each graph of the
    batch on its own."""
    from .train import make_optimizers, train_step
    model.load_state_dict(init)
    opts = make_optimizers(model, *TRAIN_LRS)
    gen = torch.Generator().manual_seed(seed)
    _sync(graph.device)
    t0 = time.perf_counter()
    res = train_step(model, opts, graph, cfg, TRAIN_LRS, TRAIN_CLIP,
                     TRAIN_JAC_WEIGHT, gen, stacked=stacked)
    _sync(graph.device)
    return res, time.perf_counter() - t0


# ----------------------------------------------------------- measurement

def _log(msg: str) -> None:
    # one write a line: the ranks of the partition mode share the stream
    sys.stderr.write(f"bench: {msg}\n")
    sys.stderr.flush()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _reset_launches() -> None:
    from .kernels import fused_mp as mp
    mp.LAUNCHES = mp.BWD_LAUNCHES = mp.JVP_LAUNCHES = 0


def _launches() -> Dict[str, int]:
    from .kernels import fused_mp as mp
    return dict(zip(KERNELS, (mp.LAUNCHES, mp.BWD_LAUNCHES,
                              mp.JVP_LAUNCHES)))


def _warm_up(run, device) -> None:
    t0 = time.perf_counter()
    run()
    _sync(device)
    _log(f"warm-up {time.perf_counter() - t0:.1f} s")


def _timed(run, device, reps: int = REPS, before=None) -> tuple:
    """(outputs, walls, launches) of ``reps`` calls of ``run``, each timed
    by the host clock and ended on the card, its launches counted from 0;
    ``before()`` runs ahead of each, untimed."""
    outs, walls, launches = [], [], []
    for _ in range(reps):
        if before is not None:
            before()
        _sync(device)
        _reset_launches()
        t0 = time.perf_counter()
        outs.append(run())
        _sync(device)
        walls.append(time.perf_counter() - t0)
        launches.append(_launches())
    return outs, walls, launches


def device_seconds(run, device) -> Optional[float]:
    """The device's kernel time in one profiled ``run()``: every device
    kernel, ``record_function`` ranges left out.  None on the CPU, which
    has no device time."""
    from .profiling import kernel_times, profiled
    if torch.device(device).type != "cuda":
        return None
    t0 = time.perf_counter()
    # the card's activity alone: recording every host operator of a
    # 28,000-launch solve too would add seconds to the run
    prof, _ = profiled(run, host=False)
    _log(f"profiled run and trace {time.perf_counter() - t0:.1f} s")
    device_s = 1e-6 * sum(t for t, _ in kernel_times(prof).values())
    if not device_s:
        raise RuntimeError("torch.profiler recorded no device time")
    return device_s


def _busy(device_s: Optional[float], wall: float) -> Optional[float]:
    return None if device_s is None else device_s / wall


def card_line(device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card (None on
    the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


# ----------------------------------------------------------------- modes

def inference(device, iters: int = HEADLINE_ITERS, radius: float = 5.0,
              hsize: float = 0.08, model=None, reps: int = REPS,
              rcm: Optional[bool] = None):
    """(line, SolverResult of the last rep): the headline solve by the
    solver's route; ``model`` defaults to ``headline_model``, ``rcm`` to
    ``bench_rcm()``."""
    from .solvers import resolve_loop
    device = torch.device(device)
    rcm = bench_rcm() if rcm is None else rcm
    t0 = time.perf_counter()
    graph, _, n_nodes, n_edges = build_big_graph(radius, hsize,
                                                 device=device, rcm=rcm)
    cfg = headline_config(iters)
    model = model if model is not None else headline_model(cfg, device)
    loop = resolve_loop(cfg.solver, None, graph.x)
    _log(f"mesh and model {time.perf_counter() - t0:.1f} s")

    def run():
        return headline_solve(model, graph, cfg)

    _warm_up(run, device)
    outs, walls, launches = _timed(run, device, reps)
    _log(f"walls {walls}")
    dt = min(walls)
    out = outs[-1]
    done = out.calls - 1             # fw_tol 0 runs the full threshold
    device_s = device_seconds(run, device)
    edges_per_s = done * 2 * n_edges / dt
    return {
        "metric": "psignn_fixed_point_edges_per_s",
        "value": round(edges_per_s, 1),
        "unit": "edges/s/chip",
        "vs_baseline": round(edges_per_s / REF_EDGES_PER_S, 3),
        "detail": {
            "n_nodes": n_nodes, "n_edges": n_edges, "iters": done,
            "wall_s": round(dt, 4), "solver": "broyden", "rcm": rcm,
            "baseline_edges_per_s": round(REF_EDGES_PER_S, 1),
            "launches": launches[-1], "device_s": device_s,
            "busy": _busy(device_s, dt), "card": card_line(device),
            "loop": loop, "host_reads": out.host_reads,
            "graphs": out.graphs, "capture_s": out.capture_s,
        },
    }, out


def train(device, n_meshes: int = TRAIN_MESHES, hsize: float = 0.08,
          ckpt: str = CKPT, reps: int = REPS, rcm: Optional[bool] = None):
    """(line, StepResults of the reps): the train step; ``rcm`` defaults
    to ``bench_rcm()``."""
    device = torch.device(device)
    rcm = bench_rcm() if rcm is None else rcm
    t0 = time.perf_counter()
    graph = train_batch(n_meshes, hsize=hsize, device=device, rcm=rcm)
    model, cfg, init = trained_model(device, TRAIN_OVERRIDES, ckpt)
    _log(f"meshes and model {time.perf_counter() - t0:.1f} s")
    _warm_up(lambda: step_from(model, cfg, init, graph, WARMUP_SEED),
             device)
    outs, walls, launches = [], [], []
    for i in range(reps):
        _reset_launches()
        # the restore is outside ``step_from``'s timed window
        res, wall = step_from(model, cfg, init, graph, REP_SEED + i)
        outs.append(res)
        walls.append(wall)
        launches.append(_launches())
    step_s = min(walls)
    _log(f"walls {walls}")
    device_s = device_seconds(
        lambda: step_from(model, cfg, init, graph, REP_SEED), device)
    steps = [dict(seconds=w, loss=r.loss, fw=list(r.fw), bw=list(r.bw),
                  launches=n) for r, w, n in zip(outs, walls, launches)]
    return {
        "metric": "psignn_train_step_seconds",
        "value": round(step_s, 4),
        "unit": f"s/step (batch {n_meshes}, canonical config)",
        "vs_baseline": round(REF_TRAIN_STEP_S / step_s, 3),
        "detail": {
            "n_nodes": graph.total_nodes,
            "n_edges": int(graph.senders.shape[0]),
            "fw_nstep": int(res.fw.nstep), "loss": float(res.loss),
            "epoch_s_extrapolated": round(step_s * EPOCH_STEPS, 1),
            "baseline_step_s": REF_TRAIN_STEP_S, "rcm": rcm,
            "launches": launches[-1], "device_s": device_s,
            "busy": _busy(device_s, step_s), "card": card_line(device),
            "ckpt": ckpt, "steps": steps,
        },
    }, outs


def rank_layout(device, n: int) -> tuple:
    """(backend, device of each rank) of ``n`` partition ranks: NCCL with
    rank r on ``cuda:r`` for ``cuda``; gloo with every rank on the one
    device for ``cuda:K`` or ``cpu`` (NCCL refuses two ranks on one card)."""
    device = torch.device(device)
    if n < 1:
        raise ValueError(f"--num_devices {n}: give at least one rank")
    if device.type == "cuda" and device.index is None:
        if n > torch.cuda.device_count():
            raise ValueError(f"--num_devices {n}: {torch.cuda.device_count()}"
                             " GPUs here; several ranks share one card only "
                             "with --device cuda:K")
        return "nccl", [f"cuda:{r}" for r in range(n)]
    return "gloo", [str(device)] * n


def _partition_rank(rank: int, n: int, backend: str, devices: list,
                    init: str, sample: dict, iters: int, reps: int) -> dict:
    """One rank of the partition mode: its part of ``sample``, a warm-up,
    ``reps`` timed solves started together, then (rank 0) one profiled."""
    from .dist import build_partitioned_graph, multihost
    from .dist.partitioned import make_partitioned_inference
    device = torch.device(devices[rank])
    with contextlib.redirect_stdout(sys.stderr):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        multihost.initialize(backend, init, n, rank)
        mesh = multihost.global_mesh(1, n, device)
        cfg = headline_config(iters)
        model = headline_model(cfg, device)
        pg = build_partitioned_graph(sample, n, mesh.part_index,
                                     device=device)
        infer = make_partitioned_inference(cfg, mesh)

        def run():
            return infer(model, pg)

        _warm_up(run, device)

        # the ranks start each rep together
        outs, walls, launches = _timed(run, device, reps, mesh.barrier)
        device_s = None
        if device.type == "cuda":
            # the same collective call on every rank, profiled on rank 0
            mesh.barrier()
            if rank == 0:
                device_s = device_seconds(run, device)
            else:
                run()
    out = outs[-1]
    return dict(walls=walls, launches=launches[-1], calls=out.calls,
                residual=out.residual, n_loc=pg.n_loc, halo=pg.halo,
                backend=mesh.backend, device_s=device_s)


def partition(device, n_ranks: Optional[int] = None,
              iters: int = HEADLINE_ITERS, radius: float = 5.0,
              hsize: float = 0.08, reps: int = REPS):
    """(line, each rank's record): the partitioned headline solve over
    ``n_ranks`` (default: every local card; 1 on the CPU)."""
    from .dist import multihost
    device = torch.device(device)
    if n_ranks is None:
        n_ranks = torch.cuda.device_count() if device.type == "cuda" else 1
    backend, devices = rank_layout(device, n_ranks)
    t0 = time.perf_counter()
    sample = rcm_ordered(headline_sample(radius, hsize))
    n_edges = int(sample["senders"].shape[0])
    _log(f"mesh {time.perf_counter() - t0:.1f} s")
    if device.type == "cuda":
        # built once here rather than by every rank
        from .kernels import build
        build.build("fused_mp_fwd")
    init = f"tcp://127.0.0.1:{multihost.free_port()}"
    ranks = multihost.spawn(
        _partition_rank, n_ranks,
        (n_ranks, backend, devices, init, sample, iters, reps),
        timeout=PARTITION_TIMEOUT)
    # a rep lasts until its slowest rank is done
    rep_walls = [max(walls) for walls in zip(*(r["walls"] for r in ranks))]
    _log(f"walls {rep_walls}")
    dt = min(rep_walls)
    r0 = ranks[0]
    done = r0["calls"] - 1           # fw_tol 0 runs the full threshold
    edges_per_s = done * 2 * n_edges / dt
    device_s = r0["device_s"]
    return {
        "metric": "psignn_partitioned_fixed_point_edges_per_s",
        "value": round(edges_per_s, 1),
        "unit": f"edges/s over {n_ranks} devices",
        "vs_baseline": round(edges_per_s / REF_EDGES_PER_S, 3),
        "detail": {
            "n_nodes": int(sample["x"].shape[0]), "n_edges": n_edges,
            "n_devices": n_ranks, "iters": done, "wall_s": round(dt, 4),
            "halo": int(r0["halo"]), "n_loc": int(r0["n_loc"]),
            "residual": float(r0["residual"]),
            "launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in KERNELS},
            "device_s": device_s, "busy": _busy(device_s, dt),
            "card": card_line(device), "backend": r0["backend"],
        },
    }, ranks


MODES = {"inference": inference, "train": train, "partition": partition}


# ------------------------------------------------------ quieting the card

def _proc_parents() -> Dict[int, int]:
    """{pid: parent pid} of every process, from ``/proc/*/stat``."""
    parents = {}
    for path in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(path) as f:
                fields = f.read().rsplit(") ", 1)[1].split()
        except (OSError, IndexError):
            continue              # gone since the listing
        parents[int(path.split("/")[2])] = int(fields[1])
    return parents


def _descendants(pid: int, parents: Dict[int, int]) -> List[int]:
    kids: Dict[int, List[int]] = {}
    for child, parent in parents.items():
        kids.setdefault(parent, []).append(child)
    out, queue = [], [pid]
    while queue:
        for child in kids.get(queue.pop(), []):
            out.append(child)
            queue.append(child)
    return out


def port_trainers(results: str) -> List[int]:
    """Launcher PIDs of the port's live trainers registered under
    ``results``: each ``<results>/*/trainer.pid`` and
    ``<results>/torch/*/trainer.pid`` whose process's command line names
    ``psignn_tpu_torch.cli.main`` (a recycled PID is left alone)."""
    pids = []
    for pf in sorted(glob.glob(os.path.join(results, "*", "trainer.pid"))
                     + glob.glob(os.path.join(results, "torch", "*",
                                              "trainer.pid"))):
        try:
            with open(pf) as f:
                pid = int(f.read().strip())
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except (OSError, ValueError):
            continue
        if TRAINER_MATCH in cmd.replace("\0", " "):
            pids.append(pid)
    return pids


def _signal_all(pids: List[int], sig: int) -> List[int]:
    done = []
    for pid in pids:
        try:
            os.kill(pid, sig)
            done.append(pid)
        except (ProcessLookupError, PermissionError):
            pass
    return done


@contextlib.contextmanager
def pause_trainers(results: Optional[str] = None, settle_s: float = 5.0):
    """Stop (SIGSTOP) the port's trainers for the block, with every
    process under each (a ``--num_devices`` run's ranks), and resume them
    (SIGCONT) when it ends, on SIGTERM and on SIGINT; yields the paused
    PIDs.  A trainer dispatching kernels beside the bench would inflate
    its wall.  JAX trainers never hold the card and are left alone.
    Sleeps ``settle_s`` for in-flight kernels to drain when it paused
    anything.  ``results`` defaults to the checkout's ``results/``."""
    paused: List[int] = []
    for pid in port_trainers(results or os.path.join(ROOT, "results")):
        # the launcher first, so that it starts no rank meanwhile
        paused += _signal_all([pid], signal.SIGSTOP)
        paused += _signal_all(_descendants(pid, _proc_parents()),
                              signal.SIGSTOP)

    def on_signal(signum, frame):
        _signal_all(paused, signal.SIGCONT)
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    handlers = {}
    if paused:
        for sig in (signal.SIGTERM, signal.SIGINT):
            handlers[sig] = signal.signal(sig, on_signal)
    try:
        if paused:
            _log(f"paused {len(paused)} trainer processes: {paused}")
            time.sleep(settle_s)
        yield paused
    finally:
        _signal_all(paused, signal.SIGCONT)
        for sig, handler in handlers.items():
            signal.signal(sig, handler)


# -------------------------------------------------------------------- cli

def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m psignn_tpu_torch.bench",
        description="The port's hot-path benchmark: one JSON line on "
                    "stdout.")
    p.add_argument("--mode", choices=tuple(MODES), default="inference")
    p.add_argument("--device", default=None,
                   help="cuda (the default; partition: rank r on cuda:r "
                        "over NCCL), cuda:K (partition: every rank on card "
                        "K over gloo) or cpu (gloo ranks on the CPU)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="the partition mode's ranks (default: every local "
                        "GPU; 1 with --device cpu)")
    return p


def main(argv=None) -> None:
    p = get_parser()
    args = p.parse_args(argv)
    if args.num_devices is not None and args.mode != "partition":
        p.error("--num_devices is the partition mode's")
    device = resolve_device(args.device)     # the card, or a raise
    kw = {"n_ranks": args.num_devices} if args.mode == "partition" else {}
    with contextlib.redirect_stdout(sys.stderr), pause_trainers():
        line, _ = MODES[args.mode](device, **kw)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
