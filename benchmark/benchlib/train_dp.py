"""The data-parallel training loop: Ψ-GNN trained on from the checkpoint
over ``ranks`` processes, one card each, as the program's trainer runs
``--num_devices``: each global batch dealt over the ranks by the
program's loader, each rank's gradients and losses averaged over the
ranks by one all-reduce (``train.step.train_step`` with a ``mesh``,
``dist.dp.dp_value_and_grad``), then the same clip and Adams on every
rank.

The parent process fills the pool's cache and spawns the ranks
(``dist.multihost.spawn``: a rank that raises or dies, or a run past its
deadline, ends every rank and raises here).  Each rank joins the process
group (NCCL on ``cuda:<rank>``, gloo on the CPU, with a timeout), loads
the model through the program's entry (``eval.run_eval.load_predictor``),
makes fresh optimizers and hands the pool to the program's loader
(``data.reader.GraphLoader`` with ``rcm``, ``cache_batches`` and its rank
of ``ranks``: the global batches dealt by the seed, each rank's shard of
each built once on its card).  Set-up runs the first pass, every batch
once; during its first three steps a forward pre-hook on the module the
configuration names (``train_capture``) keeps each rank's h*, and rank 0
copies the parameters at each step's start to the host.  After a barrier
rank 0 starts the window; every step after, rank 0 decides whether the
window goes on and all ranks follow (one all-reduce of a flag, outside
the step's time).  A step is timed on rank 0 from its call to its loss on
the host, and counts the global batch's samples.  With ``trace``, rank 0
profiles two steps about a third into the window (device activity only)
and keeps the program's spans of them.  Each rank counts the f_θ
evaluations of each window step (``models.psignn.F_CALLS``, where the
program has it).

After the ranks have ended, the parent judges rank 0's first steps by
the reference's data-parallel steps (``reference/psignn_dp.py``) at the
ranks' own h*: the four numbers of ``train.py``'s judge.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from . import devtrace, pool
from .record import Run, Step
from .train import (JUDGED_STEPS, NUMBERS, PROFILED_STEPS, _first_gradient,
                    loader_seed, probe_generator, reference_leaves)

# seconds a collective may wait for a peer before the process group
# gives up; set-up's slowest part, a rank's import and kernel build, is
# before the group is joined
PG_TIMEOUT_S = 180
# seconds the whole spawned run may take beyond its window
DEADLINE_S = 600


@dataclasses.dataclass
class DpRun(Run):
    """A data-parallel run: rank 0's steps, and each rank's counts."""
    allreduce_ms: List[float] = dataclasses.field(default_factory=list)
    rank_f_calls: List[Optional[List[int]]] = dataclasses.field(
        default_factory=list)
    span_ms: Dict[str, tuple] = dataclasses.field(default_factory=dict)


def _f_calls() -> Optional[int]:
    from psignn_tpu_torch.models import psignn
    return getattr(psignn, "F_CALLS", None)


def rank_probes(seed: int, rank: int) -> torch.Generator:
    """Rank ``rank``'s generator of Hutchinson probes."""
    return probe_generator(int(seed) + rank)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, plant: Optional[tuple] = None) -> DpRun:
    """One run of a data-parallel training cell on ``cell.traffic
    ["ranks"]`` ranks: rank r on ``cuda:r`` where ``device`` is a card,
    every rank on the CPU otherwise.  ``plant``, (module, factory, args),
    names a context each rank runs in (tests plant faults through it)."""
    outs = spawn_ranks(cell, device, seconds, _rank,
                       (cell, seed, seconds, trace, t_process, plant))
    return finish(cell, seed, outs, torch.device(device))


def run_many(cell, jobs: List[tuple], seconds: float, device: str,
             t_process: float) -> List[list]:
    """Untraced runs of the cell in one spawn of its ranks, one for each
    ``(seed, plant)`` of ``jobs``, one after another in the same process
    group (the readings and the tests, which need no process start of
    their own for each): each job's results of the ranks, for
    ``finish``."""
    outs = spawn_ranks(cell, device, seconds * len(jobs), _rank_jobs,
                       (cell, jobs, seconds, t_process))
    return [[o[j] for o in outs] for j in range(len(jobs))]


def spawn_ranks(cell, device: str, seconds: float, fn, args: tuple) -> list:
    """Each rank's result of ``fn(rank, kind, init, backend, *args)`` on
    the cell's ranks, the pool's cache filled first; ``kind`` is the
    device's type, ``init`` and ``backend`` the process group's."""
    from psignn_tpu_torch.dist import multihost
    dev = torch.device(device)
    pool.mesh_pool(cell.traffic)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    init = f"tcp://127.0.0.1:{multihost.free_port()}"
    return multihost.spawn(fn, int(cell.traffic["ranks"]),
                           (dev.type, init, backend, *args),
                           timeout=seconds + DEADLINE_S)


def finish(cell, seed: int, outs: list, dev: torch.device) -> DpRun:
    """The run of the ranks' results ``outs`` (rank order), judged on
    ``dev``."""
    from .spec import reference_module
    traffic = cell.traffic
    ranks = int(traffic["ranks"])
    samples = [s["sample"] for s in pool.mesh_pool(traffic)]
    first = outs[0]
    ref = reference_module(cell.config)
    rec = DpRun(cell=cell.name, config=cell.config, traffic=traffic,
                reference=ref, **first["run"])
    rec.rank_f_calls = [o["f_calls"] for o in outs]
    for name, (count, ms) in sorted(rec.span_ms.items()):
        print(f"benchmark: rank 0's traced steps: {count} {name} spans, "
              f"{ms:.3f} ms", file=sys.stderr)

    from psignn_tpu_torch.data.reader import GraphLoader
    deal = GraphLoader(samples, batch_size=traffic["batch_size"],
                       shuffle=True, seed=loader_seed(seed),
                       device="cpu").batch_order(0)[:JUDGED_STEPS]
    batches = [[samples[i] for i in sel] for sel in deal]
    side = {k: ([_tensors(v) for v in first["side"][k]] if k == "starts"
                else v if k == "losses" else _tensors(v))
            for k, v in first["side"].items()}
    side["h_stars"] = [
        [torch.from_numpy(o["h_stars"][t]) if t < len(o["h_stars"])
         else None for o in outs] for t in range(JUDGED_STEPS)]
    steps: Dict[str, list] = {}
    rec.judged = [judge(cell.config, batches, side, seed, ranks, dev,
                        steps), steps]
    rec.checks = {k: {"value": float(v),
                      "limit": float(cell.config["limits"][k])}
                  for k, v in rec.judged[0].items()}
    return rec


def _tensors(leaves: Dict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in leaves.items()}


def _arrays(leaves: Dict) -> Dict:
    """Tensors by leaf as numpy arrays: what a rank hands its parent
    (a tensor would go by a shared handle that ends with the rank)."""
    return {k: v.numpy() for k, v in leaves.items()}


def join(rank: int, ranks: int, kind: str, init: str, backend: str
         ) -> torch.device:
    """Join the process group as rank ``rank``; its device."""
    import torch.distributed as dist
    dev = torch.device(f"cuda:{rank}" if kind == "cuda" else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # ranks of one host: gloo on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=init, world_size=ranks,
                            rank=rank, timeout=datetime.timedelta(
                                seconds=PG_TIMEOUT_S))
    return dev


def _rank(rank: int, kind: str, init: str, backend: str, cell, seed: int,
          seconds: float, trace: bool, t_process: float,
          plant: Optional[tuple]) -> dict:
    dev = join(rank, int(cell.traffic["ranks"]), kind, init, backend)
    return rank_run(rank, dev, cell, seed, seconds, trace, t_process, plant)


def _rank_jobs(rank: int, kind: str, init: str, backend: str, cell,
               jobs: List[tuple], seconds: float, t_process: float) -> list:
    dev = join(rank, int(cell.traffic["ranks"]), kind, init, backend)
    return [rank_run(rank, dev, cell, seed, seconds, False, t_process, plant)
            for seed, plant in jobs]


def rank_run(rank: int, dev: torch.device, cell, seed: int, seconds: float,
             trace: bool, t_process: float, plant: Optional[tuple] = None
             ) -> dict:
    """One rank's run in a joined process group, in the context that
    ``plant`` names, if any."""
    if plant is None:
        return _rank_run(rank, dev, cell, seed, seconds, trace, t_process)
    module, factory, args = plant
    with getattr(importlib.import_module(module), factory)(*args):
        return _rank_run(rank, dev, cell, seed, seconds, trace, t_process)


def _rank_run(rank: int, dev: torch.device, cell, seed: int,
              seconds: float, trace: bool, t_process: float) -> dict:
    from psignn_tpu_torch import profiling
    from psignn_tpu_torch.data.reader import GraphLoader
    from psignn_tpu_torch.dist.dp import make_mesh
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.kernels import fused_mp
    from psignn_tpu_torch.train.optim import make_optimizers
    from psignn_tpu_torch.train.step import train_step

    from .spec import ROOT
    from .sweep import _check_config, _sync

    t_imported = time.perf_counter()
    config, traffic = cell.config, cell.traffic
    tcfg = config["train"]
    ranks = int(traffic["ranks"])
    mesh = make_mesh(device=dev)
    _, _, cfg, model = load_predictor(
        os.path.join(ROOT, config["checkpoint"]), dev)
    _check_config(cfg, config["model"])
    opts = make_optimizers(model, tcfg["lr_deq"], tcfg["lr_ae"])
    t_loaded = time.perf_counter()
    samples = [s["sample"] for s in pool.mesh_pool(traffic)]
    loader = GraphLoader(samples, batch_size=traffic["batch_size"],
                         shuffle=True, seed=loader_seed(seed), rcm=True,
                         cache_batches=True, device=dev, n_devices=ranks,
                         rank=rank)
    if len(loader) < JUDGED_STEPS:
        raise SystemExit(f"{cell.name}: a pass has {len(loader)} batches, "
                         f"the comparison follows {JUDGED_STEPS}")
    probes = rank_probes(seed, rank)
    lrs = (tcfg["lr_deq"], tcfg["lr_ae"])
    t_pool = time.perf_counter()

    def step(graph, sel, spans=None) -> Step:
        f0, b0 = fused_mp.LAUNCHES, fused_mp.BWD_LAUNCHES
        t0 = time.perf_counter()
        w0 = time.time_ns()
        out = train_step(model, opts, graph, cfg, lrs, tcfg["gradient_clip"],
                         tcfg["jac_weight"], probes, mesh=mesh)
        loss = float(out.loss)
        t1 = time.perf_counter()
        if spans is not None:
            spans.append(("train_step", w0, time.time_ns()))
        return Step(samples=len(sel), seconds=t1 - t0, loss=loss,
                    fw_launches=fused_mp.LAUNCHES - f0,
                    bw_launches=fused_mp.BWD_LAUNCHES - b0)

    side = {"losses": [], "starts": []}
    kept: Dict[str, torch.Tensor] = {}
    h_stars: List[torch.Tensor] = []

    def keep_h_star(_module, args):
        if "h" not in kept and args[0].requires_grad:
            kept["h"] = args[0].detach().clone()

    hook = model.get_submodule(config["train_capture"]) \
        .register_forward_pre_hook(keep_h_star)
    for k, (graph, sel) in enumerate(zip(loader, loader.batch_order(0))):
        if k < JUDGED_STEPS:
            side["starts"].append(_arrays(reference_leaves(model)))
            side["losses"].append(step(graph, sel).loss)
            if "h" in kept:
                h_stars.append(kept.pop("h").cpu().numpy())
        else:
            step(graph, sel)
        if k == 0:
            side["grad"] = _arrays(_first_gradient(model, opts))
        if k == JUDGED_STEPS - 1:
            hook.remove()
            side["change"] = {
                k: p.numpy() - side["starts"][0][k]
                for k, p in reference_leaves(model).items()}
    _sync(dev)
    mesh.barrier()
    if rank == 0:
        print(f"benchmark: set-up of rank 0: start and imports "
              f"{t_imported - t_process:.3f} s, checkpoint "
              f"{t_loaded - t_imported:.3f} s, pool and batches "
              f"{t_pool - t_loaded:.3f} s, first pass "
              f"{time.perf_counter() - t_pool:.3f} s", file=sys.stderr)

    lead = rank == 0
    slice_ = devtrace.Slice(dev) if trace and lead else None
    profiled = 0
    rec = {"steps": [], "failed": 0}
    f_calls: Optional[List[int]] = [] if _f_calls() is not None else None
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    epoch = 1
    done = False
    while not done:
        for graph, sel in zip(loader, loader.batch_order(epoch)):
            if not mesh.sync(lead and time.perf_counter() - t_start
                             < seconds):
                done = True
                break
            if slice_ is not None and slice_.prof is None and \
                    time.perf_counter() - t_start >= seconds / 3:
                slice_.start()
            in_slice = slice_ is not None and slice_.prof is not None \
                and profiled < PROFILED_STEPS
            c0 = _f_calls()
            # a step that fails on one rank would leave the others in the
            # all-reduce: it raises, and the parent ends every rank
            s = step(graph, sel, slice_.spans if in_slice else None)
            if f_calls is not None:
                f_calls.append(_f_calls() - c0)
            s.profiled = in_slice
            rec["steps"].append(s)
            if in_slice:
                profiled += 1
                if profiled == PROFILED_STEPS:
                    slice_.stop()
        epoch += 1
    window_s = time.perf_counter() - t_start
    out = {"f_calls": f_calls, "h_stars": h_stars}
    if not lead:
        return out
    rec.update(setup_s=setup_s, window_s=window_s)
    if slice_ is not None and slice_.prof is not None:
        if slice_.window_s == 0.0:
            slice_.stop()
        rec["trace"] = slice_.summary()
        spans: Dict[str, list] = {}
        for r in getattr(profiling, "recorded", lambda: [])():
            if r.end is not None:
                c, ms = spans.get(r.name, (0, 0.0))
                spans[r.name] = (c + 1, ms + (r.end - r.start) * 1e-6)
        rec["span_ms"] = spans
        rec["allreduce_ms"] = [
            (r.end - r.start) * 1e-6
            for r in getattr(profiling, "recorded", lambda: [])()
            if r.name == "dp.allreduce" and r.end is not None]
    if dev.type == "cuda":
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    out.update(run=rec, side=side)
    return out


def judge(config: dict, batches: List[list], side: dict, seed: int,
          ranks: int, device, steps: dict = None) -> Dict[str, float]:
    """The numbers of the side under test (rank 0's first steps: its
    losses, the first gradient and the change, the parameters at each
    step's start, and every rank's h* of each step) against the
    reference's data-parallel steps at those h*, in ``FixedOrder``;
    ``steps``, where given, gets each judged step's losses and residuals.
    A side that handed no h* of a rank's shard, or one of another size,
    has no equilibrium of that shard to judge: every number reads
    infinite."""
    from benchmark.reference import psignn, psignn_dp
    from benchmark.reference.common import FixedOrder, no_tf32
    no_tf32()
    bs = config["train"]["batch_size"]
    dealt = [psignn_dp.deal(b, bs, ranks) for b in batches]
    latent = config["model"]["latent_dim"]
    shapes = [[(sum(int(s["x"].shape[0]) for s in shard), latent)
               for shard in d] for d in dealt]
    handed = [[None if h is None else tuple(h.shape) for h in hs]
              for hs in side["h_stars"]]
    if handed != shapes:
        print(f"benchmark: judged steps: h* of shapes {handed}, the "
              f"shards' {shapes}", file=sys.stderr)
        return dict.fromkeys(NUMBERS, float("inf"))
    t0 = time.perf_counter()
    with FixedOrder():
        other = reference_side(config, dealt, seed, device,
                               h_stars=side["h_stars"],
                               starts=side["starts"])
    numbers = psignn.train_numbers(side, other)
    if steps is not None:
        steps.update(losses=side["losses"], ref_losses=other["losses"],
                     residuals=other["residuals"])
    print(f"benchmark: judged steps in {time.perf_counter() - t0:.3f} s: "
          f"losses {side['losses']!r}, the reference's {other['losses']!r}; "
          f"residuals {other['residuals']!r}", file=sys.stderr)
    print("benchmark: judged steps: " + ", ".join(
        f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
    return numbers


def reference_side(config: dict, dealt: List[List[list]], seed: int,
                   device, precision: str = "f32", h_stars=None,
                   starts=None) -> dict:
    """The reference's data-parallel first steps over the dealt batches
    (mesh-order samples by rank), with each rank's probes: at the
    side's ``h_stars`` (by step, by rank) measured under its ``starts``,
    or, without them, solving each shard's own (the control).  Its
    losses, residuals, h* (by step, by rank), parameters at each step's
    start, first gradient and change by leaf."""
    from benchmark.reference import psignn, psignn_dp
    from benchmark.reference.common import read_checkpoint
    from .spec import ROOT
    params = read_checkpoint(os.path.join(ROOT, config["checkpoint"]))
    model = psignn.Model(params["params"], device, precision)
    ranks = len(dealt[0])
    gens = [rank_probes(seed, d) for d in range(ranks)]
    probes = [(lambda _t, shape, g=g: torch.randn(shape, generator=g)
               .to(device)) for g in gens]
    batches = [psignn_dp.Shards(d, device) for d in dealt]
    out = (psignn_dp.solve_dp_steps(model, batches, probes, config["model"],
                                    config["train"]) if h_stars is None
           else psignn_dp.judge_dp_steps(model, batches, h_stars, starts,
                                         probes, config["model"],
                                         config["train"]))
    return dict(losses=out["losses"], residuals=out["residuals"],
                h_stars=[[z.cpu() for z in zs] for zs in out["h_stars"]],
                starts=[{k: v.cpu() for k, v in p.items()}
                        for p in out["starts"]],
                grad={k: v.cpu() for k, v in out["grad"].items()},
                change={k: (out["after"][k] - out["before"][k]).cpu()
                        for k in out["after"]})
