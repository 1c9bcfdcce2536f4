"""The readings that the mixed sweep's and the data-parallel training
cell's limits are set from, at the cells' own size: the program's sound
runs on several seeds, the program with a fault planted
(``faults_mixed_dp.planted``, and ``faults.planted``'s early stops) on
several seeds, and the control
(``control_mixed_dp.py``).  Each run is a short window of the cell's own
loop; the data-parallel cell's runs share one spawn of its ranks
(``train_dp.run_many``).

    python3 benchmark/tests/readings_mixed_dp.py psignn_mixed.sweep \\
        --seeds 3141592653 2718281828 --seconds 4 \\
        --fault neumann_skipped --fault_seeds 1618033988 --control \\
        --out chiprun_out/mixed.json
    python3 benchmark/tests/readings_mixed_dp.py \\
        psignn_dirichlet.train_dp4 --seeds 3141592653 --seconds 1 \\
        --fault loss_summed --failure --out chiprun_out/dp4.json

writes, for each run, the cell's numbers beside their limits.  With
``--failure`` a run with ``rank_dies`` planted is timed to its end, which
has to come as an error.

``RECORDED`` keeps, for each limit of each cell, the readings it was set
from: the largest sound reading over ``seeds`` seeds, and the smallest
reading of each fault and of the control that the number is held against
(``test_readings_mixed_dp.py`` checks each limit lies between them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for path in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if path not in sys.path:
        sys.path.insert(0, path)

from benchmark.benchlib.spec import load_cell  # noqa: E402

INF = float("inf")
RECORDED = {
    # readings on an NVIDIA H100 80GB HBM3 at 700 W: sound on 23 runs (15
    # readings of 4 s, 8 of benchmark/run.py), each fault on 3 seeds, the
    # control over the pool
    "psignn_mixed.sweep": {
        "converged_residual": dict(
            sound=9.9597e-06, seeds=23,
            faults={"fw_tol=5e-5": 4.9171e-05, "neumann_skipped": 0.17580,
                    "neumann_kept": 0.17580, "normals_unpermuted": 9.4648e-04},
            control=3.6359e-04, limit=1.5e-05),
        "worst_residual": dict(
            sound=9.9597e-06, seeds=23,
            faults={"neumann_skipped": 0.17580, "neumann_kept": 0.17580,
                    "normals_unpermuted": 9.4648e-04},
            control=3.6359e-04, limit=1e-04),
        "residual_gap": dict(
            sound=1.2191e-08, seeds=23,
            faults={"neumann_skipped": 0.17579, "neumann_kept": 0.17579,
                    "normals_unpermuted": 9.3736e-04},
            control=2.1919e-04, limit=5e-06),
        "decode_gap": dict(sound=4.6613e-07, seeds=23, faults={},
                           control=1.7974e-03, limit=5e-05)},
    # readings on four NVIDIA H100 80GB HBM3 at 700 W: sound on
    # 17 seeds (10 readings of 1 s, 7 of benchmark/run.py), each fault on
    # 3 seeds, the control (one card) on one; the limits are
    # psignn_dirichlet.json's, unchanged
    "psignn_dirichlet.train_dp4": {
        "train_residual": dict(sound=8.8997e-06, seeds=17,
                               faults={"rank_grad_not_reduced": 5.7473e-02},
                               control=3.8731e-04, limit=2e-05),
        "first_loss_gap": dict(sound=5.7260e-07, seeds=17,
                               faults={"loss_summed": 2.99999},
                               control=0.21344, limit=1e-03),
        "grad_gap": dict(sound=7.7208e-04, seeds=17,
                         faults={"rank_grad_not_reduced": 0.28603},
                         control=5.7608, limit=0.1),
        "change_gap": dict(sound=1.6499e-03, seeds=17,
                           faults={"rank_grad_not_reduced": 0.57220},
                           control=1.0, limit=0.1)},
}


def _row(run, seed: int) -> dict:
    return dict(seed=seed, requests=len(run.requests), steps=len(run.steps),
                failed=run.failed, correct=run.correct, checks=run.checks,
                judged=run.judged)


def mixed_runs(cell, seeds, faults_, fault_seeds, seconds: float,
               device: str) -> dict:
    import contextlib
    import faults
    import faults_mixed_dp
    from benchmark.benchlib import mixed_sweep

    def planted(name):
        if name is None:
            return contextlib.nullcontext()
        if name in faults_mixed_dp.MIXED:
            return faults_mixed_dp.planted(name)
        return faults.planted(name)       # a solve stopped early

    out = {"sound": [], "faults": {}}
    for name in [None, *faults_]:
        for seed in seeds if name is None else fault_seeds:
            with planted(name):
                run = mixed_sweep.run(cell, seed, seconds, False, device,
                                      time.perf_counter())
            row = _row(run, seed)
            (out["sound"] if name is None
             else out["faults"].setdefault(name, [])).append(row)
    return out


def _judge_jobs(cell, device: str, jobs: list) -> list:
    """Rows of ``(seed, outs)`` jobs judged one after another on
    ``device``."""
    import torch
    from benchmark.benchlib import train_dp
    torch.set_num_threads(1)
    return [_row(train_dp.finish(cell, seed, outs, torch.device(device)),
                 seed) for seed, outs in jobs]


def dp_runs(cell, seeds, faults, fault_seeds, seconds: float,
            device: str) -> dict:
    """The data-parallel runs in one spawn of the ranks; the judges then
    in one process a card (or one on the CPU)."""
    import multiprocessing
    import torch
    from benchmark.benchlib import train_dp
    from faults_mixed_dp import PLANT
    jobs = [(seed, None) for seed in seeds] + [
        (seed, PLANT(name)) for name in faults for seed in fault_seeds]
    outs = train_dp.run_many(cell, jobs, seconds, device,
                             time.perf_counter())
    cards = torch.device(device).type == "cuda"
    n = int(cell.traffic["ranks"]) if cards else 1
    work = [(cell, f"cuda:{w}" if cards else device,
             [(seed, o) for (seed, _), o in list(zip(jobs, outs))[w::n]])
            for w in range(n)]
    with multiprocessing.get_context("spawn").Pool(n) as judges:
        parts = judges.starmap(_judge_jobs, work)
    rows = [None] * len(jobs)
    for w, part in enumerate(parts):
        rows[w::n] = part
    out = {"sound": [], "faults": {}}
    for (seed, plant), row in zip(jobs, rows):
        if plant is None:
            out["sound"].append(row)
        else:
            out["faults"].setdefault(plant[2][0], []).append(row)
    return out


def failure(cell, seconds: float, device: str) -> dict:
    """A run with ``rank_dies`` planted: its seconds from the spawn to
    the error, which has to come."""
    from benchmark.benchlib import train_dp
    from faults_mixed_dp import PLANT
    t0 = time.perf_counter()
    try:
        train_dp.run(cell, 1, seconds, False, device, t0,
                     plant=PLANT("rank_dies"))
    except RuntimeError as e:
        return dict(raised=True, seconds=time.perf_counter() - t0,
                    error=str(e).splitlines()[0])
    return dict(raised=False, seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    import torch
    import control_mixed_dp

    p = argparse.ArgumentParser()
    p.add_argument("workload")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault_seeds", type=int, nargs="*", default=None,
                   help="the seeds of the faults' runs (default: --seeds)")
    p.add_argument("--control", action="store_true")
    p.add_argument("--control_seeds", type=int, nargs="*", default=[5])
    p.add_argument("--failure", action="store_true")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    dp = cell.traffic["kind"] == "train_dp"
    out = dict((dp_runs if dp else mixed_runs)(
        cell, args.seeds, args.fault,
        args.seeds if args.fault_seeds is None else args.fault_seeds,
        args.seconds, args.device),
        workload=args.workload, control=[])

    def save():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=repr)

    save()
    if args.failure:
        out["failure"] = failure(cell, args.seconds, args.device)
        save()
    if args.control:
        for seed in args.control_seeds if dp else [None]:
            out["control"].append(dict(seed=seed, checks=(
                control_mixed_dp.readings(cell, args.device, seed) if dp
                else control_mixed_dp.readings(cell, args.device))))
            save()
    for name, runs in ([("sound", out["sound"])]
                       + list(out["faults"].items())
                       + [("control", out["control"])]):
        for r in runs:
            print(name, r.get("seed"), r.get("correct"), json.dumps(
                {k: c["value"] for k, c in r["checks"].items()}))
    if "failure" in out:
        print("failure", json.dumps(out["failure"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
