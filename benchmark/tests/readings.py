"""The readings that a cell's limits are set from, at the cell's own
size, in one process: the program's sound runs on several seeds, the
program with a fault planted (``faults.planted``) on several seeds, and
the control (``control.py``).  Each run is a short window of the cell's
own loop.

    python3 benchmark/tests/readings.py psignn_dirichlet.sweep \\
        --seeds 3141592653 2718281828 1618033988 --seconds 4 \\
        --fault fw_tol=5e-5 --fault fw_thres=250 --control \\
        --out chiprun_out/readings.json

writes, for each run, the cell's numbers beside their limits and each
judged request's numbers (with its forward-kernel launches) or the
judged steps' numbers.  A training cell's control runs on each seed.
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

from benchmark.benchlib.spec import load_cell, loop_module  # noqa: E402


def one_run(cell, seed: int, seconds: float, device: str) -> dict:
    run = loop_module(cell.traffic).run(cell, seed, seconds, False, device,
                                        time.perf_counter())
    launches = {r.mesh: r.fw_launches for r in run.requests}
    judged = [dict(r, fw_calls=launches[r["mesh"]] // 2) if "mesh" in r
              else r for r in run.judged]
    return dict(seed=seed, requests=len(run.requests), steps=len(run.steps),
                failed=run.failed, correct=run.correct, checks=run.checks,
                judged=judged)


def main(argv=None) -> int:
    import torch
    import control
    from faults import planted

    p = argparse.ArgumentParser()
    p.add_argument("workload")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--sound", type=int, default=1,
                   help="0: the seeds serve the faults and control only")
    p.add_argument("--control", action="store_true")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    out = {"workload": args.workload, "sound": [], "faults": {},
           "control": []}

    def save():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    for seed in args.seeds if args.sound else []:
        out["sound"].append(one_run(cell, seed, args.seconds, args.device))
        save()
    for name in args.fault:
        out["faults"][name] = []
        for seed in args.seeds:
            with planted(name):
                out["faults"][name].append(
                    one_run(cell, seed, args.seconds, args.device))
            save()
    if args.control:
        from benchmark.benchlib.spec import reference_module
        from benchmark.benchlib.sweep import checks
        if cell.traffic["kind"] == "train":
            for seed in args.seeds:
                out["control"].append(dict(seed=seed, checks=control.readings(
                    cell, args.device, seed=seed)))
                save()
        else:
            rows = control.judged(cell, args.device)
            out["control"].append(dict(judged=rows, checks=checks(
                reference_module(cell.config), cell.config, rows)))
    save()
    for name, runs in ([("sound", out["sound"])]
                       + list(out["faults"].items())
                       + [("control", out["control"])]):
        for r in runs:
            print(name, r.get("seed"), r.get("correct"), json.dumps(
                {k: c["value"] for k, c in r["checks"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
