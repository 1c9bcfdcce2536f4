"""The control of a request cell's comparison: the plain reference put in
the program's place and computed in TF32 (every matmul's operands rounded
to a 10-bit mantissa, the nearest precision below the configuration's
float32 with TF32 off), judged as the program's answers are.  It has to
come out as not correct.

    python3 benchmark/tests/control.py psignn_dirichlet.sweep --device cuda

prints, for the cell's whole pool (or a training cell's first steps on
the batches of ``--seed``), each number beside its limit and whether the
control failed one (exit 0 when it did).  ``test_control.py``
runs it on a small pool on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.benchlib import pool  # noqa: E402
from benchmark.benchlib.spec import load_cell, reference_module  # noqa: E402
from benchmark.reference.common import no_tf32, read_checkpoint  # noqa: E402


def control_answers(ref, params, config, samples, device):
    """{pool index: answer} of the reference in TF32 in the program's
    place."""
    low = ref.Model(params, device, precision="tf32")
    m = config["model"]
    out = {}
    for i, s in enumerate(samples):
        if hasattr(ref, "solve"):
            z, u, res = ref.solve(low, s["sample"], m["fw_tol"],
                                  m["fw_thres"])
            out[i] = dict(z=z, u=u, reported=res)
        else:
            out[i] = dict(u=low.answer(s["sample"], m["k"]))
    return out


def judged(cell, device, traffic=None) -> list:
    """Each pool mesh's numbers, the control answering it."""
    from benchmark.benchlib.sweep import judge_requests
    no_tf32()
    config = cell.config
    ref = reference_module(config)
    samples = pool.mesh_pool(traffic or cell.traffic)
    params = read_checkpoint(os.path.join(ROOT, config["checkpoint"]))
    answers = control_answers(ref, params["params"], config, samples, device)
    return judge_requests(ref, config, samples, answers, device)


def train_numbers(cell, device, traffic=None, seed: int = 5) -> dict:
    """The numbers of the reference's first training steps in TF32 in
    the program's place, on the batches the run seed deals first: it
    solves each step's fixed point itself and hands its h* and its
    parameters at each step's start to the judge, as the program's run
    does."""
    from psignn_tpu_torch.data.reader import GraphLoader
    from benchmark.benchlib import train
    no_tf32()
    config, traffic = cell.config, traffic or cell.traffic
    ref = reference_module(config)
    samples = [s["sample"] for s in pool.mesh_pool(traffic)]
    deal = GraphLoader(samples, batch_size=traffic["batch_size"],
                       shuffle=True, seed=train.loader_seed(seed),
                       device="cpu").batch_order(0)[:train.JUDGED_STEPS]
    batches = [[samples[i] for i in sel] for sel in deal]
    side = train.reference_side(ref, config, batches, seed, device, "tf32")
    return train.judge(ref, config, batches, side, seed, device)


def readings(cell, device, traffic=None, seed: int = 5) -> dict:
    """{number: {"value", "limit"}} of the control over the pool (a
    request cell) or over the first steps of the run seed ``seed`` (a
    training cell)."""
    from benchmark.benchlib.sweep import checks
    if (traffic or cell.traffic)["kind"] == "train":
        numbers = train_numbers(cell, device, traffic, seed)
        return {k: {"value": v, "limit": cell.config["limits"][k]}
                for k, v in numbers.items()}
    return checks(reference_module(cell.config), cell.config,
                  judged(cell, device, traffic))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("workload")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=5)
    args = p.parse_args(argv)
    checks = readings(load_cell(args.workload), args.device, seed=args.seed)
    failed = [k for k, c in checks.items() if not c["value"] <= c["limit"]]
    print(json.dumps({"workload": args.workload, "checks": checks,
                      "control_failed": failed}))
    return 0 if failed else 1


if __name__ == "__main__":
    sys.exit(main())
