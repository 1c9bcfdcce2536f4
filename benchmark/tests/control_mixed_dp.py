"""The control of the mixed sweep's and the data-parallel training cell's
comparisons: the plain reference put in the program's place and computed
in TF32 (every matmul's operands rounded to a 10-bit mantissa, the
nearest precision below the configurations' float32 with TF32 off),
judged as the program's answers are.  It has to come out as not correct.

    python3 benchmark/tests/control_mixed_dp.py psignn_mixed.sweep --device cuda

prints, for the mixed cell's whole pool (or the data-parallel cell's
first steps on the batches of ``--seed``, each rank's shard solved by the
reference itself), each number beside its limit and whether the control
failed one (exit 0 when it did).  The data-parallel control needs no
ranks: the reference follows every shard in one process.
``test_control_mixed_dp.py`` runs it on small pools on the CPU.
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

from benchmark.benchlib.spec import load_cell, reference_module  # noqa: E402
from benchmark.reference.common import no_tf32, read_checkpoint  # noqa: E402


def mixed_judged(cell, device) -> list:
    """Each pool mesh's numbers, the control answering it."""
    from benchmark.benchlib import gen_mixed
    from benchmark.benchlib.sweep import judge_requests
    no_tf32()
    config = cell.config
    ref = reference_module(config)
    samples = gen_mixed.mesh_pool(cell.traffic)
    params = read_checkpoint(os.path.join(ROOT, config["checkpoint"]))
    low = ref.Model(params["params"], device, precision="tf32")
    m = config["model"]
    answers = {}
    for i, s in enumerate(samples):
        z, u, res = ref.solve(low, s["sample"], m["fw_tol"], m["fw_thres"])
        answers[i] = dict(z=z, u=u, reported=res)
    return judge_requests(ref, config, samples, answers, device)


def dp_numbers(cell, device, seed: int = 5) -> dict:
    """The numbers of the reference's data-parallel first steps in TF32
    in the program's place, on the batches the run seed deals first,
    each rank's shard solved by the reference itself."""
    from psignn_tpu_torch.data.reader import GraphLoader
    from benchmark.benchlib import pool, train_dp
    from benchmark.reference import psignn_dp
    no_tf32()
    config, traffic = cell.config, cell.traffic
    ranks, bs = int(traffic["ranks"]), traffic["batch_size"]
    samples = [s["sample"] for s in pool.mesh_pool(traffic)]
    deal = GraphLoader(samples, batch_size=bs, shuffle=True,
                       seed=train_dp.loader_seed(seed), device="cpu"
                       ).batch_order(0)[:train_dp.JUDGED_STEPS]
    batches = [[samples[i] for i in sel] for sel in deal]
    dealt = [psignn_dp.deal(b, bs, ranks) for b in batches]
    side = train_dp.reference_side(config, dealt, seed, device, "tf32")
    return train_dp.judge(config, batches, side, seed, ranks, device)


def readings(cell, device, seed: int = 5) -> dict:
    """{number: {"value", "limit"}} of the control."""
    from benchmark.benchlib.sweep import checks
    if cell.traffic["kind"] == "train_dp":
        return {k: {"value": v, "limit": cell.config["limits"][k]}
                for k, v in dp_numbers(cell, device, seed).items()}
    return checks(reference_module(cell.config), cell.config,
                  mixed_judged(cell, device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("workload")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=5)
    args = p.parse_args(argv)
    checks = readings(load_cell(args.workload), args.device, args.seed)
    failed = [k for k, c in checks.items() if not c["value"] <= c["limit"]]
    print(json.dumps({"workload": args.workload, "checks": checks,
                      "control_failed": failed}))
    return 0 if failed else 1


if __name__ == "__main__":
    sys.exit(main())
