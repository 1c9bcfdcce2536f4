"""Benchmark of the PyTorch and CUDA port, ``psignn_tpu_torch``: one run of
one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload psignn_dirichlet.sweep \\
        --seed 12345 --seconds 30 --trace 0

Run from the root of a checkout, on a machine with the cards the cell
asks for.  With ``--trace 0`` the last line of standard output is the
result with the cell's end-to-end metrics; with ``--trace 1`` a slice of
the window is profiled and the line holds its per-layer metrics, the
device's busy time and a breakdown.  Either way the window's answers are
judged against the plain reference in ``benchmark/reference/`` after the
window has closed, and each number compared is printed beside its limit,
in the result and as the last lines of standard error.  Without a card,
or with fewer than the cell asks for, the run exits with code 2 and
prints no result; a run that finds JAX or the JAX package loaded exits
with code 3 and prints none.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                  "torch_extensions")
# one client on one host thread: idle worker threads of a larger pool
# slowed the host-bound requests by 10-20 % and made runs spread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.benchlib import report  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.benchlib.spec import load_cell, loop_module
    cell = load_cell(args.workload)
    try:
        import psignn_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 1
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    run = loop_module(cell.traffic).run(
        cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
        T_PROCESS)
    loaded = report.forbidden_modules()
    if loaded:
        print(f"benchmark: loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    report.emit(cell, run, bool(args.trace), torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
