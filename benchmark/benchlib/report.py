"""The run's result line, and the check that no JAX was loaded."""

from __future__ import annotations

import json
import math
import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "psignn_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, one of ``FORBIDDEN``: ``psignn_tpu_torch`` is not
    ``psignn_tpu``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def result(cell, run, trace: bool, device_name: str) -> dict:
    from .spec import metric_values
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct,
           "attempted": len(run.requests) + len(run.steps) + run.failed,
           "failed": run.failed,
           "metrics": metric_values(cell, run, trace),
           "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        ops = sorted(run.trace.by_name.items(), key=lambda kv: -kv[1][0])
        out["breakdown"] = {
            "device_ops": [[name, sec] for name, (sec, _) in ops[:10]],
            "idle_gaps": [[label, sec] for label, sec in run.trace.gaps[:10]]}
    out["checks"] = run.checks
    return out


def _finite(obj):
    """The line as strict JSON: a number that is not finite (a check that
    read NaN) is written as its name."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def emit(cell, run, trace: bool, device_name: str) -> None:
    """Counts on an earlier line, the result as the last line of standard
    output, each compared number beside its limit as the last lines of
    standard error."""
    done = (f"{len(run.steps)} steps" if run.steps
            else f"{len(run.requests)} requests")
    print(f"benchmark: {cell.name}: {done} in {run.window_s:.3f} s, "
          f"{run.failed} failed, set-up {run.setup_s:.3f} s")
    line = json.dumps(_finite(result(cell, run, trace, device_name)),
                      allow_nan=False)
    sys.stdout.flush()
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(line)
    sys.stdout.flush()
