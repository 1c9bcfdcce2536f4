"""A cell as ``BENCHMARK.json`` and the benchmark's data files define it.

Everything is found by name: the cell's configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
each metric's reader in ``metrics/<metric>.py`` and the configuration's
plain reference in ``reference/<reference>.py``.  A later cell, mix or
metric is a new file and a new entry, with no edit here.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]      # the cell's end-to-end metrics
    per_layer: List[dict]       # the cell's per-layer metrics


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: str = None) -> Cell:
    with open(bench_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def metric_reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``: the metric's value, or None
    where the run holds nothing to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_module(config: dict):
    return importlib.import_module("benchmark.reference."
                                   + config["reference"])


def loop_module(traffic: dict):
    """The loop that drives a mix of this kind (``benchlib/<kind>.py``)."""
    return importlib.import_module("benchmark.benchlib." + traffic["kind"])


def metric_values(cell: Cell, run, trace: bool) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the cell's metrics of this run's kind
    that found something to read."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
