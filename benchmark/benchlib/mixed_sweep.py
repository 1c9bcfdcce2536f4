"""The request loop of the mixed sweep: one client solving fresh mixed
Dirichlet–Neumann meshes, closed loop.

As ``sweep.py``'s loop, on a pool of mixed meshes (``gen_mixed``): set-up
builds the pool, loads the configuration's predictor through the
program's own entry (``eval.run_eval.load_predictor``) and sends every
pool mesh through the request path once; the window then sends requests
back to back, a fresh permutation of the pool each cycle from the seed
(``pool.request_order``), until ``seconds`` have passed, and the request
in flight then closes it.  A request is timed on the host clock from the
hand-over of its mesh-order sample (normals included) to ``u`` on the
host in mesh order: the program's node order (``dist.partition.
rcm_ordered``), its graph build and copy (``graphs.batch_graphs``), the
predictor, and ``u`` put back in mesh order.  Each request also keeps the
change of the program's count of f_θ evaluations (``models.psignn.
F_CALLS``) across its predictor, or None where the program has no such
count.  Every pool mesh's last request is judged against the plain
reference after the window (``sweep.judge_requests``).  With ``trace``,
one cycle of the pool about a third into the window is profiled.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from . import devtrace, gen_mixed
from .pool import request_order
from .record import Request, Run
from .sweep import _check_config, _per_radius, _sync, checks, judge_requests


@dataclasses.dataclass
class CountedRequest(Request):
    """A request with the f_θ evaluations the program counted in it."""
    f_calls: Optional[int] = None


def _f_calls() -> Optional[int]:
    from psignn_tpu_torch.models import psignn
    return getattr(psignn, "F_CALLS", None)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_process: float) -> Run:
    """One run of a mixed request cell."""
    from psignn_tpu_torch.dist import partition
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.graphs import batch_graphs
    from psignn_tpu_torch.kernels import fused_mp

    from .spec import ROOT, reference_module

    t_imported = time.perf_counter()
    dev = torch.device(device)
    config, traffic = cell.config, cell.traffic
    ref = reference_module(config)
    rec = Run(cell=cell.name, config=config, traffic=traffic, reference=ref)

    predict, _, cfg, model = load_predictor(
        os.path.join(ROOT, config["checkpoint"]), dev)
    _check_config(cfg, config["model"])
    t_loaded = time.perf_counter()
    samples = gen_mixed.mesh_pool(traffic)
    order = request_order(len(samples), seed)
    for s in samples:           # the node order comes back as node_id
        s["handed"] = dict(s["sample"], node_id=np.arange(s["n"]))
    t_pool = time.perf_counter()

    captured: Dict[str, torch.Tensor] = {}

    def keep_input(_module, args):
        captured["z"] = args[0]

    hook = model.get_submodule(config["capture"]).register_forward_pre_hook(
        keep_input)
    last: Dict[int, dict] = {}

    def request(i: int, spans=None) -> CountedRequest:
        s = samples[i]
        t0 = time.perf_counter()
        w0 = time.time_ns()
        ordered = partition.rcm_ordered(s["handed"])
        perm = ordered["node_id"]
        graph = batch_graphs([ordered], device=dev)
        t1 = time.perf_counter()
        w1 = time.time_ns()
        f0, c0 = fused_mp.LAUNCHES, _f_calls()
        out = predict(graph)
        u = np.empty(s["n"], np.float32)
        u[perm] = out.u[:, 0].cpu().numpy()
        t2 = time.perf_counter()
        c1 = _f_calls()
        if spans is not None:
            w2 = time.time_ns()
            spans.append((f"graph_build r={s['radius']}", w0, w1))
            spans.append((f"solve r={s['radius']}", w1, w2))
        last[i] = dict(u=u, perm=perm, z=captured.pop("z", None),
                       reported=float(out.lowest))
        return CountedRequest(
            mesh=i, n=s["n"], e=s["e"], seconds=t2 - t0, graph_s=t1 - t0,
            fw_launches=fused_mp.LAUNCHES - f0,
            f_calls=None if c0 is None else c1 - c0)

    for i in range(len(samples)):           # warm-up: every pool mesh
        request(i)
    _sync(dev)
    print(f"benchmark: set-up: start and imports "
          f"{t_imported - t_process:.3f} s, checkpoint "
          f"{t_loaded - t_imported:.3f} s, pool {t_pool - t_loaded:.3f} s, "
          f"warm-up {time.perf_counter() - t_pool:.3f} s", file=sys.stderr)

    cycle = len(samples)
    slice_ = devtrace.Slice(dev) if trace else None
    slice_at = None
    t_start = time.perf_counter()
    rec.setup_s = t_start - t_process
    k = 0
    while time.perf_counter() - t_start < seconds:
        i = order(k)
        if slice_ is not None and slice_at is None and \
                time.perf_counter() - t_start >= seconds / 3:
            slice_at = k
            slice_.start()
        in_slice = slice_at is not None and k < slice_at + cycle
        try:
            r = request(i, slice_.spans if in_slice else None)
        except Exception:                      # a request that fails
            traceback.print_exc()
            rec.failed += 1
            k += 1
            continue
        r.profiled = in_slice
        rec.requests.append(r)
        if in_slice and k == slice_at + cycle - 1:
            slice_.stop()
        k += 1
    rec.window_s = time.perf_counter() - t_start
    _per_radius(rec, samples)
    if slice_ is not None and slice_at is not None:
        if slice_.prof is not None and slice_.window_s == 0.0:
            slice_.stop()
        rec.trace = slice_.summary()
        rec.profiled = [r for r in rec.requests if r.profiled]

    if dev.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    answers = {}
    for i, a in last.items():
        z = a.pop("z")
        zm = np.empty((samples[i]["n"], z.shape[1]), np.float32)
        zm[a["perm"]] = z.detach().cpu().numpy()
        a["z"] = zm
        answers[i] = a
    hook.remove()
    del predict, model, captured, last
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rec.judged = judge_requests(ref, config, samples, answers, dev)
    rec.checks = checks(ref, config, rec.judged)
    return rec
