"""The request loop: one client solving fresh meshes, closed loop.

Set-up builds the mix's pool of mesh-order samples with the frozen
generator, loads the configuration's predictor through the program's own
entry (``eval.run_eval.load_predictor``) and sends every pool mesh
through the request path once.  The window then sends requests back to
back, cycling through a permutation of the pool drawn from the seed each
cycle, until ``seconds`` have passed; the request in flight at that
moment completes and closes the window.  A request, timed on the host
clock from the hand-over of its sample to its answer on the host:

* the program's node order (RCM, as ``run_eval --sweep`` takes it on a
  card: ``dist.partition.rcm_ordered``), its graph build and the copy to
  the card (``graphs.batch_graphs``);
* the predictor;
* ``u`` copied to the host and put back in mesh order.

Every pool mesh's last request of the window is judged against the plain
reference after the window has closed and the program's state is freed.
With ``trace``, one cycle of the pool about a third into the window is
profiled (device activity only).
"""

from __future__ import annotations

import gc
import os
import sys
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from . import devtrace, pool
from .record import Request, Run


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_config(cfg, model_cfg: dict) -> None:
    """The checkpoint must run as the configuration states."""
    for key, want in model_cfg.items():
        have = getattr(cfg, key)
        if have != want:
            raise SystemExit(f"the checkpoint's {key} is {have!r}, the "
                             f"configuration states {want!r}")


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, predictor=None) -> Run:
    """One run of a request cell.  ``predictor`` replaces the program's
    (tests plant faults through it)."""
    from psignn_tpu_torch.dist.partition import rcm_ordered
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
    if predictor is not None:
        predict = predictor(predict, model)
    t_loaded = time.perf_counter()
    samples = pool.mesh_pool(traffic)
    order = pool.request_order(len(samples), seed)
    for s in samples:           # the node order comes back as node_id
        s["handed"] = dict(s["sample"], node_id=np.arange(s["n"]))
    t_pool = time.perf_counter()

    captured: Dict[str, torch.Tensor] = {}
    hook = None
    if config.get("capture"):
        def keep_input(_module, args):
            captured["z"] = args[0]
        hook = model.get_submodule(config["capture"]).register_forward_pre_hook(
            keep_input)

    last: Dict[int, dict] = {}

    def request(i: int, spans=None) -> Request:
        s = samples[i]
        t0 = time.perf_counter()
        w0 = time.time_ns()
        ordered = rcm_ordered(s["handed"])
        perm = ordered["node_id"]
        graph = batch_graphs([ordered], device=dev)
        t1 = time.perf_counter()
        w1 = time.time_ns()
        f0 = fused_mp.LAUNCHES
        out = predict(graph)
        u_dev = out[0] if isinstance(out, tuple) else out
        u = np.empty(s["n"], np.float32)
        u[perm] = u_dev[:, 0].cpu().numpy()
        t2 = time.perf_counter()
        if spans is not None:
            w2 = time.time_ns()
            spans.append((f"graph_build r={s['radius']}", w0, w1))
            spans.append((f"solve r={s['radius']}", w1, w2))
        last[i] = dict(u=u, perm=perm, z=captured.pop("z", None),
                       reported=(float(out[2]) if isinstance(out, tuple)
                                 else None))
        return Request(mesh=i, n=s["n"], e=s["e"], seconds=t2 - t0,
                       graph_s=t1 - t0,
                       fw_launches=fused_mp.LAUNCHES - f0)

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
        if z is not None:
            zm = np.empty((samples[i]["n"], z.shape[1]), np.float32)
            zm[a["perm"]] = z.detach().cpu().numpy()
            a["z"] = zm
        answers[i] = a
    if hook is not None:
        hook.remove()
    del predict, model, captured, last
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rec.judged = judge_requests(ref, config, samples, answers, dev)
    rec.checks = checks(ref, config, rec.judged)
    return rec


def _per_radius(rec: Run, samples: List[dict]) -> None:
    """Standard error: each radius's request count and its median, 95th
    percentile and largest latency, and median graph span (ms)."""
    by: Dict[float, list] = {}
    for r in rec.requests:
        by.setdefault(samples[r.mesh]["radius"], []).append(r)
    for radius, reqs in sorted(by.items()):
        t = np.array([r.seconds for r in reqs]) * 1e3
        g = np.array([r.graph_s for r in reqs]) * 1e3
        print(f"benchmark: radius {radius}: {len(reqs)} requests, ms "
              f"p50 {np.median(t):.2f} p95 {np.percentile(t, 95):.2f} "
              f"max {t.max():.2f}, graph p50 {np.median(g):.2f}",
              file=sys.stderr)


def judge_requests(ref, config: dict, samples: List[dict],
                   answers: Dict[int, dict], dev) -> List[dict]:
    """Each judged request's numbers by the configuration's reference, in
    pool order, with its pool index and radius; one line each on
    standard error."""
    from benchmark.reference.common import no_tf32, read_checkpoint
    from .spec import ROOT

    no_tf32()
    params = read_checkpoint(os.path.join(ROOT, config["checkpoint"]))
    model = ref.Model(params["params"], dev)
    out = []
    for i in sorted(answers):
        nums = ref.judge(model, samples[i]["sample"], answers[i],
                         config["model"])
        print(f"benchmark: judged mesh {i} (radius {samples[i]['radius']}, "
              f"{samples[i]['n']} nodes): " + ", ".join(
                  f"{k} {v!r}" for k, v in nums.items()), file=sys.stderr)
        out.append(dict(nums, mesh=i, radius=samples[i]["radius"]))
    return out


def checks(ref, config: dict, judged: List[dict]
           ) -> Dict[str, Dict[str, float]]:
    """Each number of the cell over the judged requests (the reference's
    ``aggregate``, else the worst request's), beside its limit."""
    per_request = [{k: v for k, v in r.items() if k not in ("mesh", "radius")}
                   for r in judged]
    if hasattr(ref, "aggregate"):
        numbers = ref.aggregate(per_request, config)
    else:                                   # the worst request's, NaN first
        numbers = {k: max((r[k] for r in per_request),
                          key=lambda v: (np.isnan(v), v))
                   for k in per_request[0]}
    return {k: {"value": float(v), "limit": float(config["limits"][k])}
            for k, v in numbers.items()}
