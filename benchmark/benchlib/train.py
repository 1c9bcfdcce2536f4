"""The training loop: one process training Ψ-GNN on from the checkpoint,
one step after another, as the program's trainer does with ``--pallas
--cache_batches 1``.

Set-up loads the configuration's model through the program's entry
(``eval.run_eval.load_predictor``), makes fresh optimizers
(``train.optim.make_optimizers``), draws the mix's pool of mesh-order
samples with the frozen generator and hands it to the program's loader
(``data.reader.GraphLoader`` with ``rcm`` and ``cache_batches``: each
sample put in RCM order, the batches built once on the card, dealt by the
seed, and each later pass in an order drawn from it).  Set-up then runs
the first pass over the batches through the window's own step
(``train.step.train_step``), every batch shape once.  During its first
three steps only, a forward pre-hook on the module the configuration
names (``train_capture``: f_θ) keeps on the card the input of the step's
first tracked call, which is the step's fixed point h*, and the
parameters at each step's start are copied to the host; the hook is gone
before the window.  After the window the plain reference follows those
three steps at the program's h*, solving no forward fixed point itself,
and measures each h*'s residual under the parameters of its step.  The
window runs step after step until ``seconds`` have passed, and the step
in flight then completes and closes it.  A step is timed on the host
clock from its call to its loss on the host.  With ``trace``, two steps about a third into
the window are profiled (device activity only).
"""

from __future__ import annotations

import gc
import os
import sys
import time
import traceback
from typing import Dict, List

import torch

from . import devtrace, pool
from .record import Run, Step

PROFILED_STEPS = 2
JUDGED_STEPS = 3
NUMBERS = ("train_residual", "first_loss_gap", "grad_gap", "change_gap")


def leaf_name(name: str) -> str:
    """A ``Psignn`` parameter name as the checkpoint's parameter-tree
    path, the reference's leaf name."""
    parts = name.split(".")
    kind = {"weight": "w", "bias": "b"}[parts[-1]]
    if parts[0] in ("encoder", "decoder"):
        return f"autoencoder/{parts[0]}/{parts[2]}/{kind}"
    if parts[1] == "laynorm":
        return "function/laynorm/" + ("scale" if kind == "w" else "bias")
    if parts[1] == "alpha":
        return f"function/alpha/{kind}"
    return f"function/layers/{parts[2]}/{parts[3]}/{parts[5]}/{kind}"


def reference_leaves(model) -> Dict[str, torch.Tensor]:
    """The model's parameters on the host by reference leaf, in the
    checkpoint's layout (a linear layer's weight (in, out))."""
    return {leaf_name(n): (p.detach().T if leaf_name(n).endswith("/w")
                           else p.detach()).cpu().clone()
            for n, p in model.named_parameters()}


def loader_seed(seed: int) -> int:
    """The loader's shuffle seed (numpy's RandomState takes seed + pass
    below 2**32)."""
    return int(seed) % (2 ** 32 - 2 ** 20)


def probe_generator(seed: int) -> torch.Generator:
    """The Hutchinson probes' generator, on the host: the program draws
    on the generator's device, so the reference draws the same."""
    g = torch.Generator()
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _first_gradient(model, opts) -> Dict[str, torch.Tensor]:
    """The (clipped) gradient the optimizers got at their first step, from
    their state: Adam's first moment is (1 − β1)·g after one step (zero
    where an optimizer kept no state)."""
    state = {}
    for opt in opts:
        beta1 = opt.param_groups[0]["betas"][0]
        for p, s in opt.state.items():
            if "exp_avg" in s:
                state[p] = s["exp_avg"] / (1.0 - beta1)
    return {leaf_name(n): state.get(p, torch.zeros_like(p)).detach().cpu()
            for n, p in model.named_parameters()}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_process: float) -> Run:
    from psignn_tpu_torch.data.reader import GraphLoader
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.kernels import fused_mp
    from psignn_tpu_torch.train.optim import make_optimizers
    from psignn_tpu_torch.train.step import train_step

    from .spec import ROOT, reference_module
    from .sweep import _check_config, _sync

    t_imported = time.perf_counter()
    dev = torch.device(device)
    config, traffic = cell.config, cell.traffic
    tcfg = config["train"]
    ref = reference_module(config)
    rec = Run(cell=cell.name, config=config, traffic=traffic, reference=ref)

    _, _, cfg, model = load_predictor(
        os.path.join(ROOT, config["checkpoint"]), dev)
    _check_config(cfg, config["model"])
    opts = make_optimizers(model, tcfg["lr_deq"], tcfg["lr_ae"])
    t_loaded = time.perf_counter()
    samples = [s["sample"] for s in pool.mesh_pool(traffic)]
    loader = GraphLoader(samples, batch_size=traffic["batch_size"],
                         shuffle=True, seed=loader_seed(seed), rcm=True,
                         cache_batches=True, device=dev)
    if len(loader) < JUDGED_STEPS:
        raise SystemExit(f"{cell.name}: a pass has {len(loader)} batches, "
                         f"the comparison follows {JUDGED_STEPS}")
    probes = probe_generator(seed)
    lrs = (tcfg["lr_deq"], tcfg["lr_ae"])
    t_pool = time.perf_counter()

    def step(graph, sel, spans=None, fw=None) -> Step:
        f0, b0 = fused_mp.LAUNCHES, fused_mp.BWD_LAUNCHES
        t0 = time.perf_counter()
        w0 = time.time_ns()
        out = train_step(model, opts, graph, cfg, lrs,
                         tcfg["gradient_clip"], tcfg["jac_weight"], probes)
        loss = float(out.loss)
        t1 = time.perf_counter()
        if spans is not None:
            spans.append(("train_step", w0, time.time_ns()))
        if fw is not None:
            fw.append((float(out.fw.lowest), int(out.fw.nstep)))
        return Step(samples=len(sel), seconds=t1 - t0, loss=loss,
                    fw_launches=fused_mp.LAUNCHES - f0,
                    bw_launches=fused_mp.BWD_LAUNCHES - b0)

    first = {"losses": [], "fw": [], "starts": []}
    kept: Dict[str, torch.Tensor] = {}
    h_stars: List[torch.Tensor] = []

    def keep_h_star(_module, args):
        if "h" not in kept and args[0].requires_grad:
            kept["h"] = args[0].detach().clone()

    hook = model.get_submodule(config["train_capture"]) \
        .register_forward_pre_hook(keep_h_star)
    for k, (graph, sel) in enumerate(zip(loader, loader.batch_order(0))):
        if k < JUDGED_STEPS:
            first["starts"].append(reference_leaves(model))
            s = step(graph, sel, fw=first["fw"])
            first["losses"].append(s.loss)
            if "h" in kept:
                h_stars.append(kept.pop("h"))
        else:
            s = step(graph, sel)
        if k == 0:
            first["grad"] = _first_gradient(model, opts)
        if k == JUDGED_STEPS - 1:
            hook.remove()
            first["change"] = {
                k: p - first["starts"][0][k]
                for k, p in reference_leaves(model).items()}
    _sync(dev)
    print(f"benchmark: set-up: start and imports "
          f"{t_imported - t_process:.3f} s, checkpoint "
          f"{t_loaded - t_imported:.3f} s, pool and batches "
          f"{t_pool - t_loaded:.3f} s, first pass "
          f"{time.perf_counter() - t_pool:.3f} s", file=sys.stderr)

    slice_ = devtrace.Slice(dev) if trace else None
    profiled = 0
    t_start = time.perf_counter()
    rec.setup_s = t_start - t_process
    epoch = 1
    done = False
    while not done:
        for graph, sel in zip(loader, loader.batch_order(epoch)):
            if time.perf_counter() - t_start >= seconds:
                done = True
                break
            if slice_ is not None and slice_.prof is None and \
                    time.perf_counter() - t_start >= seconds / 3:
                slice_.start()
            in_slice = slice_ is not None and slice_.prof is not None \
                and profiled < PROFILED_STEPS
            try:
                s = step(graph, sel, slice_.spans if in_slice else None)
            except Exception:                  # a step that fails
                traceback.print_exc()
                rec.failed += 1
                continue
            s.profiled = in_slice
            rec.steps.append(s)
            if in_slice:
                profiled += 1
                if profiled == PROFILED_STEPS:
                    slice_.stop()
        epoch += 1
    rec.window_s = time.perf_counter() - t_start
    if slice_ is not None and slice_.prof is not None:
        if slice_.window_s == 0.0:
            slice_.stop()
        rec.trace = slice_.summary()
    if dev.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    judged_batches = [[samples[i] for i in sel]
                      for sel in loader.batch_order(0)[:JUDGED_STEPS]]
    first["h_stars"] = [h.cpu() for h in h_stars]
    del model, opts, loader, h_stars
    graph = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    steps: Dict[str, list] = {}
    rec.judged = [judge(ref, config, judged_batches, first, seed, dev,
                        steps), steps]
    rec.checks = {k: {"value": float(v),
                      "limit": float(config["limits"][k])}
                  for k, v in rec.judged[0].items()}
    return rec


def reference_side(ref, config: dict, batches: List[list], seed: int,
                   device, precision: str = "f32", h_stars=None,
                   starts=None) -> dict:
    """The reference's first steps over ``batches`` (mesh-order samples,
    put in the loader's node order here) from the checkpoint, with the
    run's probes: at the equilibria ``h_stars`` of the side under test,
    each measured under the side's parameters ``starts`` of its step
    (``judge_steps``), or, without them, solving its own (``solve_steps``,
    the control).  Its losses, residuals, h*, parameters at each step's
    start, first gradient and change by leaf."""
    from benchmark.reference.common import read_checkpoint, rcm_order
    from .spec import ROOT
    params = read_checkpoint(os.path.join(ROOT, config["checkpoint"]))
    model = ref.Model(params["params"], device, precision)
    g = probe_generator(seed)
    args = ([ref.Batch([rcm_order(s) for s in b], device) for b in batches],
            lambda _t, shape: torch.randn(shape, generator=g).to(device),
            config["model"], config["train"])
    out = (ref.solve_steps(model, *args) if h_stars is None
           else ref.judge_steps(model, args[0], h_stars, starts,
                                *args[1:]))
    return dict(losses=out["losses"], residuals=out["residuals"],
                h_stars=[z.cpu() for z in out["h_stars"]],
                starts=[{k: v.cpu() for k, v in p.items()}
                        for p in out["starts"]],
                grad={k: v.cpu() for k, v in out["grad"].items()},
                change={k: (out["after"][k] - out["before"][k]).cpu()
                        for k in out["after"]})


def judge(ref, config: dict, batches: List[list], side: dict, seed: int,
          device, steps: dict = None) -> Dict[str, float]:
    """The numbers of the side under test (the program's first steps, or
    the control's) against the reference's at the side's own h* of each
    step, in ``FixedOrder``; ``steps``, where given, gets each judged
    step's losses and residuals.  A side that handed no h* of a judged
    step, or one of another size than its batch, has no equilibrium of
    that batch to judge: every number reads infinite."""
    from benchmark.reference.common import FixedOrder, no_tf32
    no_tf32()
    latent = config["model"]["latent_dim"]
    shapes = [(sum(int(s["x"].shape[0]) for s in b), latent)
              for b in batches]
    handed = [tuple(h.shape) for h in side["h_stars"]]
    if handed != shapes:
        print(f"benchmark: judged steps: h* of shapes {handed}, the "
              f"batches' {shapes}", file=sys.stderr)
        return dict.fromkeys(NUMBERS, float("inf"))
    t0 = time.perf_counter()
    with FixedOrder():
        other = reference_side(ref, config, batches, seed, device,
                               h_stars=side["h_stars"],
                               starts=side["starts"])
    numbers = ref.train_numbers(side, other)
    if steps is not None:
        steps.update(losses=side["losses"], ref_losses=other["losses"],
                     residuals=other["residuals"], fw=side.get("fw"))
    print(f"benchmark: judged steps in {time.perf_counter() - t0:.3f} s: "
          f"losses {side['losses']!r}, the "
          f"reference's {other['losses']!r}; residuals "
          f"{other['residuals']!r}"
          + (f", the program's {side['fw']!r}" if "fw" in side else ""),
          file=sys.stderr)
    print("benchmark: judged steps: " + ", ".join(
        f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
    return numbers
