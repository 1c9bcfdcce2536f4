#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``psignn_tpu_torch``) on one GPU.

    python3 chip_smoke.py               # the phases below, on one card

NCCL across several cards is the dry run's:
``python -m psignn_tpu_torch.dist.dryrun --num_devices N --device cuda``.

Phases, each printing one JSON line:

1. device     — a CUDA device is required; its name, count, power limit.
2. build      — compile the three CUDA kernels (forward, backward, JVP)
                from ``psignn_tpu_torch/kernels/csrc``, one ``nvcc`` each,
                in parallel.
3. native     — the port's host runtime, ``psignn_tpu_torch/native.py``:
                its library built from ``kernels/csrc/psignncore.cpp``
                with the host's C++ compiler (build seconds, the CPU
                model), then its five functions on the headline mesh,
                held without JAX to the port's scipy/numpy path:
                assembly and load vector against ``data.fem.assemble_p1``
                to 1e-12, CG against ``spsolve`` to rtol 1e-7, RCM as a
                permutation with a bandwidth below n/4 beside
                ``dist.partition.rcm_permutation``'s, and the edge-block
                packing of the RCM-ordered mesh (each edge placed once,
                ``need`` ≤ ``e_cap``, ``win_start`` non-decreasing, every
                edge inside its block's window); each function's host
                seconds beside its counterpart's.
4. kernel     — the forward fused message-passing kernel against its
                plain PyTorch version on the card, both directions, on the
                radius-5 headline mesh at edge_dim 3 and 1, on the train
                step's 50-mesh batch, on the mixed train batch's ``from``
                packing (the Neumann branch's) and on both packings of the
                50-mesh batch's DSS form (A′, edge_dim 1): max error,
                bit-identical relaunch, per-call times (CUDA events, and
                the device time of every kernel the call launched), the
                bound.  Then, checked but not timed: width 20, two small
                ragged graphs and a CSR with no edges.
5. kernel_bwd — the same for the backward kernel (the VJP), against
                ``mp_vjp_from_csr``, every output.
6. slice      — inference as a user runs it: the trained Ψ-GNN checkpoint
                through ``eval.run_eval.load_predictor`` and
                ``eval.sweep.growing_geometry_sweep`` on one mesh at each of
                radii 1, 2 and 5, counting kernel launches; then the
                radius-1 request again on the CPU to check agreement.
7. headline   — 531 Broyden iterations (fw_tol 0) on the radius-5 mesh with
                seeded random weights: wall seconds, edge-messages/s and the
                kernel launches of each timed run (two per f_θ call).
8. bench      — the port's benchmark as a benchmark runs it: one process
                of ``python -m psignn_tpu_torch.bench`` per mode —
                inference, train, partition on 1 NCCL rank, then on 2 gloo
                ranks sharing the card — each of whose one stdout line
                must carry bench.py's keys, finite positive value, device
                time and busy share, 531 iterations over 76,353 edges and
                2 · 532 forward launches a rank (inference, partition),
                launches equal to ``expected_launches`` with one fw_nstep
                across the reps (train), and ``detail.rcm`` true
                (inference, train: bench.py's default node order).
9. train_step — the implicit-gradient train step of ``bench.py:110-200``
                through ``train.train_step``: 50 seeded radius-1 meshes in
                one batch, the trained weights, a warm-up and three timed
                steps from one starting state with their kernel launches,
                one profiled step, and a 2-mesh step on the GPU against the
                same step on the CPU.
10. mixed_eval — mixed Dirichlet+Neumann inference as a user runs it: a
                fresh seeded mixed dataset from ``data.generate``, its test
                split answered with the trained ``results/psignn_mixed``
                checkpoint through ``run_eval``'s ``load_predictor`` →
                ``split_dataset`` → ``GraphLoader`` → ``evaluate_dataset``
                (three launches per f_θ call); then the same batch on the
                CPU.
11. mixed_train_step — the train step of phase 9 on 50 seeded mixed
                meshes with the mixed weights, and its 2-mesh GPU-vs-CPU
                step.
12. solvers   — the radius-1 sweep mesh solved with the trained Dirichlet
                weights by ``forward_iteration``, ``anderson`` and
                Broyden with its line search, each against the CPU.
13. newton    — Newton and Newton-Krylov: the JVP kernel against its
                plain version at every Ψ-GNN-width case of phase 4 (timed
                at the headline mesh and the 50-mesh batch, both
                directions); Newton-Krylov requests of the trained
                Dirichlet Ψ-GNN on the radius-1 and radius-5 sweep meshes
                (launches: two forward per f_θ call, two JVP per call on
                dual tensors), held to the card's Broyden answers and the
                CPU's Newton-Krylov answers; dense Newton on a coarse blob,
                card vs CPU; a 2-mesh Newton-Krylov train step (launches by
                ``expected_launches``, JVP launches two per forward JVP),
                card vs CPU; one ``cli.main --solver newton_krylov`` epoch
                resumed from the trained checkpoint and a request from
                its final checkpoint; a reference
                ``state_dict`` through ``compat`` against the
                ``weights.py`` route.
14. families  — a sweep request of each model family as a user runs it:
                the trained Ψ-GNN, DS-GPS and DSS Dirichlet checkpoints
                through ``load_predictor`` and ``growing_geometry_sweep``
                on one mesh at each of radii 1, 2 and 5 (DS-GPS and DSS
                launch the kernel exactly 2k times a request); then the
                radius-1 request of DS-GPS and DSS on the CPU.
15. dsgps_mixed_eval — phase 10's mixed test batch answered by the trained
                ``results/dsgps_mixed`` checkpoint (3k launches), then on
                the CPU.
16. unrolled_train_step — ``train.unrolled_train_step`` of DSS (the
                50-mesh batch's A′ form), DS-GPS (the 50-mesh batch) and
                mixed DS-GPS (the mixed 50-mesh batch) from their trained
                weights: a warm-up that also creates Adam's state, three
                timed steps from the same parameters with 2k (mixed 3k)
                forward and backward launches each, one profiled step,
                and a 2-mesh step on the GPU against the CPU.
17. stacked_train_step — phase 9's step with one DEQ solve per mesh
                (``--stacked_batch``): each mesh's forward steps, launches,
                seconds, busy share; then its 2-mesh GPU-vs-CPU step.
18. lowrank   — phase 7's loop with Broyden's rank memory capped at 640
                (never wraps: bit-identical to full memory) and 128 (wraps
                from step 129), each with f32 and bfloat16 pairs: wall;
                device time and the rank products' share of the cap-128
                runs; then an 8-pair ring on the radius-1 mesh on the GPU
                against the CPU.
19. zoo       — the 12 out-of-distribution shapes through ``run_eval
                --zoo``'s path with the trained Dirichlet checkpoint; then
                one shape on the CPU.
20. iterative — ``psignn_iterative_inference`` on the radius-1 sweep mesh,
                then against the CPU.
21. several_init — ``test_several_init`` (four starting points) on the
                radius-1 sweep mesh's sample, on the card and the CPU.
22. dist      — the multi-rank paths, each rank one spawned process on
                the card (one H100: several ranks share it over gloo,
                staging through the host; NCCL is checked on one rank):
                ``dist_partitioned`` (the trained Dirichlet Ψ-GNN's Picard
                request on the RCM-ordered radius-5 mesh split over 2 ranks,
                then 1 NCCL rank, against the single-process request),
                ``dist_edge_mp`` (edge-sharded message passing over 2 ranks
                against one kernel call), ``dist_train_step`` (the dp
                Ψ-GNN step on the 50-mesh batch at 2 ranks, its 2-mesh step
                on the card against the CPU, one dp DSS and one dp DS-GPS
                step, and the one-rank NCCL dp step against
                ``train_step``), ``dist_partitioned_train_step`` (dp 2 ×
                parts 2 on two RCM-ordered radius-1 meshes, the card
                against the CPU); a ``dist_world`` line says where each
                world's seconds went.
23. trainer   — training as a user runs it: a fresh Dirichlet dataset
                (with DSS's encoding) and a fresh mixed one from
                ``data.generate``, one epoch of ``cli.main`` for Ψ-GNN in
                each variant, DSS, and DS-GPS in each variant, one more
                epoch of the trained Dirichlet Ψ-GNN resumed from its JAX
                checkpoint, one ``--stacked_batch --lowrank_max_rank 128``
                epoch and one ``--num_devices 2 --device cuda:0`` epoch (two
                ranks launched as torchrun launches them, on the card
                over gloo), their logs and
                checkpoints, and one request answered from each new
                checkpoint: a sweep request (Dirichlet), the test-split
                table of ``run_eval`` (mixed).  Both loops of every epoch
                draw their batches through ``data.reader.prefetch``; the
                Ψ-GNN and DS-GPS Dirichlet epochs print their seconds
                beside their loaders' serial batch-build seconds; every
                run's ``train_metrics.csv`` parses (``eval.curves.
                parse_val``) to the values its trainer kept, and the Ψ-GNN
                Dirichlet log is compared with the JAX trainer's
                (``curves.compare``).
24. parity    — the growing-geometry parity table as ``eval.parity``
                makes it: the trained Ψ-GNN, DS-GPS (k = 100) and DSS
                (k = 30) Dirichlet checkpoints through
                ``build_predictors(source="trained")`` at fw_tol 1e-5 /
                fw_thres 1500, ``growing_geometry_sweep`` at radii 0.6, 1,
                2, 4, 5 with 10/10/5/3/3 meshes, ``write_report``: a row
                per family and radius and each family's launches; the
                reference checkpoints' skip line; then the first radius-0.6
                mesh on the card and the CPU.
25. nstep_study — ``eval.nstep_study.study`` with the trained Ψ-GNN (fw
                1e-5 / 600) on three radius-1 blob meshes and one circle
                mesh, 8 right-hand sides each; the reference checkpoint's
                skip line and the absent gmsh meshes; then the circle
                mesh's 8 right-hand sides on the card and the CPU: step
                counts printed, the first 4 iterates and the mean MSE
                held.
26. figures   — the paper figures' path, ``eval.figures`` (the JAX
                package's ``tools/make_figures.py``): the iterate traces of
                the trained Ψ-GNN (fw_thres 300) and of both DS-GPS
                checkpoints (k = 30) on fresh factory samples, on the card
                (launches: two per f_θ call; exactly 2k, mixed 3k), then on
                the CPU: the DS-GPS traces within 1e-4 · max(1, max|u|), the
                Ψ-GNN's first 4 iterates within 1e-5 and, solved to fw_tol
                1e-7, its final MSE within 1e-3.  Then the drawing modules:
                without matplotlib (the card's host has none) a drawing
                call must raise an ``ImportError`` naming it; with
                matplotlib the figures are drawn from the card's traces and
                their files checked.
27. operations — the run operations of ``scripts/torch`` as a user runs
                them: ``generate_datasets.sh`` at 3 meshes × 30 samples;
                one epoch of each of the six training protocols, its CLI
                arguments parsed from its script (the DS-GPS Dirichlet one
                through its warm start), in this process with their
                launches counted, each run's ``relaunch.cmd`` and
                ``trainer.pid`` checked; the Ψ-GNN Dirichlet protocol
                killed (SIGKILL) after its first epoch and relaunched from
                its ``relaunch.cmd``, which must resume; ``eval_trained.sh``
                on the card and on the CPU, the tables compared; the
                compute cells (those not tagged ``draw``) of
                ``notebooks/demo_torch.ipynb`` and
                ``comparatives_torch.ipynb``.
28. order     — the node orders of JAX's fused kernels (``--rcm`` /
                ``--pallas``, the bench's default) and ``--cache_batches``:
                the forward, backward and JVP kernels on the headline mesh
                and the 50-mesh train batch, each in mesh order and in
                reverse Cuthill-McKee order (``to`` and ``from``): against
                the plain version within 1e-5 · max(1, max|out|), a
                relaunch bit-identical, the RCM answer equal to the
                mesh-order one permuted; device ms a call in turns (mesh,
                RCM, RCM, mesh) beside the bound of the shapes; the
                trained Dirichlet Ψ-GNN's request on the radius-5 and
                radius-2 sweep meshes in both orders, by the carried and
                the host loop (each nstep printed; the answers, un-
                permuted, held by the first 4 iterates and, where both
                solves reached fw_tol, by residual);
                the Ψ-GNN mixed protocol's CLI (``--pallas --cache_batches
                1``) for one epoch on a fresh small mixed dataset, then
                resumed: every yielded batch a stored one, the resumed
                epoch's batches the first epoch's sample sets, every
                stored tensor bit-equal after the steps, the cache's bytes
                and ``max_memory_allocated`` once it is built, and its
                bytes reckoned for the canonical 200 × 50 dataset.
29. while_loop — the solve loop of the JAX package: Broyden and Picard
                as a carry on the card, replayed as CUDA graphs with one
                host read a chunk (``loop.run_while``), the route of every
                solve above that takes neither a line search, lanes nor
                ``reduce``/``sync``.  The headline three ways — graph
                replay, the same body stepped eagerly on the card, the
                host loop — each 531 iterations and 1,064 forward
                launches, counted and in the profile: walls, host reads,
                graphs, capture seconds, device time, busy share, memory;
                graph and eager bit-identical over the first 8 iterates
                and the answer, the host loop's first 4 iterates within
                1e-4; ``loop.CHUNK`` 4, 8, 16 and 32 on the headline and
                on the trained radius-5 request; that request at fw 1e-5
                and 1e-7 against the carried loop on the CPU, and at fw
                1e-7 / 800 against the card's host loop, by residual; a
                bench train step's launches against
                ``expected_launches``.

Every solve of phases 6-28 that the carried loop takes runs it; a CUDA
graph's replay runs no Python, so each count of launches or f_θ calls
that a check reads is one of ``loop.COUNTERS``, which a replay advances
by what its capture counted.

Then a ``seconds`` line (each phase's wall seconds; ``graphs`` builds the
headline mesh and the three 50-mesh batches), one ``{"kernels": [...]}``
line (each kernel's ``launches`` on its main path — the JVP kernel's:
the Newton-Krylov requests — and ``launches_by_path`` for every path
that launches it),
the ``nvidia-smi`` name/power-limit line, and the last line
``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero.  Imports nothing of JAX or ``psignn_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# the port itself: a copy of this script without the repo stops here,
# before it prints anything
import psignn_tpu_torch  # noqa: F401
from psignn_tpu_torch import bench, profiling
# the workloads bench.py defines, and its train step's knobs
from psignn_tpu_torch.bench import (HEADLINE_ITERS, TRAIN_CLIP,
                                    TRAIN_JAC_WEIGHT, TRAIN_LRS,
                                    TRAIN_MESHES, TRAIN_OVERRIDES,
                                    step_from, train_samples, trained_model)

CKPT = "results/psignn_dirichlet/ckpt/best_model.ckpt"
MIXED_CKPT = "results/psignn_mixed/ckpt/best_model.ckpt"
DSS_CKPT = "results/dss_dirichlet/ckpt/best_model.ckpt"
DSGPS_CKPT = "results/dsgps_dirichlet/ckpt/best_model.ckpt"
DSGPS_MIXED_CKPT = "results/dsgps_mixed/ckpt/best_model.ckpt"
# the families phase: each family's Dirichlet checkpoint
FAMILY_CKPTS = {"psignn": CKPT, "dsgps": DSGPS_CKPT, "dss": DSS_CKPT}
SWEEP_RADII = (1.0, 2.0, 5.0)
# The model's latent width, and a width above 16 for the kernels' 32-lane
# layout.
WIDTH = 10
WIDE = 20
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the f32 rate
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Kernel vs plain version: the kernel sums a row's hidden activations
# before W2 and adds deg·b2, the plain version applies W2 per edge and
# sums after — the same math in another f32 order.
KERNEL_REL_TOL = 1e-5
# Backward kernel vs plain version, each output: the same math in another
# f32 order again (per-row register sums and fixed-order tree reductions
# vs index_add_ and BLAS over the edges).
BWD_KERNEL_REL_TOL = 1e-5
# CPU agreement of the radius-1 request.  At a reachable fw_tol the stopping
# step comes before f32 reduction-order differences grow (Broyden near its
# plateau is chaotic: the JAX package and the port, both on the CPU, stop at
# 58 and 63 steps on this mesh at fw_tol 1e-5), so nstep and lowest are
# compared there; at the checkpoint's fw_tol the physics residual is.
REACHABLE_TOL = 1e-3
NSTEP_SLACK = 2
LOWEST_REL_TOL = 0.05
RES_REL_TOL = 0.01
# GPU vs CPU step on 2 meshes.  Near its f32 floor Broyden is chaotic
# under f32 summation order, so the two stop at other steps; and the
# iteration contracts slowly, so (I - J)^-1 amplifies a solve's stopping
# residual into the loss and the gradient.  Both solves therefore run to
# their f32 floor (relative residual ~1e-7) and the answers are compared,
# not the step counts: 1e-3 on each loss entry and 5e-3 on each
# parameter's gradient, as a relative norm.
CMP_MESHES = 2
CMP_OVERRIDES = dict(fw_tol=1e-7, fw_thres=800, bw_tol=1e-8, bw_thres=800)
CMP_LOSS_RTOL = 1e-3
CMP_GRAD_RTOL = 5e-3
# mixed_eval's fresh dataset: 10 radius-1 mixed meshes × 5 samples, split
# 30/10/10; the 10 test samples are one batch
MIXED_EVAL_DATA = dict(n_mesh=10, n_samples=5, radius=1.0, hsize=0.08,
                       seed=11)
# Broyden on that batch turns chaotic under f32 summation order from about
# step 35, before it reaches REACHABLE_TOL (the CPU alone at 1, 2, 4 and 8
# threads stops at 1e-3 with lowest values up to 40 % apart).  At 5e-3 every
# thread count stops at step 29 with lowest values within 0.3 %, and step
# 28 lies 15 % above it: the batch's nstep and lowest are compared there.
MIXED_REACHABLE_TOL = 5e-3
# the trainer phase: (family, variant, extra CLI flags) of each CLI epoch;
# "--resume" continues the JAX checkpoint CKPT (its optax Adam state) for
# one more epoch
TRAINER_RUNS = (("psignn", "dirichlet", ()), ("psignn", "mixed", ()),
                ("dss", "dirichlet", ()), ("dsgps", "dirichlet", ()),
                ("dsgps", "mixed", ()),
                ("psignn", "dirichlet", ("--resume", CKPT)),
                ("psignn", "dirichlet", ("--stacked_batch",
                                         "--lowrank_max_rank", "128")),
                ("psignn", "dirichlet", ("--num_devices", "2", "--device",
                                         "cuda:0")))
# trainer runs whose epoch seconds are printed beside their loaders'
# serial batch-build seconds (both loops draw through ``prefetch``)
TRAINER_PREFETCH_RUNS = ("psignn_dirichlet", "dsgps_dirichlet")
# the run whose log ``curves.compare`` holds against the JAX trainer's
TRAINER_CURVES_RUN = "psignn_dirichlet"
TRAINER_CURVES_REF = "results/psignn_dirichlet/logs/train_metrics.csv"
# the solvers phase: (solver, Armijo line search)
SOLVER_CASES = (("forward_iteration", False), ("anderson", False),
                ("broyden", True))
# DSS and DS-GPS unroll k fixed steps with no stopping test, so the card
# and the CPU run the same arithmetic in other f32 summation orders (the
# kernels' against index_add_ and BLAS): u within 1e-4 of max(1, max|u|)
# after k = 30 steps, and the physics residual within RES_REL_TOL.
UNROLLED_U_TOL = 1e-4
# unrolled_train_step: (phase case, checkpoint, sample form, variant, lr)
# with the recorded learning rates (results/dss_dirichlet/logs/
# model_config.csv; results/dsgps_*/relaunch.cmd) and clip 0.01
UNROLLED_CASES = (("dss", DSS_CKPT, "dss", "dirichlet", 0.01),
                  ("dsgps", DSGPS_CKPT, "psignn", "dirichlet", 1e-3),
                  ("dsgps_mixed", DSGPS_MIXED_CKPT, "psignn", "mixed", 1e-3))
UNROLLED_CLIP = 0.01
# GPU vs CPU unrolled step on 2 meshes, backpropagated through k = 30
# steps with f32 sums in other orders.  On the CPU, f32 against f64 moves
# these losses by up to 5e-5 (relative) and DS-GPS's gradients by up to
# 1.2e-2 of the step's whole gradient norm (``correction``'s first
# weight; its autoencoder gradients by 11 % of their own small norms):
# tools/torch_unrolled_rounding.py.  So each loss is held within 1e-3
# (relative), and each parameter's gradient within 1e-2 of the step's
# whole gradient norm, about f32's own distance from f64 on this step.
UNROLLED_LOSS_RTOL = 1e-3
UNROLLED_GRAD_TOL = 1e-2
# The newton phase.  Newton-Krylov requests of the trained Dirichlet Ψ-GNN
# on the sweep's radius-1 and radius-5 meshes at the checkpoint's fw_tol.
# They are held to the card's Broyden answers by the physics residual of
# the decoded answer, within NEWTON_BROYDEN_RTOL: at radius 5 Broyden
# stalls within its 500 steps, at a best residual that f32 summation order
# moves between 3e-5 and 2e-4 (its u 4 % from Newton-Krylov's, its
# physics residual 0.45–1.1 % from it, on the card and on the CPU), so u
# itself is not comparable there.  Against the CPU's Newton-Krylov, the
# same solver in other f32 orders, by the residual and by u within a
# tolerance of max(1, max|u|), at a tolerance each mesh reaches in a few
# seconds on the CPU: the checkpoint's fw_tol at radius 1 (4 steps, u
# within NEWTON_U_TOL), REACHABLE_TOL at radius 5 (about 21 steps; the two
# may stop a step or two apart, and on the CPU stopping at 1e-3 instead of
# 1e-5 moves u by 3.5e-3 of max|u|, so u within NEWTON_REACH_U_TOL).
NEWTON_RADII = (1.0, 5.0)
NEWTON_BROYDEN_RTOL = 0.05
NEWTON_U_TOL = 1e-3
NEWTON_REACH_U_TOL = 1e-2
# dense Newton (one JVP a column of the Jacobian) on a radius-1 blob mesh
# this coarse: about 24 nodes, 240 JVPs a step
NEWTON_DENSE_HSIZE = 0.45
# the 2-mesh train step card vs CPU with Newton-Krylov in both solves:
# fw_tol 1e-6 is reachable (the CPU's forward solve stalls near 3e-7),
# the adjoint's steps reach 0 (GMRES takes no restart), each solve capped
NEWTON_CMP_OVERRIDES = dict(solver="newton_krylov", fw_tol=1e-6, fw_thres=30,
                            bw_tol=1e-7, bw_thres=30)
# the CLI epoch: the trained Dirichlet Ψ-GNN resumed from its JAX
# checkpoint for one more epoch with Newton-Krylov at the CLI's
# tolerances, each solve capped (a fresh model's solves stall at the cap)
NEWTON_TRAIN_FLAGS = ("--solver", "newton_krylov", "--fw_thres", "50",
                      "--bw_thres", "50", "--resume", CKPT)


# the native phase: assembly within NATIVE_TOL of data.fem.assemble_p1
# (absolute, entries of order 1), the load vector within rtol NATIVE_TOL and
# atol NATIVE_LOAD_ATOL, CG (relative residual 1e-12) against spsolve within
# rtol NATIVE_CG_RTOL and atol NATIVE_CG_ATOL: tests/test_native.py's
# tolerances.  NATIVE_BLOCK_N is the JAX kernel's block of aggregation
# nodes; each function's time is the best of NATIVE_REPS calls after one
# warm-up call.
NATIVE_TOL = 1e-12
NATIVE_LOAD_ATOL = 1e-14
NATIVE_CG_RTOL = 1e-7
NATIVE_CG_ATOL = 1e-9
NATIVE_BLOCK_N = 128
NATIVE_REPS = 5


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int = 200, warmup: int = 5) -> float:
    """Mean time of one ``fn()`` call on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int = 50,
                     attempts: int = 6) -> tuple[float, float]:
    """(device ms, device kernels) per ``fn()`` call: every kernel the
    device ran inside the calls, whatever its name, from ``torch.profiler``.
    The ``reps`` calls are traced after a warm-up pass of as many calls
    that the profiler traces and drops.  A trace may still lose kernels
    (1.44 a call of a three-kernel wrapper, once in a run; every kernel
    of three traces in a row, once in another): one whose count is not a
    whole number a call is taken again, up to ``attempts`` traces, and the
    fullest is kept.  Raises when none records device time."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    best: list = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):          # the warm-up pass, the traced one
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        spans = [ev.time_range.elapsed_us()
                 for ev in profiling.device_events(prof)]
        if len(spans) > len(best):
            best = spans
        if spans and len(spans) % reps == 0:
            break
    if not sum(best):
        raise RuntimeError("torch.profiler recorded no device time")
    return sum(best) / reps / 1000.0, len(best) / reps


def fused_mp_bound(n: int, e: int, d: int, dh: int, d_out: int,
                   edge_dim: int) -> tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes, flops) of one fused MP call: each input
    read once (h, CSR row_ptr/oth/edge_attr, weights), the output written
    once; operations of the cheapest form of the function — W1a·h and W1b·h
    once per node, per edge the edge term, bias, add, ReLU and sum, W2 once
    per row."""
    weights = dh * (2 * d + edge_dim) + dh + d_out * dh + d_out
    nbytes = 4 * (n * d + (n + 1) + e + e * edge_dim + weights + n * d_out)
    flops = (n * 2 * (2 * d * dh)                 # W1a·h, W1b·h per node
             + e * dh * (2 * edge_dim + 4)         # W1c·ea, +b1, +ha+hb, relu, sum
             + n * (2 * dh * d_out + 2 * d_out))   # W2·acc + deg·b2
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    bound = max(t_bytes, t_ops)
    return bound * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        float(nbytes), float(flops)


def fused_mp_bwd_bound(n: int, e: int, d: int, dh: int, d_out: int,
                       edge_dim: int) -> tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes, flops) of one VJP of the fused MP: h, g,
    the CSR and the weights read once, dh and the parameter gradients
    written once; operations of its cheapest form — the forward's
    pre-activations again, W2ᵀ·g once per row, per edge the ReLU mask, the
    dha and dhb sums, dW1c and db1, per row A_r and the dW2, db2 products,
    and the dense dh = dha·W1a + dhb·W1b, dW1a = hᵀ·dha, dW1b = hᵀ·dhb."""
    weights = dh * (2 * d + edge_dim) + dh + d_out * dh
    nbytes = 4 * (n * d + n * d_out + (n + 1) + e + e * edge_dim + weights
                  + n * d + weights + d_out)
    flops = (n * 2 * (2 * d * dh)                  # W1a·h, W1b·h per node
             + e * dh * (2 * edge_dim + 4)          # pre, ReLU, Σ relu (A_r)
             + n * 2 * dh * d_out                   # W2ᵀ·g per row
             + e * dh * (4 + 2 * edge_dim)          # mask, dha, dhb, db1, dW1c
             + n * (2 * d_out * dh + 2 * d_out)     # dW2, db2
             + 4 * n * 2 * d * dh)                  # dh (2), dW1a, dW1b
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    bound = max(t_bytes, t_ops)
    return bound * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        float(nbytes), float(flops)


def fused_mp_jvp_bound(n: int, e: int, d: int, dh: int, d_out: int,
                       edge_dim: int) -> tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes, flops) of one JVP of the fused MP: h,
    the direction v, the CSR and W1, b1, W2 read once, the tangent written
    once; operations of its cheapest form — W1a·h, W1b·h, W1a·v and W1b·v
    once per node, per edge the pre-activation (edge term, bias, adds) for
    ReLU's mask and the masked tangent sum, W2 once per row."""
    weights = dh * (2 * d + edge_dim) + dh + d_out * dh
    nbytes = 4 * (2 * n * d + (n + 1) + e + e * edge_dim + weights
                  + n * d_out)
    flops = (n * 4 * (2 * d * dh)                  # W1a, W1b on h and v
             + e * dh * (2 * edge_dim + 3)          # pre: W1c·ea, +b1, adds
             + e * dh * 3                           # mask, add, sum
             + n * 2 * dh * d_out)                  # W2·acc
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    bound = max(t_bytes, t_ops)
    return bound * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        float(nbytes), float(flops)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = bench.card_line("cuda")
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return smi


def phase_build() -> None:
    """The three kernels, one ``nvcc`` each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from psignn_tpu_torch.kernels import build
    names = ("fused_mp_fwd", "fused_mp_bwd", "fused_mp_jvp")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        results = list(pool.map(build.build, names))
    wall = time.perf_counter() - t0
    for name, res in zip(names, results):
        ptxas = [ln.strip() for ln in res.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", kernel=name, seconds=wall, nvcc_seconds=res.seconds,
             library=str(res.path.name), ptxas=ptxas)


def phase_native(smi: str) -> dict:
    """The port's host runtime (``native.py``): its library built from the
    checkout, then its five functions on the headline mesh against the
    port's scipy/numpy path, each timed beside that counterpart."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from psignn_tpu_torch import native
    from psignn_tpu_torch.data.fem import (_QP, _QW, apply_dirichlet,
                                           assemble_p1)
    from psignn_tpu_torch.data.meshgen import blob_mesh
    from psignn_tpu_torch.dist.partition import rcm_permutation
    from psignn_tpu_torch.kernels import build
    from psignn_tpu_torch.kernels.fused_mp import pack_csr

    def timed_host(fn):
        return profiling.timed(fn, reps=NATIVE_REPS)

    res = build.build(native.LIBRARY)
    if not native.available():
        raise RuntimeError("native library built but does not load")
    info = build.host_cpu()
    cpu = {field: info.get(field) for field in build.CPU_FIELDS[:3]}
    emit("native_build", seconds=res.seconds, library=res.path.name,
         cxx=build.find_cxx(), flags=build.CXX_FLAGS, cpu=cpu,
         cores=os.cpu_count(), nvidia_smi=smi)
    # bench.headline_sample's mesh
    mesh = blob_mesh(radius=5.0, hsize=0.08, rng=np.random.default_rng(0))
    n = mesh.n_points
    out = dict(n_points=n, n_triangles=len(mesh.triangles), cpu=cpu,
               nvidia_smi=smi)

    def f(x, y):
        return 1.0 + x ** 2 - 2 * y

    # assembly and load vector, against data.fem.assemble_p1 (both at once)
    (A_py, b_py), py_s = timed_host(lambda: assemble_p1(mesh, f))
    (rows, cols, vals), coo_s = timed_host(
        lambda: native.assemble_p1_coo(mesh.points, mesh.triangles))
    A_nat = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A_nat.sum_duplicates()
    lam = np.stack([1.0 - _QP[:, 0] - _QP[:, 1], _QP[:, 0], _QP[:, 1]], 1)
    p = [mesh.points[mesh.triangles[:, i]] for i in range(3)]
    xq = sum(lam[None, :, i:i + 1] * p[i][:, None] for i in range(3))
    fq = f(xq[..., 0], xq[..., 1])
    b_nat, load_s = timed_host(lambda: native.assemble_load(
        mesh.points, mesh.triangles, fq, lam, _QW, n))
    out["assemble_p1_coo"] = dict(
        native_s=coo_s, scipy_s=py_s,
        counterpart="data.fem.assemble_p1",
        max_abs_err=float(abs(A_py - A_nat).max()))
    out["assemble_load"] = dict(
        native_s=load_s, scipy_s=py_s,
        counterpart="data.fem.assemble_p1",
        max_abs_err=float(np.abs(b_nat - b_py).max()))
    # CG on the interior-eliminated system, against spsolve of
    # apply_dirichlet's system (data.fem.solve_poisson's solve)
    A, b = assemble_p1(mesh, lambda x, y: np.full_like(x, -4.0))
    bidx = np.where(mesh.boundary_mask)[0]
    g = mesh.points[bidx, 0] ** 2 + mesh.points[bidx, 1] ** 2
    Ad, bd = apply_dirichlet(A.copy(), b.copy(), bidx, g)
    want, sp_s = timed_host(lambda: spla.spsolve(Ad.tocsc(), bd))
    iidx = np.where(~mesh.boundary_mask)[0]
    A_II = A[iidx][:, iidx].tocsr()
    rhs = b[iidx] - A[iidx][:, bidx] @ g
    (x, iters), cg_s = timed_host(lambda: native.solve_cg(
        A_II.indptr.astype(np.int64), A_II.indices, A_II.data, rhs))
    cg_ok = np.allclose(x, want[iidx], rtol=NATIVE_CG_RTOL,
                        atol=NATIVE_CG_ATOL)
    out["solve_cg"] = dict(
        native_s=cg_s, scipy_s=sp_s,
        counterpart="scipy.sparse.linalg.spsolve",
        iterations=iters, n_interior=len(iidx),
        max_abs_err=float(np.abs(x - want[iidx]).max()))
    # RCM beside scipy's (dist.partition.rcm_permutation)
    A = A.tocsr()
    perm, rcm_s = timed_host(lambda: native.rcm_order(
        A.indptr.astype(np.int64), A.indices, n))
    senders, receivers, _ = sp.find(A)
    sperm, sc_s = timed_host(
        lambda: rcm_permutation(senders, receivers, n))

    def bandwidth(order):
        inv = np.empty_like(order)
        inv[order] = np.arange(n)
        return int(np.abs(inv[senders] - inv[receivers]).max())

    is_perm = np.array_equal(np.sort(perm), np.arange(n))
    out["rcm_order"] = dict(
        native_s=rcm_s, scipy_s=sc_s,
        counterpart="dist.partition.rcm_permutation",
        bandwidth=bandwidth(perm) if is_perm else None,
        scipy_bandwidth=bandwidth(np.asarray(sperm)),
        mesh_order_bandwidth=int(np.abs(senders - receivers).max()))
    # the JAX package's edge-block packing of the RCM-ordered mesh (its TPU
    # kernel's banded windows need the order), beside the port's own
    # packing of the same edges, a CSR (kernels.fused_mp.pack_csr)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=perm.dtype)
    s, r = inv[senders], inv[receivers]
    keep = s != r
    order = np.argsort(r[keep], kind="stable")
    agg, oth = r[keep][order], s[keep][order]
    n_cap = -(-n // 256) * 256
    counts = np.bincount(agg // NATIVE_BLOCK_N,
                         minlength=n_cap // NATIVE_BLOCK_N)
    e_cap = max(NATIVE_BLOCK_N, -(-int(counts.max()) // NATIVE_BLOCK_N)
                * NATIVE_BLOCK_N)
    (al, og, mask, ws, need), pack_s = timed_host(
        lambda: native.pack_mp_blocks_core(agg, oth, n_cap, NATIVE_BLOCK_N,
                                           e_cap))
    ea = np.zeros((len(s), 3), np.float32)
    _, csr_s = timed_host(lambda: pack_csr(s, r, ea, n, "to",
                                             device="cpu"))
    live = mask > 0
    blk = np.nonzero(live)[0]
    placed = sorted(zip((al[live] + blk * NATIVE_BLOCK_N).tolist(),
                        og[live].tolist()))
    in_window = bool(np.all((og[live] >= ws[blk])
                            & (og[live] < ws[blk] + need)))
    out["pack_mp_blocks_core"] = dict(
        native_s=pack_s, scipy_s=csr_s,
        counterpart="kernels.fused_mp.pack_csr",
        edges=int(len(agg)), blocks=int(len(ws)), e_cap=e_cap, need=need)
    emit("native", **out)

    bad = []
    if out["assemble_p1_coo"]["max_abs_err"] >= NATIVE_TOL:
        bad.append("assemble_p1_coo")
    if not np.allclose(b_nat, b_py, rtol=NATIVE_TOL, atol=NATIVE_LOAD_ATOL):
        bad.append("assemble_load")
    if not cg_ok or iters <= 0:
        bad.append("solve_cg")
    if not is_perm or out["rcm_order"]["bandwidth"] >= n // 4:
        bad.append("rcm_order")
    if placed != sorted(zip(agg.tolist(), oth.tolist())) \
            or need > e_cap or np.any(np.diff(ws) < 0) or not in_window:
        bad.append("pack_mp_blocks_core")
    if bad:
        raise RuntimeError(f"native disagrees with the scipy/numpy path: "
                           f"{bad}: {out}")
    return out


def mp_cases(graph, sample, tgraph, mgraph, dgraph, device):
    """(mesh, edge_dim, direction, csr, width, timed) of each kernel check.
    Timed, at the main paths' shapes: the radius-5 headline mesh at
    edge_dim 3 and at a 1-dim edge feature (the matrix value a_ij),
    then the train step's 50-mesh batch, the mixed 50-mesh batch's
    ``from`` packing, which its Neumann branch adds to ``phi_from``'s, and
    both packings of the 50-mesh batch's DSS form (A′ without its
    Dirichlet rows, edge_dim 1 from ``a_ij_norm``).
    Checked only: the headline mesh
    at width 20 (32 lanes a row), a small ragged graph at the model's
    widths and at width 12, edge_dim 2 (widths the kernels take at run
    time), and a CSR with no edges."""
    from psignn_tpu_torch.kernels.fused_mp import pack_csr
    n = graph.total_nodes
    cases = []
    for edge_dim in (3, 1):
        for direction in ("to", "from"):
            if edge_dim == 3:
                csr = graph.mp_to if direction == "to" else graph.mp_from
            else:
                csr = pack_csr(sample["senders"], sample["receivers"],
                               sample["a_ij"], n, direction, device=device)
            cases.append(("headline", edge_dim, direction, csr, WIDTH, True))
    cases += [("train", 3, "to", tgraph.mp_to, WIDTH, True),
              ("train", 3, "from", tgraph.mp_from, WIDTH, True),
              ("mixed_train", 3, "from", mgraph.mp_from, WIDTH, True),
              ("dss_train", 1, "to", dgraph.mp_to, WIDTH, True),
              ("dss_train", 1, "from", dgraph.mp_from, WIDTH, True),
              ("headline", 3, "to", graph.mp_to, WIDE, False),
              ("ragged", 3, "to", ragged_csr(3, device), WIDTH, False),
              ("ragged", 2, "to", ragged_csr(2, device), 12, False),
              ("empty", 3, "to", pack_csr([], [], np.zeros((0, 3), np.float32),
                                          5, "to", device=device),
               WIDTH, False)]
    return cases


def empty_rows(csr) -> int:
    """Rows of a packing with no edge (DSS's Dirichlet rows in ``from``)."""
    return int((csr.row_ptr.diff() == 0).sum())


def ragged_csr(edge_dim: int, device):
    """37 nodes (not a multiple of the rows a block takes), nodes 30-36
    isolated, node 0 receiving and node 1 sending 40 edges (more than one
    chunk of 32 edge indices, an odd tail)."""
    from psignn_tpu_torch.kernels.fused_mp import pack_csr
    rng = np.random.default_rng(5)
    s, r = rng.integers(0, 30, 240), rng.integers(0, 30, 240)
    r[:40], s[40:80] = 0, 1
    ea = rng.normal(size=(240, edge_dim)).astype(np.float32)
    return pack_csr(s, r, ea, 37, "to", device=device)


def case_inputs(seed: int, csr, width: int, edge_dim: int, device):
    """Seeded (w1, b1, w2, b2, h, g) at ``width`` for a case."""
    from psignn_tpu_torch.nn import MLP
    gen = torch.Generator().manual_seed(seed)
    l1, l2 = MLP([2 * width + edge_dim, width, width], generator=gen).layers
    h, g = (torch.randn(csr.n_rows, width, generator=gen) for _ in range(2))
    return [t.detach().to(device) for t in
            (l1.weight, l1.bias, l2.weight, l2.bias, h, g)]


def kernel_entry(name: str, replaces: str, cases: list, main: tuple) -> dict:
    """The ``kernels`` line's entry: times from the case ``main`` (mesh,
    edge_dim, direction, width), the largest error of every case."""
    entry = next(c for c in cases
                 if (c["mesh"], c["edge_dim"], c["direction"], c["width"])
                 == main)
    return dict(name=name, route="cuda",
                source=f"psignn_tpu_torch/kernels/csrc/{name}.cu",
                replaces=replaces, launches=None,
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=entry["ms"], plain_ms=entry["plain_ms"],
                bound_ms=entry["bound_ms"], bound_by=entry["bound_by"],
                library_ms=None)


def check_kernel(phase: str, name: str, replaces: str, kernel, plain,
                 bound, cases, device, seed: int, with_g: bool,
                 skip=lambda edge_dim, timed: False) -> dict:
    """``kernel`` against its ``plain`` version on the card, case by case
    (seeded inputs; the case's g is passed too when ``with_g``): max error
    within KERNEL_REL_TOL, a relaunch bit-identical, and at the timed
    cases the per-call times beside ``bound``.  Returns the ``kernels``
    line's entry, its times from the headline mesh's ``to`` case."""
    done = []
    for i, (mesh, edge_dim, direction, csr, width, timed) in enumerate(cases):
        if skip(edge_dim, timed):
            continue
        w1, b1, w2, b2, h, g = case_inputs(seed + i, csr, width, edge_dim,
                                           device)
        args = (w1, b1, w2, b2, h, csr) + ((g,) if with_g else ())
        with torch.no_grad():
            out1 = kernel(*args)
            out2 = kernel(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err = float((out1 - ref).abs().max()) if ref.numel() else 0.0
            scale = float(ref.abs().max()) if ref.numel() else 0.0
            case = dict(mesh=mesh, direction=direction, edge_dim=edge_dim,
                        width=width, n_rows=csr.n_rows, n_edges=csr.n_edges,
                        empty_rows=empty_rows(csr),
                        max_abs_err=err, max_rel_err=err / max(scale, 1e-30),
                        bit_identical=bool(torch.equal(out1, out2)))
            if timed:
                dev_ms, dev_kernels = kernel_device_ms(lambda: kernel(*args))
                bound_ms, bound_by, nbytes, flops = bound(
                    csr.n_rows, csr.n_edges, width, width, width, edge_dim)
                case.update(
                    ms=cuda_ms(lambda: kernel(*args)),
                    device_ms=dev_ms, device_kernels=dev_kernels,
                    plain_ms=cuda_ms(lambda: plain(*args)),
                    bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                    flops=flops, library_ms=None)
        emit(phase, **case)
        if not case["bit_identical"]:
            raise RuntimeError(f"{name} relaunch differs: {case}")
        if not err <= KERNEL_REL_TOL * max(1.0, scale):
            raise RuntimeError(f"{name} disagrees with plain: {case}")
        done.append(case)
    return kernel_entry(name, replaces, done, ("headline", 3, "to", WIDTH))


def phase_kernel(cases, device) -> dict:
    """Forward kernel vs plain on the card; the ``kernels`` line reports
    the headline mesh's ``to`` case."""
    from psignn_tpu_torch.kernels.fused_mp import (fused_message_passing,
                                                   mp_from_csr)
    return check_kernel("kernel", "fused_mp_fwd",
                        "psignn_tpu/kernels/fused_mp.py:282",
                        fused_message_passing, mp_from_csr, fused_mp_bound,
                        cases, device, 0, False)


def _sweep(device, radii, warmup, overrides=None, count_launches=False):
    """One mesh per radius through the user's entry points; per request the
    solve's kernel-launch delta of the timed call."""
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.eval.sweep import growing_geometry_sweep
    from psignn_tpu_torch.kernels import fused_mp as mp
    predict, family, cfg, _ = load_predictor(CKPT, device, overrides)
    deltas = []

    def counted(graph):
        before = mp.LAUNCHES
        out = predict(graph)
        deltas.append(mp.LAUNCHES - before)
        return out

    summary = growing_geometry_sweep(
        {family: counted if count_launches else predict}, radii=radii,
        n_meshes=1, hsize=0.08, seed=0, device=device, warmup=warmup)
    per_call = 2 if warmup else 1
    requests = []
    for i, r in enumerate(radii):
        m = summary[family][r]
        req = dict(radius=r, n_nodes=int(m["n_nodes"]),
                   n_edges=int(m["n_edges"]), nstep=int(m["nstep"]),
                   lowest=m["lowest"], res=m["res"], mse=m["mse"],
                   rel=m["rel"], seconds=m["time"],
                   prot_break=bool(m["prot_break"]))
        if count_launches:
            req["launches"] = deltas[per_call * (i + 1) - 1]
        requests.append(req)
    return cfg, requests


def phase_slice(device) -> int:
    from psignn_tpu_torch.kernels import fused_mp as mp
    mp.LAUNCHES = 0
    cfg, requests = _sweep(device, SWEEP_RADII, warmup=True,
                           count_launches=True)
    launches = mp.LAUNCHES
    for req in requests:
        emit("slice", device=str(device), fw_tol=cfg.fw_tol,
             fw_thres=cfg.fw_thres, **req)
        finite = all(np.isfinite(req[k]) for k in
                     ("lowest", "res", "mse", "rel", "seconds"))
        if not finite or req["prot_break"] or req["launches"] == 0:
            raise RuntimeError(f"slice request failed: {req}")
    if launches == 0:
        raise RuntimeError("the main path launched no fused_mp kernel")

    # the radius-1 request on the CPU, at the checkpoint's fw_tol and at a
    # reachable one
    gpu1 = requests[0]
    _, (cpu1,) = _sweep("cpu", (1.0,), warmup=False)
    res_rel = abs(gpu1["res"] - cpu1["res"]) / cpu1["res"]
    _, (gpu_r,) = _sweep(device, (1.0,), warmup=False,
                         overrides=dict(fw_tol=REACHABLE_TOL))
    _, (cpu_r,) = _sweep("cpu", (1.0,), warmup=False,
                         overrides=dict(fw_tol=REACHABLE_TOL))
    low_rel = abs(gpu_r["lowest"] - cpu_r["lowest"]) / cpu_r["lowest"]
    agree = dict(fw_tol=cfg.fw_tol, gpu=gpu1, cpu=cpu1, res_rel_diff=res_rel,
                 reachable_tol=REACHABLE_TOL, gpu_reachable=gpu_r,
                 cpu_reachable=cpu_r, lowest_rel_diff=low_rel)
    emit("slice_cpu_agreement", **agree)
    if (res_rel > RES_REL_TOL or low_rel > LOWEST_REL_TOL
            or abs(gpu_r["nstep"] - cpu_r["nstep"]) > NSTEP_SLACK
            or cpu1["prot_break"] or cpu_r["prot_break"]):
        raise RuntimeError(f"GPU and CPU disagree at radius 1: {agree}")
    return launches


def phase_headline(graph, sample, device, smi: str) -> None:
    """``graph`` is ``bench.build_big_graph``'s, solved as the bench's
    inference mode solves it."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    cfg = bench.headline_config()
    model = bench.headline_model(cfg, device)

    def run():
        out = bench.headline_solve(model, graph, cfg)
        torch.cuda.synchronize()
        return out

    run()   # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls, launches = [], []
    for _ in range(3):
        mp.LAUNCHES = 0
        t0 = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t0)
        launches.append(mp.LAUNCHES)
    iters = out.trace_len - 1
    # f_θ runs once per iteration plus once at the start; phi_to and
    # phi_from each launch the kernel once
    want_launches = 2 * (iters + 1)
    if (iters != HEADLINE_ITERS or not np.isfinite(out.lowest)
            or any(n != want_launches for n in launches)):
        raise RuntimeError(f"headline ran {iters} iterations with launches "
                           f"{launches} (want {want_launches} each), lowest "
                           f"{out.lowest}, prot {out.prot_break}")
    wall = min(walls)
    n_edges = len(sample["senders"])
    emit("headline", card=smi, n_nodes=graph.total_nodes, n_edges=n_edges,
         mp_edges=graph.mp_to.n_edges, iters=iters, launches=launches[0],
         wall_s=wall,
         wall_s_all=walls, edges_per_s=iters * 2 * n_edges / wall,
         ms_per_iter=wall / iters * 1e3, lowest=out.lowest,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    emit("headline_profile", card=smi, unprofiled_wall_s=wall,
         **device_breakdown(run))


# the bench phase: each run of ``python -m psignn_tpu_torch.bench``, its
# path name in the kernels line, and the seconds it may take
BENCH_RUNS = (
    ("bench_inference", "psignn_fixed_point_edges_per_s",
     ("--mode", "inference")),
    ("bench_train", "psignn_train_step_seconds", ("--mode", "train")),
    ("bench_partition_1", "psignn_partitioned_fixed_point_edges_per_s",
     ("--mode", "partition", "--num_devices", "1")),
    ("bench_partition_2", "psignn_partitioned_fixed_point_edges_per_s",
     ("--mode", "partition", "--num_devices", "2", "--device", "cuda:0")))
BENCH_TIMEOUT = 300
# bench.py's detail keys of each metric (but ``pallas_mp``; the train
# mode's with the checkpoint it read; the inference and train modes' with
# ``rcm``, their node order), and the port's own: launches, device time,
# busy share, card
BENCH_DETAIL = {
    "psignn_fixed_point_edges_per_s": {
        "n_nodes", "n_edges", "iters", "wall_s", "solver",
        "baseline_edges_per_s", "rcm", "loop", "host_reads", "graphs",
        "capture_s"},
    "psignn_train_step_seconds": {
        "n_nodes", "n_edges", "fw_nstep", "loss", "epoch_s_extrapolated",
        "baseline_step_s", "ckpt", "rcm"},
    "psignn_partitioned_fixed_point_edges_per_s": {
        "n_nodes", "n_edges", "n_devices", "iters", "wall_s", "halo",
        "n_loc", "residual"}}
BENCH_PORT_KEYS = {"launches", "device_s", "busy", "card"}
HEADLINE_EDGES = 76_353


def bench_line(argv) -> tuple:
    """(the JSON line, seconds, its stage lines on stderr) of one ``python
    -m psignn_tpu_torch.bench`` process in this checkout; raises unless it
    exits 0 with exactly one line on stdout."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    # bench.py's default node order (RCM): its switch left unset
    env = {k: v for k, v in os.environ.items()
           if k != "PSIGNN_TPU_BENCH_PALLAS"}
    proc = subprocess.run(
        [sys.executable, "-m", "psignn_tpu_torch.bench", *argv], cwd=root,
        env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"bench {argv} exited {proc.returncode} with "
                           f"stdout {proc.stdout!r}:\n{proc.stderr[-4000:]}")
    return json.loads(lines[0]), seconds, [
        ln for ln in proc.stderr.splitlines() if ln.startswith("bench: ")]


def bench_problems(name: str, metric: str, line: dict) -> list:
    """What is wrong with one bench line: its metric and keys, its
    numbers, its launches against the path it ran."""
    from types import SimpleNamespace

    from psignn_tpu_torch.deq import SolveStats
    d = line["detail"]
    bad = []
    if line["metric"] != metric or "pallas_mp" in d \
            or not BENCH_DETAIL[metric] | BENCH_PORT_KEYS <= set(d):
        return [f"metric {line['metric']}, detail keys {sorted(d)}"]
    values = [line["value"], line["vs_baseline"], d["device_s"], d["busy"]]
    if not all(isinstance(v, (int, float)) and np.isfinite(v) and v > 0
               for v in values):
        bad.append(f"values {values}")
    got = (d["launches"]["fused_mp_fwd"], d["launches"]["fused_mp_bwd"])
    if "rcm" in BENCH_DETAIL[metric] and d["rcm"] is not True:
        # bench.py's default order: RCM (PSIGNN_TPU_BENCH_PALLAS unset)
        bad.append(f"rcm {d['rcm']}")
    if name == "bench_train":
        _, cfg, _ = trained_model("cpu", TRAIN_OVERRIDES)
        for st in d["steps"]:
            res = SimpleNamespace(fw=SolveStats(*st["fw"]),
                                  bw=SolveStats(*st["bw"]))
            want_l = expected_launches(res, cfg)
            have = (st["launches"]["fused_mp_fwd"],
                    st["launches"]["fused_mp_bwd"])
            if have != want_l or 0 in have:
                bad.append(f"step launches {have}, want {want_l}")
        if len({st["fw"][1] for st in d["steps"]}) != 1:
            bad.append("fw_nstep moved between the reps")
        return bad
    ranks = d.get("n_devices", 1)
    # f_θ runs once per iteration and once at the start; phi_to and
    # phi_from each launch the kernel once
    want_l = (ranks * 2 * (HEADLINE_ITERS + 1), 0)
    if d["iters"] != HEADLINE_ITERS or got != want_l \
            or d["n_edges"] != HEADLINE_EDGES:
        bad.append(f"iters {d['iters']}, launches {got} (want {want_l}), "
                   f"n_edges {d['n_edges']}")
    if name.startswith("bench_partition") and not (
            np.isfinite(d["residual"]) and d["backend"]
            == ("nccl" if ranks == 1 else "gloo")):
        bad.append(f"residual {d['residual']}, backend {d['backend']}")
    if name == "bench_inference" and (
            d["loop"] != "while" or d["graphs"] < 1
            or d["host_reads"] != carried_reads(HEADLINE_ITERS)):
        # the card's route: the carried loop, one read a chunk and one at
        # the end
        bad.append(f"loop {d['loop']}, graphs {d['graphs']}, host_reads "
                   f"{d['host_reads']}")
    return bad


def phase_bench(smi: str) -> dict:
    """The port's benchmark as the benchmark runs it: one process of
    ``python -m psignn_tpu_torch.bench`` per mode (partition on 1 NCCL
    rank, then 2 gloo ranks sharing the card).  Returns each run's
    (forward, backward) launches."""
    launches = {}
    for name, metric, argv in BENCH_RUNS:
        line, seconds, log = bench_line(argv)
        emit("bench", card=smi, run=name, argv=list(argv),
             process_s=seconds, log=log, **line)
        bad = bench_problems(name, metric, line)
        if bad:
            raise RuntimeError(f"{name} failed: {bad}: {line}")
        launches[name] = (line["detail"]["launches"]["fused_mp_fwd"],
                          line["detail"]["launches"]["fused_mp_bwd"])
    return launches


# the order phase: the kernels at both node orders, a trained request at
# both, and a CLI epoch with the mixed protocol's flags, resumed
ORDER_KERNELS = (
    ("fused_mp_fwd", "fused_message_passing", "mp_from_csr", False,
     fused_mp_bound),
    ("fused_mp_bwd", "fused_mp_vjp", "mp_vjp_from_csr", True,
     fused_mp_bwd_bound),
    ("fused_mp_jvp", "fused_mp_jvp", "mp_jvp_from_csr", True,
     fused_mp_jvp_bound))
# The order request's meshes.  On the radius-5 sweep mesh the trained
# Ψ-GNN is far out of its training range (MSE 116-138 against 0.009 at
# radius 1), and Broyden in f32 stalls above fw 1e-7 on some trajectories,
# in JAX's solver as in the port's, in either loop and order (witness:
# ``python tests/test_torch_while_loop.py order``; PERF.md §6).
# Where a solve stalls, its answer and residual measure the stall, not the
# order: the two orders' residuals are held to RES_REL_TOL only where both
# solves reached the tolerance, their first iterates always.  On the
# radius-2 sweep mesh both orders reach 1e-7 in either loop.
ORDER_RADII = (5.0, 2.0)
ORDER_DATA = dict(n_mesh=3, n_samples=4, radius=1.0, hsize=0.08)
ORDER_BATCH = "3"
# the canonical dataset (resume_round.sh's factory call): 200 meshes × 50
# samples, its train and validation parts cached (60 % and 20 %)
CANONICAL_SAMPLES = 200 * 50
CANONICAL_CACHED = 0.8


def node_orders(samples: list) -> tuple:
    """(RCM-ordered samples, the batch's permutation): row i of the
    RCM-ordered batch is row ``perm[i]`` of the mesh-ordered one."""
    from psignn_tpu_torch.dist.partition import (apply_node_permutation,
                                                 rcm_permutation)
    out, perms, off = [], [], 0
    for s in samples:
        n = s["x"].shape[0]
        p = rcm_permutation(s["senders"], s["receivers"], n)
        out.append(apply_node_permutation(s, p))
        perms.append(p + off)
        off += n
    return out, np.concatenate(perms)


def bandwidth(graph) -> int:
    """The largest |i − j| over the edges of a batch (edges join nodes of
    one mesh, so it is the widest mesh's)."""
    return int((graph.senders - graph.receivers).abs().max())


def order_kernels(meshes: dict, device, smi: str) -> list:
    """Each kernel of ``ORDER_KERNELS`` on each mesh of ``meshes``
    ({name: (mesh-order graph, RCM graph, perm)}), ``to`` and ``from``, in
    both orders: against its plain version within KERNEL_REL_TOL, a
    relaunch bit-identical, the RCM answer equal to the mesh-order one
    permuted; ``to`` timed in turns (mesh, RCM, RCM, mesh) by
    ``kernel_device_ms``, each time's share of the bound of the shapes
    (the same in both orders)."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    rows = []
    for k, (name, wrapper, plain, with_g, bound) in enumerate(ORDER_KERNELS):
        kernel, ref = getattr(mp, wrapper), getattr(mp, plain)
        for m, (mesh, (graph, rgraph, perm)) in enumerate(meshes.items()):
            for direction in ("to", "from"):
                csrs = {o: (g.mp_to if direction == "to" else g.mp_from)
                        for o, g in (("mesh", graph), ("rcm", rgraph))}
                w1, b1, w2, b2, h, g = case_inputs(
                    300 + 10 * k + m, csrs["mesh"], WIDTH, 3, device)
                idx = torch.as_tensor(perm, device=device)
                args = {o: (w1, b1, w2, b2, h if o == "mesh" else h[idx],
                            csrs[o])
                        + ((g if o == "mesh" else g[idx],) if with_g
                           else ())
                        for o in csrs}
                rec = dict(kernel=name, mesh=mesh, direction=direction,
                           n_rows=graph.total_nodes,
                           n_edges=csrs["mesh"].n_edges,
                           bandwidth={"mesh": bandwidth(graph),
                                      "rcm": bandwidth(rgraph)})
                outs = {}
                with torch.no_grad():
                    for o, a in args.items():
                        out1, out2 = kernel(*a), kernel(*a)
                        want = ref(*a)
                        torch.cuda.synchronize()
                        out1, out2, want = (
                            x if isinstance(x, tuple) else (x,)
                            for x in (out1, out2, want))
                        err = max(float((a_ - b_).abs().max())
                                  for a_, b_ in zip(out1, want))
                        scale = max(float(b_.abs().max()) for b_ in want)
                        rec[f"max_abs_err_{o}"] = err
                        rec[f"bit_identical_{o}"] = all(
                            torch.equal(a_, b_) for a_, b_ in zip(out1, out2))
                        if not rec[f"bit_identical_{o}"] or \
                                not err <= KERNEL_REL_TOL * max(1.0, scale):
                            raise RuntimeError(f"{name} at {o} order: {rec}")
                        outs[o] = out1
                # the node rows of the RCM answer are the mesh answer's
                # permuted (dh last for the backward); weights' alike
                node = [outs["mesh"][-1][idx], outs["rcm"][-1]]
                pairs = list(zip(outs["mesh"][:-1], outs["rcm"][:-1])) + [
                    tuple(node)]
                cross = max(float((a_ - b_).abs().max()) for a_, b_ in pairs)
                scale = max(float(a_.abs().max()) for a_, _ in pairs)
                rec["order_abs_diff"] = cross
                if not cross <= KERNEL_REL_TOL * max(1.0, scale):
                    raise RuntimeError(f"{name}: the orders disagree: {rec}")
                if direction == "to":
                    times = {"mesh": [], "rcm": []}
                    for o in ("mesh", "rcm", "rcm", "mesh"):
                        times[o].append(kernel_device_ms(
                            lambda a=args[o]: kernel(*a))[0])
                    bound_ms, bound_by, nbytes, _ = bound(
                        graph.total_nodes, csrs["mesh"].n_edges, WIDTH,
                        WIDTH, WIDTH, 3)
                    rec.update(card=smi, device_ms=times,
                               bound_ms=bound_ms, bound_by=bound_by,
                               bytes=nbytes,
                               bound_share={o: bound_ms / min(t)
                                            for o, t in times.items()},
                               rcm_over_mesh=min(times["rcm"])
                               / min(times["mesh"]))
                emit("order_kernel", **rec)
                rows.append(rec)
    return rows


def order_request(device, radius: float) -> dict:
    """The trained Dirichlet Ψ-GNN (CKPT at CMP_OVERRIDES) on the
    ``radius`` sweep mesh in mesh and in RCM order, through
    ``load_predictor`` (the carried loop), and again by the host loop:
    each nstep printed (Broyden's stop is chaotic, so it is not compared);
    in each loop the RCM answer, un-permuted, against the mesh-order one
    by the first ``NSTEP_EARLY_STEPS`` decoded Broyden iterates
    (NSTEP_EARLY_RTOL in ‖·‖₂ relative) and, where both solves reached
    fw_tol, by physics residual (RES_REL_TOL).  Returns each order's
    (forward, backward) launches in the carried loop."""
    from psignn_tpu_torch.data.meshgen import blob_mesh
    from psignn_tpu_torch.eval.metrics import errors_batch
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.eval.sweep import build_data
    from psignn_tpu_torch.graphs import batch_graphs
    from psignn_tpu_torch.models import psignn_iterative_inference
    rng = np.random.default_rng(0)
    for r in SWEEP_RADII:
        mesh = blob_mesh(radius=r, hsize=0.08, rng=rng)
        sample = build_data(mesh, r, rng, ("psignn",))["psignn"]
        if r == radius:
            break
    (rsample,), perm = node_orders([sample])
    idx = torch.as_tensor(perm, device=device)
    graphs = {"mesh": batch_graphs([sample], device=device),
              "rcm": batch_graphs([rsample], device=device)}
    cfg, answer = counted_predictor(CKPT, device, CMP_OVERRIDES)
    _, _, early_cfg, model = load_predictor(
        CKPT, device, dict(CMP_OVERRIDES, fw_thres=NSTEP_EARLY_STEPS,
                           fw_tol=1e-12))
    rec, us, traces, launches = dict(radius=radius,
                                     overrides=CMP_OVERRIDES), {}, {}, {}
    tag = "" if radius == ORDER_RADII[0] else f"r{radius:g}_"
    for o, g in graphs.items():
        out, r = answer(g)
        m = errors_batch(out.u, g)
        rec[o] = dict(r, res=float(m["res"][0]), mse=float(m["mse"][0]),
                      bandwidth=bandwidth(g))
        hout, hres = carried_request(model, cfg, g, "host")
        rec[o + "_host"] = dict(nstep=hout.nstep, lowest=hout.lowest,
                                prot_break=hout.prot_break, res=hres)
        us[o] = out.u
        traces[o] = psignn_iterative_inference(
            model, g, early_cfg)["trace"]["u"][:NSTEP_EARLY_STEPS + 1]
        launches[f"order_request_{tag}{o}"] = (r["fwd_launches"],
                                               r["bwd_launches"])
        if (not finite(rec[o]["res"], rec[o]["mse"], hres) or r["prot_break"]
                or hout.prot_break
                or r["fwd_launches"] != mp_per_call(cfg) * r["f_calls"]):
            raise RuntimeError(f"order request at {o} order failed: {rec}")
    held = {}
    for lp in ("", "_host"):
        a, b = rec["mesh" + lp], rec["rcm" + lp]
        both = a["lowest"] < cfg.fw_tol and b["lowest"] < cfg.fw_tol
        res_rel = abs(b["res"] - a["res"]) / a["res"]
        rec["res_rel_diff" + lp] = res_rel
        rec["res_held" + lp] = both
        held[lp] = not both or res_rel <= RES_REL_TOL
    early = max(float(torch.linalg.vector_norm(a[idx] - b)
                      / torch.linalg.vector_norm(b))
                for a, b in zip(traces["mesh"], traces["rcm"]))
    u_gap = float(torch.linalg.vector_norm(us["mesh"][idx] - us["rcm"])
                  / torch.linalg.vector_norm(us["mesh"]))
    rec.update(res_rtol=RES_REL_TOL, early_steps=NSTEP_EARLY_STEPS,
               early_gap=early, early_rtol=NSTEP_EARLY_RTOL,
               u_rel_diff=u_gap)
    emit("order_request", **rec)
    if not all(held.values()) or early > NSTEP_EARLY_RTOL:
        raise RuntimeError(f"the two orders' answers disagree: {rec}")
    return launches


def graph_tensors(graph) -> dict:
    """{name: tensor} of every tensor of a batch, its CSR packings' as
    ``mp_to.<field>`` and ``mp_from.<field>``."""
    import dataclasses

    from psignn_tpu_torch.kernels.fused_mp import MPCsr
    out = {}
    for f in dataclasses.fields(graph):
        v = getattr(graph, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif isinstance(v, MPCsr):
            out.update({f"{f.name}.{c.name}": getattr(v, c.name)
                        for c in dataclasses.fields(v)})
    return out


def graph_nbytes(graph) -> int:
    """Bytes a batch holds on its device (``mp_from`` holds ``mp_to``'s
    tensors, swapped)."""
    return sum(t.numel() * t.element_size()
               for k, t in graph_tensors(graph).items()
               if not k.startswith("mp_from."))


def sample_ids(graph, index: dict) -> tuple:
    """The loader indices of a batch's samples, in order, each found by
    the bytes of its own ``sol`` rows."""
    sol = graph.sol.cpu().numpy()
    ends = np.cumsum(graph.n_nodes.cpu().numpy())
    return tuple(index[part.tobytes()]
                 for part in np.split(sol, ends[:-1]))


def order_cli(device, graphs: dict) -> dict:
    """The Ψ-GNN mixed protocol (``scripts/torch/train_psignn_mixed.sh``,
    ``--pallas --cache_batches 1``) for one epoch on a fresh 3 × 4 mixed
    dataset at batch 3, then resumed for a second, in this process, the
    trainer's ``prefetch`` recorded: every batch a loader yields is one of
    its stored graphs; the resumed epoch's batches hold the first epoch's
    sample sets; every stored tensor is bit-equal after the steps to its
    copy taken before them; ``max_memory_allocated`` once the train cache
    is built.  The cache's bytes beside their reckoning for the canonical
    dataset from ``graphs`` ({variant: 50-mesh batch}).  Returns each
    run's (forward, backward) launches."""
    from psignn_tpu_torch.cli.main import main as train_main
    from psignn_tpu_torch.data.generate import generate_data
    from psignn_tpu_torch.data.reader import load_dataset
    from psignn_tpu_torch.kernels import fused_mp as mp
    from psignn_tpu_torch.train import trainer as trainer_mod
    root = os.path.join(".chipwork", "smoke_order")
    shutil.rmtree(root, ignore_errors=True)
    data, out = os.path.join(root, "data"), os.path.join(root, "run")
    generate_data(data, variant="mixed", verbose=False, **ORDER_DATA)
    (cmd,) = script_commands(os.path.join(SCRIPTS, "train_psignn_mixed.sh"),
                             dict(DATA=data, OUT=out))
    flags = [a for a in cmd["argv"] if a in ("--pallas", "--cache_batches")]
    mesh_bandwidth = max(int(np.abs(s["senders"] - s["receivers"]).max())
                         for s in load_dataset(data, variant="mixed"))
    argv = cmd["argv"] + ["--batch_size", ORDER_BATCH, "--device",
                          str(device)]
    real = trainer_mod.prefetch
    launches, runs = {}, []
    for run, extra in (("first", ["--max_epochs", "1"]),
                       ("resumed", ["--max_epochs", "2", "--resume",
                                    os.path.join(out, "ckpt",
                                                 "running_model.ckpt")])):
        seen, state = [], {}

        def recording(loader, depth=2):
            for g in real(loader, depth):
                if id(loader) not in state:     # the cache was just built
                    sync(device)
                    state[id(loader)] = dict(
                        loader=loader, peak=torch.cuda.max_memory_allocated(),
                        copy=[{k: t.clone()
                               for k, t in graph_tensors(c).items()}
                              for c in loader._cached])
                seen.append((id(loader), g))
                yield g

        trainer_mod.prefetch = recording
        torch.cuda.reset_peak_memory_stats()
        sync(device)
        mp.LAUNCHES = mp.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        try:
            captured(train_main, argv + extra)
        finally:
            trainer_mod.prefetch = real
        sync(device)
        launches["order_cli_" + run] = (mp.LAUNCHES, mp.BWD_LAUNCHES)
        loaders = [s["loader"] for s in state.values()]
        train = next(ld for ld in loaders if ld.shuffle)
        index = {s["sol"].tobytes(): i for i, s in enumerate(train.samples)}
        stored = {id(ld): {id(c) for c in ld._cached} for ld in loaders}
        changed = [k for s in state.values()
                   for c, copy in zip(s["loader"]._cached, s["copy"])
                   for k, t in graph_tensors(c).items()
                   if not torch.equal(t, copy[k])]
        rec = dict(run=run, flags=flags, seconds=time.perf_counter() - t0,
                   fwd_launches=mp.LAUNCHES, bwd_launches=mp.BWD_LAUNCHES,
                   rcm=all(ld.rcm for ld in loaders),
                   cached=all(ld.cache_batches for ld in loaders),
                   yielded_stored=all(id(g) in stored[lid]
                                      for lid, g in seen),
                   batches=[sample_ids(g, index) for lid, g in seen
                            if lid == id(train)],
                   changed_tensors=changed,
                   cache_bytes={("train" if ld.shuffle else "val"):
                                sum(graph_nbytes(c) for c in ld._cached)
                                for ld in loaders},
                   peak_after_train_cache=state[id(train)]["peak"],
                   bandwidth=max(bandwidth(c) for c in train._cached),
                   mesh_bandwidth=mesh_bandwidth)
        emit("order_cli", **rec)
        runs.append(rec)
        if (rec["changed_tensors"] or not rec["yielded_stored"]
                or not (rec["rcm"] and rec["cached"])
                or sorted(flags) != ["--cache_batches", "--pallas"]
                or 0 in launches["order_cli_" + run]
                or not rec["bandwidth"] < rec["mesh_bandwidth"]):
            raise RuntimeError(f"order CLI run {run} failed: {rec}")
    first, second = (sorted(tuple(sorted(b)) for b in r["batches"])
                     for r in runs)
    per_sample = {v: graph_nbytes(g) / g.num_graphs
                  for v, g in graphs.items()}
    frozen = dict(first=runs[0]["batches"], resumed=runs[1]["batches"],
                  same_sets=first == second, n_batches=len(first),
                  reckoned_canonical_cache_bytes={
                      v: b * CANONICAL_SAMPLES * CANONICAL_CACHED
                      for v, b in per_sample.items()},
                  bytes_per_sample=per_sample)
    emit("order_cache", **frozen)
    if not frozen["same_sets"] or len(first) < 2:
        raise RuntimeError(f"the resumed epoch re-dealt the batches: "
                           f"{frozen}")
    return launches


def phase_order(graph, sample, tgraph, tsamples, mgraph, device,
                smi: str) -> dict:
    """The node orders JAX's fused kernels run in (``--rcm``/``--pallas``,
    the bench's default) and ``--cache_batches``: the three kernels at
    both orders on the headline mesh and the 50-mesh train batch, a
    trained request at both orders, and a CLI epoch with the mixed
    protocol's flags, resumed.  Returns each path's launches."""
    from psignn_tpu_torch.graphs import batch_graphs
    meshes = {}
    for name, g, samples in (("headline", graph, [sample]),
                             ("train", tgraph, tsamples)):
        ordered, perm = node_orders(samples)
        meshes[name] = (g, batch_graphs(ordered, device=device), perm)
    order_kernels(meshes, device, smi)
    launches = {}
    for radius in ORDER_RADII:
        launches.update(order_request(device, radius))
    launches.update(order_cli(device, {"dirichlet": tgraph,
                                       "mixed": mgraph}))
    return launches


def phase_kernel_bwd(cases, device) -> dict:
    """Backward kernel vs plain on the card; the ``kernels`` line reports
    the train batch's ``to`` case, the shapes of the train step whose
    launches it counts."""
    from psignn_tpu_torch.kernels.fused_mp import fused_mp_vjp, mp_vjp_from_csr
    names = ("dw1", "db1", "dw2", "db2", "dh")
    done = []
    for i, (mesh, edge_dim, direction, csr, width, timed) in enumerate(cases):
        w1, b1, w2, b2, h, g = case_inputs(100 + i, csr, width, edge_dim,
                                           device)
        args = (w1, b1, w2, b2, h, csr, g)
        with torch.no_grad():
            out1 = fused_mp_vjp(*args)
            out2 = fused_mp_vjp(*args)
            ref = mp_vjp_from_csr(*args)
            torch.cuda.synchronize()
            errs = {k: float((a - b).abs().max()) if b.numel() else 0.0
                    for k, a, b in zip(names, out1, ref)}
            scales = {k: float(b.abs().max()) if b.numel() else 0.0
                      for k, b in zip(names, ref)}
            case = dict(mesh=mesh, direction=direction, edge_dim=edge_dim,
                        width=width, n_rows=csr.n_rows, n_edges=csr.n_edges,
                        empty_rows=empty_rows(csr), max_abs_err=errs,
                        max_rel_err={k: errs[k] / max(scales[k], 1e-30)
                                     for k in names},
                        bit_identical=all(torch.equal(a, b)
                                          for a, b in zip(out1, out2)))
            if timed:
                dev_ms, dev_kernels = kernel_device_ms(
                    lambda: fused_mp_vjp(*args))
                bound_ms, bound_by, nbytes, flops = fused_mp_bwd_bound(
                    csr.n_rows, csr.n_edges, width, width, width, edge_dim)
                case.update(
                    ms=cuda_ms(lambda: fused_mp_vjp(*args)),
                    device_ms=dev_ms, device_kernels=dev_kernels,
                    plain_ms=cuda_ms(lambda: mp_vjp_from_csr(*args)),
                    bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                    flops=flops, library_ms=None)
        emit("kernel_bwd", **case)
        if not case["bit_identical"]:
            raise RuntimeError(f"fused_mp_bwd relaunch differs: {case}")
        bad = [k for k in names
               if not errs[k] <= BWD_KERNEL_REL_TOL * max(1.0, scales[k])]
        if bad:
            raise RuntimeError(f"fused_mp_bwd disagrees with plain in "
                               f"{bad}: {case}")
        done.append(dict(case, max_abs_err=max(errs.values())))
    return kernel_entry("fused_mp_bwd", "psignn_tpu/kernels/fused_mp.py:429",
                        done, ("train", 3, "to", WIDTH))


def train_graph(n_meshes: int, seed: int, device,
                variant: str = "dirichlet", form: str = "psignn"):
    """``bench.train_samples``' batch in one graph (``variant``, ``form``:
    the mixed meshes, DSS's A′ form)."""
    from psignn_tpu_torch.graphs import batch_graphs
    return batch_graphs(train_samples(n_meshes, seed, variant=variant,
                                      form=form), device=device)


def forward_seconds(model, cfg, init, graph, seed: int = 7) -> float:
    """Host seconds of the step's forward alone (``psignn_forward`` with its
    losses, no backward) from the state ``init``."""
    from psignn_tpu_torch.models import psignn_forward
    model.load_state_dict(init)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = psignn_forward(model, graph, cfg,
                         torch.Generator().manual_seed(seed))
    torch.stack(list(out.losses.values())).cpu()
    return time.perf_counter() - t0


def mp_per_call(cfg) -> int:
    """Fused message passings in one f_θ call, each one kernel launch:
    ``phi_to`` and ``phi_from`` per layer, and ``phi_neumann`` per layer in
    the mixed variant."""
    return (3 if cfg.bc_mode == "mixed" else 2) * cfg.n_layers


def expected_launches(res, cfg, linearized: bool = True) -> tuple[int, int]:
    """(forward, backward) kernel launches one train step implies:
    ``mp_per_call`` per f_θ call — the forward solve's calls and its JVPs
    (Newton's: forward-mode AD evaluates f_θ on dual tensors), the tracked
    application, the Jacobian loss's and, ``linearized`` (f_θ's own
    ``linearize``; not the partitioned solve's wrapper), the adjoint's
    linearization at h*; and as many per VJP of f_θ — each adjoint
    iteration's and adjoint JVP's (Newton's: the VJP is the affine adjoint
    map's tangent), the route of the adjoint solution into the parameters,
    the Hutchinson VJP and its own second-order backward through f_θ's
    forward."""
    k = mp_per_call(cfg)
    return (k * (res.fw.calls + res.fw.jvps + 2 + int(linearized)),
            k * (res.bw.calls + res.bw.jvps + 3))


def phase_train_step(graph, graph_s: float, device, smi: str,
                     ckpt: str = CKPT, phase: str = "train_step"
                     ) -> tuple[int, int]:
    """``graph`` is ``train_graph(TRAIN_MESHES, 0, device, variant)`` of
    the checkpoint's variant, built in ``graph_s`` seconds.  Returns the
    first timed step's (forward, backward) launches."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    t0 = time.perf_counter()
    model, cfg, init = trained_model(device, TRAIN_OVERRIDES, ckpt)
    setup_s = graph_s + time.perf_counter() - t0

    step_from(model, cfg, init, graph)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(3):
        mp.LAUNCHES = mp.BWD_LAUNCHES = 0
        res, wall = step_from(model, cfg, init, graph)
        launches = (mp.LAUNCHES, mp.BWD_LAUNCHES)
        want = expected_launches(res, cfg)
        rec = dict(seconds=wall, loss=res.loss, losses=res.losses,
                   grad_norm=res.grad_norm, fw_nstep=res.fw.nstep,
                   fw_calls=res.fw.calls, fw_lowest=res.fw.lowest,
                   bw_nstep=res.bw.nstep, bw_calls=res.bw.calls,
                   bw_lowest=res.bw.lowest, fwd_launches=launches[0],
                   bwd_launches=launches[1], expected_launches=list(want))
        steps.append(rec)
        finite = all(np.isfinite(v) for v in
                     [res.loss, res.grad_norm, *res.losses.values()])
        if not finite or launches != want or 0 in launches:
            raise RuntimeError(f"{phase} failed: {rec}")
    best = min(r["seconds"] for r in steps)
    forward_s = forward_seconds(model, cfg, init, graph)
    emit(phase, card=smi, bc_mode=cfg.bc_mode, n_meshes=TRAIN_MESHES,
         n_nodes=graph.total_nodes, n_edges=int(graph.senders.shape[0]),
         mp_edges=graph.mp_to.n_edges, setup_s=setup_s, step_s=best,
         step_s_all=[r["seconds"] for r in steps], forward_s=forward_s,
         backward_share=1.0 - forward_s / best,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), steps=steps)
    emit(phase + "_profile", card=smi, unprofiled_step_s=best,
         **device_breakdown(lambda: step_from(model, cfg, init, graph)))
    phase_train_step_cpu_agreement(device, ckpt, cfg.bc_mode, phase)
    return steps[0]["fwd_launches"], steps[0]["bwd_launches"]


def phase_train_step_cpu_agreement(device, ckpt: str, variant: str,
                                   phase: str, stacked: bool = False,
                                   overrides=None) -> None:
    """The same step on 2 meshes on the GPU and on the CPU, with the
    solves of ``overrides`` (default ``CMP_OVERRIDES``)."""
    overrides = overrides or CMP_OVERRIDES
    out = []
    for dev in (device, torch.device("cpu")):
        graph = train_graph(CMP_MESHES, 1, dev, variant)
        model, cfg, init = trained_model(dev, overrides, ckpt)
        res, _ = step_from(model, cfg, init, graph, stacked=stacked)
        grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
        out.append((res, grads))
    (gpu, ggrad), (cpu, cgrad) = out
    loss_rel = {k: abs(gpu.losses[k] - cpu.losses[k])
                / max(abs(cpu.losses[k]), 1e-30)
                for k in ("residual_loss", "jacobian_loss", "encoder_loss",
                          "autoencoder_loss", "mse_loss")}
    grad_rel = {k: float(torch.linalg.vector_norm(ggrad[k] - cgrad[k])
                         / max(float(torch.linalg.vector_norm(cgrad[k])),
                               1e-30))
                for k in cgrad}
    rec = dict(overrides=overrides, n_meshes=CMP_MESHES,
               gpu=dict(loss=gpu.loss, grad_norm=gpu.grad_norm,
                        fw=stats(gpu.fw), bw=stats(gpu.bw)),
               cpu=dict(loss=cpu.loss, grad_norm=cpu.grad_norm,
                        fw=stats(cpu.fw), bw=stats(cpu.bw)),
               loss_rel_diff=loss_rel, max_loss_rel_diff=max(loss_rel.values()),
               max_grad_rel_diff=max(grad_rel.values()),
               worst_grad=max(grad_rel, key=grad_rel.get),
               loss_rtol=CMP_LOSS_RTOL, grad_rtol=CMP_GRAD_RTOL)
    emit(phase + "_cpu_agreement", **rec)
    if (max(loss_rel.values()) > CMP_LOSS_RTOL
            or max(grad_rel.values()) > CMP_GRAD_RTOL):
        raise RuntimeError(f"GPU and CPU {phase}s disagree: {rec}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class FCalls:
    """f_θ calls seen by a forward hook on ``UpdateFunction`` modules
    (``jvp``: those on dual tensors, the JVPs of Newton's solvers).  A
    CUDA graph's replay runs no hook, so inside ``with calls:`` both
    counts are entries of ``loop.COUNTERS``, which a replay advances by
    what its capture saw, as it advances the kernels' launch counts; on
    leaving the block they are taken out again."""

    def __init__(self):
        self.calls = self.jvp = 0

    def _entries(self) -> list:
        return [(self, "calls"), (self, "jvp")]

    def __enter__(self) -> "FCalls":
        from psignn_tpu_torch import loop
        loop.COUNTERS.extend(self._entries())
        return self

    def __exit__(self, *exc) -> None:
        from psignn_tpu_torch import loop
        for entry in self._entries():
            loop.COUNTERS.remove(entry)

    def __call__(self, module, args, out) -> None:
        import torch.autograd.forward_ad as fwAD

        from psignn_tpu_torch.models.psignn import UpdateFunction
        if isinstance(module, UpdateFunction):
            self.calls += 1
            self.jvp += fwAD.unpack_dual(args[0]).tangent is not None

    def reset(self) -> None:
        self.calls = self.jvp = 0


def counted_predictor(ckpt: str, device, overrides=None):
    """(cfg, answer): ``answer(graph)`` runs ``load_predictor``'s predictor
    on ``graph`` and returns (PsignnInference, record) with its host
    seconds, f_θ calls (``jvp_f_calls`` of them on dual tensors: the JVPs
    of Newton's solvers) and the kernel launches of the call."""
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.kernels import fused_mp as mp
    predict, _, cfg, model = load_predictor(ckpt, device, overrides)
    calls = FCalls()
    model.function.register_forward_hook(calls)

    def answer(graph):
        calls.reset()
        sync(device)
        mp.LAUNCHES = mp.BWD_LAUNCHES = mp.JVP_LAUNCHES = 0
        t0 = time.perf_counter()
        with calls:
            out = predict(graph)
        sync(device)
        seconds = time.perf_counter() - t0
        return out, dict(nstep=out.nstep, lowest=out.lowest,
                         prot_break=out.prot_break, seconds=seconds,
                         f_calls=calls.calls, jvp_f_calls=calls.jvp,
                         fwd_launches=mp.LAUNCHES,
                         bwd_launches=mp.BWD_LAUNCHES,
                         jvp_launches=mp.JVP_LAUNCHES)

    return cfg, answer


def phase_mixed_eval(device):
    """A fresh mixed dataset's test split (one batch of 10 meshes) through
    ``run_eval``'s path with the mixed checkpoint, on the card and on the
    CPU.  Returns the card's forward launches and the test split."""
    from psignn_tpu_torch.data.generate import generate_data
    from psignn_tpu_torch.data.reader import (GraphLoader, load_dataset,
                                              split_dataset)
    from psignn_tpu_torch.eval.metrics import evaluate_dataset
    data = os.path.join(".chipwork", "smoke_mixed_eval")
    shutil.rmtree(data, ignore_errors=True)
    t0 = time.perf_counter()
    generate_data(data, variant="mixed", verbose=False, **MIXED_EVAL_DATA)
    _, _, test = split_dataset(load_dataset(data, variant="mixed"),
                               variant="mixed")
    gen_s = time.perf_counter() - t0

    def table(dev, overrides=None):
        cfg, answer = counted_predictor(MIXED_CKPT, dev, overrides)
        recs = []

        def u(graph):
            out, rec = answer(graph)
            recs.append(rec)
            return out.u

        loader = GraphLoader(test, batch_size=len(test), device=dev)
        means = {k: v for k, v in evaluate_dataset(
            u, loader, verbose=False).items() if k.endswith("_mean")}
        (rec,) = recs
        return cfg, dict(rec, **means)

    cfg, gpu = table(device)
    n_nodes = sum(len(s["x"]) for s in test)
    emit("mixed_eval", fw_tol=cfg.fw_tol, fw_thres=cfg.fw_thres,
         n_graphs=len(test), n_nodes=n_nodes, generate_s=gen_s, **gpu)
    if (gpu["fwd_launches"] != 3 * gpu["f_calls"] or gpu["f_calls"] == 0
            or gpu["bwd_launches"] or gpu["prot_break"]
            or not all(np.isfinite(v) for k, v in gpu.items()
                       if k.endswith("_mean") or k == "lowest")):
        raise RuntimeError(f"mixed_eval failed: {gpu}")

    _, cpu = table("cpu")
    res_rel = abs(gpu["res_mean"] - cpu["res_mean"]) / cpu["res_mean"]
    _, gpu_r = table(device, dict(fw_tol=MIXED_REACHABLE_TOL))
    _, cpu_r = table("cpu", dict(fw_tol=MIXED_REACHABLE_TOL))
    low_rel = abs(gpu_r["lowest"] - cpu_r["lowest"]) / cpu_r["lowest"]
    agree = dict(fw_tol=cfg.fw_tol, gpu=gpu, cpu=cpu, res_rel_diff=res_rel,
                 reachable_tol=MIXED_REACHABLE_TOL, gpu_reachable=gpu_r,
                 cpu_reachable=cpu_r, lowest_rel_diff=low_rel)
    emit("mixed_eval_cpu_agreement", **agree)
    if (res_rel > RES_REL_TOL or low_rel > LOWEST_REL_TOL
            or abs(gpu_r["nstep"] - cpu_r["nstep"]) > NSTEP_SLACK
            or cpu["prot_break"] or cpu_r["prot_break"]):
        raise RuntimeError(f"GPU and CPU mixed tables disagree: {agree}")
    return gpu["fwd_launches"], test


def phase_solvers(device) -> None:
    """The radius-1 sweep mesh (the slice phase's) answered with the
    trained Dirichlet weights by each solver of ``SOLVER_CASES``: at the
    checkpoint's fw_tol on the card (timed, two launches per f_θ call),
    and at ``REACHABLE_TOL`` on the card and on the CPU (compared)."""
    from psignn_tpu_torch.data.fem import solve_poisson
    from psignn_tpu_torch.data.meshgen import blob_mesh
    from psignn_tpu_torch.data.reader import psignn_sample_from_fem
    from psignn_tpu_torch.graphs import batch_graphs
    rng = np.random.default_rng(0)
    mesh = blob_mesh(radius=1.0, hsize=0.08, rng=rng)
    sample = psignn_sample_from_fem(solve_poisson(mesh, 1.0, rng))
    cpu = torch.device("cpu")
    graphs = {dev: batch_graphs([sample], device=dev) for dev in (device, cpu)}

    def solve(dev, solver, ls, overrides=None):
        cfg, answer = counted_predictor(CKPT, dev, dict(
            solver=solver, ls=ls, **(overrides or {})))
        return cfg, answer(graphs[dev])[1]

    for solver, ls in SOLVER_CASES:
        reach = dict(fw_tol=REACHABLE_TOL)
        _, gpu_r = solve(device, solver, ls, reach)    # also the warm-up
        cfg, gpu = solve(device, solver, ls)
        _, cpu_r = solve(cpu, solver, ls, reach)
        low_rel = abs(gpu_r["lowest"] - cpu_r["lowest"]) / cpu_r["lowest"]
        rec = dict(solver=solver, ls=ls, n_nodes=graphs[cpu].total_nodes,
                   fw_tol=cfg.fw_tol, fw_thres=cfg.fw_thres, gpu=gpu,
                   reachable_tol=REACHABLE_TOL, gpu_reachable=gpu_r,
                   cpu_reachable=cpu_r, lowest_rel_diff=low_rel)
        emit("solvers", **rec)
        if (gpu["fwd_launches"] != 2 * gpu["f_calls"] or gpu["f_calls"] == 0
                or not np.isfinite(gpu["lowest"]) or gpu["prot_break"]
                or low_rel > LOWEST_REL_TOL
                or abs(gpu_r["nstep"] - cpu_r["nstep"]) > NSTEP_SLACK
                or cpu_r["prot_break"]):
            raise RuntimeError(f"solver {solver} (ls={ls}) failed: {rec}")


def phase_trainer(device) -> None:
    """A fresh 4-mesh × 5-sample dataset of each variant (12/4/4 split; the
    Dirichlet one with DSS's encoding), then for each run of
    ``TRAINER_RUNS`` one epoch of the CLI at batch 4 (three train steps,
    one validation step, with the power method for Ψ-GNN) and one request
    from the new best checkpoint: a sweep request (Dirichlet), the
    test-split table of ``run_eval`` (mixed).  The resumed run starts from
    CKPT's last epoch and answers from its final checkpoint (its
    validation residual on these meshes need not beat the checkpoint's
    best).  Each run draws its loss and gradient plots, or, without
    matplotlib, logs once that it does not.  Returns each run's (forward,
    backward) launches."""
    import importlib.util

    from psignn_tpu_torch.cli.main import main as train_main
    from psignn_tpu_torch.data.generate import add_dss_variable, generate_data
    from psignn_tpu_torch.eval import run_eval
    from psignn_tpu_torch.eval.curves import compare as curves_compare
    from psignn_tpu_torch.eval.curves import parse_epoch_times
    from psignn_tpu_torch.eval.sweep import growing_geometry_sweep
    from psignn_tpu_torch.kernels import fused_mp as mp
    from psignn_tpu_torch.train import TrainConfig
    from psignn_tpu_torch.weights import load_jax_checkpoint
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    root = os.path.join(".chipwork", "smoke_trainer")
    shutil.rmtree(root, ignore_errors=True)
    data = {}
    for variant in ("dirichlet", "mixed"):
        path = os.path.join(root, "data_" + variant)
        t0 = time.perf_counter()
        generate_data(path, n_mesh=4, n_samples=5, radius=1.0, hsize=0.08,
                      variant=variant, verbose=False)
        if variant == "dirichlet":
            add_dss_variable(path)
        data[variant] = (path, time.perf_counter() - t0)
    all_launches = {}
    for family, variant, flags in TRAINER_RUNS:
        path, gen_s = data[variant]
        run = "_".join([family, variant] + [f.strip("-") for f in flags
                                            if f.startswith("--")])
        work = os.path.join(root, run)
        results = os.path.join(work, "results")
        resume = "--resume" in flags
        epochs = 1 + (len(load_jax_checkpoint(CKPT)["hist_val"]["loss"])
                      if resume else 0)
        argv = ["--family", family, "--variant", variant, "--path_dataset",
                path, "--path_results", results, "--batch_size", "4",
                "--max_epochs", str(epochs), "--device", str(device), *flags]
        t0 = time.perf_counter()
        if "--num_devices" in flags:
            launches = trainer_world(
                argv, int(flags[flags.index("--num_devices") + 1]))
        else:
            mp.LAUNCHES = mp.BWD_LAUNCHES = 0
            train_main(argv)
            launches = (mp.LAUNCHES, mp.BWD_LAUNCHES)
        train_s = time.perf_counter() - t0
        logs = os.path.join(results, "logs")
        lines = {}
        for name in ("train_metrics.csv", "forward_iteration.csv",
                     "backward_iteration.csv", "spectral_radius.csv",
                     "model_config.csv"):
            with open(os.path.join(logs, name)) as f:
                lines[name] = len(f.read().strip().splitlines())
        metrics = os.path.join(logs, "train_metrics.csv")
        # the trainer draws its plots at every plot_every-th epoch, or
        # logs once that matplotlib is missing
        with open(metrics) as f:
            plots = dict(files=sorted(n for n in os.listdir(logs)
                                      if n.endswith(".png")),
                         not_drawn_lines=f.read().count("Plots not drawn"))
        if (epochs - 1) % TrainConfig.plot_every:
            want_plots = dict(files=[], not_drawn_lines=0)
        elif has_mpl:
            want_plots = dict(files=["gradients.png", "track_losses.png"],
                              not_drawn_lines=0)
        else:
            want_plots = dict(files=[], not_drawn_lines=1)
        logged = trainer_log_agreement(
            metrics, os.path.join(results, "ckpt", "final_model.ckpt"))
        if run in TRAINER_PREFETCH_RUNS:
            epoch_s = parse_epoch_times(metrics)
            emit("trainer_prefetch", run=run, epoch_s=epoch_s,
                 serial_batch_build_s=loader_build_seconds(argv, device),
                 train_s=train_s)
        if run == TRAINER_CURVES_RUN:
            rows = curves_compare(metrics, TRAINER_CURVES_REF)[0]
            emit("trainer_curves", run=run, ref=TRAINER_CURVES_REF,
                 rows=[dict(epoch=e, our_epoch=ee, res=o, ref_res=r,
                            ratio=ratio, mse=om, ref_mse=rm)
                       for e, ee, o, r, ratio, om, rm in rows])
            if not rows:
                raise RuntimeError("curves.compare matched no epoch")
        ckpts = {name: os.path.exists(os.path.join(results, "ckpt",
                                                   name + ".ckpt"))
                 for name in ("running_model", "best_model", "final_model")
                 if not (resume and name == "best_model")}
        best = os.path.join(results, "ckpt", ("final_model" if resume
                                              else "best_model") + ".ckpt")
        if resume:
            final = load_jax_checkpoint(best)
            if len(final["hist_val"]["loss"]) != epochs:
                raise RuntimeError(f"the resumed run trained "
                                   f"{len(final['hist_val']['loss'])} "
                                   f"epochs in all, not {epochs}")
        if variant == "dirichlet":
            predict, fam, _, _ = run_eval.load_predictor(best, device)
            req = growing_geometry_sweep(
                {fam: predict}, radii=(1.0,), n_meshes=1, hsize=0.08,
                seed=0, device=device, warmup=False,
                families=sweep_forms(fam))[fam][1.0]
            req = {k: req[k] for k in ("n_nodes", "nstep", "res", "mse")}
        else:
            out = os.path.join(work, "eval")
            run_eval.main(["--ckpt", best, "--variant", "mixed",
                           "--path_dataset", path, "--batch_size", "4",
                           "--out", out, "--device", str(device)])
            with open(os.path.join(out, "test_metrics.json")) as f:
                table = json.load(f)
            req = dict(res=table["res_mean"], mse=table["mse_mean"],
                       rel=table["rel_mean"])
        rec = dict(run=run, family=family, variant=variant, flags=flags,
                   generate_s=gen_s, train_s=train_s,
                   fwd_launches=launches[0], bwd_launches=launches[1],
                   log_lines=lines, checkpoints=ckpts, request=req,
                   parsed_val_epochs=logged, plots=plots)
        emit("trainer", **rec)
        all_launches[run] = launches
        # Ψ-GNN: header + 3 steps in each iteration log, one spectral
        # radius; the unrolled families write the headers only
        psignn = family == "psignn"
        if (not all(ckpts.values()) or 0 in launches
                or lines["forward_iteration.csv"] != (4 if psignn else 1)
                or lines["backward_iteration.csv"] != (4 if psignn else 1)
                or lines["spectral_radius.csv"] != (2 if psignn else 1)
                or plots != want_plots
                or not finite(req["res"], req["mse"])):
            raise RuntimeError(f"trainer phase failed: {rec}")
    return all_launches


def trainer_log_agreement(metrics: str, ckpt: str) -> list:
    """``curves.parse_val`` of a run's ``train_metrics.csv`` against the
    validation residual and MSE its trainer kept (the checkpoint's
    ``hist_val``), as the log's ``%.5e`` prints them; the epochs parsed."""
    from psignn_tpu_torch.eval.curves import parse_val
    from psignn_tpu_torch.weights import load_jax_checkpoint
    hist = load_jax_checkpoint(ckpt)["hist_val"]
    parsed = parse_val(metrics)
    for e, (res, mse) in parsed.items():
        want = (float(f"{hist['residual_loss'][e]:.5e}"),
                float(f"{hist['mse_loss'][e]:.5e}"))
        if (res, mse) != want:
            raise RuntimeError(f"{metrics}: epoch {e} parsed as "
                               f"{(res, mse)}, logged {want}")
    if not parsed:
        raise RuntimeError(f"{metrics}: no validation line parsed")
    return sorted(parsed)


def loader_build_seconds(argv: list, device) -> float:
    """Seconds to build one epoch of a CLI run's train and validation
    batches serially on ``device``: its loaders, as ``cli.main`` builds
    them (``build_loaders``), iterated bare, with nothing else running."""
    from psignn_tpu_torch.cli.main import build_loaders, get_parser
    loaders = build_loaders(get_parser().parse_args(argv), device)
    sync(device)
    t0 = time.perf_counter()
    for loader in loaders:
        for _ in loader:
            pass
    sync(device)
    return time.perf_counter() - t0


def trainer_rank(rank: int, n: int, port: int, argv: list) -> tuple:
    """One rank of a torchrun-style launch of the training CLI (the
    launcher's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_*``): its (forward,
    backward) launches, counted from 0 just before the command."""
    from psignn_tpu_torch.cli.main import main as train_main
    from psignn_tpu_torch.kernels import fused_mp as mp
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    mp.LAUNCHES = mp.BWD_LAUNCHES = 0
    train_main(argv)
    return mp.LAUNCHES, mp.BWD_LAUNCHES


def trainer_world(argv: list, n: int) -> tuple:
    """``argv`` (with ``--num_devices n``) on ``n`` ranks launched as
    torchrun launches them; their launches summed."""
    from psignn_tpu_torch.dist import multihost
    ranks = multihost.spawn(trainer_rank, n, (n, multihost.free_port(), argv),
                            timeout=DIST_TIMEOUT)
    return tuple(sum(r[i] for r in ranks) for i in (0, 1))


def mp_per_step(cfg) -> int:
    """Fused message passings in one DS-GPS or DSS step, each one kernel
    launch: ``phi_to`` and ``phi_from``, and ``phi_neumann`` in the mixed
    DS-GPS."""
    return 3 if getattr(cfg, "bc_mode", "dirichlet") == "mixed" else 2


def sweep_forms(family: str) -> tuple:
    """The sample forms a sweep builds for a family's predictor."""
    return ("psignn", "dss") if family == "dss" else ("psignn",)


def finite(*values) -> bool:
    return all(np.isfinite(v) for v in values)


def sweep_graphs(radii, devices, family: str = "psignn") -> dict:
    """{radius: [graph on each device]}: the sweep's meshes (seed 0, one a
    radius of ``SWEEP_RADII``, as the slice phase's) at ``radii``, in the
    family's sample form."""
    from psignn_tpu_torch.data.meshgen import blob_mesh
    from psignn_tpu_torch.eval.sweep import build_data
    from psignn_tpu_torch.graphs import batch_graphs
    form = "dss" if family == "dss" else "psignn"
    rng = np.random.default_rng(0)
    out = {}
    for r in SWEEP_RADII:
        if r > max(radii):
            break
        mesh = blob_mesh(radius=r, hsize=0.08, rng=rng)
        sample = build_data(mesh, r, rng, (form,))[form]
        if r in radii:
            out[r] = [batch_graphs([sample], device=d) for d in devices]
    return out


def phase_families(device) -> None:
    """A sweep request of each family's trained Dirichlet checkpoint (one
    mesh at each of ``SWEEP_RADII``) through the user's entry points, with
    each request's kernel launches; then the radius-1 request of DS-GPS
    and DSS on the CPU."""
    from psignn_tpu_torch.eval.metrics import errors_batch
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.eval.sweep import growing_geometry_sweep
    from psignn_tpu_torch.kernels import fused_mp as mp
    cpu = torch.device("cpu")
    for family, ckpt in FAMILY_CKPTS.items():
        predict, _, cfg, _ = load_predictor(ckpt, device)
        deltas = []

        def counted(graph):
            before = mp.LAUNCHES
            out = predict(graph)
            deltas.append(mp.LAUNCHES - before)
            return out

        mp.LAUNCHES = mp.BWD_LAUNCHES = 0
        summary = growing_geometry_sweep(
            {family: counted}, radii=SWEEP_RADII, n_meshes=1, hsize=0.08,
            seed=0, device=device, families=sweep_forms(family))[family]
        launches = (mp.LAUNCHES, mp.BWD_LAUNCHES)
        # DS-GPS and DSS: one launch per message passing, k steps
        want = None if family == "psignn" else mp_per_step(cfg) * cfg.k
        for i, r in enumerate(SWEEP_RADII):
            m = summary[r]
            # the timed call of each mesh follows its warm-up
            req = dict(family=family, radius=r, n_nodes=int(m["n_nodes"]),
                       n_edges=int(m["n_edges"]), seconds=m["time"],
                       res=m["res"], rel=m["rel"], mse=m["mse"],
                       nstep=int(m["nstep"]), launches=deltas[2 * i + 1],
                       expected_launches=want)
            emit("families", **req)
            if (not finite(req["seconds"], req["res"], req["rel"])
                    or req["launches"] == 0
                    or want is not None and req["launches"] != want):
                raise RuntimeError(f"families request failed: {req}")
        if launches[0] == 0 or launches[1]:
            raise RuntimeError(f"{family} sweep launched {launches}")
        if family == "psignn":
            continue     # compared with the CPU by the slice phase
        gpu_g, cpu_g = sweep_graphs((1.0,), (device, cpu), family)[1.0]
        u_gpu = predict(gpu_g)
        u_cpu = load_predictor(ckpt, cpu)[0](cpu_g)
        res_gpu = float(errors_batch(u_gpu, gpu_g)["res"][0])
        res_cpu = float(errors_batch(u_cpu, cpu_g)["res"][0])
        u_diff = float((u_gpu.cpu() - u_cpu).abs().max())
        scale = max(1.0, float(u_cpu.abs().max()))
        rec = dict(family=family, k=cfg.k, n_nodes=cpu_g.total_nodes,
                   res_gpu=res_gpu, res_cpu=res_cpu,
                   res_rel_diff=abs(res_gpu - res_cpu) / res_cpu,
                   res_rtol=RES_REL_TOL, u_max_abs_diff=u_diff,
                   u_scale=scale, u_tol=UNROLLED_U_TOL)
        emit("families_cpu_agreement", **rec)
        if (u_diff > UNROLLED_U_TOL * scale
                or rec["res_rel_diff"] > RES_REL_TOL):
            raise RuntimeError(f"GPU and CPU {family} requests disagree: "
                               f"{rec}")


def phase_dsgps_mixed_eval(test, device) -> None:
    """The mixed_eval phase's test batch answered by the trained mixed
    DS-GPS through ``run_eval``'s path (``load_predictor`` →
    ``GraphLoader`` → ``evaluate_dataset``), on the card and on the CPU."""
    from psignn_tpu_torch.data.reader import GraphLoader
    from psignn_tpu_torch.eval.metrics import evaluate_dataset
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.kernels import fused_mp as mp

    def table(dev):
        predict, _, cfg, _ = load_predictor(DSGPS_MIXED_CKPT, dev)
        rec = {}

        def answer(graph):
            sync(dev)
            mp.LAUNCHES = mp.BWD_LAUNCHES = 0
            t0 = time.perf_counter()
            u = predict(graph)
            sync(dev)
            rec.update(seconds=time.perf_counter() - t0,
                       fwd_launches=mp.LAUNCHES, bwd_launches=mp.BWD_LAUNCHES,
                       u=u.cpu())
            return u

        loader = GraphLoader(test, batch_size=len(test), device=dev)
        means = {k: v for k, v in evaluate_dataset(
            answer, loader, verbose=False).items() if k.endswith("_mean")}
        return cfg, rec.pop("u"), dict(rec, **means)

    cfg, u_gpu, gpu = table(device)
    want = mp_per_step(cfg) * cfg.k
    emit("dsgps_mixed_eval", k=cfg.k, n_graphs=len(test),
         n_nodes=sum(len(s["x"]) for s in test), expected_launches=want,
         **gpu)
    if (gpu["fwd_launches"] != want or gpu["bwd_launches"]
            or not finite(*(v for k, v in gpu.items()
                            if k.endswith("_mean")))):
        raise RuntimeError(f"dsgps_mixed_eval failed: {gpu}")
    _, u_cpu, cpu = table("cpu")
    u_diff = float((u_gpu - u_cpu).abs().max())
    scale = max(1.0, float(u_cpu.abs().max()))
    rec = dict(gpu_res_mean=gpu["res_mean"], cpu_res_mean=cpu["res_mean"],
               res_rel_diff=abs(gpu["res_mean"] - cpu["res_mean"])
               / cpu["res_mean"], res_rtol=RES_REL_TOL,
               u_max_abs_diff=u_diff, u_scale=scale, u_tol=UNROLLED_U_TOL)
    emit("dsgps_mixed_eval_cpu_agreement", **rec)
    if u_diff > UNROLLED_U_TOL * scale or rec["res_rel_diff"] > RES_REL_TOL:
        raise RuntimeError(f"GPU and CPU mixed DS-GPS tables disagree: {rec}")


def unrolled_step_from(model, cfg, init, graph, lr: float, opt=None):
    """One ``unrolled_train_step`` from the parameters ``init`` with the
    Adam ``opt`` (default: a fresh one), timed by the host clock around
    it.  The loss and gradients depend on the parameters only; an Adam that
    already took a step has its state and skips the lazy creation of two
    moment tensors per parameter (DSS has 480 parameter tensors), as every
    step after a run's first does."""
    from psignn_tpu_torch.train import make_adam, unrolled_train_step
    model.load_state_dict(init)
    opt = opt or make_adam(model, lr)
    sync(graph.device)
    t0 = time.perf_counter()
    res = unrolled_train_step(model, opt, graph, cfg, lr, UNROLLED_CLIP)
    sync(graph.device)
    return res, time.perf_counter() - t0


def phase_unrolled_train_step(built, device, smi: str) -> None:
    """Each case of ``UNROLLED_CASES`` on its 50-mesh batch of ``built``
    ({(form, variant): (graph, build seconds)}): a warm-up, three timed
    steps from the same parameters with one Adam (which the warm-up
    initialised) and their kernel launches, one profiled step, then a
    2-mesh step on the GPU against the CPU."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    from psignn_tpu_torch.train import make_adam
    for case, ckpt, form, variant, lr in UNROLLED_CASES:
        graph, graph_s = built[(form, variant)]
        t0 = time.perf_counter()
        model, cfg, init = trained_model(device, ckpt=ckpt)
        setup_s = graph_s + time.perf_counter() - t0
        opt = make_adam(model, lr)
        _, first_s = unrolled_step_from(model, cfg, init, graph, lr, opt)
        torch.cuda.reset_peak_memory_stats()
        # one forward and one backward launch per message passing
        want = (mp_per_step(cfg) * cfg.k,) * 2
        steps = []
        for _ in range(3):
            mp.LAUNCHES = mp.BWD_LAUNCHES = 0
            res, wall = unrolled_step_from(model, cfg, init, graph, lr, opt)
            launches = (mp.LAUNCHES, mp.BWD_LAUNCHES)
            rec = dict(seconds=wall, loss=res.loss, losses=res.losses,
                       grad_norm=res.grad_norm, fwd_launches=launches[0],
                       bwd_launches=launches[1], expected_launches=list(want))
            steps.append(rec)
            if (not finite(res.loss, res.grad_norm, *res.losses.values())
                    or launches != want):
                raise RuntimeError(f"unrolled_train_step {case} failed: "
                                   f"{rec}")
        best = min(r["seconds"] for r in steps)
        emit("unrolled_train_step", card=smi, case=case, k=cfg.k, lr=lr,
             clip=UNROLLED_CLIP, n_meshes=TRAIN_MESHES,
             n_nodes=graph.total_nodes, n_edges=int(graph.senders.shape[0]),
             mp_edges=graph.mp_to.n_edges, setup_s=setup_s,
             first_step_s=first_s, step_s=best,
             step_s_all=[r["seconds"] for r in steps],
             peak_mem_bytes=torch.cuda.max_memory_allocated(), steps=steps)
        emit("unrolled_train_step_profile", card=smi, case=case,
             unprofiled_step_s=best, **device_breakdown(
                 lambda: unrolled_step_from(model, cfg, init, graph, lr,
                                            opt)))
        unrolled_cpu_agreement(case, ckpt, form, variant, lr, device)


def unrolled_cpu_agreement(case: str, ckpt: str, form: str, variant: str,
                           lr: float, device) -> None:
    """The same unrolled step on 2 meshes on the GPU and on the CPU."""
    out = []
    for dev in (device, torch.device("cpu")):
        graph = train_graph(CMP_MESHES, 1, dev, variant, form)
        model, cfg, init = trained_model(dev, ckpt=ckpt)
        res, _ = unrolled_step_from(model, cfg, init, graph, lr)
        out.append((res, {k: p.grad.detach().cpu() for k, p in
                          model.named_parameters() if p.grad is not None}))
    (gpu, ggrad), (cpu, cgrad) = out

    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a)

    def norm(t):
        return float(torch.linalg.vector_norm(t))

    loss_rel = {k: rel(gpu.losses[k], cpu.losses[k]) for k in cpu.losses}
    total = norm(torch.cat([g.flatten() for g in cgrad.values()]))
    diff = {k: norm(ggrad[k] - cgrad[k]) for k in cgrad}
    own = {k: diff[k] / max(norm(cgrad[k]), 1e-30) for k in cgrad}
    rec = dict(case=case, n_meshes=CMP_MESHES, gpu_loss=gpu.loss,
               cpu_loss=cpu.loss, gpu_grad_norm=gpu.grad_norm,
               cpu_grad_norm=cpu.grad_norm,
               max_loss_rel_diff=max(loss_rel.values()),
               worst_loss=max(loss_rel, key=loss_rel.get),
               max_grad_diff_of_total=max(diff.values()) / total,
               worst_grad=max(diff, key=diff.get),
               max_grad_rel_diff_own=max(own.values()),
               worst_grad_own=max(own, key=own.get),
               loss_rtol=UNROLLED_LOSS_RTOL, grad_tol=UNROLLED_GRAD_TOL)
    emit("unrolled_train_step_cpu_agreement", **rec)
    if (rec["max_loss_rel_diff"] > UNROLLED_LOSS_RTOL
            or rec["max_grad_diff_of_total"] > UNROLLED_GRAD_TOL
            or set(ggrad) != set(cgrad)):
        raise RuntimeError(f"GPU and CPU unrolled steps disagree: {rec}")


def stats(s) -> list:
    """A ``SolveStats`` as JSON: [lowest, nstep, calls], per-graph lists
    for a stacked step's."""
    return [np.asarray(v).tolist() for v in s]


def phase_stacked_train_step(graph, graph_s: float, device, smi: str
                             ) -> tuple[int, int]:
    """``train_step`` on the 50-mesh Dirichlet batch with one DEQ solve
    per mesh (``--stacked_batch``): a warm-up, one timed step with its
    kernel launches (f_θ runs on the whole batch once per iteration of the
    slowest mesh) and each mesh's forward steps, one profiled step, then
    the 2-mesh stacked step on the GPU against the CPU.  Returns the timed
    step's (forward, backward) launches."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    t0 = time.perf_counter()
    model, cfg, init = trained_model(device, TRAIN_OVERRIDES)
    setup_s = graph_s + time.perf_counter() - t0
    step_from(model, cfg, init, graph, stacked=True)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    mp.LAUNCHES = mp.BWD_LAUNCHES = 0
    res, wall = step_from(model, cfg, init, graph, stacked=True)
    launches = (mp.LAUNCHES, mp.BWD_LAUNCHES)
    want = expected_launches(res, cfg)
    fw_nstep = np.asarray(res.fw.nstep).tolist()
    prof = device_breakdown(lambda: step_from(model, cfg, init, graph,
                                              stacked=True))
    rec = dict(card=smi, n_meshes=TRAIN_MESHES, n_nodes=graph.total_nodes,
               setup_s=setup_s, step_s=wall, loss=res.loss,
               losses=res.losses, grad_norm=res.grad_norm,
               fw_nstep_per_graph=fw_nstep, fw=stats(res.fw),
               bw=stats(res.bw), fwd_launches=launches[0],
               bwd_launches=launches[1], expected_launches=list(want),
               busy_share=prof["device_kernel_s"] / wall,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    emit("stacked_train_step", **rec)
    emit("stacked_train_step_profile", card=smi, unprofiled_step_s=wall,
         **prof)
    if (not finite(res.loss, res.grad_norm, *res.losses.values())
            or launches != want or 0 in launches
            or len(set(fw_nstep)) == 1 or len(fw_nstep) != TRAIN_MESHES):
        raise RuntimeError(f"stacked_train_step failed: {rec}")
    phase_train_step_cpu_agreement(device, CKPT, "dirichlet",
                                   "stacked_train_step", stacked=True)
    return launches


# the lowrank phase: (max_rank, bfloat16 pairs) of each headline run; 640
# rounds to 640 > 531 iterations (never wraps), 128 wraps from step 129
LOWRANK_CASES = ((640, False), (640, True), (128, False), (128, True))
# its GPU-vs-CPU check: an 8-pair ring (the rank block set to 8) on the
# radius-1 sweep mesh, 16 steps at fw_tol 0 (the ring wraps from step 9),
# each step's residual within 1e-2 (the JAX package and the port hold a
# wrapped ring to 2e-3 on an analytic problem, tests/test_torch_lowrank.py).
# With bfloat16 pairs an f32-order difference that moves a right-hand side
# across a bfloat16 rounding boundary changes it by 0.4 %: the card and
# the CPU part at step 12 (10 % apart there; run 1, PR 6), so bfloat16 is
# compared over steps 1-11, three of them after the ring wraps.
LOWRANK_CMP_BLOCK = 8
LOWRANK_CMP_ITERS = {False: 16, True: 11}
LOWRANK_TRACE_RTOL = 1e-2
RANK_RANGE = "broyden_rank_products"


def phase_lowrank(graph, device, smi: str) -> int:
    """The headline loop (seeded weights, 531 iterations at fw_tol 0, the
    radius-5 mesh) with Broyden's rank memory capped and/or in bfloat16:
    at max_rank 640 each run must equal full memory (run first, the
    reference) bit for bit; at 128 the ring wraps.  Wall of each run;
    device time and the rank products' device time (the kernels launched
    inside ``solvers._rank_products``, labelled for the profiler here) of
    each run whose ring wraps; then the capped solver on the card against
    the CPU.  A graph's replay launches its kernels outside any host
    range, so the profiled run steps the same carried body eagerly
    (``loop._GRAPHS``): the same kernels, each inside its range.
    Returns the launches of the timed runs."""
    from psignn_tpu_torch import solvers
    from psignn_tpu_torch.deq import fixed_point_forward
    from psignn_tpu_torch.kernels import fused_mp as mp
    from psignn_tpu_torch.models import Psignn, PsignnConfig
    model = Psignn(PsignnConfig(), generator=torch.Generator().manual_seed(0),
                   device=device).eval()

    def run(max_rank, bf16):
        cfg = PsignnConfig(fw_tol=0.0, fw_thres=HEADLINE_ITERS,
                           lowrank_max_rank=max_rank, lowrank_bf16=bf16)
        with torch.no_grad():
            h0 = model.encoder(graph.x) * graph.fnode_mask
            out = fixed_point_forward(model.function, h0, graph, cfg.deq)
        torch.cuda.synchronize()
        return out

    real = solvers._rank_products

    def labelled(*args):
        with torch.profiler.record_function(RANK_RANGE):
            return real(*args)

    full, total = {}, 0
    for max_rank, bf16 in ((0, False), (0, True)) + LOWRANK_CASES:
        mp.LAUNCHES = 0
        t0 = time.perf_counter()
        out = run(max_rank, bf16)
        wall = time.perf_counter() - t0
        launches = mp.LAUNCHES
        total += launches
        if max_rank == 0:           # full memory: the reference of its dtype
            full[bf16] = out
        ref = full[bf16]
        same = (torch.equal(out.result, ref.result)
                and torch.equal(out.rel_trace, ref.rel_trace)
                and out.lowest == ref.lowest)
        rec = dict(card=smi, max_rank=max_rank, bf16=bf16,
                   cap=solvers.rank_cap(HEADLINE_ITERS, max_rank),
                   iters=out.trace_len - 1, wall_s=wall,
                   lowest=out.lowest, nstep=out.nstep,
                   prot_break=out.prot_break, launches=launches,
                   equals_full_memory=same)
        if 0 < max_rank < HEADLINE_ITERS:
            # a profile of this loop takes about 14 s (28,000 launches):
            # the full-memory references are not profiled, and neither are
            # the cap-640 runs, which repeat their arithmetic bit for bit
            solvers._rank_products = labelled
            try:
                with loop_switch(graphs=False):
                    prof = device_breakdown(lambda: run(max_rank, bf16),
                                            ranges=(RANK_RANGE,))
            finally:
                solvers._rank_products = real
            rank_s = prof[RANK_RANGE + "_device_s"]
            rec.update(device_kernel_s=prof["device_kernel_s"],
                       rank_products_device_s=rank_s,
                       rank_products_share=rank_s / prof["device_kernel_s"],
                       busy_share=prof["device_kernel_s"] / wall,
                       top_kernels=prof["kernels"][:4])
        emit("lowrank", **rec)
        if (out.trace_len - 1 != HEADLINE_ITERS or not np.isfinite(out.lowest)
                or launches != 2 * (HEADLINE_ITERS + 1)
                or (max_rank >= HEADLINE_ITERS and not same)):
            raise RuntimeError(f"lowrank run failed: {rec}")
    lowrank_cpu_agreement(device)
    return total


def lowrank_cpu_agreement(device) -> None:
    """The trained Dirichlet weights on the radius-1 sweep mesh with an
    8-pair ring (the rank block set to ``LOWRANK_CMP_BLOCK``), f32 and
    bfloat16 pairs, for ``LOWRANK_CMP_ITERS[bf16]`` steps at fw_tol 0 on
    the card and on the CPU: the residual traces step by step within
    ``LOWRANK_TRACE_RTOL``."""
    from psignn_tpu_torch import solvers
    from psignn_tpu_torch.deq import fixed_point_forward
    from psignn_tpu_torch.weights import load_psignn_checkpoint
    cpu = torch.device("cpu")
    graphs = dict(zip((device, cpu),
                      sweep_graphs((1.0,), (device, cpu))[1.0]))

    def trace(dev, bf16):
        model, cfg = load_psignn_checkpoint(CKPT, dev, dict(
            fw_tol=0.0, fw_thres=LOWRANK_CMP_ITERS[bf16], lowrank_bf16=bf16,
            lowrank_max_rank=LOWRANK_CMP_BLOCK))
        g = graphs[dev]
        with torch.no_grad():
            h0 = model.encoder(g.x) * g.fnode_mask
            out = fixed_point_forward(model.function, h0, g, cfg.deq)
        return out.rel_trace.numpy()

    block = solvers._LR_BLOCK
    solvers._LR_BLOCK = LOWRANK_CMP_BLOCK
    try:
        for bf16 in (False, True):
            gpu, cpu_t = trace(device, bf16), trace(cpu, bf16)
            rel = float(np.max(np.abs(gpu / cpu_t - 1.0)))
            rec = dict(bf16=bf16, max_rank=LOWRANK_CMP_BLOCK,
                       block=LOWRANK_CMP_BLOCK, iters=LOWRANK_CMP_ITERS[bf16],
                       gpu_rel_trace=gpu.tolist(),
                       cpu_rel_trace=cpu_t.tolist(),
                       max_rel_diff=rel, rtol=LOWRANK_TRACE_RTOL)
            emit("lowrank_cpu_agreement", **rec)
            if not rel <= LOWRANK_TRACE_RTOL:
                raise RuntimeError(f"GPU and CPU capped solves disagree: "
                                   f"{rec}")
    finally:
        solvers._LR_BLOCK = block


ZOO_CMP_SHAPE = "heart"


def _zoo(device, shapes=None, overrides=None, warmup=True):
    """``run_eval --zoo``'s path (``load_predictor`` →
    ``geometry_zoo_eval``) with the Dirichlet checkpoint: {shape: metrics},
    each with the kernel launches of its timed call."""
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.eval.sweep import geometry_zoo_eval
    from psignn_tpu_torch.kernels import fused_mp as mp
    predict, family, _, _ = load_predictor(CKPT, device, overrides)
    deltas = []

    def counted(graph):
        before = mp.LAUNCHES
        out = predict(graph)
        deltas.append(mp.LAUNCHES - before)
        return out

    zoo = geometry_zoo_eval({family: counted}, shapes=shapes, device=device,
                            warmup=warmup)
    per = 2 if warmup else 1
    return {shape: dict(m[family], launches=deltas[per * (i + 1) - 1])
            for i, (shape, m) in enumerate(zoo.items())}


def phase_zoo(device) -> int:
    """All 12 zoo shapes answered on the card by the trained Dirichlet
    Ψ-GNN; then ``ZOO_CMP_SHAPE`` on the card and the CPU: at the
    checkpoint's fw_tol the answer's residual and MSE within RES_REL_TOL,
    at REACHABLE_TOL the steps within NSTEP_SLACK.  (The best residual at
    REACHABLE_TOL, which the slice phase compares on its own mesh, stood
    8 % apart here at the same step in run 2 of PR 6: this mesh's
    trajectory parts earlier.)  Returns the launches of the 12 timed
    requests."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    mp.LAUNCHES = 0
    zoo = _zoo(device)
    for shape, m in zoo.items():
        emit("zoo", shape=shape, **m)
        if (not finite(m["res"], m["mse"], m["time"]) or m["launches"] == 0
                or m["prot_break"]):
            raise RuntimeError(f"zoo request {shape} failed: {m}")
    if len(zoo) != 12:
        raise RuntimeError(f"the zoo answered {len(zoo)} shapes, not 12")
    one = [ZOO_CMP_SHAPE]
    (gpu,), (cpu,) = (_zoo(d, one, warmup=False).values()
                      for d in (device, "cpu"))
    reach = dict(fw_tol=REACHABLE_TOL)
    (gpu_r,), (cpu_r,) = (_zoo(d, one, reach, warmup=False).values()
                          for d in (device, "cpu"))
    rel = {k: abs(gpu[k] - cpu[k]) / cpu[k] for k in ("res", "mse")}
    rec = dict(shape=ZOO_CMP_SHAPE, gpu=gpu, cpu=cpu, rel_diff=rel,
               res_rtol=RES_REL_TOL, reachable_tol=REACHABLE_TOL,
               gpu_reachable=gpu_r, cpu_reachable=cpu_r)
    emit("zoo_cpu_agreement", **rec)
    if (max(rel.values()) > RES_REL_TOL
            or abs(gpu_r["nstep"] - cpu_r["nstep"]) > NSTEP_SLACK):
        raise RuntimeError(f"GPU and CPU zoo requests disagree: {rec}")
    return sum(m["launches"] for m in zoo.values())


# the iterative phase compares the first iterates' residuals, reached
# before f32 order moves a Broyden trajectory
ITERATIVE_CMP_ITERS = 10


def phase_iterative(device) -> int:
    """``psignn_iterative_inference`` of the trained Dirichlet Ψ-GNN on the
    radius-1 sweep mesh: the decoded trace of every iterate and its
    metrics, on the card (launches: 2 per f_θ call) and on the CPU at
    REACHABLE_TOL (steps, x's own metrics, and the first
    ITERATIVE_CMP_ITERS iterates' residuals within RES_REL_TOL).  Returns
    the card's launches at the checkpoint's fw_tol."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    from psignn_tpu_torch.models import psignn_iterative_inference
    from psignn_tpu_torch.weights import load_psignn_checkpoint
    cpu = torch.device("cpu")
    graphs = dict(zip((device, cpu),
                      sweep_graphs((1.0,), (device, cpu))[1.0]))

    def trace(dev, overrides=None):
        model, cfg = load_psignn_checkpoint(CKPT, dev, overrides)
        calls = FCalls()
        model.function.register_forward_hook(calls)
        sync(dev)
        mp.LAUNCHES = 0
        t0 = time.perf_counter()
        with calls:
            out = psignn_iterative_inference(model, graphs[dev], cfg)
        sync(dev)
        n = out["trace_len"]
        res = out["trace"]["res"].cpu().numpy()
        return out, dict(seconds=time.perf_counter() - t0, nstep=out["nstep"],
                         trace_len=n, f_calls=calls.calls,
                         launches=mp.LAUNCHES,
                         entries=int(out["trace"]["u"].shape[0]),
                         res_initial=float(out["initial"]["res"]),
                         res_first=res[:ITERATIVE_CMP_ITERS].tolist(),
                         res_last=float(res[n - 1]),
                         mse_last=float(out["trace"]["mse"][n - 1]))

    _, gpu = trace(device)
    emit("iterative", **gpu)
    if (gpu["launches"] != 2 * gpu["f_calls"] or gpu["f_calls"] == 0
            or not finite(gpu["res_last"], gpu["mse_last"])):
        raise RuntimeError(f"iterative failed: {gpu}")
    reach = dict(fw_tol=REACHABLE_TOL)
    (_, gpu_r), (_, cpu_r) = trace(device, reach), trace(cpu, reach)
    first_rel = float(np.max(np.abs(np.subtract(gpu_r["res_first"],
                                                cpu_r["res_first"]))
                             / np.abs(cpu_r["res_first"])))
    rec = dict(reachable_tol=REACHABLE_TOL, gpu=gpu_r, cpu=cpu_r,
               first_res_rel_diff=first_rel, res_rtol=RES_REL_TOL)
    emit("iterative_cpu_agreement", **rec)
    if (first_rel > RES_REL_TOL
            or abs(gpu_r["nstep"] - cpu_r["nstep"]) > NSTEP_SLACK
            or abs(gpu_r["res_initial"] - cpu_r["res_initial"])
            > 1e-6 * cpu_r["res_initial"]):
        raise RuntimeError(f"GPU and CPU iterate traces disagree: {rec}")
    return gpu["launches"]


# several_init's answers at the checkpoint's fw_tol: across 1, 2 and 8 CPU
# threads their residuals move by up to 0.2 % and their MSEs by up to
# 1.4 % (the exact-solution start's), so the card is held to RES_REL_TOL
# and to this on the MSE
SEVERAL_INIT_MSE_RTOL = 0.05


def phase_several_init(device) -> int:
    """``test_several_init`` of the trained Dirichlet Ψ-GNN on the radius-1
    sweep mesh's sample (zero, default, uniform random in [−10, 10] and
    exact-solution starting points) on the card and on the CPU, at the
    checkpoint's fw_tol: each start's residual within RES_REL_TOL and MSE
    within SEVERAL_INIT_MSE_RTOL.  Returns the card's launches."""
    from psignn_tpu_torch.data.meshgen import blob_mesh
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.eval.sweep import build_data, test_several_init
    from psignn_tpu_torch.kernels import fused_mp as mp
    rng = np.random.default_rng(0)
    sample = build_data(blob_mesh(radius=1.0, hsize=0.08, rng=rng), 1.0,
                        rng, ("psignn",))["psignn"]
    out = {}
    for dev in (device, "cpu"):
        predict = load_predictor(CKPT, dev)[0]
        mp.LAUNCHES = 0
        t0 = time.perf_counter()
        out[dev] = test_several_init(predict, sample, device=dev)
        sync(dev)
        out[dev] = dict(inits=out[dev], seconds=time.perf_counter() - t0,
                        launches=mp.LAUNCHES)
    gpu, cpu = out[device], out["cpu"]
    rel = {init: {k: abs(m[k] - cpu["inits"][init][k])
                  / abs(cpu["inits"][init][k]) for k in ("res", "mse")}
           for init, m in gpu["inits"].items()}
    rec = dict(gpu=gpu, cpu=cpu, rel_diff=rel, res_rtol=RES_REL_TOL,
               mse_rtol=SEVERAL_INIT_MSE_RTOL)
    emit("several_init", **rec)
    if (gpu["launches"] == 0 or len(gpu["inits"]) != 4
            or not finite(*(v for m in gpu["inits"].values()
                            for v in m.values()))
            or max(r["res"] for r in rel.values()) > RES_REL_TOL
            or max(r["mse"] for r in rel.values()) > SEVERAL_INIT_MSE_RTOL):
        raise RuntimeError(f"several_init failed: {rec}")
    return gpu["launches"]


# --------------------------------------------------------------- multi-rank
#
# The smoke runs on one card: every multi-rank world below puts its ranks
# on cuda:0 over gloo (NCCL refuses two ranks on one card), each rank one
# process spawned from this script; one world of one rank checks NCCL.
# Each job below runs on every rank of its world and returns what the
# parent checks; every rank counts its own kernel launches.

# the partitioned request: Picard at a reachable fw_tol on the radius-5
# mesh, compared as JAX's tests/test_halo.py:113-151 compares its
# partitioned solve with one device — |Δnstep| ≤ 1, the residual of a step
# both solves took within 5e-2, u within 1e-2 relative and 2e-3 absolute,
# the mesh's residual within 1e-3.  Picard's iterates contract whatever
# the f32 summation order; Broyden's, with the trained weights on this
# mesh, part under it well before fw_tol 1e-4 (on the CPU, one process
# against two ranks: 409 and 337 steps, u 17 % apart), so its
# partitioned solve is held to the CPU's at the f32 floor instead
# (dist_partitioned_train_step).
DIST_OVERRIDES = dict(solver="forward_iteration", fw_tol=1e-3,
                      fw_thres=4000)
DIST_SOLVER = DIST_OVERRIDES["solver"]
# the multi-rank steps' card-vs-CPU (and NCCL-vs-one-process) checks: both
# solves at their f32 floor as CMP_OVERRIDES, in at most 400 iterations
# (the forward reaches the floor first; the adjoint, at bw_tol 1e-8 never
# met, then stands within 1e-7 of it either way)
DIST_CMP_OVERRIDES = dict(CMP_OVERRIDES, fw_thres=400, bw_thres=400)
DIST_NSTEP_SLACK = 1
DIST_LOWEST_RTOL = 5e-2
DIST_U_RTOL, DIST_U_ATOL = 1e-2, 2e-3
DIST_RES_RTOL = 1e-3
# seconds a world may take before its ranks are terminated
DIST_TIMEOUT = 300


def dist_rank(rank: int, n: int, backend: str, device: str, init: str,
              jobs: list) -> dict:
    """One spawned rank: join the world, run each job by name; with the
    host clock at its entry, once joined, and at its end."""
    from psignn_tpu_torch.dist import multihost
    entry = time.time()
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
        torch.zeros(1, device=device)           # the context, made here
    multihost.initialize(backend, init, n, rank)
    joined = time.time()
    results = [globals()[name](**kw) for name, kw in jobs]
    return dict(entry=entry, joined=joined, end=time.time(),
                results=results)


def dist_world(n: int, backend: str, jobs: list, device: str = "cuda:0"
               ) -> list:
    """Each rank's results of ``jobs`` in a fresh world of ``n`` ranks, all
    on ``device``; emits where the world's time went (``dist_world``)."""
    from psignn_tpu_torch.dist import multihost
    init = f"tcp://127.0.0.1:{multihost.free_port()}"
    t0 = time.time()
    ranks = multihost.spawn(dist_rank, n, (n, backend, device, init, jobs),
                            timeout=DIST_TIMEOUT)
    t1 = time.time()
    emit("dist_world", ranks=n, backend=backend,
         jobs=[name for name, _ in jobs], wall_s=t1 - t0,
         start_s=[r["entry"] - t0 for r in ranks],
         join_s=[r["joined"] - r["entry"] for r in ranks],
         jobs_s=[r["end"] - r["joined"] for r in ranks],
         exit_s=[t1 - r["end"] for r in ranks])
    return [r["results"] for r in ranks]


def _counted(fn, device):
    """(result, host seconds, (forward, backward) launches) of ``fn()``."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    sync(device)
    mp.LAUNCHES = mp.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0, (mp.LAUNCHES, mp.BWD_LAUNCHES)


def job_partitioned(sample: dict, parts: int, device: str,
                    overrides: dict = DIST_OVERRIDES) -> dict:
    """The trained Dirichlet Ψ-GNN's partitioned request: part
    ``part_index`` of ``sample`` on this rank, ``parts`` ranks a row;
    the second of two, timed and counted."""
    from psignn_tpu_torch.dist import build_partitioned_graph, multihost
    from psignn_tpu_torch.dist.partitioned import make_partitioned_inference
    mesh = multihost.global_mesh(1, parts, device)
    model, cfg, _ = trained_model(device, overrides)
    pg = build_partitioned_graph(sample, parts, mesh.part_index,
                                 device=device)
    infer = make_partitioned_inference(cfg, mesh)
    infer(model, pg)     # warm-up: a fresh process's first calls, untimed
    mesh.barrier()
    out, seconds, launches = _counted(lambda: infer(model, pg), device)
    return dict(part=mesh.part_index, u=out.u.cpu().numpy(),
                nstep=out.nstep, lowest=out.lowest, residual=out.residual,
                calls=out.calls, rel_trace=out.rel_trace, seconds=seconds,
                launches=launches, n_loc=pg.n_loc, halo=pg.halo,
                backend=mesh.backend)


def job_edge_mp(sample: dict, device: str) -> dict:
    """``partition_message_passing`` of the headline mesh over the row,
    against one kernel call on the whole graph (made after the count)."""
    from psignn_tpu_torch.dist import multihost, partition_message_passing
    from psignn_tpu_torch.dist.partition import pad_edges_for_sharding
    from psignn_tpu_torch.graphs import batch_graphs
    from psignn_tpu_torch.nn import MLP
    from psignn_tpu_torch.ops import message_passing
    mesh = multihost.global_mesh(1, multihost.world_size(), device)
    g = batch_graphs([sample], device=device)
    mlp = MLP([2 * WIDTH + 3, WIDTH, WIDTH],
              generator=torch.Generator().manual_seed(3), device=device)
    h = torch.randn((g.total_nodes, WIDTH),
                    generator=torch.Generator().manual_seed(4)).to(device)
    arrs = pad_edges_for_sharding(dict(
        senders=np.asarray(sample["senders"]),
        receivers=np.asarray(sample["receivers"]),
        edge_attr=np.asarray(sample["edge_attr"], np.float32),
        edge_mask=np.ones(len(sample["senders"]), bool)), mesh.parts)
    mp = partition_message_passing(mesh)
    out = {}
    for direction in ("to", "from"):
        with torch.no_grad():
            got, seconds, launches = _counted(lambda: mp(
                mlp, h, arrs["senders"], arrs["receivers"],
                arrs["edge_attr"], arrs["edge_mask"], direction), device)
            want = message_passing(mlp, h, g, direction)
        out[direction] = dict(
            max_abs_err=float((got - want).abs().max()),
            scale=float(want.abs().max()), seconds=seconds,
            launches=launches, shard_edges=len(arrs["senders"]) // mesh.parts)
    return out


def _dp_psignn_step(samples: list, device: str, overrides: dict,
                    seed: int = 7):
    """One data-parallel ``train_step`` of the rank's shard of
    ``samples`` from the trained weights: (StepResult, host seconds,
    launches, clipped gradients on the host)."""
    from psignn_tpu_torch.dist import make_mesh, shard_stacked
    from psignn_tpu_torch.train import make_optimizers, train_step
    mesh = make_mesh(device=device)
    graph = shard_stacked(samples, len(samples), mesh)
    model, cfg, init = trained_model(device, overrides)

    def step():
        model.load_state_dict(init)
        opts = make_optimizers(model, *TRAIN_LRS)
        return train_step(model, opts, graph, cfg, TRAIN_LRS, TRAIN_CLIP,
                          TRAIN_JAC_WEIGHT,
                          torch.Generator().manual_seed(seed + mesh.rank),
                          mesh=mesh)

    res, seconds, launches = _counted(step, device)
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return res, seconds, launches, grads, (model, cfg, step, graph, mesh)


def job_dp_train_step(samples: list, cmp_samples: list,
                      device: str) -> dict:
    """The dp Ψ-GNN step on the rank's shard of the 50-mesh batch: a
    warm-up, one timed step with its launches, one profiled step (rank 0);
    then the 2-mesh step at the f32 floor on the card and on the CPU."""
    _dp_psignn_step(samples, device, TRAIN_OVERRIDES)          # warm-up
    res, seconds, launches, _, (model, cfg, step, graph, mesh) = \
        _dp_psignn_step(samples, device, TRAIN_OVERRIDES)
    out = dict(rank=mesh.rank, n_nodes=graph.total_nodes,
               n_graphs=graph.num_graphs, seconds=seconds, loss=res.loss,
               losses=res.losses, grad_norm=res.grad_norm,
               fw=stats(res.fw), bw=stats(res.bw), launches=launches,
               expected_launches=expected_launches(res, cfg))
    if mesh.rank == 0:
        prof = device_breakdown(step)
        out.update(busy_share=prof["device_kernel_s"] / seconds,
                   device_kernel_s=prof["device_kernel_s"],
                   top_kernels=prof["kernels"][:4])
    else:
        step()
    for label, dev in (("gpu", device), ("cpu", "cpu")):
        r, _, _, grads, _ = _dp_psignn_step(cmp_samples, dev,
                                            DIST_CMP_OVERRIDES)
        out["cmp_" + label] = dict(
            loss=r.loss, losses=r.losses, grad_norm=r.grad_norm,
            fw=stats(r.fw), bw=stats(r.bw),
            grads={k: v.numpy() for k, v in grads.items()})
    return out


def job_dp_unrolled(samples: dict, device: str) -> dict:
    """One dp DSS and one dp DS-GPS step (each after a warm-up) on the
    rank's shard of the 50-mesh batch: seconds and launches (2k each)."""
    from psignn_tpu_torch.dist import make_mesh, shard_stacked
    from psignn_tpu_torch.train import make_adam, unrolled_train_step
    mesh = make_mesh(device=device)
    out = {}
    for case, ckpt, form, _, lr in UNROLLED_CASES[:2]:
        chunk = samples[form]
        graph = shard_stacked(chunk, len(chunk), mesh)
        model, cfg, init = trained_model(device, ckpt=ckpt)
        opt = make_adam(model, lr)

        def step():
            model.load_state_dict(init)
            return unrolled_train_step(model, opt, graph, cfg, lr,
                                       UNROLLED_CLIP, mesh=mesh)

        step()
        res, seconds, launches = _counted(step, device)
        out[case] = dict(seconds=seconds, loss=res.loss,
                         grad_norm=res.grad_norm, launches=launches,
                         expected=(mp_per_step(cfg) * cfg.k,) * 2)
    return out


def job_nccl_step(samples: list, device: str) -> dict:
    """On a one-rank NCCL world: the dp step (its flat all-reduce through
    NCCL) against ``train_step`` on the same batch."""
    from psignn_tpu_torch.graphs import batch_graphs
    res, seconds, launches, grads, (_, cfg, _, _, mesh) = \
        _dp_psignn_step(samples, device, DIST_CMP_OVERRIDES)
    graph = batch_graphs(samples, device=device)
    model, cfg, init = trained_model(device, DIST_CMP_OVERRIDES)
    plain, _ = step_from(model, cfg, init, graph, seed=7 + mesh.rank)
    pgrads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return dict(backend=mesh.backend, seconds=seconds, launches=launches,
                expected_launches=expected_launches(res, cfg),
                dp=dict(loss=res.loss, losses=res.losses,
                        grads={k: v.numpy() for k, v in grads.items()}),
                plain=dict(loss=plain.loss, losses=plain.losses,
                           grads={k: v.numpy() for k, v in pgrads.items()}))


def job_partitioned_train_step(samples: list, device: str) -> dict:
    """dp 2 × parts 2: one partitioned train step on the card, then the same
    step on the CPU, each from the trained weights with both solves at the
    f32 floor; the rank's probe from one CPU generator on both.  On the
    card the rank's launches follow ``expected_launches`` from its own
    solves' calls."""
    from psignn_tpu_torch.dist import (make_partitioned_train_step,
                                       multihost, stack_partitioned_graphs)
    from psignn_tpu_torch.train import make_optimizers
    out = {}
    for label, dev in (("gpu", device), ("cpu", "cpu")):
        mesh = multihost.global_mesh(2, 2, dev)
        model, cfg, _ = trained_model(dev, DIST_CMP_OVERRIDES)
        pg = stack_partitioned_graphs(samples, mesh)
        step = make_partitioned_train_step(cfg, mesh, TRAIN_JAC_WEIGHT,
                                           TRAIN_CLIP)
        opts = make_optimizers(model, *TRAIN_LRS)
        gen = torch.Generator().manual_seed(11 + mesh.rank)
        res, seconds, launches = _counted(
            lambda: step(model, opts, pg, gen, *TRAIN_LRS), dev)
        out[label] = dict(
            loss=res.loss, losses=res.losses, grad_norm=res.grad_norm,
            fw=stats(res.fw), bw=stats(res.bw), seconds=seconds,
            launches=launches,
            expected_launches=expected_launches(res, cfg, linearized=False),
            n_loc=pg.n_loc,
            halo=pg.halo,
            grads={k: p.grad.detach().cpu().numpy()
                   for k, p in model.named_parameters()})
    return out


def single_request(sample: dict, device,
                   overrides: dict = DIST_OVERRIDES) -> dict:
    """The single-process request on ``sample``."""
    from psignn_tpu_torch.deq import fixed_point_forward
    from psignn_tpu_torch.graphs import batch_graphs
    from psignn_tpu_torch.ops import residual_loss
    model, cfg, _ = trained_model(device, overrides)
    g = batch_graphs([sample], device=device)

    def run():
        with torch.no_grad():
            h0 = model.encoder(g.x) * g.fnode_mask
            out = fixed_point_forward(model.function, h0, g, cfg.deq)
            u = model.decoder(out.result) * g.fnode_mask
            return out, u, float(residual_loss(u, g))

    (out, u, res), seconds, launches = _counted(run, device)
    return dict(u=u.cpu().numpy(), nstep=out.nstep, lowest=out.lowest,
                residual=res, rel_trace=out.rel_trace.numpy(),
                seconds=seconds, launches=launches)


def compare_partitioned(ranks: list, single: dict, n_nodes: int) -> dict:
    """The partitioned request (its ranks' results) against the single
    process's, within the DIST_* limits; raises on disagreement."""
    parts = sorted(ranks, key=lambda r: r["part"])
    u = np.concatenate([r["u"] for r in parts])
    r0 = parts[0]
    same = {(r["nstep"], r["lowest"], r["residual"]) for r in parts}
    # the residual of the later of the two solves' best steps that both
    # took: Picard's trace holds step n at n, Broyden's at n − 1
    n = min(r0["nstep"], single["nstep"])
    at = n - (DIST_SOLVER != "forward_iteration")
    step_rel = abs(r0["rel_trace"][at] - single["rel_trace"][at]) \
        / single["rel_trace"][at]
    u_ok = bool(np.allclose(u[:n_nodes], single["u"], rtol=DIST_U_RTOL,
                            atol=DIST_U_ATOL) and not u[n_nodes:].any())
    res_rel = abs(r0["residual"] - single["residual"]) / single["residual"]
    rec = dict(parts=len(parts), n_loc=r0["n_loc"], halo=r0["halo"],
               backend=r0["backend"],
               nstep=r0["nstep"], single_nstep=single["nstep"],
               lowest=r0["lowest"], single_lowest=single["lowest"],
               common_step=n, common_step_rel_diff=float(step_rel),
               u_max_abs_diff=float(np.abs(u[:n_nodes] - single["u"]).max()),
               u_scale=float(np.abs(single["u"]).max()),
               residual=r0["residual"], single_residual=single["residual"],
               residual_rel_diff=res_rel,
               seconds=[r["seconds"] for r in parts],
               single_seconds=single["seconds"],
               calls=[r["calls"] for r in parts],
               fwd_launches=[r["launches"][0] for r in parts],
               expected_fwd_launches=[2 * r["calls"] for r in parts])
    if (len(same) != 1 or abs(r0["nstep"] - single["nstep"]) > DIST_NSTEP_SLACK
            or step_rel > DIST_LOWEST_RTOL or not u_ok
            or res_rel > DIST_RES_RTOL
            or rec["fwd_launches"] != rec["expected_fwd_launches"]):
        raise RuntimeError(f"the partitioned request disagrees: {rec}")
    return rec


def _step_agreement(gpu: dict, cpu: dict) -> dict:
    """Loss entries and each parameter's gradient of two steps, relative."""
    keys = ("residual_loss", "jacobian_loss", "encoder_loss",
            "autoencoder_loss", "mse_loss")
    loss_rel = {k: abs(gpu["losses"][k] - cpu["losses"][k])
                / max(abs(cpu["losses"][k]), 1e-30) for k in keys}
    grad_rel = {k: float(np.linalg.norm(gpu["grads"][k] - cpu["grads"][k])
                         / max(np.linalg.norm(cpu["grads"][k]), 1e-30))
                for k in cpu["grads"]}
    return dict(max_loss_rel_diff=max(loss_rel.values()),
                worst_loss=max(loss_rel, key=loss_rel.get),
                max_grad_rel_diff=max(grad_rel.values()),
                worst_grad=max(grad_rel, key=grad_rel.get),
                gpu_loss=gpu["loss"], cpu_loss=cpu["loss"],
                loss_rtol=CMP_LOSS_RTOL, grad_rtol=CMP_GRAD_RTOL)


def _agreed(rec: dict) -> bool:
    return (rec["max_loss_rel_diff"] <= CMP_LOSS_RTOL
            and rec["max_grad_rel_diff"] <= CMP_GRAD_RTOL)


def phase_dist(sample, built, device, smi: str, seconds: dict) -> dict:
    """Every multi-rank path (phases ``dist_partitioned``,
    ``dist_edge_mp``, ``dist_train_step``, ``dist_partitioned_train_step``)
    in three worlds on the card: 2 gloo ranks, 1 NCCL rank, 4 gloo ranks.
    ``sample`` is the headline mesh's, ``built`` the 50-mesh batches'
    samples.  Returns each path's (forward, backward) launches, summed
    over its ranks."""
    # every rank on the card that ``device`` names (the CPU: a rehearsal)
    card = device.type == "cuda"
    rank_dev, one_rank = ("cuda:0", "nccl") if card else ("cpu", "gloo")
    t0 = time.perf_counter()
    rcm = bench.rcm_ordered(sample)
    n_nodes = rcm["x"].shape[0]
    single = single_request(rcm, device)
    cmp_samples = train_samples(CMP_MESHES, 1)
    two = [bench.rcm_ordered(s) for s in train_samples(2, 1)]
    seconds["dist_setup"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gloo2 = dist_world(2, "gloo", [
        ("job_partitioned", dict(sample=rcm, parts=2, device=rank_dev)),
        ("job_edge_mp", dict(sample=sample, device=rank_dev)),
        ("job_dp_train_step", dict(samples=built[("psignn", "dirichlet")],
                                   cmp_samples=cmp_samples,
                                   device=rank_dev)),
        ("job_dp_unrolled", dict(samples={
            "psignn": built[("psignn", "dirichlet")],
            "dss": built[("dss", "dirichlet")]}, device=rank_dev))],
        rank_dev)
    seconds["dist_gloo2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (nccl,) = dist_world(1, one_rank, [
        ("job_partitioned", dict(sample=rcm, parts=1, device=rank_dev)),
        ("job_nccl_step", dict(samples=cmp_samples, device=rank_dev))],
        rank_dev)
    seconds["dist_nccl1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gloo4 = dist_world(4, "gloo", [
        ("job_partitioned_train_step", dict(samples=two, device=rank_dev))],
        rank_dev)
    seconds["dist_gloo4"] = time.perf_counter() - t0

    launches = {}
    # dist_partitioned: 2 gloo ranks, then 1 NCCL rank
    for name, ranks in (("dist_partitioned", [r[0] for r in gloo2]),
                        ("dist_partitioned_nccl", [nccl[0]])):
        rec = compare_partitioned(ranks, single, n_nodes)
        emit(name, card=smi, n_nodes=n_nodes, overrides=DIST_OVERRIDES,
             **rec)
        launches[name] = (sum(rec["fwd_launches"]), 0)
    # dist_edge_mp: 2 ranks, each its half of the edges
    for direction in ("to", "from"):
        recs = [r[1][direction] for r in gloo2]
        rec = dict(card=smi, direction=direction, ranks=len(recs),
                   n_nodes=n_nodes, **{k: [r[k] for r in recs] for k in
                                       ("max_abs_err", "scale", "seconds",
                                        "launches", "shard_edges")})
        emit("dist_edge_mp", **rec)
        if any(r["max_abs_err"] > KERNEL_REL_TOL * max(1.0, r["scale"])
               or r["launches"] != (1, 0) for r in recs):
            raise RuntimeError(f"dist_edge_mp failed: {rec}")
    launches["dist_edge_mp"] = (2 * len(gloo2), 0)
    # dist_train_step: the 50-mesh dp step, its 2-mesh card-vs-CPU step
    steps = [r[2] for r in gloo2]
    agree = _step_agreement(steps[0]["cmp_gpu"], steps[0]["cmp_cpu"])
    for st in steps:
        emit("dist_train_step", card=smi, n_meshes=TRAIN_MESHES,
             **{k: v for k, v in st.items() if not k.startswith("cmp_")})
    emit("dist_train_step_cpu_agreement", n_meshes=CMP_MESHES,
         overrides=DIST_CMP_OVERRIDES, **agree)
    if (not _agreed(agree) or any(
            tuple(st["launches"]) != tuple(st["expected_launches"])
            or not finite(st["loss"], st["grad_norm"]) for st in steps)
            or len({st["loss"] for st in steps}) != 1):
        raise RuntimeError(f"dist_train_step failed: {steps}, {agree}")
    launches["dist_train_step"] = tuple(
        sum(st["launches"][i] for st in steps) for i in (0, 1))
    for case in ("dss", "dsgps"):
        recs = [r[3][case] for r in gloo2]
        emit("dist_unrolled_train_step", card=smi, case=case,
             ranks=len(recs), seconds=[r["seconds"] for r in recs],
             loss=recs[0]["loss"], grad_norm=recs[0]["grad_norm"],
             launches=[r["launches"] for r in recs],
             expected=recs[0]["expected"])
        if any(tuple(r["launches"]) != tuple(r["expected"])
               or not finite(r["loss"], r["grad_norm"]) for r in recs):
            raise RuntimeError(f"dist_unrolled_train_step {case}: {recs}")
        launches["dist_unrolled_" + case] = tuple(
            sum(r["launches"][i] for r in recs) for i in (0, 1))
    # the one-rank NCCL dp step against train_step
    st = nccl[1]
    agree = _step_agreement(st["dp"], st["plain"])
    emit("dist_train_step_nccl", card=smi, backend=st["backend"],
         seconds=st["seconds"], launches=st["launches"],
         expected_launches=st["expected_launches"], **agree)
    if (st["backend"] != one_rank or not _agreed(agree)
            or tuple(st["launches"]) != tuple(st["expected_launches"])):
        raise RuntimeError(f"dist_train_step_nccl failed: {agree}")
    launches["dist_train_step_nccl"] = tuple(st["launches"])
    # dist_partitioned_train_step: dp 2 × parts 2, card against CPU
    ranks = [r[0] for r in gloo4]
    agree = _step_agreement(ranks[0]["gpu"], ranks[0]["cpu"])
    rec = dict(card=smi, layout=[2, 2], n_loc=[r["gpu"]["n_loc"]
                                                for r in ranks],
               halo=[r["gpu"]["halo"] for r in ranks],
               seconds=[r["gpu"]["seconds"] for r in ranks],
               cpu_seconds=[r["cpu"]["seconds"] for r in ranks],
               fw=[r["gpu"]["fw"] for r in ranks],
               bw=[r["gpu"]["bw"] for r in ranks],
               launches=[r["gpu"]["launches"] for r in ranks],
               expected_launches=[r["gpu"]["expected_launches"]
                                  for r in ranks],
               grad_norm=ranks[0]["gpu"]["grad_norm"], **agree)
    emit("dist_partitioned_train_step", **rec)
    if (not _agreed(agree) or any(
            tuple(r["gpu"]["launches"]) != tuple(r["gpu"]["expected_launches"])
            for r in ranks)
            or len({r["gpu"]["loss"] for r in ranks}) != 1):
        raise RuntimeError(f"dist_partitioned_train_step failed: {rec}")
    launches["dist_partitioned_train_step"] = tuple(
        sum(r["gpu"]["launches"][i] for r in ranks) for i in (0, 1))
    return launches




def phase_kernel_jvp(cases, device) -> dict:
    """JVP kernel vs plain on the card, at every case of the Ψ-GNN's
    widths (edge_dim 3; the DSS cases at edge_dim 1 do not solve a fixed
    point) and the checked-only ones, the direction v the case's g; the
    ``kernels`` line reports the headline mesh's ``to`` case."""
    from psignn_tpu_torch.kernels.fused_mp import (fused_mp_jvp,
                                                   mp_jvp_from_csr)
    return check_kernel(
        "kernel_jvp", "fused_mp_jvp", "none: no TPU kernel (JAX linearizes "
        "the XLA message passing, psignn_tpu/ops.py:48-67)", fused_mp_jvp,
        mp_jvp_from_csr, fused_mp_jvp_bound, cases, device, 200, True,
        skip=lambda edge_dim, timed: timed and edge_dim != 3)


def _newton_answer(solver: str, graph, device, check: bool = True,
                   fw_tol=None):
    """(u, record) of ``solver``'s request of the trained Dirichlet Ψ-GNN
    on ``graph`` (at ``fw_tol``, default the checkpoint's), with its
    physics residual.  With ``check`` it raises
    unless the launches keep the rule: two forward launches per f_θ call,
    two JVP launches per call on dual tensors (the JVPs: one per entry of
    the state a step for dense Newton, some for Newton-Krylov, none for
    the others), no backward launch."""
    from psignn_tpu_torch.eval.metrics import errors_batch
    overrides = dict(solver=solver)
    if fw_tol is not None:
        overrides["fw_tol"] = fw_tol
    _, answer = counted_predictor(CKPT, device, overrides)
    out, rec = answer(graph)
    rec["res"] = float(errors_batch(out.u, graph)["res"][0])
    if check:
        jvps, primal = rec["jvp_f_calls"], rec["f_calls"] - rec["jvp_f_calls"]
        ok = (rec["fwd_launches"] == 2 * rec["f_calls"] and primal > 0
              and rec["jvp_launches"] == 2 * jvps
              and rec["bwd_launches"] == 0)
        if solver == "newton":
            ok &= jvps == graph.total_nodes * WIDTH * primal
        else:
            ok &= (jvps > 0) == (solver == "newton_krylov")
        if not ok or rec["prot_break"] or not finite(rec["res"]):
            raise RuntimeError(f"{solver} request failed: {rec}")
    return out.u, rec


def reference_state_dict(sd: dict) -> dict:
    """A port Ψ-GNN state dict (Dirichlet, one layer) under the reference
    model's key names: what ``compat.convert_psignn`` reads."""
    import re
    rules = ((r"^function\.layers\.(\d+)\.(phi_to|phi_from)\.layers\.(\d)",
              lambda m: (f"deqdss.f.{m[2]}_list.{m[1]}.mlp.mlp."
                         f"{2 * int(m[3])}")),
             (r"^function\.layers\.(\d+)\.update\.layers\.(\d)",
              lambda m: f"deqdss.f.update_list.{m[1]}.mlp.{2 * int(m[2])}"),
             (r"^function\.alpha", lambda m: "deqdss.f.alpha.0"),
             (r"^function\.laynorm", lambda m: "deqdss.f.laynorm"),
             (r"^(encoder|decoder)\.layers\.(\d)",
              lambda m: f"autoencoder.{m[1]}.mlp.mlp.{2 * int(m[2])}"))
    out = {}
    for key, value in sd.items():
        for pattern, repl in rules:
            new, n = re.subn(pattern, repl, key)
            if n:
                out[new] = value.detach().cpu().clone()
                break
        else:
            raise KeyError(key)
    return out


def phase_newton(cases, device, smi: str) -> tuple:
    """Newton and Newton-Krylov on the card: the JVP kernel against its
    plain version; Newton-Krylov requests (``NEWTON_RADII``) against the
    card's Broyden and the CPU's Newton-Krylov; dense Newton on a coarse
    blob, card vs CPU; a 2-mesh Newton-Krylov train step with its launch
    rule, card vs CPU; one CLI epoch with ``--solver newton_krylov`` (the
    trained checkpoint resumed) and a request from its checkpoint; the
    compat round trip.  Returns the
    ``kernels`` line's JVP entry and {path: (forward, backward, JVP)
    launches}."""
    from psignn_tpu_torch import compat
    from psignn_tpu_torch.cli.main import main as train_main
    from psignn_tpu_torch.data.fem import solve_poisson
    from psignn_tpu_torch.data.generate import generate_data
    from psignn_tpu_torch.data.meshgen import blob_mesh
    from psignn_tpu_torch.data.reader import psignn_sample_from_fem
    from psignn_tpu_torch.eval import run_eval
    from psignn_tpu_torch.eval.sweep import growing_geometry_sweep
    from psignn_tpu_torch.graphs import batch_graphs
    from psignn_tpu_torch.kernels import fused_mp as mp
    from psignn_tpu_torch.models import psignn_inference
    from psignn_tpu_torch.weights import load_jax_checkpoint
    cpu = torch.device("cpu")
    entry = phase_kernel_jvp(cases, device)
    launches = {}

    graphs = sweep_graphs(NEWTON_RADII, (device, cpu))
    _newton_answer("newton_krylov", graphs[1.0][0], device)      # warm-up
    for r in NEWTON_RADII:
        gpu_g, cpu_g = graphs[r]
        u, gpu = _newton_answer("newton_krylov", gpu_g, device)
        _, broyden = _newton_answer("broyden", gpu_g, device)
        # against the CPU at a tolerance it reaches in a few seconds
        tol, u_tol = ((None, NEWTON_U_TOL) if r == NEWTON_RADII[0]
                      else (REACHABLE_TOL, NEWTON_REACH_U_TOL))
        u_r, gpu_r = (u, gpu) if tol is None else _newton_answer(
            "newton_krylov", gpu_g, device, fw_tol=tol)
        u_cpu, cpu_r = _newton_answer("newton_krylov", cpu_g, cpu, False,
                                      fw_tol=tol)
        scale = max(1.0, float(u_cpu.abs().max()))
        rec = dict(radius=r, n_nodes=cpu_g.total_nodes,
                   n_edges=int(cpu_g.senders.shape[0]), gpu=gpu,
                   broyden=broyden, cpu_cmp_fw_tol=tol or "checkpoint's",
                   gpu_cmp=gpu_r, cpu_cmp=cpu_r,
                   res_rel_diff_broyden=abs(gpu["res"] - broyden["res"])
                   / broyden["res"],
                   res_rel_diff_cpu=abs(gpu_r["res"] - cpu_r["res"])
                   / cpu_r["res"],
                   u_max_abs_diff_cpu=float((u_r.cpu() - u_cpu).abs().max()),
                   u_scale=scale, u_tol=u_tol, res_rtol=RES_REL_TOL,
                   res_rtol_broyden=NEWTON_BROYDEN_RTOL)
        emit("newton_request", card=smi, **rec)
        if (rec["res_rel_diff_broyden"] > NEWTON_BROYDEN_RTOL
                or rec["res_rel_diff_cpu"] > RES_REL_TOL
                or rec["u_max_abs_diff_cpu"] > u_tol * scale):
            raise RuntimeError(f"newton_krylov request disagrees: {rec}")
        launches[f"newton_krylov_r{r:g}"] = (
            gpu["fwd_launches"], gpu["bwd_launches"], gpu["jvp_launches"])

    rng = np.random.default_rng(0)
    sample = psignn_sample_from_fem(solve_poisson(blob_mesh(
        radius=1.0, hsize=NEWTON_DENSE_HSIZE, rng=rng), 1.0, rng))
    u, gpu = _newton_answer("newton", batch_graphs([sample], device=device),
                            device)
    u_cpu, cpu_rec = _newton_answer(
        "newton", batch_graphs([sample], device=cpu), cpu, False)
    scale = max(1.0, float(u_cpu.abs().max()))
    rec = dict(n_nodes=len(sample["x"]), gpu=gpu, cpu=cpu_rec,
               u_max_abs_diff_cpu=float((u.cpu() - u_cpu).abs().max()),
               u_scale=scale, u_tol=NEWTON_U_TOL)
    emit("newton_dense", card=smi, **rec)
    if rec["u_max_abs_diff_cpu"] > NEWTON_U_TOL * scale:
        raise RuntimeError(f"dense newton disagrees: {rec}")
    launches["newton_dense"] = (gpu["fwd_launches"], gpu["bwd_launches"],
                                gpu["jvp_launches"])

    graph = train_graph(CMP_MESHES, 1, device)
    model, cfg, init = trained_model(device, NEWTON_CMP_OVERRIDES)
    step_from(model, cfg, init, graph)      # warm-up
    mp.LAUNCHES = mp.BWD_LAUNCHES = mp.JVP_LAUNCHES = 0
    res, wall = step_from(model, cfg, init, graph)
    got = (mp.LAUNCHES, mp.BWD_LAUNCHES, mp.JVP_LAUNCHES)
    want = (*expected_launches(res, cfg), mp_per_call(cfg) * res.fw.jvps)
    rec = dict(n_meshes=CMP_MESHES, n_nodes=graph.total_nodes, seconds=wall,
               loss=res.loss, grad_norm=res.grad_norm, fw=stats(res.fw),
               bw=stats(res.bw), launches=got, expected_launches=want)
    emit("newton_train_step", card=smi, **rec)
    if got != want or res.fw.jvps == 0 or res.bw.jvps == 0 or not finite(
            res.loss, res.grad_norm):
        raise RuntimeError(f"newton_train_step failed: {rec}")
    launches["newton_train_step"] = got
    phase_train_step_cpu_agreement(device, CKPT, "dirichlet",
                                   "newton_train_step",
                                   overrides=NEWTON_CMP_OVERRIDES)

    root = os.path.join(".chipwork", "smoke_newton")
    shutil.rmtree(root, ignore_errors=True)
    data, results = os.path.join(root, "data"), os.path.join(root, "results")
    generate_data(data, n_mesh=2, n_samples=5, radius=1.0, hsize=0.08,
                  verbose=False)
    epochs = 1 + len(load_jax_checkpoint(CKPT)["hist_val"]["loss"])
    mp.LAUNCHES = mp.BWD_LAUNCHES = mp.JVP_LAUNCHES = 0
    t0 = time.perf_counter()
    train_main(["--path_dataset", data, "--path_results", results,
                "--batch_size", "3", "--max_epochs", str(epochs),
                "--device", str(device), *NEWTON_TRAIN_FLAGS])
    got = (mp.LAUNCHES, mp.BWD_LAUNCHES, mp.JVP_LAUNCHES)
    train_s = time.perf_counter() - t0
    final = os.path.join(results, "ckpt", "final_model.ckpt")
    predict, fam, cfg, _ = run_eval.load_predictor(final, device)
    req = growing_geometry_sweep(
        {fam: predict}, radii=(1.0,), n_meshes=1, hsize=0.08, seed=0,
        device=device, warmup=False, families=("psignn",))[fam][1.0]
    rec = dict(flags=NEWTON_TRAIN_FLAGS, train_s=train_s, launches=got,
               checkpoint_solver=cfg.solver,
               request={k: req[k] for k in ("n_nodes", "nstep", "res",
                                            "mse")})
    emit("newton_trainer", card=smi, **rec)
    if (0 in got or cfg.solver != "newton_krylov"
            or not finite(req["res"], req["mse"])):
        raise RuntimeError(f"newton_trainer failed: {rec}")
    launches["newton_trainer"] = got

    gpu_g = graphs[1.0][0]
    model, cfg, _ = trained_model(device)
    out = compat.convert_psignn(reference_state_dict(model.state_dict()))
    converted = type(model)(cfg, device=device)
    converted.load_state_dict(out)
    want = psignn_inference(model.eval(), gpu_g, cfg)
    got = psignn_inference(converted.eval(), gpu_g, cfg)
    diff = float((got.u - want.u).abs().max())
    rec = dict(n_nodes=gpu_g.total_nodes, nstep=(got.nstep, want.nstep),
               u_max_abs_diff=diff, bit_identical=bool(torch.equal(got.u,
                                                                   want.u)))
    emit("newton_compat", **rec)
    if diff > 1e-6 * max(1.0, float(want.u.abs().max())):
        raise RuntimeError(f"compat round trip differs: {rec}")
    return entry, launches


# the parity phase: PARITY.md's protocol line (radii and meshes per
# radius, Broyden at fw_tol 1e-5 / fw_thres 1500, DS-GPS k = 100, DSS
# k = 30), with the trained checkpoints
PARITY_RADII = (0.6, 1.0, 2.0, 4.0, 5.0)
PARITY_MESHES = (10, 10, 5, 3, 3)
PARITY_FW_THRES = 1500
PARITY_FW_TOL = 1e-5
# card against CPU on the sweep's first radius-0.6 mesh: DS-GPS and DSS
# run the same k steps in f32 (1e-3 relative in MSE); Ψ-GNN's two solves
# stop at different iterates below fw_tol 1e-5, which moves the MSE by up
# to 0.9 % on the CPU alone against JAX (tests/test_torch_nstep_study.py),
# so 2e-2 there, and nstep within NSTEP_SLACK
PARITY_MSE_RTOL = 1e-3
PARITY_STOP_MSE_RTOL = 2e-2
# the nstep study: JAX main's solver settings and right-hand sides per mesh
NSTEP_STUDY_FW = (600, 1e-5)
NSTEP_STUDY_SAMPLES = 8
# card against CPU on the study's circle mesh, each of its right-hand
# sides: the step counts are printed, not held, as rounding sets them on
# radius-1 meshes (the two packages' iterates drift apart from step 5 on:
# tests/test_torch_nstep_study.py); held are the first NSTEP_EARLY_STEPS
# iterates (‖·‖₂ relative, 3.1e-6 between JAX and the port on the CPU; the
# card's kernel sums in another order, so 1e-4), and the answers by MSE
NSTEP_EARLY_STEPS = 4
NSTEP_EARLY_RTOL = 1e-4
# the figures phase: tests/test_torch_figures.py's tolerances; the Ψ-GNN
# trace's final MSE is held where the solves converge (at the
# checkpoint's fw_tol 1e-5 they stop in a tail whose MSE still moves by
# several per cent)
FIGURE_EARLY_STEPS = 4
FIGURE_EARLY_RTOL = 1e-5
FIGURE_CONVERGED_TOL = 1e-7
FIGURE_MSE_RTOL = 1e-3
FIGURE_DSGPS_UTOL = 1e-4


def captured(fn, *args) -> str:
    """What ``fn(*args)`` prints on stdout, kept off the smoke's own."""
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().strip()


def counted_predictors(preds: dict) -> tuple:
    """(predictors, deltas): each predictor wrapped to append the forward
    launches of each of its calls to ``deltas[family]``."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    deltas = {family: [] for family in preds}

    def wrap(family, predict):
        def counted(graph):
            before = mp.LAUNCHES
            out = predict(graph)
            deltas[family].append(mp.LAUNCHES - before)
            return out
        return counted

    return {f: wrap(f, p) for f, p in preds.items()}, deltas


def phase_parity(device, smi: str) -> dict:
    """The growing-geometry parity table as ``eval.parity`` makes it, with
    the trained checkpoints: ``build_predictors(source="trained")`` for the
    three families, ``growing_geometry_sweep`` at ``PARITY_RADII`` ×
    ``PARITY_MESHES`` (each request after a warm-up request, as the sweep
    runs it), ``write_report``; a row per family and radius and each
    family's launches.  ``parity.main`` (the reference's checkpoints) says
    it skips.  Then the sweep's first radius-0.6 mesh on the card and on
    the CPU.  Returns each family's forward launches."""
    import tempfile

    from psignn_tpu_torch.eval import parity
    from psignn_tpu_torch.eval.sweep import growing_geometry_sweep
    from psignn_tpu_torch.kernels import fused_mp as mp
    with tempfile.TemporaryDirectory() as tmp:
        printed = captured(parity.main, ["--device", str(device), "--out",
                                         os.path.join(tmp, "PARITY.md")])
    emit("parity_reference", printed=printed, checkpoints={
        f: os.path.exists(path) for f, path in parity.CKPTS.items()})
    preds = parity.build_predictors(PARITY_FW_THRES, PARITY_FW_TOL,
                                    source="trained", device=device)
    if sorted(preds) != ["dsgps", "dss", "psignn"]:
        raise RuntimeError(f"trained predictors: {sorted(preds)}")
    counted, deltas = counted_predictors(preds)
    mp.LAUNCHES = mp.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    summary = growing_geometry_sweep(
        counted, radii=PARITY_RADII, n_meshes=PARITY_MESHES,
        families=("psignn", "dss"), device=device)
    sweep_s = time.perf_counter() - t0
    launches = (mp.LAUNCHES, mp.BWD_LAUNCHES)
    proto = (f"Protocol: radii {list(PARITY_RADII)} with "
             f"{list(PARITY_MESHES)} meshes per radius respectively, "
             f"fw_thres {PARITY_FW_THRES}, fw_tol {PARITY_FW_TOL}, the "
             f"trained checkpoints of results/; {smi}.")
    with tempfile.TemporaryDirectory() as tmp:
        with open(parity.write_report(summary, os.path.join(tmp, "P.md"),
                                      protocol=proto, device=device)) as f:
            report = f.read()
    table_rows = [ln for ln in report.splitlines()
                  if ln.startswith("| ") and ln[2].isdigit()]
    emit("parity_report", lines=len(report.splitlines()),
         table_rows=len(table_rows), title=report.splitlines()[0],
         sweep_s=sweep_s)
    if len(table_rows) != 3 * len(PARITY_RADII) or "TPU" in report:
        raise RuntimeError(f"parity report: {report}")
    out = {}
    for family, per_radius in summary.items():
        cfg = preds[family].cfg
        for r in PARITY_RADII:
            m = per_radius[r]
            row = dict(family=family, radius=r, n_nodes=m["n_nodes"],
                       mse=m["mse"],
                       ref_mse=parity.BASELINE_MSE[family][r],
                       nstep=m["nstep"], nstep_std=m["nstep_std"],
                       ref_nstep=(parity.BASELINE_NSTEP[r]
                                  if family == "psignn" else None),
                       lowest=m["lowest"] if family == "psignn" else None,
                       seconds=m["time"],
                       seconds_std=m["time_std"], res=m["res"])
            emit("parity", **row)
            if (not finite(row["mse"], row["seconds"], row["res"])
                    or family == "psignn" and row["nstep"] > PARITY_FW_THRES):
                raise RuntimeError(f"parity row failed: {row}")
        calls = deltas[family]
        want = None if family == "psignn" else mp_per_step(cfg) * cfg.k
        rec = dict(family=family, requests=len(calls), launches=sum(calls),
                   per_request_min=min(calls), per_request_max=max(calls),
                   expected_per_request=want)
        emit("parity_launches", **rec)
        if (len(calls) != 2 * sum(PARITY_MESHES) or min(calls) == 0
                or want is not None and set(calls) != {want}):
            raise RuntimeError(f"parity launches: {rec}")
        out["parity_" + family] = sum(calls)
    if launches != (sum(out.values()), 0):
        raise RuntimeError(f"parity sweep launched {launches}, {out}")
    # the first radius-0.6 mesh again, on the card and on the CPU
    cpu = torch.device("cpu")
    rows = [growing_geometry_sweep(
        p, radii=PARITY_RADII[:1], n_meshes=1, families=("psignn", "dss"),
        device=d, warmup=False)
        for p, d in ((preds, device),
                     (parity.build_predictors(PARITY_FW_THRES, PARITY_FW_TOL,
                                              source="trained", device=cpu),
                      cpu))]
    for family in preds:
        gpu, host = (x[family][PARITY_RADII[0]] for x in rows)
        rtol = PARITY_STOP_MSE_RTOL if family == "psignn" else PARITY_MSE_RTOL
        rec = dict(family=family, radius=PARITY_RADII[0],
                   n_nodes=gpu["n_nodes"], mse_gpu=gpu["mse"],
                   mse_cpu=host["mse"],
                   mse_rel_diff=abs(gpu["mse"] - host["mse"]) / host["mse"],
                   mse_rtol=rtol, nstep_gpu=gpu["nstep"],
                   nstep_cpu=host["nstep"], nstep_slack=NSTEP_SLACK,
                   seconds_gpu=gpu["time"], seconds_cpu=host["time"])
        emit("parity_cpu_agreement", **rec)
        if (rec["mse_rel_diff"] > rtol
                or abs(gpu["nstep"] - host["nstep"]) > NSTEP_SLACK):
            raise RuntimeError(f"card and CPU parity rows disagree: {rec}")
    return out


def nstep_circle_cmp(device) -> dict:
    """The nstep study's circle mesh (radius 1, seed 3) and its 8
    right-hand sides (seed 20), each answered by the trained Ψ-GNN at the
    study's settings on the card and on the CPU: per-sample steps and
    lowest residuals, the mean MSE's relative gap, and the largest
    ‖u_card − u_CPU‖₂ / ‖u_CPU‖₂ over the first ``NSTEP_EARLY_STEPS``
    decoded Broyden iterates of any sample."""
    import dataclasses

    from psignn_tpu_torch.data.fem import solve_poisson
    from psignn_tpu_torch.data.meshgen import circle_mesh
    from psignn_tpu_torch.data.reader import psignn_sample_from_fem
    from psignn_tpu_torch.eval import parity
    from psignn_tpu_torch.eval.metrics import errors_batch
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.graphs import batch_graphs
    from psignn_tpu_torch.models import psignn_iterative_inference

    sides = (("gpu", device), ("cpu", torch.device("cpu")))
    mesh = circle_mesh(radius=1.0, hsize=0.08, seed=3)
    rng = np.random.default_rng(20)
    samples = [psignn_sample_from_fem(solve_poisson(mesh, 1.0, rng))
               for _ in range(NSTEP_STUDY_SAMPLES)]
    early, mse = {}, {}
    rec = dict(mesh="ours_circle_r1", n_samples=len(samples))
    for key, d in sides:
        cfg = parity.predictor_configs(NSTEP_EARLY_STEPS, 1e-12)["psignn"]
        _, _, cfg, model = load_predictor(
            parity.TRAINED_CKPTS["psignn"], d,
            overrides=dataclasses.asdict(cfg))
        early[key] = [psignn_iterative_inference(
            model, batch_graphs([s], device=d), cfg)["trace"]["u"].cpu()
            for s in samples]
        predict = parity.build_predictors(*NSTEP_STUDY_FW, source="trained",
                                          device=d)["psignn"]
        steps, lowest, mse[key] = [], [], []
        for s in samples:
            g = batch_graphs([s], device=d)
            u, nstep, low = predict(g)[:3]
            steps.append(int(nstep))
            lowest.append(float(low))
            mse[key].append(float(errors_batch(u, g)["mse"][0]))
        rec[f"nstep_{key}"], rec[f"lowest_{key}"] = steps, lowest
    rec.update(early_steps=NSTEP_EARLY_STEPS, early_rtol=NSTEP_EARLY_RTOL,
               early_gap=max(
                   float(torch.linalg.vector_norm(a - b)
                         / torch.linalg.vector_norm(b))
                   for ga, gb in zip(early["gpu"], early["cpu"])
                   for a, b in zip(ga[:NSTEP_EARLY_STEPS + 1],
                                   gb[:NSTEP_EARLY_STEPS + 1])))
    gpu_mse, cpu_mse = float(np.mean(mse["gpu"])), float(np.mean(mse["cpu"]))
    rec.update(mse_gpu=gpu_mse, mse_cpu=cpu_mse,
               mse_rel_diff=abs(gpu_mse - cpu_mse) / cpu_mse,
               mse_rtol=PARITY_STOP_MSE_RTOL)
    return rec


def phase_nstep_study(device) -> int:
    """The nstep study as ``eval.nstep_study`` runs it, with the trained
    Ψ-GNN (``build_predictors(source="trained")`` at JAX main's fw_tol
    1e-5 / fw_thres 600): ``study`` on three radius-1 blob meshes and a
    circle mesh, 8 right-hand sides each; ``main`` (the reference's
    checkpoint) says it skips, and the phase says which gmsh meshes are
    absent.  Then ``nstep_circle_cmp``: the circle mesh's right-hand sides
    on the card and on the CPU.  Returns the study's forward launches."""
    import tempfile

    from psignn_tpu_torch.eval import nstep_study, parity
    from psignn_tpu_torch.kernels import fused_mp as mp
    with tempfile.TemporaryDirectory() as tmp:
        printed = captured(nstep_study.main, [
            "--device", str(device), "--out", os.path.join(tmp, "n.md")])
    emit("nstep_study_reference", printed=printed, gmsh_meshes={
        name: os.path.exists(path)
        for name, path in nstep_study.REF_MESHES.items()})
    predict = parity.build_predictors(*NSTEP_STUDY_FW, source="trained",
                                      device=device)["psignn"]
    mp.LAUNCHES = mp.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    results = nstep_study.study(predict, NSTEP_STUDY_SAMPLES, device)
    study_s = time.perf_counter() - t0
    launches = (mp.LAUNCHES, mp.BWD_LAUNCHES)
    for name, r in results.items():
        emit("nstep_study", mesh=name, n_samples=NSTEP_STUDY_SAMPLES, **r)
        if (not finite(r["nstep"], r["mse"], r["lowest"])
                or r["nstep"] > NSTEP_STUDY_FW[0]):
            raise RuntimeError(f"nstep study row failed: {name} {r}")
    emit("nstep_study_launches", launches=launches[0], study_s=study_s,
         meshes=sorted(results))
    if launches[0] == 0 or launches[1] or len(results) != 4:
        raise RuntimeError(f"nstep study launched {launches}: {results}")
    circle = nstep_circle_cmp(device)
    emit("nstep_study_cpu_agreement", **circle)
    if (circle["mse_rel_diff"] > PARITY_STOP_MSE_RTOL
            or circle["early_gap"] > NSTEP_EARLY_RTOL
            or max(circle["lowest_gpu"] + circle["lowest_cpu"])
            >= NSTEP_STUDY_FW[1]):
        raise RuntimeError(f"card and CPU nstep study disagree: {circle}")
    return launches[0]


def figure_traces(device, sample: dict, mixed: dict) -> dict:
    """``eval.figures``' traces on ``device``: ``psignn_trace`` of the
    trained Ψ-GNN on ``sample``, ``dsgps_trace`` of the DS-GPS Dirichlet
    checkpoint on ``sample`` and of the mixed one on ``mixed``.  Each
    record: the forward launches counted from 0 just before the trace,
    the launches its f_θ calls (Ψ-GNN) or k steps imply, seconds, and the
    trace itself under ``trace``."""
    from psignn_tpu_torch.eval import figures
    from psignn_tpu_torch.kernels import fused_mp as mp
    from psignn_tpu_torch.models import DsgpsConfig, PsignnConfig
    from psignn_tpu_torch.weights import load_jax_checkpoint

    def hp(ckpt):
        return load_jax_checkpoint(ckpt)["hyperparameters"]

    out = {}
    for name, ckpt, s in (("psignn", CKPT, sample),
                          ("dsgps_dirichlet", DSGPS_CKPT, sample),
                          ("dsgps_mixed", DSGPS_MIXED_CKPT, mixed)):
        calls = FCalls()
        hook = torch.nn.modules.module.register_module_forward_hook(calls)
        try:
            sync(device)
            mp.LAUNCHES = 0
            t0 = time.perf_counter()
            if name == "psignn":
                with calls:
                    trace = figures.psignn_trace(ckpt, s, device)
                cfg = PsignnConfig.from_hyperparameters(hp(ckpt))
                want = mp_per_call(cfg) * calls.calls
            else:
                trace = figures.dsgps_trace(ckpt, s, device)
                cfg = DsgpsConfig.from_hyperparameters(hp(ckpt))
                want = mp_per_step(cfg) * cfg.k
            sync(device)
            seconds = time.perf_counter() - t0
        finally:
            hook.remove()
        out[name] = dict(launches=mp.LAUNCHES, expected_launches=want,
                         f_calls=calls.calls, seconds=seconds,
                         n_nodes=int(s["x"].shape[0]), trace=trace)
    return out


def phase_figures(device, smi: str) -> dict:
    """The figure path of ``eval.figures`` on fresh factory samples
    (radius 1, hsize 0.08): the traces on the card with their launches,
    then on the CPU, held to the tests' tolerances; then the drawing
    modules, by whether matplotlib is installed here.  Returns each
    trace's forward launches."""
    import importlib.util
    import tempfile

    from psignn_tpu_torch.eval import figures, vis
    from psignn_tpu_torch.train import plots  # noqa: F401  (imports)
    t_phase = time.perf_counter()
    sample = figures.factory_sample("dirichlet")
    mixed = figures.factory_sample("mixed")
    gpu = figure_traces(device, sample, mixed)
    cpu = figure_traces(torch.device("cpu"), sample, mixed)
    launches = {}
    for name, rec in gpu.items():
        g, c = rec["trace"], cpu[name]["trace"]
        gu, cu = g["u_trace"], c["u_trace"]
        agree = dict(name=name, n_nodes=rec["n_nodes"],
                     launches=rec["launches"],
                     expected_launches=rec["expected_launches"],
                     f_calls=rec["f_calls"], seconds_gpu=rec["seconds"],
                     seconds_cpu=cpu[name]["seconds"],
                     iterates_gpu=len(gu), iterates_cpu=len(cu))
        if name == "psignn":
            k = FIGURE_EARLY_STEPS
            gap = (np.linalg.norm((gu[:k] - cu[:k])[..., 0], axis=1)
                   / np.linalg.norm(cu[:k, :, 0], axis=1))
            conv = [figures.psignn_trace(CKPT, sample, d,
                                         fw_tol=FIGURE_CONVERGED_TOL)
                    for d in (device, torch.device("cpu"))]
            mse_g, mse_c = (float(t["mse_trace"][-1]) for t in conv)
            agree.update(nstep_gpu=g["nstep"], nstep_cpu=c["nstep"],
                         early_gap=float(gap.max()),
                         early_rtol=FIGURE_EARLY_RTOL,
                         converged_tol=FIGURE_CONVERGED_TOL,
                         converged_nstep_gpu=conv[0]["nstep"],
                         converged_nstep_cpu=conv[1]["nstep"],
                         mse_gpu=mse_g, mse_cpu=mse_c,
                         mse_rel_diff=abs(mse_g - mse_c) / mse_c,
                         mse_rtol=FIGURE_MSE_RTOL)
            ok = (len(gu) > k and len(cu) > k
                  and agree["early_gap"] <= FIGURE_EARLY_RTOL
                  and agree["mse_rel_diff"] <= FIGURE_MSE_RTOL)
        else:
            tol = FIGURE_DSGPS_UTOL * max(1.0, float(np.abs(cu).max()))
            agree.update(u_max_abs_diff=float(np.abs(gu - cu).max())
                         if gu.shape == cu.shape else None, u_tol=tol,
                         res_last_gpu=float(g["res"][-1]),
                         res_last_cpu=float(c["res"][-1]))
            ok = gu.shape == cu.shape and agree["u_max_abs_diff"] <= tol
        emit("figures_trace", **agree)
        if (not ok or rec["launches"] != rec["expected_launches"]
                or rec["launches"] == 0 or not np.isfinite(gu).all()):
            raise RuntimeError(f"figure trace {name} failed: {agree}")
        launches["figures_" + name] = rec["launches"]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    draw = dict(matplotlib=has_mpl)
    s, tr = sample, gpu["psignn"]["trace"]
    with tempfile.TemporaryDirectory() as tmp:
        if has_mpl:
            paths = [vis.plot_iterative_montage(
                         s["pos"], tr["u_trace"], os.path.join(tmp, "m.png"),
                         sol=s["sol"], res_trace=tr["res_trace"]),
                     vis.plot_paper_figure(
                         s["pos"], s["tags"], tr["u_trace"], s["sol"],
                         os.path.join(tmp, "p.png"),
                         res_trace=tr["res_trace"], nstep=tr["nstep"])]
            draw["bytes"] = [os.path.getsize(p) for p in paths]
            failed = min(draw["bytes"]) == 0
        else:
            # the expected outcome on a host without matplotlib
            try:
                vis.plot_solution_map(s["pos"], s["sol"],
                                      os.path.join(tmp, "x.png"))
            except ImportError as e:
                draw.update(import_error=str(e), name=e.name)
            failed = (draw.get("name") != "matplotlib"
                      or bool(os.listdir(tmp)))
    emit("figures_draw", **draw)
    if failed:
        raise RuntimeError(f"figures drawing failed: {draw}")
    emit("figures", smi=smi, phase_s=time.perf_counter() - t_phase,
         trace_s_gpu={n: r["seconds"] for n, r in gpu.items()},
         trace_s_cpu={n: r["seconds"] for n, r in cpu.items()})
    return launches


# ------------------------------------------------------------ operations

# the six training protocols of scripts/torch/ and the dataset each reads
PROTOCOLS = (("psignn_dirichlet", "dirichlet"), ("psignn_mixed", "mixed"),
             ("dss_dirichlet", "dirichlet"), ("dsgps_dirichlet", "dirichlet"),
             ("dsgps_mixed", "mixed"), ("dsgps_k70", "dirichlet"))
SCRIPTS = os.path.join("scripts", "torch")
# scripts/torch/generate_datasets.sh at this size: a 60/20/20 split leaves
# 54 training samples, one full batch of 50 and a short one
OPS_DATA = dict(N_MESH="3", N_SAMPLES="30")
OPS_KILL_EPOCHS = 3
OPS_TIMEOUT = 300
# eval_trained.sh's tables, card against CPU: the unrolled families'
# rows.  Ψ-GNN's row is held by the chaos rule of the other phases: at its
# checkpoint's fw_tol 1e-5 the solves stop at different iterates below the
# tolerance, and the table's MSE moves with the stop (on this test split
# the CPU alone gives 0.02865 to 0.03036 at 1 and 4 threads and at the
# table's own, host or carried loop; the residual moves by 0.05 %), so the
# table's residual is held to RES_REL_TOL, and the MSE of the answers at
# FIGURE_CONVERGED_TOL (the same runs: 0.029724 to 0.029730) to
# FIGURE_MSE_RTOL.
OPS_TABLE_RTOL = 1e-4
EVAL_RUNS = (("psignn", "psignn_dirichlet"), ("dsgps", "dsgps_dirichlet"),
             ("dss", "dss_dirichlet"))
NOTEBOOKS = ("demo_torch", "comparatives_torch")
# cells with this tag draw or display; the card's host has no matplotlib
DRAW_TAG = "draw"


def _subs(line: str) -> tuple:
    """``line`` with each ``$(...)`` replaced by a placeholder word, and
    the substitutions: (text, quoted) by placeholder."""
    out, subs, i = [], {}, 0
    while True:
        j = line.find("$(", i)
        if j < 0:
            return "".join(out) + line[i:], subs
        depth, k = 0, j + 1
        while True:
            depth += {"(": 1, ")": -1}.get(line[k], 0)
            if depth == 0:
                break
            k += 1
        key = f"@@SUB{len(subs)}@@"
        subs[key] = (line[j:k + 1], line[j - 1:j] == '"'
                     and line[k + 1:k + 2] == '"')
        out.append(line[i:j] + key)
        i = k + 1


def _expand(text: str, env: dict) -> str:
    """``$NAME``, ``${NAME}`` and ``${NAME:-default}`` expanded from
    ``env`` (the last to its default when ``env`` lacks it); other
    variables kept as written."""
    import re

    def one(m):
        name = m.group(1) or m.group(3)
        if m.group(2) is not None:
            return env.get(name, m.group(2))
        return env.get(name, m.group(0))

    return re.sub(r"\$\{([A-Za-z_]\w*)(?::-([^}]*))?\}|\$([A-Za-z_]\w*)",
                  one, text)


def script_vars(text: str) -> dict:
    """The top-level variable defaults of a shell script: ``NAME=value``
    and ``NAME=${X:-value}`` at the start of a line."""
    import re
    import shlex
    out = {}
    for line in text.splitlines():
        m = re.match(r"([A-Z_][A-Z0-9_]*)=(\S*)\s*$", line)
        if not m or "$(" in m.group(2):
            continue
        value = m.group(2)
        d = re.fullmatch(r"\$\{[A-Za-z0-9_]+:-(.*)\}", value)
        out[m.group(1)] = d.group(1) if d else (shlex.split(value) or [""])[0]
    return out


def script_commands(path: str, env: dict = None) -> list:
    """The ``python -m <module>`` commands of a shell script, in order:
    each a dict of ``module``, ``argv`` (its arguments, with the script's
    top-level variable defaults, overridden by ``env``, expanded; a quoted
    ``"$(...)"`` argument kept as written; ``"$@"`` dropped) and
    ``clauses`` (each bare ``$(...)`` among them, such as a resume
    clause, with its variables expanded)."""
    import re
    import shlex
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    env = {**script_vars(text), **(env or {})}
    cmds = []
    for line in text.splitlines():
        if line.lstrip().startswith("#") or not re.search(
                r"-m\s+psignn_tpu", line):
            continue
        line, subs = _subs(line)
        line = re.sub(r'"\$\{?@[^"]*"', "", line)
        tokens = shlex.split(_expand(line, env))
        tokens = tokens[tokens.index("-m") + 1:]
        tokens = tokens[:next((i for i, t in enumerate(tokens)
                               if t in ("&", "|", ";", "&&", "||")
                               or re.match(r"\d?>", t)), len(tokens))]
        argv, clauses = [], []
        for t in tokens[1:]:
            if t in subs and not subs[t][1]:
                clauses.append(_expand(subs[t][0], env))
                continue
            for key, (sub, _) in subs.items():
                t = t.replace(key, sub)
            argv.append(t)
        cmds.append(dict(module=tokens[0], argv=argv, clauses=clauses))
    return cmds


def _script_env(**kw) -> dict:
    """The environment a smoke run gives a script of ``scripts/torch``:
    this interpreter, and ``kw``."""
    return dict(os.environ, PYTHON=sys.executable, **kw)


def relaunch_check(results: str) -> dict:
    """What ``relaunch.cmd`` and ``trainer.pid`` of a finished run say."""
    import shlex
    with open(os.path.join(results, "relaunch.cmd")) as f:
        argv = shlex.split(f.read())
    running = os.path.join(results, "ckpt", "running_model.ckpt")
    return dict(names_port=argv[1:3] == ["-m", "psignn_tpu_torch.cli.main"],
                resumes_running=(argv.count("--resume") == 1
                                 and argv[-2:] == ["--resume", running]),
                pid_file_left=os.path.exists(
                    os.path.join(results, "trainer.pid")))


def _load_script_module(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ops_protocols(data: dict, root: str, device) -> dict:
    """One epoch of each of the six protocols of ``scripts/torch``: its
    CLI arguments parsed from the script, with ``--max_epochs 1 --device
    <device>`` appended, run in this process; the DS-GPS Dirichlet one
    resumes from ``make_warmae_ckpt.py``'s warm start as a fresh run of
    its script does.  Returns each protocol's (forward, backward)
    launches."""
    from psignn_tpu_torch.cli.main import main as train_main
    from psignn_tpu_torch.kernels import fused_mp as mp
    from psignn_tpu_torch.weights import load_jax_checkpoint
    launches = {}
    for run, variant in PROTOCOLS:
        out = os.path.join(root, "runs", run)
        env = dict(DATA=data[variant], OUT=out)
        if run == "dsgps_dirichlet":
            warm = os.path.join(root, "warmae", "warm_init.ckpt")
            captured(_load_script_module("make_warmae_ckpt").main,
                     ["--out", os.path.dirname(warm)])
            env["WARM"] = f"--resume {warm}"
        (cmd,) = script_commands(
            os.path.join(SCRIPTS, f"train_{run}.sh"), env)
        argv = cmd["argv"] + ["--max_epochs", "1", "--device", str(device)]
        sync(device)
        mp.LAUNCHES = mp.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        captured(train_main, argv)
        sync(device)
        seconds = time.perf_counter() - t0
        n = (mp.LAUNCHES, mp.BWD_LAUNCHES)
        final = load_jax_checkpoint(os.path.join(out, "ckpt",
                                                 "final_model.ckpt"))
        rec = dict(protocol=run, seconds=seconds, fwd_launches=n[0],
                   bwd_launches=n[1],
                   val_res=final["hist_val"]["residual_loss"][-1],
                   epochs=len(final["hist_val"]["loss"]),
                   warm_start=run == "dsgps_dirichlet",
                   clauses=cmd["clauses"], **relaunch_check(out))
        emit("operations_protocol", **rec)
        if (0 in n or rec["epochs"] != 1 or not finite(rec["val_res"])
                or not rec["names_port"] or not rec["resumes_running"]
                or rec["pid_file_left"]):
            raise RuntimeError(f"protocol {run} failed: {rec}")
        launches["operations_" + run] = n
    return launches


def ops_kill_relaunch(data: dict, root: str, device, extra=(),
                      env=None) -> dict:
    """The Ψ-GNN Dirichlet protocol at ``--max_epochs 3`` in a process of
    its own, killed (SIGKILL) once its ``trainer.pid`` and a running
    checkpoint of its first epoch are on disk, then ``bash -c "$(cat
    relaunch.cmd)"``: the relaunch must resume (three epochs in the
    history, each validated once, the last the checkpoint's epoch 2) and
    remove ``trainer.pid`` at its clean exit.  ``extra`` flags go to the
    script, ``env`` to both processes' environment."""
    import signal

    from psignn_tpu_torch.weights import load_jax_checkpoint
    out = os.path.join(root, "kill")
    pid_file = os.path.join(out, "trainer.pid")
    running = os.path.join(out, "ckpt", "running_model.ckpt")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        ["bash", os.path.join(SCRIPTS, "train_psignn_dirichlet.sh"),
         data["dirichlet"], out, "--max_epochs", str(OPS_KILL_EPOCHS),
         "--device", str(device), *extra], env=_script_env(**(env or {})),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        while not (os.path.exists(pid_file) and os.path.exists(running)):
            if proc.poll() is not None or (time.perf_counter() - t0
                                           > OPS_TIMEOUT):
                raise RuntimeError(f"the run to kill ended or stalled: "
                                   f"{proc.poll()} {proc.stderr.read()}")
            time.sleep(0.1)
        with open(pid_file) as f:
            pid = int(f.read())
        os.kill(pid, signal.SIGKILL)
        proc.wait(OPS_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    killed_s = time.perf_counter() - t0
    killed_epochs = len(load_jax_checkpoint(running)["hist_val"]["loss"])
    pid_left = os.path.exists(pid_file)
    with open(os.path.join(out, "relaunch.cmd")) as f:
        relaunch = f.read()
    t1 = time.perf_counter()
    again = subprocess.run(["bash", "-c", relaunch],
                           env=_script_env(**(env or {})),
                           capture_output=True, text=True,
                           timeout=OPS_TIMEOUT)
    relaunch_s = time.perf_counter() - t1
    final = load_jax_checkpoint(os.path.join(out, "ckpt",
                                             "final_model.ckpt"))
    with open(os.path.join(out, "logs", "train_metrics.csv")) as f:
        log = f.read()
    validated = [log.count(f"Validation Epoch {e} ")
                 for e in range(OPS_KILL_EPOCHS)]
    rec = dict(pid=pid, killed_after_s=killed_s, killed_rc=proc.returncode,
               killed_epochs=killed_epochs, pid_file_after_kill=pid_left,
               relaunch_rc=again.returncode, relaunch_s=relaunch_s,
               epochs=len(final["hist_val"]["loss"]),
               final_epoch=final["epoch"], validated=validated,
               **relaunch_check(out))
    emit("operations_kill_relaunch", **rec)
    if (again.returncode or rec["epochs"] != OPS_KILL_EPOCHS
            or rec["final_epoch"] != OPS_KILL_EPOCHS - 1
            or not 1 <= killed_epochs < OPS_KILL_EPOCHS
            or validated != [1] * OPS_KILL_EPOCHS or not pid_left
            or rec["pid_file_left"] or not rec["resumes_running"]):
        raise RuntimeError(f"kill and relaunch failed: {rec} "
                           f"{again.stderr[-2000:]}")
    return rec


def ops_tables(data: dict, root: str, device) -> dict:
    """``eval_trained.sh`` on the Dirichlet data's test split for the three
    trained checkpoints, on the card and, at the same time, on the CPU
    (``--device cpu``): the unrolled families' rows within
    ``OPS_TABLE_RTOL``, Ψ-GNN's residual within ``RES_REL_TOL`` and, solved
    to ``FIGURE_CONVERGED_TOL``, its MSE within ``FIGURE_MSE_RTOL``; each
    side's Ψ-GNN steps are printed."""
    from psignn_tpu_torch.data.reader import (GraphLoader, load_dataset,
                                              split_dataset)
    from psignn_tpu_torch.eval.metrics import errors_batch
    from psignn_tpu_torch.eval.run_eval import load_predictor
    # both sides at once: each side's three processes mostly start up
    t0 = time.perf_counter()
    procs = {}
    for side, dev in (("gpu", str(device)), ("cpu", "cpu")):
        with open(os.path.join(root, f"eval_{side}.err"), "w") as err:
            procs[side] = subprocess.Popen(
                ["bash", os.path.join(SCRIPTS, "eval_trained.sh"),
                 "--device", dev],
                env=_script_env(DATA=data["dirichlet"],
                                EVAL_OUT=os.path.join(root, "eval_" + side)),
                stdout=subprocess.DEVNULL, stderr=err)
    tables = {}
    for side, proc in procs.items():
        if proc.wait(OPS_TIMEOUT):
            with open(os.path.join(root, f"eval_{side}.err")) as f:
                raise RuntimeError(f"eval_trained.sh on {side}: "
                                   f"{f.read()[-2000:]}")
        tables[side] = dict(seconds=time.perf_counter() - t0)
        for _, run in EVAL_RUNS:
            with open(os.path.join(root, "eval_" + side, run,
                                   "test_metrics.json")) as f:
                tables[side][run] = json.load(f)
    steps, converged = {}, {}
    _, _, test = split_dataset(load_dataset(data["dirichlet"]))
    for side, d in (("gpu", device), ("cpu", torch.device("cpu"))):
        batch = next(iter(GraphLoader(test, batch_size=len(test), device=d)))
        steps[side] = int(load_predictor(CKPT, d)[0](batch)[1])
        out = load_predictor(CKPT, d, dict(fw_tol=FIGURE_CONVERGED_TOL))[0](
            batch)
        converged[side] = float(errors_batch(out.u, batch)["mse"].mean())
    ok = True
    for family, run in EVAL_RUNS:
        gpu, cpu = tables["gpu"][run], tables["cpu"][run]
        keys = ["res_mean"] if family == "psignn" else sorted(cpu)
        rtol = RES_REL_TOL if family == "psignn" else OPS_TABLE_RTOL
        gaps = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-30)
                for k in keys}
        rec = dict(run=run, n_test=len(test), rtol=rtol, rel_gaps=gaps,
                   mse_gpu=gpu["mse_mean"], mse_cpu=cpu["mse_mean"],
                   res_gpu=gpu["res_mean"], res_cpu=cpu["res_mean"])
        if family == "psignn":
            mse_gap = abs(converged["gpu"] - converged["cpu"]) \
                / converged["cpu"]
            rec.update(nstep_gpu=steps["gpu"], nstep_cpu=steps["cpu"],
                       converged_tol=FIGURE_CONVERGED_TOL,
                       converged_mse_gpu=converged["gpu"],
                       converged_mse_cpu=converged["cpu"],
                       converged_mse_rel_diff=mse_gap,
                       converged_mse_rtol=FIGURE_MSE_RTOL)
            ok &= mse_gap <= FIGURE_MSE_RTOL
        emit("operations_table", **rec)
        ok &= max(gaps.values()) <= rtol and finite(*gpu.values())
    emit("operations_tables", seconds_gpu=tables["gpu"]["seconds"],
         seconds_cpu=tables["cpu"]["seconds"])
    if not ok:
        raise RuntimeError("eval_trained.sh's card and CPU tables disagree")
    return tables


def notebook_cells(name: str, draw: bool = True) -> list:
    """The code cells of ``notebooks/<name>.ipynb``, as source strings;
    without ``draw``, those tagged ``DRAW_TAG`` left out."""
    with open(os.path.join("notebooks", name + ".ipynb")) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code" and (draw or DRAW_TAG not in
                                             c["metadata"].get("tags", []))]


def run_cells(cells: list, name: str, **constants) -> dict:
    """Run ``cells`` in order in a namespace of their own, ``constants``
    replacing the first cell's; returns the namespace."""
    ns = {"__name__": "__notebook__"}
    for i, c in enumerate(cells):
        exec(compile(c, f"{name}[{i}]", "exec"), ns)
        if i == 0:
            ns.update(constants)
    return ns


def ops_notebooks(device) -> dict:
    """The untagged code cells of ``NOTEBOOKS`` in order (their first cell
    names ``DEVICE = "cuda"``; a rehearsal on the CPU puts ``device`` in
    its place): their seconds and launches.  Returns the launches."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    launches = {}
    for name in NOTEBOOKS:
        cells = notebook_cells(name, draw=False)
        own = run_cells(cells[:1], name)["DEVICE"]
        sync(device)
        mp.LAUNCHES = mp.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        printed = captured(lambda: run_cells(cells, name,
                                             DEVICE=str(device)))
        sync(device)
        rec = dict(notebook=name, cells=len(cells),
                   seconds=time.perf_counter() - t0, device=own,
                   fwd_launches=mp.LAUNCHES, bwd_launches=mp.BWD_LAUNCHES,
                   printed_lines=len(printed.splitlines()),
                   tail=printed.splitlines()[-3:])
        emit("operations_notebook", **rec)
        if own != "cuda" or mp.LAUNCHES == 0:
            raise RuntimeError(f"notebook {name} failed: {rec}")
        launches["notebook_" + name] = (mp.LAUNCHES, mp.BWD_LAUNCHES)
    return launches


def phase_operations(device) -> dict:
    """The run operations of ``scripts/torch`` and the notebooks on the
    card: (a) ``generate_datasets.sh`` at ``OPS_DATA``; (b) one epoch of
    each training protocol; (c) a killed run relaunched from its
    ``relaunch.cmd``; (d) ``eval_trained.sh``'s tables, card against
    CPU; (e) the notebooks' compute cells.  Returns the (forward,
    backward) launches of each protocol epoch and notebook."""
    t_phase = time.perf_counter()
    root = os.path.abspath(os.path.join(".chipwork", "smoke_operations"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    seconds = {}
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["bash", os.path.abspath(os.path.join(SCRIPTS,
                                              "generate_datasets.sh"))],
        cwd=root, env=_script_env(**OPS_DATA), capture_output=True,
        text=True, timeout=OPS_TIMEOUT)
    seconds["data"] = time.perf_counter() - t0
    data = {v: os.path.join(root, "data", v) for v in ("dirichlet", "mixed")}
    if proc.returncode or not all(
            os.path.exists(os.path.join(p, "A_sparse_matrix.npy"))
            for p in data.values()):
        raise RuntimeError(f"generate_datasets.sh: {proc.stderr[-2000:]}")
    emit("operations_data", seconds=seconds["data"], **OPS_DATA,
         a_prime=os.path.exists(os.path.join(data["dirichlet"],
                                             "A_prime.npy")))
    t0 = time.perf_counter()
    launches = ops_protocols(data, root, device)
    seconds["protocols"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops_kill_relaunch(data, root, device)
    seconds["kill_relaunch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops_tables(data, root, device)
    seconds["tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(ops_notebooks(device))
    seconds["notebooks"] = time.perf_counter() - t0
    emit("operations", phase_s=time.perf_counter() - t_phase, **seconds)
    return launches


# the while_loop phase: the carried solve as the card runs it (CUDA graphs,
# one host read a chunk), the same body stepped eagerly on the card, and
# the host loop.  Graph and eager replay one arithmetic: their first
# WHILE_EARLY iterates and their answers are held bit for bit, or, where
# cuBLAS under capture took another algorithm, within WHILE_GRAPH_TOL ·
# max(1, max|x|) with the reason printed.  The host loop sums its rank
# products over the live rows alone, the carried one over whole zeroed
# blocks: the headline's first NSTEP_EARLY_STEPS iterates are held to
# NSTEP_EARLY_RTOL, the trained request's answers by residual.
WHILE_CHUNKS = (4, 8, 16, 32)
WHILE_EARLY = 8
WHILE_GRAPH_TOL = 1e-6
WHILE_REQUEST_TOLS = (1e-5, 1e-7)
WHILE_RADIUS = 5.0
WHILE_REPS = 2


@contextlib.contextmanager
def loop_switch(graphs: bool = True, chunk: int = None):
    """The carried loop with CUDA graphs on or off (off: its body stepped
    eagerly on the card) and ``chunk`` iterations a host read, for the
    block."""
    from psignn_tpu_torch import loop
    saved = loop._GRAPHS, loop.CHUNK
    loop._GRAPHS = graphs
    loop.CHUNK = saved[1] if chunk is None else chunk
    try:
        yield
    finally:
        loop._GRAPHS, loop.CHUNK = saved


def carried_reads(iters: int, chunk: int = None) -> int:
    """Host reads of a carried solve that runs ``iters`` steps: one a
    chunk of ``chunk`` (default ``loop.CHUNK``), one at the end."""
    from psignn_tpu_torch import loop
    return -(-iters // (chunk or loop.CHUNK)) + 1


def timed_solve(run) -> tuple:
    """(SolverResult, record) of one ``run()`` on the card, its forward
    launches counted from 0: wall, launches, f_θ calls, host reads, graphs
    and their capture seconds, and the bytes its allocations peaked at
    above what was held before it (the carry, the graphs' pool)."""
    from psignn_tpu_torch.kernels import fused_mp as mp
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mp.LAUNCHES = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, dict(wall_s=wall, launches=mp.LAUNCHES, calls=out.calls,
                     iters=out.trace_len - 1, nstep=out.nstep,
                     lowest=out.lowest, host_reads=out.host_reads,
                     graphs=out.graphs, capture_s=out.capture_s,
                     peak_extra_bytes=torch.cuda.max_memory_allocated()
                     - held)


def solve_profile(run, want: int, attempts: int = 3) -> dict:
    """One more ``run()`` under ``torch.profiler`` (the card's activity),
    after a warm-up run that the profiler traces and drops (a cold trace
    lost the first kernels of a solve): its device kernel seconds, and the
    forward kernels the trace holds, those launched by a graph's replay
    included (CUPTI names them ``void (anonymous
    namespace)::fused_mp_fwd_kernel<...>(...)``).  A trace that lost
    kernels (``kernel_device_ms``) holds fewer than the ``want`` a run
    launches: it is taken again, up to ``attempts`` traces, and the
    fullest is kept."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from psignn_tpu_torch.kernels import fused_mp as mp
    best = None
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):          # the warm-up run, the traced one
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                prof.step()
        by_name = profiling.kernel_times(prof)
        rec = dict(device_s=1e-6 * sum(t for t, _ in by_name.values()),
                   profiled_wall_s=wall,
                   fwd_kernels=sum(c for name, (_, c) in by_name.items()
                                   if f"::{mp.KERNEL}_kernel<" in name))
        if best is None or rec["fwd_kernels"] > best["fwd_kernels"]:
            best = rec
        if rec["fwd_kernels"] >= want:
            break
    return best


def carried_request(model, cfg, graph, lp=None):
    """(SolverResult, physics residual of u) of the Ψ-GNN request of
    ``psignn_inference`` (encoder, fixed point, decoder) by ``lp``'s loop
    (None: the route's)."""
    from psignn_tpu_torch.deq import fixed_point_forward
    from psignn_tpu_torch.ops import residual_loss
    with torch.no_grad():
        h0 = model.encoder(graph.x) * graph.fnode_mask
        out = fixed_point_forward(model.function, h0, graph, cfg.deq,
                                  loop=lp)
        u = model.decoder(out.result) * graph.fnode_mask
        return out, float(residual_loss(u, graph))


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a − b| over max(1, max|b|)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def phase_while_loop(graph, tgraph, device, smi: str) -> tuple:
    """The headline three ways (graph replay, the body eagerly, the host
    loop): 531 iterations and 1,064 forward launches each, counted and in
    the profile (but the eager way's), wall, host reads, graphs, capture
    seconds, device time, busy share, memory; graph against eager bit for
    bit over the first ``WHILE_EARLY`` iterates and the answer, against
    the host loop by the chaos rule; each ``CHUNK`` of ``WHILE_CHUNKS`` on
    the headline and on the trained radius-5 request; that request at
    ``WHILE_REQUEST_TOLS`` on the card against the carried loop on the
    CPU, and at ``CMP_OVERRIDES`` against the host loop, by residual; its
    counted launches and f_θ calls against its profile's forward kernels;
    a bench train step's launches.  Returns the graph way's (forward,
    backward) launches and the train step's."""
    from psignn_tpu_torch import loop, solvers
    from psignn_tpu_torch.deq import fixed_point_forward
    from psignn_tpu_torch.kernels import fused_mp as mp
    from psignn_tpu_torch.weights import load_psignn_checkpoint
    cfg = bench.headline_config()
    model = bench.headline_model(cfg, device)
    want = 2 * (HEADLINE_ITERS + 1)
    # one graph a live rank-block count: 531 steps fill 5 blocks of 128
    blocks = -(-HEADLINE_ITERS // solvers._LR_BLOCK)
    ways = (("graph", "while", True), ("eager", "while", False),
            ("host", "host", True))

    def headline(lp, chunk=None, graphs=True):
        def run():
            return bench.headline_solve(model, graph, cfg, lp)
        with loop_switch(graphs, chunk):
            run()                                       # warm-up
            recs = [timed_solve(run)[1] for _ in range(WHILE_REPS)]
            # the eager way repeats the graph way's kernels: not profiled
            prof = solve_profile(run, want) if graphs else dict(
                device_s=None, fwd_kernels=want)
        best = min(r["wall_s"] for r in recs)
        rec = dict(card=smi, loop=lp, graphs_on=graphs,
                   chunk=chunk or loop.CHUNK, wall_s=best,
                   busy=prof["device_s"] / best if graphs else None,
                   reps=recs, **prof)
        reads = carried_reads(HEADLINE_ITERS, chunk) if lp == "while" \
            else HEADLINE_ITERS
        bad = [r for r in recs if r["launches"] != want
               or r["iters"] != HEADLINE_ITERS or r["calls"] != want // 2
               or r["host_reads"] != reads
               or r["graphs"] != (blocks if lp == "while" and graphs
                                  else 0)]
        if bad or prof["fwd_kernels"] != want:
            raise RuntimeError(f"while_loop headline ({lp}, graphs "
                               f"{graphs}, chunk {chunk}) failed: {rec}")
        return rec

    runs = {}
    for name, lp, graphs in ways:
        runs[name] = headline(lp, graphs=graphs)
        emit("while_loop_headline", way=name, **runs[name])
    launches = runs["graph"]["reps"][0]["launches"]

    # the first iterates and the answers: graph, eager, host
    traces = {}
    for name, lp, graphs in ways:
        with loop_switch(graphs), torch.no_grad():
            h0 = model.encoder(graph.x) * graph.fnode_mask
            out = fixed_point_forward(model.function, h0, graph, cfg.deq,
                                      keep_trace=True, loop=lp)
        traces[name] = (out.trace[:WHILE_EARLY + 1].clone(), out.result)
        del out
    (tg, rg), (te, re_), (th, _) = (traces[n] for n, _, _ in ways)
    bitwise = torch.equal(tg, te) and torch.equal(rg, re_)
    early_host = max(float(torch.linalg.vector_norm(a - b)
                           / torch.linalg.vector_norm(b))
                     for a, b in zip(tg[1:NSTEP_EARLY_STEPS + 1],
                                     th[1:NSTEP_EARLY_STEPS + 1]))
    cmp = dict(early=WHILE_EARLY, graph_eager_bit_identical=bitwise,
               graph_eager_early_gap=gap(tg, te),
               graph_eager_result_gap=gap(rg, re_),
               graph_tol=WHILE_GRAPH_TOL,
               host_early_steps=NSTEP_EARLY_STEPS,
               graph_host_early_rel=early_host,
               host_early_rtol=NSTEP_EARLY_RTOL)
    if not bitwise:
        cmp["reason"] = ("graph and eager differ: cuBLAS under capture "
                         "took another algorithm")
    emit("while_loop_iterates", **cmp)
    if (not bitwise and max(cmp["graph_eager_early_gap"],
                            cmp["graph_eager_result_gap"]) > WHILE_GRAPH_TOL
            or early_host > NSTEP_EARLY_RTOL):
        raise RuntimeError(f"while_loop iterates disagree: {cmp}")

    # CHUNK: the headline and the trained radius-5 request
    cpu = torch.device("cpu")
    rgraph, rgraph_cpu = sweep_graphs((WHILE_RADIUS,),
                                      (device, cpu))[WHILE_RADIUS]
    tmodel, tcfg = load_psignn_checkpoint(CKPT, device)
    for chunk in WHILE_CHUNKS:
        rec = runs["graph"] if chunk == loop.CHUNK else \
            headline("while", chunk)
        with loop_switch(chunk=chunk):
            carried_request(tmodel, tcfg, rgraph)       # warm-up
            reqs = [timed_solve(lambda: carried_request(
                tmodel, tcfg, rgraph)[0])[1] for _ in range(WHILE_REPS)]
        emit("while_loop_chunk", card=smi, chunk=chunk,
             headline=dict(wall_s=rec["wall_s"], device_s=rec["device_s"],
                           busy=rec["busy"],
                           host_reads=rec["reps"][0]["host_reads"],
                           graphs=rec["reps"][0]["graphs"],
                           capture_s=[r["capture_s"] for r in rec["reps"]],
                           peak_extra_bytes=rec["reps"][0]
                           ["peak_extra_bytes"]),
             request=dict(radius=WHILE_RADIUS, fw_tol=tcfg.fw_tol,
                          n_nodes=rgraph.total_nodes,
                          wall_s=min(r["wall_s"] for r in reqs), reps=reqs))
        if any(r["launches"] != 2 * r["calls"] or r["graphs"] < 1
               for r in reqs):
            raise RuntimeError(f"while_loop request at chunk {chunk}: "
                               f"{reqs}")

    # the trained request: the card's graphs against the CPU's carried
    # loop, and against the card's host loop, by residual.  A CPU solve
    # that ran to its threshold fired no stop test, so at a tighter
    # tolerance it is the same solve: it is not run again.
    cpu_ran = None
    for over, lp_card in (*((dict(fw_tol=t), None)
                            for t in WHILE_REQUEST_TOLS),
                          (CMP_OVERRIDES, "host")):
        m_gpu, c_gpu = load_psignn_checkpoint(CKPT, device, over)
        gout, gres = carried_request(m_gpu, c_gpu, rgraph)
        reused = False
        if lp_card == "host":         # the card's host loop, not the CPU
            oout, ores = carried_request(m_gpu, c_gpu, rgraph, "host")
        elif cpu_ran is not None and \
                cpu_ran[0].trace_len - 1 == c_gpu.fw_thres:
            (oout, ores), reused = cpu_ran, True
        else:
            m_cpu, c_cpu = load_psignn_checkpoint(CKPT, cpu, over)
            oout, ores = cpu_ran = carried_request(m_cpu, c_cpu, rgraph_cpu,
                                                   "while")
        rec = dict(overrides=over, other="card host loop" if lp_card
                   else "cpu carried loop", other_reused=reused,
                   graph=dict(nstep=gout.nstep, lowest=gout.lowest,
                              calls=gout.calls, res=gres),
                   other_solve=dict(nstep=oout.nstep, lowest=oout.lowest,
                                    calls=oout.calls,
                                    iters=oout.trace_len - 1, res=ores),
                   res_rel_diff=abs(gres - ores) / ores, res_rtol=RES_REL_TOL)
        emit("while_loop_request", **rec)
        if (rec["res_rel_diff"] > RES_REL_TOL or gout.prot_break
                or oout.prot_break):
            raise RuntimeError(f"while_loop request disagrees: {rec}")

    # one replayed request's counted launches and f_θ calls against the
    # forward kernels its profile holds: what a replay adds to the counts
    # is what ran on the card
    calls, seen = FCalls(), []
    hook = tmodel.function.register_forward_hook(calls)

    def request():
        calls.reset()
        mp.LAUNCHES = 0
        with calls:
            out = carried_request(tmodel, tcfg, rgraph)[0]
        torch.cuda.synchronize()
        seen.append(dict(launches=mp.LAUNCHES, f_calls=calls.calls,
                         calls=out.calls, graphs=out.graphs,
                         host_reads=out.host_reads))

    try:
        request()
        prof = solve_profile(request, seen[0]["launches"])
    finally:
        hook.remove()
    rec = dict(seen[-1], radius=WHILE_RADIUS, fw_tol=tcfg.fw_tol,
               profiled_fwd_kernels=prof["fwd_kernels"],
               device_s=prof["device_s"])
    emit("while_loop_request_profile", **rec)
    if (rec["graphs"] < 1 or rec["f_calls"] != rec["calls"]
            or not rec["profiled_fwd_kernels"] == rec["launches"]
            == mp_per_call(tcfg) * rec["f_calls"]):
        raise RuntimeError(f"while_loop request's counts are not what "
                           f"ran: {rec}")

    # a bench train step: its forward solve carried, the adjoint's not
    smodel, scfg, init = trained_model(device, TRAIN_OVERRIDES)
    mp.LAUNCHES = mp.BWD_LAUNCHES = 0
    res, wall = step_from(smodel, scfg, init, tgraph)
    step = (mp.LAUNCHES, mp.BWD_LAUNCHES)
    want_step = expected_launches(res, scfg)
    rec = dict(card=smi, seconds=wall, fw=stats(res.fw), bw=stats(res.bw),
               launches=list(step), expected_launches=list(want_step))
    emit("while_loop_train_step", **rec)
    if step != want_step or 0 in step:
        raise RuntimeError(f"while_loop train step failed: {rec}")
    return (launches, 0), step


def device_breakdown(run, top: int = 8, ranges=()) -> dict:
    """One more run of ``run`` under ``torch.profiler``: the device's kernel
    time in all and by kernel name, and the busy share of the unprofiled
    wall it implies.  Kernels run on one stream, so their times add.  For
    each ``record_function`` name of ``ranges``, ``<name>_device_s`` is the
    device time of the kernels launched inside those ranges."""
    from torch.autograd import DeviceType
    # the host's operators are recorded only where a range needs them:
    # they add seconds to a trace of tens of thousands of launches
    prof, profiled_wall = profiling.profiled(run, host=bool(ranges))
    by_name = profiling.kernel_times(prof)
    busy_s = sum(t for t, _ in by_name.values()) * 1e-6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out = dict(profiled_wall_s=profiled_wall, device_kernel_s=busy_s,
               device_launches=sum(c for _, c in by_name.values()),
               kernels=[dict(name=k[:80], ms=t * 1e-3, count=c)
                        for k, (t, c) in ranked])
    for name in ranges:
        out[name + "_device_s"] = 1e-6 * sum(
            ev.device_time_total for ev in prof.events()
            if ev.name == name and ev.device_type == DeviceType.CPU)
    return out


def main() -> None:
    from psignn_tpu_torch.graphs import batch_graphs
    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    device = torch.device("cuda")
    timed("build", phase_build)
    timed("native", phase_native, smi)
    graph, sample, _, _ = timed("graphs", bench.build_big_graph,
                                device=device)
    # the 50-mesh batches by (sample form, variant)
    built, built_samples = {}, {}
    for form, variant in (("psignn", "dirichlet"), ("psignn", "mixed"),
                          ("dss", "dirichlet")):
        t0 = time.perf_counter()
        chunk = train_samples(TRAIN_MESHES, 0, variant=variant, form=form)
        g = batch_graphs(chunk, device=device)
        built[(form, variant)] = (g, time.perf_counter() - t0)
        built_samples[(form, variant)] = chunk
    seconds["graphs"] += sum(t for _, t in built.values())
    (tgraph, tgraph_s), (mgraph, mgraph_s), (dgraph, _) = built.values()
    cases = mp_cases(graph, sample, tgraph, mgraph, dgraph, device)
    fwd = timed("kernel", phase_kernel, cases, device)
    bwd = timed("kernel_bwd", phase_kernel_bwd, cases, device)
    fwd["launches"] = timed("slice", phase_slice, device)
    timed("headline", phase_headline, graph, sample, device, smi)
    benched = timed("bench", phase_bench, smi)
    bwd["launches"] = timed("train_step", phase_train_step, tgraph, tgraph_s,
                            device, smi)[1]
    _, mixed_test = timed("mixed_eval", phase_mixed_eval, device)
    timed("mixed_train_step", phase_train_step, mgraph, mgraph_s, device,
          smi, MIXED_CKPT, "mixed_train_step")
    timed("solvers", phase_solvers, device)
    jvp, newton = timed("newton", phase_newton, cases, device, smi)
    timed("families", phase_families, device)
    timed("dsgps_mixed_eval", phase_dsgps_mixed_eval, mixed_test, device)
    timed("unrolled_train_step", phase_unrolled_train_step, built, device,
          smi)
    stacked = timed("stacked_train_step", phase_stacked_train_step, tgraph,
                    tgraph_s, device, smi)
    lowrank = timed("lowrank", phase_lowrank, graph, device, smi)
    zoo = timed("zoo", phase_zoo, device)
    iterative = timed("iterative", phase_iterative, device)
    several = timed("several_init", phase_several_init, device)
    dist = timed("dist", phase_dist, sample, built_samples, device, smi,
                 seconds)
    trainer = timed("trainer", phase_trainer, device)
    parity = timed("parity", phase_parity, device, smi)
    nstep = timed("nstep_study", phase_nstep_study, device)
    figures = timed("figures", phase_figures, device, smi)
    operations = timed("operations", phase_operations, device)
    ordered = timed("order", phase_order, graph, sample, tgraph,
                    built_samples[("psignn", "dirichlet")], mgraph, device,
                    smi)
    carried, carried_step = timed("while_loop", phase_while_loop, graph,
                                  tgraph, device, smi)
    emit("seconds", **seconds)
    # each path's launches, counted from 0 just before it ran
    fwd["launches_by_path"] = dict(
        slice=fwd["launches"], stacked_train_step=stacked[0],
        lowrank=lowrank, zoo=zoo, iterative=iterative, several_init=several,
        **{path: n[0] for path, n in dist.items()},
        **{"trainer_" + run: n[0] for run, n in trainer.items()},
        **parity, nstep_study=nstep, **figures,
        **{path: n[0] for path, n in operations.items()},
        **{path: n[0] for path, n in benched.items()},
        **{path: n[0] for path, n in ordered.items()},
        while_loop=carried[0], while_loop_train_step=carried_step[0])
    bwd["launches_by_path"] = dict(
        train_step=bwd["launches"], stacked_train_step=stacked[1],
        **{path: n[1] for path, n in benched.items() if n[1]},
        **{path: n[1] for path, n in ordered.items() if n[1]},
        **{path: n[1] for path, n in dist.items() if n[1]},
        **{"trainer_" + run: n[1] for run, n in trainer.items()},
        **{path: n[1] for path, n in operations.items() if n[1]},
        **{path: n[1] for path, n in newton.items() if n[1]},
        while_loop_train_step=carried_step[1])
    fwd["launches_by_path"].update(
        {path: n[0] for path, n in newton.items()})
    # the JVP kernel's main path: the Newton-Krylov requests
    jvp["launches"] = sum(n[2] for path, n in newton.items()
                          if path.startswith("newton_krylov_"))
    jvp["launches_by_path"] = {path: n[2] for path, n in newton.items()}
    print(json.dumps({"kernels": [fwd, bwd, jvp]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
