"""psignn_tpu_torch — the PyTorch/CUDA port of ``psignn_tpu``.

Runs Ψ-GNN inference (fresh mesh → FEM system → encoder → fixed point of
the update function → decoder → residual metrics) and training
(implicit-gradient DEQ step, dual Adam, trainer and CLI), and the same for
the paper's two baselines, DS-GPS and DSS (k-step unrolls, trained by
backpropagation through the unroll), with Dirichlet or mixed
Dirichlet+Neumann conditions (DSS: Dirichlet), on an NVIDIA GPU, with the
fused message passing, its backward and its tangent (forward-mode AD, for
Newton-Krylov) as hand-written CUDA kernels
(``kernels/csrc/fused_mp_{fwd,bwd,jvp}.cu``).  Module names mirror the JAX
package so each counterpart is easy to find:

  graphs   — unpadded concatenated mesh graphs + CSR edge packings
  nn       — Xavier-initialised MLP blocks
  ops      — message passing, SpMV and BC-encoded residuals, masked means
  solvers  — Picard, Anderson, Broyden (+ Armijo line search, capped or
             bfloat16 rank memory), Newton (dense Jacobian) and
             Newton-Krylov (JAX's batched GMRES on JVPs), each also as
             per-graph lanes of one batch; all but the Newton solvers
             also split over ranks (the ``reduce`` / ``sync`` hooks)
  deq      — forward solve, implicit backward, Jacobian regularisers
  models   — Ψ-GNN, DS-GPS (Dirichlet and mixed) and DSS (Dirichlet):
             inference, the iterate traces and the training forwards
             (Ψ-GNN also per graph: ``--stacked_batch``)
  weights  — JAX parameter trees and checkpoints ↔ port modules
  data     — blob and mixed meshes, P1 FEM assembly, samples, dataset
             factory and loader
  kernels  — the CUDA fused message-passing kernels (forward, backward,
             JVP) and their plain versions
  train    — optimizers, the train steps, checkpoints, the trainer
  dist     — several devices over ``torch.distributed``, one process a
             rank: data parallelism, edge-sharded message passing, the
             halo-partitioned solve and train step, the rank launcher
  cli      — the training command line (``--num_devices``)
  eval     — per-graph metrics, the test-split table, the
             growing-geometry sweep, the out-of-distribution geometry zoo
             and the several-initialisations study
  compat   — reference ``.pt`` checkpoints → port models
  profiling — the program's spans (recorded under ``torch.profiler``),
              its traces and device time, best-of timing
  entry    — one training forward on one card, and the multi-rank dry run

The package imports torch, numpy and scipy only — never JAX or the JAX
package.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Every f32 matmul and convolution stays full IEEE f32: a TF32 dot capped the
# DEQ residual on the reference build (docs/PERF.md "Fixes that mattered" #3).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the first
    CUDA device.  Raises when there is none — the CPU is used only when a
    caller asks for it explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "psignn_tpu_torch needs a CUDA device; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or ``default_device()`` if None."""
    return default_device() if device is None else torch.device(device)
