"""psignn_tpu_torch — the PyTorch/CUDA port of ``psignn_tpu``.

Runs Ψ-GNN Dirichlet inference (fresh mesh → FEM system → encoder →
Broyden fixed point of the update function → decoder → residual metrics)
on an NVIDIA GPU, with the fused message passing as a hand-written CUDA
kernel (``kernels/csrc/fused_mp_fwd.cu``).  Module names mirror the JAX
package so each counterpart is easy to find:

  graphs   — unpadded concatenated mesh graphs + CSR edge packings
  nn       — Xavier-initialised MLP blocks
  ops      — message passing, SpMV residual, masked means
  solvers  — Broyden (others not yet ported)
  deq      — the forward fixed-point solve
  models   — Ψ-GNN (Dirichlet)
  weights  — JAX parameter trees and checkpoints → port modules
  data     — blob meshes, P1 FEM assembly, sample conversion
  kernels  — the CUDA fused message-passing kernel and its plain version
  eval     — per-graph metrics and the growing-geometry sweep

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
