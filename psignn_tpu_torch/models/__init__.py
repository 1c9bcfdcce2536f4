"""Model families of the port (Ψ-GNN Dirichlet so far)."""

from .psignn import (Psignn, PsignnConfig, PsignnInference, PsignnOutput,
                     UpdateFunction, psignn_forward, psignn_inference)

__all__ = ["Psignn", "PsignnConfig", "PsignnInference", "PsignnOutput",
           "UpdateFunction", "psignn_forward", "psignn_inference"]
