"""Model families of the port (Ψ-GNN Dirichlet so far)."""

from .psignn import (Psignn, PsignnConfig, PsignnInference, UpdateFunction,
                     psignn_inference)

__all__ = ["Psignn", "PsignnConfig", "PsignnInference", "UpdateFunction",
           "psignn_inference"]
