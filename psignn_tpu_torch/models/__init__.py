"""Model families of the port: Ψ-GNN, DS-GPS and DSS."""

from .dsgps import (Dsgps, DsgpsConfig, DsgpsOutput, dsgps_forward,
                    dsgps_inference, dsgps_iterative_inference)
from .dss import Dss, DssConfig, DssOutput, dss_forward, dss_inference
from .psignn import (Psignn, PsignnConfig, PsignnInference, PsignnOutput,
                     UpdateFunction, psignn_forward, psignn_forward_stacked,
                     psignn_inference, psignn_iterative_inference)

__all__ = ["Dsgps", "DsgpsConfig", "DsgpsOutput", "Dss", "DssConfig",
           "DssOutput", "Psignn", "PsignnConfig", "PsignnInference",
           "PsignnOutput", "UpdateFunction", "dsgps_forward",
           "dsgps_inference", "dsgps_iterative_inference", "dss_forward",
           "dss_inference", "psignn_forward", "psignn_forward_stacked",
           "psignn_inference", "psignn_iterative_inference"]
