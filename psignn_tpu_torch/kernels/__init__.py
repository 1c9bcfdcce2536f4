"""Hand-written GPU kernels and their plain PyTorch versions.

``fused_mp`` — fused directional message passing: the CUDA C++ ports of
the TPU kernels ``psignn_tpu/kernels/fused_mp.py:_fused_mp_kernel``
(forward) and ``_fused_mp_bwd_kernel`` (backward).
"""

from .fused_mp import (MPCsr, fused_message_passing, fused_mp_vjp,
                       mp_from_csr, mp_vjp_from_csr, pack_csr)

__all__ = ["MPCsr", "fused_message_passing", "fused_mp_vjp", "mp_from_csr",
           "mp_vjp_from_csr", "pack_csr"]
