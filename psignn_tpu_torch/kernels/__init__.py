"""Hand-written GPU kernels and their plain PyTorch versions.

``fused_mp`` — fused directional message passing, the CUDA C++ port of the
TPU kernel ``psignn_tpu/kernels/fused_mp.py:_fused_mp_kernel``.
"""

from .fused_mp import MPCsr, fused_message_passing, mp_from_csr, pack_csr

__all__ = ["MPCsr", "fused_message_passing", "mp_from_csr", "pack_csr"]
