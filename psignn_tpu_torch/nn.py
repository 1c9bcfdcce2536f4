"""Xavier-initialised Linear / MLP / LayerNorm blocks.

Port of ``psignn_tpu/nn.py``: Xavier-uniform weights with zero bias, ReLU
between hidden layers, LayerNorm with the biased variance and eps 1e-5
(``nn.LayerNorm`` computes exactly that).  Weights are in ``nn.Linear``
layout (out, in); ``weights.params_from_jax`` converts the JAX (in, out)
layout.  Matmuls stay full f32: the package switches TF32 off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def linear(fan_in: int, fan_out: int,
           generator: Optional[torch.Generator] = None,
           device=None) -> nn.Linear:
    """``nn.Linear`` with Xavier-uniform weight from ``generator`` and zero
    bias (the reference's ``initialize_weights_xavier``).  The draw happens
    on the CPU, so a CPU generator seeds a model on any device."""
    lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out, device="cpu")
    with torch.no_grad():
        nn.init.xavier_uniform_(lin.weight, generator=generator)
        lin.bias.zero_()
    return lin.to(device)


class MLP(nn.Module):
    """Linear layers over ``channels = [in, h1, ..., out]`` with ReLU
    between them and none after the last."""

    def __init__(self, channels: Sequence[int],
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            linear(a, b, generator, device)
            for a, b in zip(channels[:-1], channels[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < last:
                x = torch.relu(x)
        return x


def layer_norm(dim: int, device=None) -> nn.LayerNorm:
    """LayerNorm over the last axis: biased variance, eps 1e-5, unit scale
    and zero bias."""
    return nn.LayerNorm(dim, eps=1e-5, device=device)
