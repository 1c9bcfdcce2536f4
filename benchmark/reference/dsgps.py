"""Plain reference of a DS-GPS request (Dirichlet): the encoder, k steps
of the gated recurrent update and the decoder, in PyTorch over the
checkpoint's JAX-layout parameters.

The unroll is a fixed number of steps, so the reference recomputes the
answer itself and ``judge`` compares it with the program's:
``u_gap`` = max |u − u_ref| / max |u_ref|.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .common import Edges, message_passing, mlp, node_tensors, to_device


class Model:
    """The checkpoint's DS-GPS, on ``device``."""

    def __init__(self, params, device, precision: str = "f32"):
        self.p = to_device(params, device)
        self.device = device
        self.precision = precision

    def answer(self, sample: Dict[str, np.ndarray], k: int) -> np.ndarray:
        """(N,) u after ``k`` steps, mesh order."""
        p, pr, dev = self.p, self.precision, self.device
        with torch.no_grad():
            x, prb, dmask = node_tensors(sample, dev)
            edges = Edges(sample, dev)
            h0 = mlp(p["autoencoder"]["encoder"], x, pr)
            h = h0
            for _ in range(k):
                mp_to = message_passing(p["phi_to"], h, edges, "to", pr)
                mp_from = message_passing(p["phi_from"], h, edges, "from", pr)
                concat = torch.cat([h, mp_to, mp_from, prb], -1)
                gate = torch.sigmoid(mlp(p["z_k"], concat, pr))
                reset = torch.sigmoid(mlp(p["r_k"], concat, pr))
                corr = torch.tanh(mlp(p["correction"], torch.cat(
                    [reset * h, mp_to, mp_from, prb], -1), pr))
                h = torch.where(dmask > 0, h0, h + gate * corr)
            u = mlp(p["autoencoder"]["decoder"], h, pr)[:, 0]
        return u.cpu().numpy().astype(np.float64)


def judge(model: Model, sample: Dict[str, np.ndarray], answer: dict,
          cfg: dict) -> Dict[str, float]:
    """``u_gap`` of one request; ``answer["u"]`` (N,) in mesh order."""
    u = answer["u"]
    u_ref = model.answer(sample, cfg["k"])
    scale = max(float(np.max(np.abs(u_ref))), 1e-6)
    return dict(u_gap=float(np.max(np.abs(np.asarray(u, np.float64) - u_ref))
                            / scale))


def request_flops(cfg: dict, n: int, e: int, fw_calls: int,
                  mp_flops) -> float:
    """Model operations of one request: ``fw_calls`` steps (two message
    passings at ``mp_flops(n, e)``, the gates z and r, the correction,
    the gated update), the encoder and the decoder."""
    D, P = cfg["latent_dim"], 2
    c = 3 * D + P
    node = 3 * (2 * c * D) + 4 * D + 5 * D + 3 * D
    step = 2 * mp_flops(n, e) + n * node
    autoenc = n * (2 * 1 * D + D + 2 * D * D) + n * (2 * D * D + D + 2 * D)
    return fw_calls * step + autoenc
