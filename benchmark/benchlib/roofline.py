"""Frozen roofline arithmetic: the H100's published peaks and the least
bytes and operations of one call of each fused message-passing kernel.

A copy of ``chip_smoke.py``'s ``fused_mp_bound`` and
``fused_mp_bwd_bound`` (their bytes and flops; the bound is the larger of
bytes over the HBM rate and flops over the f32 rate) and peaks, as they
stood when the benchmark was defined.  The model widths of the cells:
d = dh = d_out = latent (10), edge_dim 3.
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet: HBM3 rate and the f32 rate outside the
# tensor cores (TF32 is off, so no matmul of the port uses them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def fused_mp_costs(n: int, e: int, d: int = 10, dh: int = 10,
                   d_out: int = 10, edge_dim: int = 3):
    """(bytes, flops) of one forward call over ``n`` rows and ``e``
    edges: each input read once, the output written once; per node W1a·h
    and W1b·h, per edge the edge term, bias, add, ReLU and sum, per row W2
    and deg·b2."""
    weights = dh * (2 * d + edge_dim) + dh + d_out * dh + d_out
    nbytes = 4 * (n * d + (n + 1) + e + e * edge_dim + weights + n * d_out)
    flops = (n * 2 * (2 * d * dh)
             + e * dh * (2 * edge_dim + 4)
             + n * (2 * dh * d_out + 2 * d_out))
    return float(nbytes), float(flops)


def fused_mp_bwd_costs(n: int, e: int, d: int = 10, dh: int = 10,
                       d_out: int = 10, edge_dim: int = 3):
    """(bytes, flops) of one VJP call: h, g, the CSR and the weights read
    once, dh and the parameter gradients written once."""
    weights = dh * (2 * d + edge_dim) + dh + d_out * dh
    nbytes = 4 * (n * d + n * d_out + (n + 1) + e + e * edge_dim + weights
                  + n * d + weights + d_out)
    flops = (n * 2 * (2 * d * dh)
             + e * dh * (2 * edge_dim + 4)
             + n * 2 * dh * d_out
             + e * dh * (4 + 2 * edge_dim)
             + n * (2 * d_out * dh + 2 * d_out)
             + 4 * n * 2 * d * dh)
    return float(nbytes), float(flops)


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card could take for these bytes and flops."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def fused_mp_bound_s(n: int, e: int, d: int = 10) -> float:
    return bound_s(*fused_mp_costs(n, e, d, d, d))


def fused_mp_flops(n: int, e: int, d: int = 10) -> float:
    return fused_mp_costs(n, e, d, d, d)[1]
