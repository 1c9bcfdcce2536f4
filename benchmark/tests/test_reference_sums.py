"""The reference's sums of rows into nodes (``index_add_`` in
``message_passing`` and ``Batch.spmv``, and the backward of their
gathers) inside ``common.FixedOrder()``, as the training judge runs them:
two calls give the same bits, forward and backward, on the CPU and on the
card."""

import os

import pytest
import torch

from benchmark.benchlib import pool
from benchmark.benchlib.spec import ROOT
from benchmark.reference import psignn
from benchmark.reference.common import (FixedOrder, message_passing,
                                        read_checkpoint)

TRAFFIC = dict(radii=[1.0], meshes_per_radius=2, hsize=0.08, pool_seed=3)


def _params(device):
    from benchmark.benchlib.spec import load_cell
    config = load_cell("psignn_dirichlet.sweep").config
    p = read_checkpoint(os.path.join(ROOT, config["checkpoint"]))["params"]
    return psignn.Model(p, device).p["function"]["layers"][0]


def _both_sums(device):
    """message_passing in both directions and spmv over a batch of two
    meshes, with their gradients in h, u and the edge MLP's weights, and
    a gradient of a gradient (the judge's Jacobian term)."""
    samples = [s["sample"] for s in pool.mesh_pool(TRAFFIC)]
    batch = psignn.Batch(samples, device)
    layer = _params(device)
    g = torch.Generator().manual_seed(7)
    h = torch.randn(batch.n, 10, generator=g).to(device).requires_grad_()
    u = torch.randn(batch.n, 1, generator=g).to(device).requires_grad_()
    w = layer["phi_to"][0]["w"].requires_grad_()
    with FixedOrder():
        out = [message_passing(layer["phi_to"], h, batch.edges, "to", "f32"),
               message_passing(layer["phi_from"], h, batch.edges, "from",
                               "f32"),
               batch.spmv(u)]
        loss = sum(torch.sum(o * torch.sin(o)) for o in out)
        grads = torch.autograd.grad(loss, [h, u, w], create_graph=True)
        (again,) = torch.autograd.grad(torch.sum(grads[0] ** 2), w)
    return [t.detach().cpu() for t in out + list(grads) + [again]]


def _bit_identical(device):
    first, second = _both_sums(device), _both_sums(device)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_two_calls_bit_identical_cpu():
    _bit_identical("cpu")


@pytest.mark.chip
def test_two_calls_bit_identical_card(cuda):
    _bit_identical(cuda)


def test_fixed_order_restores_the_mode():
    """The program's own steps after a judge run as they did before it."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    with FixedOrder():
        assert torch.are_deterministic_algorithms_enabled()
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled()) == was
