"""The plain reference against the program's CPU path on small meshes."""

import os

import numpy as np
import pytest
import torch

from benchmark.benchlib import pool
from benchmark.benchlib.spec import ROOT, load_cell
from benchmark.reference import dsgps, psignn
from benchmark.reference.common import read_checkpoint, tf32

TRAFFIC = dict(radii=[0.6, 1.0], meshes_per_radius=1, hsize=0.08,
               pool_seed=3)


def _program(config):
    from psignn_tpu_torch.eval.run_eval import load_predictor
    return load_predictor(os.path.join(ROOT, config["checkpoint"]), "cpu")


def _graph(s):
    from psignn_tpu_torch.dist.partition import (apply_node_permutation,
                                                 rcm_permutation)
    from psignn_tpu_torch.graphs import batch_graphs
    perm = rcm_permutation(s["senders"], s["receivers"], s["n"])
    return perm, batch_graphs([apply_node_permutation(s["sample"], perm)],
                              device="cpu")


def _mesh_order(perm, a):
    out = np.empty_like(a)
    out[perm] = a
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_psignn_request_matches_reference(i):
    config = load_cell("psignn_dirichlet.sweep").config
    predict, _, _, model = _program(config)
    kept = {}
    hook = model.decoder.register_forward_pre_hook(
        lambda _m, args: kept.__setitem__("z", args[0]))
    s = pool.mesh_pool(TRAFFIC)[i]
    perm, graph = _graph(s)
    out = predict(graph)
    hook.remove()
    z = _mesh_order(perm, kept["z"].numpy())
    u = _mesh_order(perm, out.u[:, 0].numpy())
    ref = psignn.Model(read_checkpoint(os.path.join(
        ROOT, config["checkpoint"]))["params"], "cpu")
    nums = psignn.judge(ref, s["sample"],
                        dict(z=z, u=u, reported=out.lowest), config["model"])
    assert nums["residual"] < config["model"]["fw_tol"]
    assert nums["residual_gap"] < 1e-7
    assert nums["decode_gap"] < 1e-6
    # the reference's own solve reaches the same fixed point
    z_ref, u_ref, res = psignn.solve(ref, s["sample"], 1e-5, 500)
    assert res < 1e-5
    assert np.max(np.abs(u_ref - u)) / np.max(np.abs(u_ref)) < 5e-3


@pytest.mark.parametrize("i", [0, 1])
def test_dsgps_request_matches_reference(i):
    config = load_cell("dsgps_dirichlet.sweep").config
    predict, _, _, _ = _program(config)
    s = pool.mesh_pool(TRAFFIC)[i]
    perm, graph = _graph(s)
    u = _mesh_order(perm, predict(graph)[:, 0].numpy())
    ref = dsgps.Model(read_checkpoint(os.path.join(
        ROOT, config["checkpoint"]))["params"], "cpu")
    assert dsgps.judge(ref, s["sample"], dict(u=u), config["model"])[
        "u_gap"] < 1e-5


def test_tf32_rounding():
    """Round to nearest, ties to even, on a 10-bit mantissa."""
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -12, -1.0 - 3 * 2 ** -12])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                         -1.0, -1.0 - 2 ** -10])
    assert torch.equal(tf32(x), want)
