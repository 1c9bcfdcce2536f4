"""The mixed Dirichlet–Neumann Ψ-GNN on the port's sweep path, against
the benchmark's plain reference (``benchmark/reference/psignn_mixed.py``):
f_θ, its encoding and decoding on seeded random weights, a whole mixed
inference through the sweep's sample build and RCM order, the carried
loop's body stepped eagerly against the host loop, the count of f_θ
evaluations against the solver's, ``run_eval --sweep --variant mixed``
end to end, and the benchmark's frozen mixed generator against the
program's, bit for bit.  All on the CPU at small sizes."""

import json

import numpy as np
import pytest
import torch

from _torch_parity import MIXED_CKPT, mixed_sample
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from benchmark.benchlib import gen_mixed
from benchmark.reference import psignn_mixed as ref
from benchmark.reference.common import Edges, read_checkpoint
from psignn_tpu_torch import deq
from psignn_tpu_torch.data.meshgen import blob_mesh, mixed_blob_mesh
from psignn_tpu_torch.eval import run_eval
from psignn_tpu_torch.eval.sweep import build_data, growing_geometry_sweep
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import Psignn, PsignnConfig, psignn_inference
from psignn_tpu_torch.models import psignn as psignn_module
from psignn_tpu_torch.weights import load_psignn_checkpoint, params_to_jax

DIRICHLET_CKPT = "results/psignn_dirichlet/ckpt/best_model.ckpt"


def _random_model(seed: int):
    """A mixed Ψ-GNN with seeded random weights, and the reference on the
    same weights."""
    cfg = PsignnConfig(bc_mode="mixed")
    model = Psignn(cfg, generator=torch.Generator().manual_seed(seed))
    tree = params_to_jax({k: v.detach() for k, v in
                          model.state_dict().items()})
    return model, cfg, ref.Model(tree, "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_f_encode_decode_match_the_reference(seed):
    """f_θ at a random h, the encoding and the decoding agree with the
    plain reference within 1e-5 of their scale (f32 sums in other
    orders)."""
    model, _, plain = _random_model(seed)
    s = mixed_sample(seed, radius=1.0, hsize=0.2)
    g = batch_graphs([s], device="cpu")
    nodes, edges = ref.Nodes(s, "cpu"), Edges(s, "cpu")
    h = torch.randn(g.total_nodes, 10,
                    generator=torch.Generator().manual_seed(seed + 7))
    with torch.no_grad():
        h0 = model.encoder(g.x)
        got = model.function(h, h0, g)
        want = plain.f(h, plain.encode(nodes.x), nodes, edges)
        u = model.decoder(h)

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, b.abs().max()))

    assert int(s["tags"][:, 2].sum()) > 0          # Neumann rows present
    close(h0, plain.encode(nodes.x))
    close(got, want)
    close(u, plain.decode(h))


def test_mixed_inference_through_the_sweep_build_matches_the_reference():
    """A mixed request as the sweep builds it on a card (mixed mesh, mixed
    sample, RCM order): the trained checkpoint's z* put back in mesh order
    is a fixed point of the reference's f_θ within the solve's tolerance,
    and ``u`` is the reference's decoding of it."""
    from psignn_tpu_torch.dist.partition import rcm_ordered
    model, cfg = load_psignn_checkpoint(MIXED_CKPT, "cpu")

    def built(pallas):
        rng = np.random.default_rng(3)
        mesh = mixed_blob_mesh(radius=1.0, hsize=0.12, rng=rng)
        return build_data(mesh, 1.0, rng, ("psignn",), pallas=pallas,
                          variant="mixed")["psignn"]

    s = built(False)
    ordered = rcm_ordered(dict(s, node_id=np.arange(s["x"].shape[0])))
    perm = ordered["node_id"]
    # the sweep's RCM order on a card permutes every node array, normals too
    swept = built(True)
    assert set(swept) == set(ordered) - {"node_id"}
    for k, v in swept.items():
        assert np.array_equal(v, ordered[k]), k
    assert np.array_equal(swept["unit_normal_vector"],
                          s["unit_normal_vector"][perm])
    assert not np.array_equal(perm, np.arange(len(perm)))
    z = {}
    hook = model.decoder.register_forward_pre_hook(
        lambda _m, args: z.setdefault("z", args[0]))
    out = psignn_inference(model, batch_graphs([ordered], device="cpu"),
                           cfg)
    hook.remove()
    zm = np.empty((len(perm), 10), np.float32)
    zm[perm] = z["z"].numpy()
    um = np.empty(len(perm), np.float32)
    um[perm] = out.u[:, 0].numpy()
    plain = ref.Model(read_checkpoint(MIXED_CKPT)["params"], "cpu")
    nums = ref.judge(plain, s, dict(z=zm, u=um, reported=out.lowest),
                     {"fw_tol": cfg.fw_tol})
    assert out.lowest < cfg.fw_tol
    assert nums["residual"] < 1.5 * cfg.fw_tol, nums
    assert nums["residual_gap"] < 1e-6 and nums["decode_gap"] < 1e-5, nums


def test_mixed_carried_body_stepped_eagerly_matches_the_host_loop():
    """The carried loop (``loop="while"``, stepped eagerly on the CPU)
    answers the mixed model's solve as the host loop does: both under
    fw_tol, their fixed points within 1e-4."""
    model, cfg = load_psignn_checkpoint(MIXED_CKPT, "cpu")
    g = batch_graphs([mixed_sample(2, radius=1.0, hsize=0.15)],
                     device="cpu")
    with torch.no_grad():
        h0 = model.encoder(g.x) * g.fnode_mask
    host, carried = (deq.fixed_point_forward(model.function, h0, g, cfg.deq,
                                             loop=lp)
                     for lp in ("host", "while"))
    assert host.lowest < cfg.fw_tol and carried.lowest < cfg.fw_tol
    assert abs(host.nstep - carried.nstep) <= 2
    np.testing.assert_allclose(carried.result.numpy(), host.result.numpy(),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("loop", ["host", "while"])
@pytest.mark.parametrize("variant", ["dirichlet", "mixed"])
def test_f_calls_counter_equals_the_solvers_count(variant, loop):
    """``models.psignn.F_CALLS`` advances by ``SolverResult.calls`` over a
    solve, in either loop, and is one of ``loop.COUNTERS``."""
    from psignn_tpu_torch import loop as loop_module
    assert (psignn_module, "F_CALLS") in loop_module.COUNTERS
    ckpt = MIXED_CKPT if variant == "mixed" else DIRICHLET_CKPT
    model, cfg = load_psignn_checkpoint(ckpt, "cpu")
    if variant == "mixed":
        s = mixed_sample(4, radius=0.6, hsize=0.12)
    else:
        rng = np.random.default_rng(4)
        s = build_data(blob_mesh(radius=0.6, hsize=0.12, rng=rng), 0.6, rng,
                       ("psignn",))["psignn"]
    g = batch_graphs([s], device="cpu")
    with torch.no_grad():
        h0 = model.encoder(g.x) * g.fnode_mask
    before = psignn_module.F_CALLS
    out = deq.fixed_point_forward(model.function, h0, g, cfg.deq, loop=loop)
    assert psignn_module.F_CALLS - before == out.calls > 1


def test_run_eval_sweeps_a_mixed_checkpoint(tmp_path, capsys):
    """``run_eval --sweep --variant mixed`` answers fresh mixed meshes
    (one a radius) with the mixed checkpoint, each solve under fw_tol,
    and writes its table."""
    run_eval.main(["--ckpt", MIXED_CKPT, "--sweep", "--variant", "mixed",
                   "--radii", "0.6", "1.0", "--n_meshes", "1",
                   "--out", str(tmp_path), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out)
    rows = summary["psignn"]
    assert set(rows) == {"0.6", "1.0"}
    for row in rows.values():
        assert row["lowest"] < 1e-5 and row["nstep"] > 0
        assert row["n_nodes"] > 150
    assert (tmp_path / "psignn_results.csv").read_text().startswith(
        "metric,0.6,1.0")


def test_the_sweep_draws_mixed_meshes_for_the_mixed_variant():
    """``growing_geometry_sweep(variant="mixed")`` hands the predictor
    mixed graphs (3-column tags, normals, Neumann rows); the mixed
    variant has no DSS form."""
    seen = []

    def predictor(graph):
        seen.append(graph)
        return torch.zeros(graph.total_nodes, 1)

    growing_geometry_sweep({"psignn": predictor}, radii=(0.6,), n_meshes=1,
                           device="cpu", warmup=False, families=("psignn",),
                           variant="mixed")
    g = seen[0]
    assert g.tags.shape[1] == 3 and g.unit_normal_vector is not None
    assert float(g.neumann_mask.sum()) > 0
    with pytest.raises(ValueError):
        growing_geometry_sweep({"dss": predictor}, radii=(0.6,),
                               n_meshes=1, device="cpu",
                               families=("psignn", "dss"), variant="mixed")


def test_gen_mixed_is_the_programs_generator_bit_for_bit():
    """The benchmark's frozen mixed pool is what the program's mixed sweep
    draws from the same seed: every array of every sample, dtype and
    bits."""
    from psignn_tpu_torch.data.fem import solve_poisson_mixed
    from psignn_tpu_torch.data.reader import psignn_sample_from_fem
    fields = dict(radii=[0.6, 1.0], meshes_per_radius=2, hsize=0.1,
                  pool_seed=11)
    got = gen_mixed.draw(fields)
    rng = np.random.default_rng(11)
    want = []
    for radius in fields["radii"]:
        for _ in range(2):
            mesh = mixed_blob_mesh(radius=radius, hsize=0.1, rng=rng)
            want.append(psignn_sample_from_fem(
                solve_poisson_mixed(mesh, radius, rng), variant="mixed"))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
