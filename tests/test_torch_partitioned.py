"""The port's partitioned Ψ-GNN solve and train step on gloo ranks on the
CPU, against the JAX package's (``psignn_tpu/dist/partitioned.py``) on
the conftest's 8 virtual devices, with the trained Dirichlet and mixed
weights on small RCM-ordered meshes.

One spawned world of 4 ranks (``_torch_dist``) runs every port case:
parts 4 (Broyden, Picard), dp 2 × parts 2 (Broyden without and with
``sync``, Picard, mixed Broyden), the partitioned loss and its gradients
with an explicit probe, and three train steps.  Row 0 of a 2 × 2 case is
an n_parts 2 solve of the first graph.

Solves are compared at a reachable tolerance by their answers, as JAX's
``tests/test_halo.py:113-151`` compares its partitioned solve with one
device: |Δnstep| ≤ 1, best residual within 5e-2, u within 1e-2 relative
and 2e-3 absolute, the mesh's residual within 1e-3.  The loss at
``tests/test_partitioned_train.py:86-131``'s limits: loss within 2e-3,
gradients within 5e-2 relative and 5e-4 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

import _torch_dist
from _torch_parity import MIXED_CKPT, load_trained
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu.dist import make_mesh as jax_make_mesh
from psignn_tpu.dist.partitioned import (
    build_partitioned_graph as jax_build_partitioned_graph,
    make_partitioned_loss as jax_make_partitioned_loss,
    partitioned_psignn_inference as jax_partitioned_inference,
    partitioned_psignn_inference_dp as jax_partitioned_inference_dp,
    stack_partitioned_graphs as jax_stack_partitioned_graphs)
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu_torch.data.fem import solve_poisson, solve_poisson_mixed
from psignn_tpu_torch.data.meshgen import blob_mesh, mixed_blob_mesh
from psignn_tpu_torch.data.reader import psignn_sample_from_fem
from psignn_tpu_torch.dist.partition import (apply_node_permutation,
                                             rcm_permutation)
from psignn_tpu_torch.weights import params_from_jax

REACHABLE = dict(fw_tol=1e-4, fw_thres=120)
# the loss: both solves run to a converged point (contractive weights)
LOSS_CFG = dict(solver="broyden", fw_tol=1e-6, fw_thres=100, bw_tol=1e-9,
                bw_thres=100)
NSTEP_SLACK, LOWEST_RTOL, U_RTOL, U_ATOL, RES_RTOL = 1, 5e-2, 1e-2, 2e-3, 1e-3
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-3, 5e-2, 5e-4
# the train steps: no Jacobian term, so that the probes (each package
# draws its own) do not enter
TRAIN_CFG = dict(LOSS_CFG, fw_tol=1e-5, bw_tol=1e-7)
D = 10


def _rcm(s):
    return apply_node_permutation(
        s, rcm_permutation(s["senders"], s["receivers"], s["x"].shape[0]))


def _two_samples(mixed: bool, seed: int):
    """Two right-hand sides on one RCM-ordered mesh (one partition shape,
    as JAX's dp stack needs)."""
    rng = np.random.default_rng(seed)
    if mixed:
        mesh = mixed_blob_mesh(radius=1.0, hsize=0.15, rng=rng)
        return [_rcm(psignn_sample_from_fem(
            solve_poisson_mixed(mesh, 1.0, rng), variant="mixed"))
            for _ in range(2)]
    mesh = blob_mesh(radius=1.0, hsize=0.11, rng=rng)
    return [_rcm(psignn_sample_from_fem(solve_poisson(mesh, 1.0, rng)))
            for _ in range(2)]


def _contractive(params, scale=0.5):
    """The trained weights with the update function scaled down, so that
    the loss's forward and adjoint solves converge (JAX's
    ``_contractive_params``)."""
    return {"autoencoder": params["autoencoder"],
            "function": jax.tree.map(lambda x: np.asarray(x) * scale,
                                     params["function"])}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    params, hp = load_trained()
    mparams, mhp = load_trained(MIXED_CKPT)
    params, mparams = _contractive(params), _contractive(mparams)
    dsamples = _two_samples(False, 11)
    msamples = _two_samples(True, 5)
    lparams = params
    n_loc = jax_build_partitioned_graph(dsamples[0], n_parts=2).n_loc
    rng = np.random.default_rng(3)
    probes = rng.normal(size=(2, 2, n_loc, D)).astype(np.float32)

    def inf(samples, dp, parts, solver="broyden", sync=False, p=params,
            h=hp):
        return ("partitioned_inference",
                dict(samples=samples, params=p, hp=h, dp=dp, parts=parts,
                     sync=sync, over=dict(REACHABLE, solver=solver)))

    jobs = [inf(dsamples[:1], 1, 4), inf(dsamples[:1], 1, 4, "picard"),
            inf(dsamples, 2, 2), inf(dsamples, 2, 2, sync=True),
            inf(dsamples, 2, 2, "picard"),
            inf(msamples, 2, 2, p=mparams, h=mhp),
            ("partitioned_loss", dict(samples=dsamples, probes=probes,
                                      params=lparams, hp=hp, dp=2, parts=2,
                                      over=LOSS_CFG)),
            ("partitioned_train", dict(samples=dsamples, params=lparams,
                                       hp=hp, dp=2, parts=2, steps=3,
                                       over=TRAIN_CFG, jac_weight=0.0))]
    ranks = _torch_dist.spawn(tmp_path_factory.mktemp("rdv"), 4, jobs)
    names = ["parts4", "parts4_picard", "dp2x2", "dp2x2_sync",
             "dp2x2_picard", "mixed2x2", "loss", "train"]
    out = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
    return dict(out=out, params=params, hp=hp, mparams=mparams, mhp=mhp,
                dsamples=dsamples, msamples=msamples, lparams=lparams,
                probes=probes)


def _gather(results, row=0):
    """(u of the row's mesh in node order, [(nstep, lowest, res) of each
    rank of the row]) from the ranks' results."""
    mine = sorted((r for r in results if r[0] == row), key=lambda r: r[1])
    return np.concatenate([r[2] for r in mine]), [r[3:6] for r in mine]


def _jax(params, hp, sample, parts, solver="broyden"):
    cfg = JaxPsignnConfig(**{**hp, **REACHABLE, "solver": solver})
    pg = jax_build_partitioned_graph(sample, n_parts=parts)
    u, nstep, lowest, res = jax_partitioned_inference(
        jax.tree.map(jnp.asarray, params), pg, cfg,
        jax_make_mesh(parts, axis="x"))
    return np.asarray(u).reshape(-1, 1), int(nstep), float(lowest), float(res)


def _assert_solve(port, want, n_nodes):
    u, stats = port
    ju, jn, jlow, jres = want
    # every rank of a row holds the row's stats
    assert len(set(map(tuple, stats))) == 1, stats
    nstep, lowest, res = stats[0]
    assert abs(nstep - jn) <= NSTEP_SLACK, (nstep, jn)
    np.testing.assert_allclose(lowest, jlow, rtol=LOWEST_RTOL)
    np.testing.assert_allclose(u[:n_nodes], ju[:n_nodes], rtol=U_RTOL,
                               atol=U_ATOL)
    np.testing.assert_allclose(res, jres, rtol=RES_RTOL)
    assert np.all(u[n_nodes:] == 0.0)


@pytest.mark.parametrize("parts,solver", [(4, "broyden"), (4, "picard"),
                                          (2, "broyden"), (2, "picard")])
def test_partitioned_solve_matches_jax(case, parts, solver):
    """The Dirichlet solve at n_parts 4 and 2 (row 0 of the 2 × 2 world)
    against JAX's ``partitioned_psignn_inference``."""
    s = case["dsamples"][0]
    key = (f"parts{parts}" if parts == 4 else "dp2x2") + \
        ("_picard" if solver == "picard" else "")
    want = _jax(case["params"], case["hp"], s, parts, solver)
    _assert_solve(_gather(case["out"][key]), want, s["x"].shape[0])


def test_mixed_partitioned_solve_matches_jax(case):
    """The mixed solve (Neumann branch through the window's ``from``
    packing) at n_parts 2, both rows, against JAX's."""
    for row, s in enumerate(case["msamples"]):
        want = _jax(case["mparams"], case["mhp"], s, 2)
        _assert_solve(_gather(case["out"]["mixed2x2"], row), want,
                      s["x"].shape[0])


@pytest.mark.parametrize("sync", [False, True])
def test_dp_by_partition_matches_jax(case, sync):
    """dp 2 × parts 2: each row against JAX's
    ``partitioned_psignn_inference_dp`` on a 2 × 2 device mesh, whose rows
    freeze their carries until both stop.  The port's rows stop on their
    own, or with ``sync`` step together; either way each row's answer and
    nstep are JAX's."""
    samples = case["dsamples"]
    cfg = JaxPsignnConfig(**{**case["hp"], **REACHABLE})
    stacked = jax_stack_partitioned_graphs(
        [jax_build_partitioned_graph(s, n_parts=2) for s in samples])
    mesh2d = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "x"))
    u, nstep, lowest, res = jax_partitioned_inference_dp(
        jax.tree.map(jnp.asarray, case["params"]), stacked, cfg, mesh2d)
    key = "dp2x2_sync" if sync else "dp2x2"
    calls = {}
    for row, s in enumerate(samples):
        want = (np.asarray(u[row]).reshape(-1, 1), int(nstep[row]),
                float(lowest[row]), float(res[row]))
        _assert_solve(_gather(case["out"][key], row), want, s["x"].shape[0])
        calls[row] = {r[6] for r in case["out"][key] if r[0] == row}
    if sync:        # every rank evaluated f as often as the slowest row
        assert len(set.union(*calls.values())) == 1, calls


def test_partitioned_loss_matches_jax(case):
    """``make_partitioned_loss`` on dp 2 × parts 2 with an explicit probe:
    the loss, its aux values and every parameter's gradient against JAX's
    on the 2 × 2 device mesh (implicit gradients through the halo
    exchanges on both sides), and the adjoint solve's stats."""
    samples = case["dsamples"]
    cfg = JaxPsignnConfig(**{**case["hp"], **LOSS_CFG})
    pgs = [jax_build_partitioned_graph(s, n_parts=2) for s in samples]
    mesh2d = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "x"))
    loss_fn = jax_make_partitioned_loss(cfg, n_parts=2, halo=pgs[0].halo,
                                        mesh=mesh2d)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, case["lparams"]),
                                jax_stack_partitioned_graphs(pgs),
                                jnp.asarray(case["probes"]))
    want = params_from_jax(jgrads)
    results = case["out"]["loss"]
    for loss, aux, bw, grads in results:
        np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
        for k in ("residual_loss", "jacobian_loss", "encoder_loss",
                  "autoencoder_loss", "mse_loss"):
            np.testing.assert_allclose(aux[k], float(jaux[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        # the adjoint solve's (lowest, nstep), averaged over the ranks
        assert np.isfinite(bw[0]) and 0 < bw[1] <= LOSS_CFG["bw_thres"], bw
        for name, g in grads.items():
            np.testing.assert_allclose(g, want[name].numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=name)
    # one all-reduce: every rank holds the same averaged gradients
    for _, _, _, grads in results[1:]:
        for name, g in grads.items():
            np.testing.assert_array_equal(g, results[0][3][name])


def test_partitioned_train_step_matches_jax(case):
    """Three partitioned train steps (clip 0.1, the dual Adam at 0.01 /
    0.05) on dp 2 × parts 2 against JAX's ``make_partitioned_train_step``
    on the 2 × 2 device mesh, both without the Jacobian term: each step's
    loss and gradient norm; every rank ends with the same parameters."""
    from psignn_tpu.dist import make_partitioned_train_step
    from psignn_tpu.train.optim import init_adam
    cfg = JaxPsignnConfig(**{**case["hp"], **TRAIN_CFG})
    pgs = [jax_build_partitioned_graph(s, n_parts=2)
           for s in case["dsamples"]]
    mesh2d = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "x"))
    step = jax.jit(make_partitioned_train_step(
        cfg, 2, pgs[0].halo, mesh2d, jac_weight=0.0, clip=0.1))
    p = jax.tree.map(jnp.asarray, case["lparams"])
    opt = {"deq": init_adam(p["function"]), "ae": init_adam(p["autoencoder"])}
    stacked = jax_stack_partitioned_graphs(pgs)
    want = []
    for i in range(3):
        p, opt, loss, _, gnorm = step(p, opt, stacked,
                                      jax.random.PRNGKey(i), 0.01, 0.05)
        want.append((float(loss), float(gnorm)))
    results = case["out"]["train"]
    hist, _ = results[0]
    np.testing.assert_allclose([h[0] for h in hist], [w[0] for w in want],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([h[1] for h in hist], [w[1] for w in want],
                               rtol=GRAD_RTOL)
    for other in results[1:]:
        assert other == results[0]


def test_rank_failure_ends_the_run(case, tmp_path):
    """A rank that raises in the middle of a partitioned solve ends the
    whole run with its traceback while its peers wait in an exchange:
    ``multihost.spawn`` terminates them instead of hanging."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        _torch_dist.spawn(tmp_path, 2, [("fail_mid_solve", dict(
            samples=case["dsamples"][:1], params=case["params"],
            hp=case["hp"], dp=1, parts=2))], timeout=60)
    assert time.monotonic() - t0 < 60

