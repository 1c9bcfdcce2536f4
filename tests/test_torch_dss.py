"""Port DSS (the DSS sample form from FEM and from an ``add_dss_variable``
dataset, its split, the A′ packing, the stacked and BC-encoded residuals,
``errors_batch`` in DSS form, ``dss_forward`` with its seven losses and
its gradient, ``dss_inference``, the trained ``results/dss_dirichlet``
checkpoint, the weight layout and the sweep) against the JAX package on
the CPU, JAX on its XLA path (``ops.USE_PALLAS_MP`` False)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import (DSS_CKPT, fem_sample, fem_solve, grad_rel,
                           jax_dss_params, kernel_route, load_trained)
from psignn_tpu import ops as jops
from psignn_tpu.data import generate as jgenerate
from psignn_tpu.data import reader as jreader
from psignn_tpu.eval.metrics import errors_batch as jax_errors_batch
from psignn_tpu.eval.run_eval import load_predictor as jax_load_predictor
from psignn_tpu.eval.sweep import growing_geometry_sweep as jax_sweep
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import DssConfig as JaxDssConfig
from psignn_tpu.models import dss_forward as jax_dss_forward
from psignn_tpu.models import dss_inference as jax_dss_inference
from psignn_tpu_torch import ops, weights
from psignn_tpu_torch.data import generate, reader
from psignn_tpu_torch.eval.metrics import errors_batch
from psignn_tpu_torch.eval.run_eval import load_predictor
from psignn_tpu_torch.eval.sweep import growing_geometry_sweep
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import DssConfig, dss_forward, dss_inference

K = 3
# losses and u: f32 sums in other orders, as tests/test_kernels.py
RTOL = ATOL = 2e-4


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def fem():
    return fem_solve(0, hsize=0.25)


@pytest.fixture(scope="module")
def small(fem):
    """One small mesh's DSS sample in both packages' graph forms."""
    s = reader.dss_sample_from_fem(fem)
    return s, jax_batch_graphs([s]), batch_graphs([s], device="cpu")


@pytest.fixture(scope="module")
def random_model(small):
    """A seeded JAX-layout DSS tree at k = 3 (α = 0.5, so that the updates
    move u) with its JAX forward, gradient and inference on the small
    mesh."""
    _, jg, _ = small
    jcfg = JaxDssConfig(k=K, alpha=0.5)
    params = jax.tree.map(jnp.asarray,
                          jax_dss_params(np.random.default_rng(3), K))

    def loss(p):
        out = jax_dss_forward(p, jg, jcfg)
        return out.losses["train_loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    u_inf = jax.jit(lambda p: jax_dss_inference(p, jg, jcfg))(params)
    np_tree = jax.tree.map(np.asarray, params)
    return np_tree, DssConfig(k=K, alpha=0.5), out, grads, u_inf


@pytest.mark.parametrize("seed", [0, 4])
def test_dss_sample_from_fem_matches_jax(seed):
    """Built sparsely, the sample equals JAX's (dense A copy) array by
    array, the COO order of ``sp.find`` included."""
    s = fem_solve(seed, hsize=0.25)
    got = reader.dss_sample_from_fem(s)
    _assert_samples_equal(got, jreader.dss_sample_from_fem(s))
    b1 = got["b_prime"][:, 1]
    # Dirichlet rows have no edge in A′; their columns stay
    assert b1.sum() > 0
    assert not np.isin(np.flatnonzero(b1), got["senders"]).any()
    assert np.isin(np.flatnonzero(b1), got["receivers"]).any()
    assert not (got["senders"] == got["receivers"]).any()


@pytest.fixture(scope="module")
def dss_datasets(tmp_path_factory):
    """The same small Dirichlet dataset encoded by both factories."""
    out = []
    for mod in (jgenerate, generate):
        path = str(tmp_path_factory.mktemp("dss"))
        jgenerate.generate_data(path, n_mesh=2, n_samples=3, hsize=0.3,
                                seed=5, verbose=False)
        mod.add_dss_variable(path)
        out.append(path)
    return out


def test_add_dss_variable_matches_jax(dss_datasets):
    jpath, tpath = dss_datasets
    for name in ("A_prime", "b_prime"):
        want = np.load(os.path.join(jpath, name + ".npy"), allow_pickle=True)
        got = np.load(os.path.join(tpath, name + ".npy"), allow_pickle=True)
        assert got.dtype == object and len(got) == len(want) == 6
        for a, b in zip(got, want):
            if name == "A_prime":
                assert type(a) is type(b)
                for att in ("data", "indices", "indptr"):
                    x, y = getattr(a, att), getattr(b, att)
                    assert x.dtype == y.dtype, att
                    np.testing.assert_array_equal(x, y, err_msg=att)
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    with open(os.path.join(jpath, "dataset_info.csv")) as f:
        want = f.read()
    with open(os.path.join(tpath, "dataset_info.csv")) as f:
        assert f.read() == want
    assert "Mean of a_ij" in want


@pytest.mark.parametrize("stats", ["reference", "auto"])
def test_load_dss_dataset_matches_jax(dss_datasets, stats):
    jpath, _ = dss_datasets
    want = jreader.load_dataset(jpath, family="dss", stats=stats)
    got = reader.load_dataset(jpath, family="dss", stats=stats)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_samples_equal(g, w)


def test_generate_main_writes_the_dss_encoding(tmp_path):
    """The factory's command line encodes Dirichlet datasets only."""
    for variant in ("dirichlet", "mixed"):
        path = str(tmp_path / variant)
        generate.main(["--path_data", path, "--n_mesh", "1", "--n_samples",
                       "1", "--hsize", "0.4", "--variant", variant])
        assert os.path.exists(os.path.join(path, "A_prime.npy")) is \
            (variant == "dirichlet")


@pytest.mark.parametrize("n", [5, 12, 23])
def test_split_dataset_dss_order_matches_jax(n):
    """DSS orders its parts train | test | val."""
    items = list(range(n))
    got = reader.split_dataset(items, family="dss")
    assert got == tuple(jreader.split_dataset(items, family="dss"))
    assert got[1] == items[len(got[0]) + len(got[2]):]


def test_batch_graphs_packs_a_ij_norm(small):
    """A DSS batch carries its message passing's edge feature in the 1-wide
    ``a_ij_norm``, and its ``from`` packing leaves the Dirichlet rows
    empty."""
    s, jg, tg = small
    n = tg.total_nodes
    for name in ("a_ij_norm", "b_prime", "b_prime_norm"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name))[
                                          :getattr(tg, name).shape[0]])
    assert tg.mp_to.edge_attr.shape == (tg.mp_to.n_edges, 1)
    order = np.argsort(s["receivers"], kind="stable")
    np.testing.assert_array_equal(tg.mp_to.edge_attr.numpy(),
                                  s["a_ij_norm"][order])
    empty = tg.mp_from.row_ptr.diff().numpy() == 0
    dirichlet = s["b_prime"][:, 1] == 1
    np.testing.assert_array_equal(empty, dirichlet)
    assert 0 < dirichlet.sum() < n


def test_stacked_residuals_match_jax(small):
    """``residual_loss_stacked`` (on the Ψ-GNN form of the mesh),
    ``dss_residual_loss_stacked``, ``dss_residual_vector``,
    ``dss_residual_loss`` and ``mse_masked_stacked`` on seeded iterates:
    f32 sums in other orders (2e-4)."""
    _, jg, tg = small
    n = tg.total_nodes
    rng = np.random.default_rng(7)
    U = rng.normal(size=(4, n, 1)).astype(np.float32)
    U_pad = np.zeros((4, jg.n_node_cap, 1), np.float32)
    U_pad[:, :n] = U
    tU, jU = torch.from_numpy(U), jnp.asarray(U_pad)
    pairs = [
        (ops.dss_residual_loss_stacked(tU, tg),
         jops.dss_residual_loss_stacked(jU, jg)),
        (ops.dss_residual_loss(tU[1], tg), jops.dss_residual_loss(jU[1], jg)),
        (ops.dss_residual_vector(tU[2], tg),
         jops.dss_residual_vector(jU[2], jg)[:n]),
        (ops.mse_masked_stacked(tU, tg.x, tg.fnode_mask[:, 0] > 0),
         jops.mse_masked_stacked(jU, jg.x, jg.node_mask)),
    ]
    ps = fem_sample(0, hsize=0.25)
    jps, tps = jax_batch_graphs([ps]), batch_graphs([ps], device="cpu")
    pairs.append((ops.residual_loss_stacked(tU, tps),
                  jops.residual_loss_stacked(jU, jps)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_errors_batch_dss_form_matches_jax(small):
    """The DSS branch: the BC-encoded residual normalised by ‖B0 + B2‖."""
    _, jg, tg = small
    n = tg.total_nodes
    u = np.random.default_rng(8).normal(size=(n, 1)).astype(np.float32)
    u_pad = np.zeros((jg.n_node_cap, 1), np.float32)
    u_pad[:n] = u
    got = errors_batch(torch.from_numpy(u), tg)
    want = jax_errors_batch(jnp.asarray(u_pad), jg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_dss_forward_matches_jax(small, random_model):
    """All seven losses and ``u_final`` at k = 3 (2e-4)."""
    _, _, tg = small
    tree, cfg, jout, _, _ = random_model
    out = dss_forward(weights.model_from_jax("dss", tree, cfg, "cpu"), tg,
                      cfg)
    assert set(out.losses) == set(jout.losses)
    for k, v in jout.losses.items():
        np.testing.assert_allclose(out.losses[k].detach().numpy(),
                                   np.asarray(v), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(out.u_final.detach().numpy(),
                               np.asarray(jout.u_final)[:tg.total_nodes],
                               rtol=RTOL, atol=ATOL)
    assert out.losses["res_per_iter"].shape == (K,)


def test_dss_gradients_match_jax(small, random_model):
    """Every parameter's gradient of ``train_loss`` against ``jax.grad``,
    as a relative norm within 1e-4."""
    _, _, tg = small
    tree, cfg, _, jgrads, _ = random_model
    model = weights.model_from_jax("dss", tree, cfg, "cpu")
    dss_forward(model, tg, cfg).losses["train_loss"].backward()
    want = weights.dss_params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        assert grad_rel(p.grad.numpy(), want[name].numpy()) < 1e-4, name


def test_dss_inference_matches_jax(small, random_model):
    _, _, tg = small
    tree, cfg, jout, _, u_inf = random_model
    u = dss_inference(weights.model_from_jax("dss", tree, cfg, "cpu"), tg,
                      cfg)
    assert not u.requires_grad
    np.testing.assert_allclose(u.numpy(), np.asarray(u_inf)[:tg.total_nodes],
                               rtol=RTOL, atol=ATOL)


def test_dss_kernel_route_matches_plain(small, random_model, monkeypatch):
    """The forward and its backward on the CUDA route's autograd wiring
    (kernels replaced by their plain versions): 2k launches each way, and
    the plain path's losses and gradients."""
    _, _, tg = small
    tree, cfg, _, _, _ = random_model

    def run():
        model = weights.model_from_jax("dss", tree, cfg, "cpu")
        out = dss_forward(model, tg, cfg)
        out.losses["train_loss"].backward()
        return out, {n: p.grad for n, p in model.named_parameters()}

    plain, plain_grads = run()
    fm = kernel_route(monkeypatch)
    routed, routed_grads = run()
    want = chip_smoke.mp_per_step(cfg) * K
    assert want == 2 * K and (fm.LAUNCHES, fm.BWD_LAUNCHES) == (want, want)
    for k, v in plain.losses.items():
        np.testing.assert_allclose(routed.losses[k].detach().numpy(),
                                   v.detach().numpy(), rtol=1e-5, err_msg=k)
    for k, g in plain_grads.items():
        assert grad_rel(routed_grads[k].numpy(), g.numpy()) < 1e-5, k


def test_trained_dss_matches_jax(small):
    """The trained ``results/dss_dirichlet`` weights at their full k = 30
    through ``load_predictor``, on the small mesh: u within 2e-4."""
    _, jg, tg = small
    params, hp = load_trained(DSS_CKPT)
    predict, family, cfg, _ = load_predictor(DSS_CKPT, "cpu")
    assert family == "dss" and cfg == DssConfig(**hp) and cfg.k == 30
    want = jax_dss_inference(jax.tree.map(jnp.asarray, params), jg,
                             JaxDssConfig(**hp))
    np.testing.assert_allclose(predict(tg).numpy(),
                               np.asarray(want)[:tg.total_nodes],
                               rtol=RTOL, atol=ATOL)


def test_dss_weights_round_trip():
    """JAX tree → state dict → JAX tree is the identity on the trained
    tree (leading k axis restacked), and state dict → tree → state dict on
    a fresh port model."""
    params, _ = load_trained(DSS_CKPT)
    sd = weights.dss_params_from_jax(params)
    assert sd["layers.29.phi_to.layers.0.weight"].shape == (10, 21)
    back = weights.dss_params_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    fresh = weights.FAMILIES["dss"][0](
        DssConfig(k=2), generator=torch.Generator().manual_seed(0))
    again = weights.dss_params_from_jax(
        weights.dss_params_to_jax(fresh.state_dict()))
    assert set(again) == set(fresh.state_dict())
    for k, v in fresh.state_dict().items():
        assert torch.equal(again[k], v), k


def test_dss_sweep_request_matches_jax():
    """One radius-1 mesh of the growing-geometry sweep answered by the
    trained DSS in both packages: the same mesh and the same DSS sample
    (the same random stream), res and rel within 2e-4."""
    kw = dict(radii=(1.0,), n_meshes=1, hsize=0.25, seed=0)
    jpredict = jax_load_predictor(DSS_CKPT)[0]
    want = jax_sweep({"dss": jpredict}, **kw)["dss"][1.0]
    predict, family, _, _ = load_predictor(DSS_CKPT, "cpu")
    got = growing_geometry_sweep({family: predict}, device="cpu",
                                 warmup=False, **kw)[family][1.0]
    assert got["n_nodes"] == want["n_nodes"] and got["nstep"] == -1
    for k in ("res", "rel", "mse"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
