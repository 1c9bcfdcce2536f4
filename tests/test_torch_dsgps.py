"""Port DS-GPS, Dirichlet and mixed (``dsgps_forward`` with its ten losses
in both auxiliary-loss semantics and its gradient, ``neumann_init_scale``,
``dsgps_inference`` with its k override, ``dsgps_iterative_inference``,
the trained ``results/dsgps_dirichlet`` and ``results/dsgps_mixed``
checkpoints, the weight layout, and loading without jax or optax) against
the JAX package on the CPU, JAX on its XLA path (``ops.USE_PALLAS_MP``
False)."""

import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import (DSGPS_CKPT, DSGPS_MIXED_CKPT, DSS_CKPT,
                           fem_sample, grad_rel, jax_dsgps_params,
                           kernel_route, load_trained, mixed_sample)
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import DsgpsConfig as JaxDsgpsConfig
from psignn_tpu.models import dsgps_forward as jax_dsgps_forward
from psignn_tpu.models import dsgps_inference as jax_dsgps_inference
from psignn_tpu.models.dsgps import \
    dsgps_iterative_inference as jax_dsgps_iterative_inference
from psignn_tpu_torch import weights
from psignn_tpu_torch.eval.run_eval import load_predictor
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import (Dsgps, DsgpsConfig, dsgps_forward,
                                     dsgps_inference,
                                     dsgps_iterative_inference)

K = 3
# losses and u: f32 sums in other orders, as tests/test_kernels.py
RTOL = ATOL = 2e-4
CASES = [("dirichlet", "freeze"), ("dirichlet", "detach"),
         ("mixed", "freeze"), ("mixed", "detach")]


@pytest.fixture(scope="module")
def graphs():
    """One small mesh of each variant in both packages' graph forms."""
    out = {}
    for variant, sample in (("dirichlet", fem_sample(0, hsize=0.25)),
                            ("mixed", mixed_sample(0, hsize=0.25))):
        out[variant] = (jax_batch_graphs([sample]),
                        batch_graphs([sample], device="cpu"))
    return out


def _jax_cfg(variant, mode, **kw):
    return JaxDsgpsConfig(k=K, bc_mode=variant, neumann_init_scale=0.5,
                          enc_loss_override=mode, **kw)


@pytest.fixture(scope="module", params=CASES, ids="-".join)
def random_case(request, graphs):
    """A seeded JAX-layout DS-GPS tree at k = 3 with its JAX forward and
    gradient, per (variant, semantics)."""
    variant, mode = request.param
    jg, tg = graphs[variant]
    jcfg = _jax_cfg(variant, mode)
    params = jax.tree.map(jnp.asarray, jax_dsgps_params(
        np.random.default_rng(1), variant == "mixed"))

    def loss(p):
        out = jax_dsgps_forward(p, jg, jcfg)
        return out.losses["train_loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    cfg = DsgpsConfig(k=K, bc_mode=variant, neumann_init_scale=0.5,
                      enc_loss_override=mode)
    return jax.tree.map(np.asarray, params), cfg, tg, out, grads


def test_dsgps_forward_matches_jax(random_case):
    """All ten losses and ``u_final`` (2e-4)."""
    tree, cfg, tg, jout, _ = random_case
    out = dsgps_forward(weights.model_from_jax("dsgps", tree, cfg, "cpu"),
                        tg, cfg)
    assert set(out.losses) == set(jout.losses)
    for k, v in jout.losses.items():
        np.testing.assert_allclose(out.losses[k].detach().numpy(),
                                   np.asarray(v), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(out.u_final.detach().numpy(),
                               np.asarray(jout.u_final)[:tg.total_nodes],
                               rtol=RTOL, atol=ATOL)


def test_dsgps_gradients_match_jax(random_case):
    """Every parameter's gradient of ``train_loss`` against ``jax.grad``,
    as a relative norm within 1e-4, in both semantics:
    *freeze* detaches the other half's parameters and keeps the value
    gradients, *detach* detaches the values.  ``laynorm`` is declared and
    unused: no gradient in the port, zeros in JAX."""
    tree, cfg, tg, _, jgrads = random_case
    model = weights.model_from_jax("dsgps", tree, cfg, "cpu")
    dsgps_forward(model, tg, cfg).losses["train_loss"].backward()
    want = weights.dsgps_params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        if name.startswith("laynorm."):
            assert p.grad is None and not want[name].any()
            continue
        assert grad_rel(p.grad.numpy(), want[name].numpy()) < 1e-4, name


@pytest.mark.parametrize("variant", ["dirichlet", "mixed"])
def test_dsgps_kernel_route_matches_plain(graphs, variant, monkeypatch):
    """The forward and its backward on the CUDA route's autograd wiring
    (kernels replaced by their plain versions): 2k launches each way, 3k in
    the mixed variant, and the plain path's losses and gradients."""
    _, tg = graphs[variant]
    cfg = DsgpsConfig(k=K, bc_mode=variant)

    def run():
        model = Dsgps(cfg, generator=torch.Generator().manual_seed(2))
        out = dsgps_forward(model, tg, cfg)
        out.losses["train_loss"].backward()
        return out, {n: p.grad for n, p in model.named_parameters()
                     if p.grad is not None}

    plain, plain_grads = run()
    fm = kernel_route(monkeypatch)
    routed, routed_grads = run()
    want = chip_smoke.mp_per_step(cfg) * K
    assert want == (3 if variant == "mixed" else 2) * K
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == (want, want)
    for k, v in plain.losses.items():
        np.testing.assert_allclose(routed.losses[k].detach().numpy(),
                                   v.detach().numpy(), rtol=1e-5, err_msg=k)
    assert set(routed_grads) == set(plain_grads)
    for k, g in plain_grads.items():
        assert grad_rel(routed_grads[k].numpy(), g.numpy()) < 1e-5, k


def test_neumann_init_scale_scales_the_output_layer():
    """Only ``update_neumann``'s last weight is scaled at init."""
    one, tenth = (Dsgps(DsgpsConfig(bc_mode="mixed", neumann_init_scale=s),
                        generator=torch.Generator().manual_seed(4))
                  for s in (1.0, 0.1))
    for (k, a), b in zip(one.state_dict().items(),
                         tenth.state_dict().values()):
        want = a * 0.1 if k == "update_neumann.layers.1.weight" else a
        torch.testing.assert_close(b, want, rtol=0, atol=0, msg=k)


def test_enc_loss_mode_defaults_and_override():
    assert DsgpsConfig().enc_loss_mode == "freeze"
    assert DsgpsConfig(bc_mode="mixed").enc_loss_mode == "detach"
    assert DsgpsConfig(bc_mode="mixed",
                       enc_loss_override="freeze").enc_loss_mode == "freeze"
    assert DsgpsConfig(bc_mode="mixed").prb_dim == 3
    with pytest.raises(ValueError):
        DsgpsConfig(enc_loss_override="stop")


@pytest.mark.parametrize("variant", ["dirichlet", "mixed"])
def test_dsgps_inference_and_iterates_match_jax(graphs, variant):
    """``dsgps_inference`` with its k override and
    ``dsgps_iterative_inference``'s trace, residuals and MSEs (2e-4)."""
    jg, tg = graphs[variant]
    jcfg = JaxDsgpsConfig(k=4, bc_mode=variant, neumann_init_scale=0.3)
    params = jax.tree.map(jnp.asarray, jax_dsgps_params(
        np.random.default_rng(5), variant == "mixed"))
    cfg = DsgpsConfig(k=4, bc_mode=variant, neumann_init_scale=0.3)
    model = weights.model_from_jax("dsgps", jax.tree.map(np.asarray, params),
                                   cfg, "cpu")
    n = tg.total_nodes
    for k in (None, 2):
        want = jax_dsgps_inference(params, jg, jcfg, k=k)
        np.testing.assert_allclose(dsgps_inference(model, tg, cfg, k=k),
                                   np.asarray(want)[:n], rtol=RTOL,
                                   atol=ATOL)
    want = jax_dsgps_iterative_inference(params, jg, jcfg, k=3)
    got = dsgps_iterative_inference(model, tg, cfg, k=3)
    np.testing.assert_allclose(got["u_trace"].numpy(),
                               np.asarray(want["u_trace"])[:, :n],
                               rtol=RTOL, atol=ATOL)
    for key in ("res", "mse"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("ckpt,variant", [(DSGPS_CKPT, "dirichlet"),
                                          (DSGPS_MIXED_CKPT, "mixed")],
                         ids=["dirichlet", "mixed"])
def test_trained_dsgps_matches_jax(graphs, ckpt, variant):
    """The trained weights at their full k = 30 through ``load_predictor``
    on the small mesh of their variant: u within 2e-4 of max(1, |u|).  The
    mixed recurrence is ungated on Neumann rows, and its trained weights
    keep it contractive here."""
    jg, tg = graphs[variant]
    params, hp = load_trained(ckpt)
    predict, family, cfg, _ = load_predictor(ckpt, "cpu")
    assert family == "dsgps" and cfg == DsgpsConfig(**hp) and cfg.k == 30
    want = np.asarray(jax_dsgps_inference(jax.tree.map(jnp.asarray, params),
                                          jg, JaxDsgpsConfig(**hp)))
    got = predict(tg).numpy()
    np.testing.assert_allclose(got, want[:tg.total_nodes], rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("ckpt", [DSGPS_CKPT, DSGPS_MIXED_CKPT],
                         ids=["dirichlet", "mixed"])
def test_dsgps_weights_round_trip(ckpt):
    """JAX tree → state dict → JAX tree is the identity on a trained tree,
    ``laynorm`` and the Neumann MLPs included, and the state dict fills a
    model of the checkpoint's config exactly."""
    params, hp = load_trained(ckpt)
    sd = weights.dsgps_params_from_jax(params)
    assert set(sd) == set(Dsgps(DsgpsConfig(**hp)).state_dict())
    back = weights.dsgps_params_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    bad = dict(params, gru_cell=params["z_k"])
    with pytest.raises(NotImplementedError, match="gru_cell"):
        weights.dsgps_params_from_jax(bad)
    # and state dict → JAX tree → state dict on a fresh port model
    fresh = Dsgps(DsgpsConfig(**hp),
                  generator=torch.Generator().manual_seed(0)).state_dict()
    again = weights.dsgps_params_from_jax(weights.dsgps_params_to_jax(fresh))
    assert set(again) == set(fresh)
    for k, v in fresh.items():
        assert torch.equal(again[k], v), k


def test_checkpoints_load_without_jax_or_optax():
    """In a process where ``import jax`` and ``import optax`` fail, each
    DS-GPS and DSS checkpoint builds its model through
    ``load_model_checkpoint``."""
    script = textwrap.dedent(f"""
        import json, sys
        sys.modules["jax"] = None
        sys.modules["optax"] = None
        from psignn_tpu_torch.weights import load_model_checkpoint
        out = {{}}
        for path in {[DSGPS_CKPT, DSGPS_MIXED_CKPT, DSS_CKPT]!r}:
            family, model, cfg = load_model_checkpoint(path, "cpu")
            out[path] = [family, cfg.k,
                         sum(p.numel() for p in model.parameters())]
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for path, (family, k, n) in out.items():
        params, _ = load_trained(path)
        assert family == ("dss" if path == DSS_CKPT else "dsgps") and k == 30
        assert n == sum(np.asarray(a).size for a in jax.tree.leaves(params))
