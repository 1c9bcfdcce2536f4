"""Port reference-checkpoint conversion (``psignn_tpu_torch.compat``)
against the JAX package's ``compat`` followed by its ``weights.py`` route
into a port model, on synthetic reference ``state_dict``s (the
reference's key names, numbers from a numpy seed; the reference's own
checkpoints are not in the repository, so ``tests/test_compat.py``'s
``needs_ref`` cases stay skipped): every tensor equal, and equal model
outputs, for Ψ-GNN and DS-GPS in both variants and DSS at k = 30.  Then a
synthetic ``.pt`` whose hyperparameters pickle a function of a fake
``utilities.solver`` module, loaded with and without JAX's stub of that
module in ``sys.modules``.  Conversion copies numbers: tolerance 0."""

import sys
import types

import numpy as np
import pytest
import torch

from _torch_parity import dss_sample, fem_sample, mixed_sample
from psignn_tpu import compat as jcompat
from psignn_tpu_torch import compat
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import (Dsgps, DsgpsConfig, Dss, DssConfig,
                                     Psignn, PsignnConfig)
from psignn_tpu_torch.weights import (dsgps_params_from_jax,
                                      dss_params_from_jax, params_from_jax)

D, K = 10, 30


def _lin(rng, sd, prefix, n_in, n_out):
    sd[prefix + ".weight"] = torch.from_numpy(
        rng.normal(size=(n_out, n_in)).astype(np.float32) * 0.3)
    sd[prefix + ".bias"] = torch.from_numpy(
        rng.normal(size=n_out).astype(np.float32) * 0.1)


def _seq(rng, sd, prefix, channels):
    """A reference ``Sequential`` MLP: Linear layers at 0, 2, ..."""
    for i, (a, b) in enumerate(zip(channels[:-1], channels[1:])):
        _lin(rng, sd, f"{prefix}.{2 * i}", a, b)


def _norm(rng, sd, prefix):
    sd[prefix + ".weight"] = torch.from_numpy(
        1 + 0.1 * rng.normal(size=D).astype(np.float32))
    sd[prefix + ".bias"] = torch.from_numpy(
        0.1 * rng.normal(size=D).astype(np.float32))


def reference_state_dict(family: str, bc_mode: str = "dirichlet",
                         seed: int = 0) -> dict:
    """A reference model's ``state_dict`` (the key names
    ``psignn_tpu/compat.py:63-127`` reads) with seeded numbers."""
    rng = np.random.default_rng(seed)
    sd = {}
    P = 2 if bc_mode == "dirichlet" else 3
    if family == "dss":
        for i in range(K):
            _seq(rng, sd, f"phi_to_list.{i}.mlp.mlp", [2 * D + 1, D, D])
            _seq(rng, sd, f"phi_from_list.{i}.mlp.mlp", [2 * D + 1, D, D])
            _seq(rng, sd, f"psi_list.{i}.mlp.mlp", [3 * D + 3, D, D])
            _seq(rng, sd, f"decoder_list.{i}.mlp.mlp", [D, D, 1])
        return sd
    _seq(rng, sd, "autoencoder.encoder.mlp.mlp", [1, D, D])
    _seq(rng, sd, "autoencoder.decoder.mlp.mlp", [D, D, 1])
    f = "deqdss.f." if family == "psignn" else ""
    if family == "psignn":
        _seq(rng, sd, f + "phi_to_list.0.mlp.mlp", [2 * D + 3, D, D])
        _seq(rng, sd, f + "phi_from_list.0.mlp.mlp", [2 * D + 3, D, D])
        _seq(rng, sd, f + "update_list.0.mlp", [3 * D + P, D, D])
        _lin(rng, sd, f + "alpha.0", 3 * D + P, 1)
        _norm(rng, sd, f + "laynorm")
    else:
        _norm(rng, sd, "laynorm")
        _seq(rng, sd, "phi_to.mlp.mlp", [2 * D + 3, D, D])
        _seq(rng, sd, "phi_from.mlp.mlp", [2 * D + 3, D, D])
        for name in ("z_k", "r_k", "correction"):
            _seq(rng, sd, f"{name}.mlp", [3 * D + P, D])
    if bc_mode == "mixed":
        _seq(rng, sd, f + "phi_neumann.mlp.mlp", [2 * D + 3, D, D])
        _seq(rng, sd, f + "update_neumann.mlp", [2 * D + P + 2, D, D])
    return sd


def _jax_route(family, sd, bc_mode):
    """JAX's ``compat`` then ``weights.*_params_from_jax``."""
    if family == "psignn":
        return params_from_jax(jcompat.convert_psignn(sd, 1, bc_mode))
    if family == "dsgps":
        return dsgps_params_from_jax(jcompat.convert_dsgps(sd, bc_mode))
    return dss_params_from_jax(jcompat.convert_dss(sd, K))


def _port(family, sd, bc_mode):
    if family == "psignn":
        return compat.convert_psignn(sd, 1, bc_mode)
    if family == "dsgps":
        return compat.convert_dsgps(sd, bc_mode)
    return compat.convert_dss(sd, K)


def _output(family, bc_mode, state):
    """One forward of the family's model holding ``state`` on a small
    graph: f_θ of a seeded h (Ψ-GNN), the unrolled model's answer (DS-GPS
    at k = 3, DSS)."""
    torch.manual_seed(0)
    if family == "dss":
        model = Dss(DssConfig(k=K))
        graph = batch_graphs([dss_sample(1)], device="cpu")
    else:
        sample = (fem_sample(1) if bc_mode == "dirichlet"
                  else mixed_sample(1))
        graph = batch_graphs([sample], device="cpu")
        model = (Psignn(PsignnConfig(bc_mode=bc_mode)) if family == "psignn"
                 else Dsgps(DsgpsConfig(bc_mode=bc_mode, k=3)))
    model.load_state_dict(state)
    with torch.no_grad():
        if family == "psignn":
            h = torch.randn(graph.total_nodes, D)
            return model.function(h, model.encoder(graph.x), graph)
        if family == "dss":
            from psignn_tpu_torch.models.dss import dss_inference
            return dss_inference(model, graph, DssConfig(k=K))
        from psignn_tpu_torch.models.dsgps import dsgps_inference
        return dsgps_inference(model, graph, DsgpsConfig(bc_mode=bc_mode,
                                                         k=3))


CASES = [("psignn", "dirichlet"), ("psignn", "mixed"),
         ("dsgps", "dirichlet"), ("dsgps", "mixed"), ("dss", "dirichlet")]


@pytest.mark.parametrize("family,bc_mode", CASES)
def test_convert_matches_jax_compat_and_weights(family, bc_mode):
    sd = reference_state_dict(family, bc_mode)
    want = _jax_route(family, sd, bc_mode)
    got = _port(family, sd, bc_mode)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k],
                                                             want[k]), k
    assert torch.equal(_output(family, bc_mode, got),
                       _output(family, bc_mode, want))


@pytest.fixture
def fake_reference_module(monkeypatch):
    """A ``utilities.solver`` with a ``broyden`` function, as the
    reference's code defines it, in ``sys.modules``."""
    solver = types.ModuleType("utilities.solver")

    def broyden(*args, **kwargs):
        return None
    broyden.__module__, broyden.__qualname__ = "utilities.solver", "broyden"
    solver.broyden = broyden
    utilities = types.ModuleType("utilities")
    utilities.solver = solver
    monkeypatch.setitem(sys.modules, "utilities", utilities)
    monkeypatch.setitem(sys.modules, "utilities.solver", solver)
    return broyden


def _write_reference_pt(path, monkeypatch, fake):
    """A reference Ψ-GNN ``.pt``, saved while ``utilities.solver`` exists
    and loaded after it is gone (as on any host but the reference's)."""
    torch.save({"state_dict": reference_state_dict("psignn", seed=3),
                "hyperparameters": {"solver": fake, "n_layers": 1,
                                    "latent_dim": D, "fw_tol": 1e-5,
                                    "lr": 0.01}}, path)
    monkeypatch.delitem(sys.modules, "utilities")
    monkeypatch.delitem(sys.modules, "utilities.solver")


@pytest.mark.parametrize("jax_stub_first", [False, True])
def test_reference_pt_loads_and_converts(tmp_path, monkeypatch,
                                         fake_reference_module,
                                         jax_stub_first):
    path = str(tmp_path / "best_model.pt")
    _write_reference_pt(path, monkeypatch, fake_reference_module)
    if jax_stub_first:
        # JAX's loader installs its stub module; the port's must not need
        # it nor replace it
        jcompat.load_reference_checkpoint(path)
        stub = sys.modules["utilities"]
    out = compat.convert_reference_checkpoint(path, "psignn", device="cpu")
    if jax_stub_first:
        assert sys.modules["utilities"] is stub
    else:
        assert "utilities" not in sys.modules
    assert callable(out["torch_ckpt"]["hyperparameters"]["solver"])
    assert out["hyperparameters"] == {"n_layers": 1, "latent_dim": D,
                                      "fw_tol": 1e-5, "lr": 0.01}
    assert out["config"].fw_tol == 1e-5 and not out["model"].training
    want = params_from_jax(jcompat.convert_psignn(
        reference_state_dict("psignn", seed=3)))
    for k, v in out["model"].state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError):
        compat.convert_reference_checkpoint(path, "nope", device="cpu")
