"""Shared inputs for the JAX ↔ PyTorch parity tests (``test_torch_*.py``).

Every input is made with numpy from a seed and handed to both packages;
JAX stays on the CPU (tests/conftest.py), torch runs with device="cpu".
"""

import numpy as np

CKPT = "results/psignn_dirichlet/ckpt/best_model.ckpt"
MIXED_CKPT = "results/psignn_mixed/ckpt/best_model.ckpt"
DSS_CKPT = "results/dss_dirichlet/ckpt/best_model.ckpt"
DSGPS_CKPT = "results/dsgps_dirichlet/ckpt/best_model.ckpt"
DSGPS_MIXED_CKPT = "results/dsgps_mixed/ckpt/best_model.ckpt"


def fem_sample(seed: int, radius: float = 1.0, hsize: float = 0.2):
    """One Ψ-GNN graph sample from the port's own data path."""
    from psignn_tpu_torch.data.fem import solve_poisson
    from psignn_tpu_torch.data.meshgen import blob_mesh
    from psignn_tpu_torch.data.reader import psignn_sample_from_fem
    rng = np.random.default_rng(seed)
    mesh = blob_mesh(radius=radius, hsize=hsize, rng=rng)
    return psignn_sample_from_fem(solve_poisson(mesh, radius, rng))


def fem_solve(seed: int, radius: float = 1.0, hsize: float = 0.2):
    """One FEM solve (``solve_poisson``'s dict) on a seeded blob mesh."""
    from psignn_tpu_torch.data.fem import solve_poisson
    from psignn_tpu_torch.data.meshgen import blob_mesh
    rng = np.random.default_rng(seed)
    mesh = blob_mesh(radius=radius, hsize=hsize, rng=rng)
    return solve_poisson(mesh, radius, rng)


def dss_sample(seed: int, radius: float = 1.0, hsize: float = 0.2):
    """One DSS graph sample (A′, b′) from the port's own data path."""
    from psignn_tpu_torch.data.reader import dss_sample_from_fem
    return dss_sample_from_fem(fem_solve(seed, radius, hsize))


def grad_rel(got, want) -> float:
    """‖got − want‖ / ‖want‖ of two arrays."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def mixed_sample(seed: int, radius: float = 1.0, hsize: float = 0.2):
    """One mixed Ψ-GNN graph sample (normals included) from the port's own
    data path."""
    from psignn_tpu_torch.data.fem import solve_poisson_mixed
    from psignn_tpu_torch.data.meshgen import mixed_blob_mesh
    from psignn_tpu_torch.data.reader import psignn_sample_from_fem
    rng = np.random.default_rng(seed)
    mesh = mixed_blob_mesh(radius=radius, hsize=hsize, rng=rng)
    return psignn_sample_from_fem(solve_poisson_mixed(mesh, radius, rng),
                                  variant="mixed")


def jax_mlp_params(rng: np.random.Generator, channels):
    """A JAX-layout MLP parameter list ``[{"w": (in, out), "b": (out,)}]``
    with Xavier-scaled weights and nonzero biases."""
    out = []
    for a, b in zip(channels[:-1], channels[1:]):
        lim = np.sqrt(6.0 / (a + b))
        out.append({"w": rng.uniform(-lim, lim, (a, b)).astype(np.float32),
                    "b": rng.uniform(-0.1, 0.1, (b,)).astype(np.float32)})
    return out


def jax_dss_params(rng: np.random.Generator, k: int, D: int = 10):
    """A JAX-layout DSS tree (``dss_init``'s: every leaf stacked on a
    leading k axis) of seeded numpy MLPs."""
    layers = [{"phi_to": jax_mlp_params(rng, [2 * D + 1, D, D]),
               "phi_from": jax_mlp_params(rng, [2 * D + 1, D, D]),
               "psi": jax_mlp_params(rng, [3 * D + 3, D, D]),
               "decoder": jax_mlp_params(rng, [D, D, 1])}
              for _ in range(k)]
    return {"layers": {
        name: [{key: np.stack([lay[name][i][key] for lay in layers])
                for key in ("w", "b")}
               for i in range(len(layers[0][name]))]
        for name in layers[0]}}


def jax_dsgps_params(rng: np.random.Generator, mixed: bool, D: int = 10,
                     E: int = 3):
    """A JAX-layout DS-GPS tree (``dsgps_init``'s) of seeded numpy MLPs,
    the unused ``laynorm`` at its init values."""
    P = 3 if mixed else 2
    tree = {"laynorm": {"scale": np.ones(D, np.float32),
                        "bias": np.zeros(D, np.float32)},
            "phi_to": jax_mlp_params(rng, [2 * D + E, D, D]),
            "phi_from": jax_mlp_params(rng, [2 * D + E, D, D]),
            "z_k": jax_mlp_params(rng, [3 * D + P, D]),
            "r_k": jax_mlp_params(rng, [3 * D + P, D]),
            "correction": jax_mlp_params(rng, [3 * D + P, D]),
            "autoencoder": {"encoder": jax_mlp_params(rng, [1, D, D]),
                            "decoder": jax_mlp_params(rng, [D, D, 1])}}
    if mixed:
        tree["phi_neumann"] = jax_mlp_params(rng, [2 * D + E, D, D])
        tree["update_neumann"] = jax_mlp_params(rng, [2 * D + P + 2, D, D])
    return tree


def load_trained(path: str = CKPT):
    """(numpy parameter tree, hyperparameters) of a trained Ψ-GNN."""
    from psignn_tpu_torch.weights import load_jax_checkpoint
    ck = load_jax_checkpoint(path)
    return ck["params"], dict(ck["hyperparameters"])


def kernel_route(monkeypatch):
    """Send CPU tensors down the CUDA route of ``fused_message_passing``
    (the ``_FusedMP`` / ``_FusedMPVjp`` autograd wiring and the launch
    counters), with each kernel replaced by its plain version.  The kernels
    themselves run only on the card (``chip_smoke.py``); this checks the
    wiring around them."""
    import torch
    from psignn_tpu_torch import ops
    from psignn_tpu_torch.kernels import fused_mp as fm

    def fwd(w1, b1, w2, b2, h, csr):
        fm.LAUNCHES += 1
        with torch.no_grad():
            return fm.mp_from_csr(w1, b1, w2, b2, h, csr)

    def bwd(w1, b1, w2, b2, h, csr, g):
        fm.BWD_LAUNCHES += 1
        with torch.no_grad():
            return fm.mp_vjp_from_csr(w1, b1, w2, b2, h, csr, g)

    monkeypatch.setattr(fm, "_fused_mp_cuda", fwd)
    monkeypatch.setattr(fm, "fused_mp_vjp", bwd)
    monkeypatch.setattr(ops, "fused_message_passing", fm._FusedMP.apply)
    monkeypatch.setattr(fm, "LAUNCHES", 0)
    monkeypatch.setattr(fm, "BWD_LAUNCHES", 0)
    return fm
