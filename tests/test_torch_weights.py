"""Port weights: ``load_jax_checkpoint`` without jax or optax, and the JAX
parameter-tree layout change of ``params_from_jax``."""

import io
import json
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_parity import CKPT, MIXED_CKPT, jax_mlp_params
from psignn_tpu_torch import weights
from psignn_tpu_torch.models import Psignn, PsignnConfig


def _flatten(tree, prefix=""):
    """{path: numpy array} of a nested dict/list tree of arrays."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("ckpt,n_leaves", [(CKPT, 24), (MIXED_CKPT, 32)],
                         ids=["dirichlet", "mixed"])
def test_load_jax_checkpoint_without_jax_or_optax(tmp_path, ckpt, n_leaves):
    """In a process where ``import jax`` and ``import optax`` fail, the
    checkpoint loads, builds its model (the mixed one with the Neumann
    MLPs) and matches an ordinary ``pickle.load`` here."""
    dump = tmp_path / "params.npz"
    script = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        sys.modules["jax"] = None
        sys.modules["optax"] = None
        from psignn_tpu_torch.weights import (load_jax_checkpoint,
                                              load_psignn_checkpoint)
        load_psignn_checkpoint({ckpt!r}, "cpu")
        ck = load_jax_checkpoint({ckpt!r})
        flat = {{}}
        def walk(t, p):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{{p}}/{{k}}" if p else str(k))
            elif isinstance(t, list):
                for k, v in enumerate(t):
                    walk(v, f"{{p}}/{{k}}" if p else str(k))
            else:
                flat[p] = np.asarray(t)
        walk(ck["params"], "")
        np.savez({str(dump)!r}, **flat)
        print(json.dumps(dict(hp=ck["hyperparameters"], family=ck["family"],
                              jax="jax" in sys.modules and
                                  sys.modules["jax"] is not None,
                              optax=sys.modules.get("optax") is not None)))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not info["jax"] and not info["optax"]

    with open(ckpt, "rb") as f:
        want = pickle.load(f)      # imports optax for the optimizer state
    assert info["hp"] == want["hyperparameters"]
    assert info["family"] == want["family"] == "psignn"
    assert info["hp"]["fw_tol"] == 1e-5 and info["hp"]["fw_thres"] == 500
    flat_want = _flatten(want["params"])
    with np.load(dump) as got:
        assert set(got.files) == set(flat_want)
        assert len(flat_want) == n_leaves
        for k, v in flat_want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert flat_want["function/layers/0/phi_to/0/w"].shape == (23, 10)


def test_unpickler_refuses_other_classes():
    """A checkpoint may refer to numpy and optax classes only."""
    evil = pickle.dumps(dict(params={}, hook=print))
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        weights._CheckpointUnpickler(io.BytesIO(evil)).load()


def test_unpickler_stubs_optax_state():
    """An optax named tuple, as protocol 2+ pickles it (GLOBAL, args,
    NEWOBJ), comes back as the inert stub."""
    blob = (b"\x80\x02coptax._src.transform\nScaleByAdamState\n"
            b"K\x01K\x02\x86\x81.")
    got = weights._CheckpointUnpickler(io.BytesIO(blob)).load()
    assert isinstance(got, weights._OptaxState) and tuple(got) == (1, 2)


def test_params_from_jax_layout():
    """JAX ``w`` is (fan_in, fan_out); ``nn.Linear.weight`` is (out, in)."""
    rng = np.random.default_rng(0)
    D, E, P = 10, 3, 2
    layer = {name: jax_mlp_params(rng, [2 * D + E, D, D])
             for name in ("phi_to", "phi_from")}
    layer["update"] = jax_mlp_params(rng, [3 * D + P, D, D])
    tree = dict(
        function=dict(layers=[layer],
                      alpha=jax_mlp_params(rng, [3 * D + P, 1])[0],
                      laynorm=dict(scale=rng.normal(size=D).astype(np.float32),
                                   bias=rng.normal(size=D).astype(np.float32))),
        autoencoder=dict(encoder=jax_mlp_params(rng, [1, D, D]),
                         decoder=jax_mlp_params(rng, [D, D, 1])))
    sd = weights.params_from_jax(tree)
    model = Psignn(PsignnConfig())
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape and sd[k].dtype == torch.float32, k
    w = tree["function"]["layers"][0]["phi_to"][0]["w"]
    np.testing.assert_array_equal(
        sd["function.layers.0.phi_to.layers.0.weight"].numpy(), w.T)
    np.testing.assert_array_equal(sd["function.laynorm.weight"].numpy(),
                                  tree["function"]["laynorm"]["scale"])
    # an unported variant's parameters are refused, not dropped
    tree["function"]["normal_mlp"] = []
    with pytest.raises(NotImplementedError, match="normal_mlp"):
        weights.params_from_jax(tree)


def test_load_psignn_checkpoint_overrides():
    model, cfg = weights.load_psignn_checkpoint(CKPT, "cpu",
                                                dict(fw_thres=7))
    assert cfg.fw_thres == 7 and cfg.fw_tol == 1e-5 and cfg.latent_dim == 10
    assert not model.training
    assert next(model.parameters()).device.type == "cpu"
