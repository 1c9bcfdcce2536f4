"""Warm start of the DS-GPS Dirichlet protocol on the PyTorch/CUDA port.

Fresh DS-GPS weights (k 30, gamma 0.9; the port's own draw from seed 1234)
with the encoder and decoder of a trained Ψ-GNN checkpoint copied in
exactly, written as a port checkpoint at epoch 0 that ``cli.main
--resume`` reads: empty histories, a fresh Adam state.
``train_dsgps_dirichlet.sh`` runs it for a fresh output directory.

    python scripts/torch/make_warmae_ckpt.py [--psignn CKPT] [--out DIR]

``--psignn`` (default ``results/psignn_dirichlet/ckpt/running_model.ckpt``)
takes a checkpoint of the JAX trainer or of the port; the checkpoint lands
in ``--out`` (default ``$TMPDIR/warmae_ckpt_torch``, ``/tmp`` without
``TMPDIR``) as ``warm_init.ckpt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from psignn_tpu_torch.models import Dsgps, DsgpsConfig  # noqa: E402
from psignn_tpu_torch.train.checkpoint import (  # noqa: E402
    optimizer_state_to_numpy, save_checkpoint)
from psignn_tpu_torch.train.optim import make_adam  # noqa: E402
from psignn_tpu_torch.train.trainer import LOSS_KEYS  # noqa: E402
from psignn_tpu_torch.weights import (dsgps_params_from_jax,  # noqa: E402
                                      dsgps_params_to_jax,
                                      load_jax_checkpoint)

PSIGNN_CKPT = "results/psignn_dirichlet/ckpt/running_model.ckpt"
SEED = 1234
LR = 1e-3


def warm_state(psignn_ckpt: str = PSIGNN_CKPT, seed: int = SEED) -> dict:
    """The epoch-0 DS-GPS checkpoint: seeded weights, the Ψ-GNN
    checkpoint's encoder and decoder."""
    ae = load_jax_checkpoint(psignn_ckpt)["params"]["autoencoder"]
    cfg = DsgpsConfig(k=30, gamma=0.9)
    model = Dsgps(cfg, generator=torch.Generator().manual_seed(seed),
                  device="cpu")
    params = dsgps_params_to_jax(model.state_dict())
    params["autoencoder"] = {"encoder": ae["encoder"],
                             "decoder": ae["decoder"]}
    # the tree must load into the model as the trainer loads it
    model.load_state_dict(dsgps_params_from_jax(params))
    adam = make_adam(model, LR)
    return dict(epoch=0, family="dsgps",
                hyperparameters=dataclasses.asdict(cfg), params=params,
                hist_train={k: [] for k in LOSS_KEYS},
                hist_val={k: [] for k in LOSS_KEYS},
                min_loss_save=1e10, lr_scale=1.0, training_time=0.0,
                torch_optim={"adam": optimizer_state_to_numpy(
                    adam.state_dict())})


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--psignn", default=PSIGNN_CKPT)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "warmae_ckpt_torch"))
    args = p.parse_args(argv)
    path = save_checkpoint(warm_state(args.psignn), args.out, "warm_init")
    print(f"wrote {path}: DS-GPS seed {SEED}, encoder and decoder of "
          f"{args.psignn}")
    return path


if __name__ == "__main__":
    main()
