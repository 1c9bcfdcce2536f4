#!/bin/bash
# Canonical Ψ-GNN Dirichlet training config of the PyTorch/CUDA port
# (reference dirichlet/psignn/launch_slurm.sh:14-40, SURVEY.md §6):
# latent_dim 10, n_layers 1, broyden, fw_tol 1e-5, fw_thres 500, bw_tol
# 1e-8, lr_deq 0.01, lr_ae 0.05, grad clip 0.1, jac_weight 1.0, batch 50.
# The flags of scripts/train_psignn_dirichlet.sh; OUT defaults under
# results/torch/, never to the JAX run's results/psignn_dirichlet/.
#
# Usage: bash scripts/torch/train_psignn_dirichlet.sh [DATA] [OUT] [flags]
# (extra flags, e.g. --device cuda:1 or --max_epochs 1, go to the CLI)
set -e
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
DATA=${1:-data/dirichlet}
OUT=${2:-results/torch/psignn_dirichlet}

"$PYTHON" -m psignn_tpu_torch.cli.main \
  --family psignn --variant dirichlet \
  --path_dataset "$DATA" --path_results "$OUT" \
  --solver broyden --fw_tol 1e-5 --fw_thres 500 --bw_tol 1e-8 --bw_thres 500 \
  --latent_dim 10 --n_layers 1 \
  --lr_deq 0.01 --lr_ae 0.05 --sched_step_deq 0.5 --sched_step_ae 0.5 \
  --gradient_clip 0.1 --jac_weight 1.0 \
  --batch_size 50 --max_epochs 700 "${@:3}"
