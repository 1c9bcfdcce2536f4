#!/bin/bash
# Canonical DSS config of the PyTorch/CUDA port (reference
# dirichlet/dss/launch.sh, SURVEY.md §6): k 30, alpha 1e-3, gamma 0.9,
# lr 0.01, grad clip 0.01, batch 50.  The flags of
# scripts/train_dss_dirichlet.sh.
#
# Usage: bash scripts/torch/train_dss_dirichlet.sh [DATA] [OUT] [flags]
set -e
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
DATA=${1:-data/dirichlet}
OUT=${2:-results/torch/dss_dirichlet}

"$PYTHON" -m psignn_tpu_torch.cli.main \
  --family dss --variant dirichlet \
  --path_dataset "$DATA" --path_results "$OUT" \
  --k 30 --alpha 1e-3 --gamma 0.9 --latent_dim 10 \
  --lr 0.01 --gradient_clip 0.01 \
  --batch_size 50 --max_epochs 400 "${@:3}"
