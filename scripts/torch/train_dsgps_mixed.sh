#!/bin/bash
# Mixed-BC DS-GPS on the PyTorch/CUDA port (reference mixed/dsgps/launch.sh).
# The flags of scripts/train_dsgps_mixed.sh.
#
# Usage: bash scripts/torch/train_dsgps_mixed.sh [DATA] [OUT] [flags]
set -e
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
DATA=${1:-data/mixed}
OUT=${2:-results/torch/dsgps_mixed}

"$PYTHON" -m psignn_tpu_torch.cli.main \
  --family dsgps --variant mixed \
  --path_dataset "$DATA" --path_results "$OUT" \
  --k 30 --gamma 0.9 --latent_dim 10 \
  --lr 0.001 --gradient_clip 0.01 \
  --batch_size 50 --max_epochs 400 "${@:3}"
