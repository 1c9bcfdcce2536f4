#!/bin/bash
# A second point on the reference's DS-GPS config grid, on the PyTorch/CUDA
# port: k 70, gamma 1.0 (reference 70_ite_gamma_1/logs: lr 1e-3, clip 0.01;
# endpoint val Res 2.18e-3 at epoch 399, matched-epoch targets 7.8e-3 at
# 49, 4.5e-3 at 99).  Bounded to 120 epochs; resumes from OUT's running
# checkpoint when there is one.  The flags of tools/launch_k70.sh
# (--cache_batches 1: every batch kept on the card, its membership frozen
# after the first shuffle); it runs in the foreground (run it under nohup
# to detach it, as launch_k70.sh does).
#
# Usage: bash scripts/torch/train_dsgps_k70.sh [DATA] [OUT] [flags]
set -e
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
DATA=${1:-data/dirichlet}
OUT=${2:-results/torch/dsgps_k70_g1}

"$PYTHON" -m psignn_tpu_torch.cli.main \
  --family dsgps --variant dirichlet \
  --path_dataset "$DATA" --path_results "$OUT" \
  --k 70 --gamma 1.0 --latent_dim 10 --lr 1e-3 --gradient_clip 0.01 \
  --batch_size 50 --max_epochs 120 --cache_batches 1 --seed 7 --spike_guard \
  $( [ -f "$OUT/ckpt/running_model.ckpt" ] && echo "--resume $OUT/ckpt/running_model.ckpt" ) \
  "${@:3}"
