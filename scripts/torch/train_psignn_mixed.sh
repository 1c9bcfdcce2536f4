#!/bin/bash
# Mixed-BC Ψ-GNN of the PyTorch/CUDA port (reference mixed/psignn/launch.sh
# + the recorded config of results/best_model/logs/model_config.csv: 400
# epochs, fw_thres 500): same knobs as the Dirichlet config on the mixed
# dataset (3-column tags/prb, Neumann branch).  Endpoint to match: val Res
# 3.17e-3 at epoch 399.  The flags of scripts/train_psignn_mixed.sh:
# --pallas puts each sample in RCM node order and --cache_batches 1 keeps
# every batch on the card, its membership frozen after the first shuffle;
# resumes from OUT's running checkpoint when there is one.
#
# Usage: bash scripts/torch/train_psignn_mixed.sh [DATA] [OUT] [flags]
set -e
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
DATA=${1:-data/mixed}
OUT=${2:-results/torch/psignn_mixed}

"$PYTHON" -m psignn_tpu_torch.cli.main \
  --family psignn --variant mixed \
  --path_dataset "$DATA" --path_results "$OUT" \
  --solver broyden --fw_tol 1e-5 --fw_thres 500 --bw_tol 1e-8 --bw_thres 500 \
  --latent_dim 10 --n_layers 1 \
  --lr_deq 0.01 --lr_ae 0.05 --sched_step_deq 0.5 --sched_step_ae 0.5 \
  --gradient_clip 0.1 --jac_weight 1.0 \
  --batch_size 50 --max_epochs 400 --pallas --cache_batches 1 \
  $( [ -f "$OUT/ckpt/running_model.ckpt" ] && echo "--resume $OUT/ckpt/running_model.ckpt" ) \
  "${@:3}"
