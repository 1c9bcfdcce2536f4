#!/bin/bash
# Evaluate the trained checkpoints on the held-out test split with the
# PyTorch/CUDA port: the Ψ-GNN, DS-GPS and DSS Dirichlet runs'
# best_model.ckpt under CKPTS (default results/, the JAX runs' checkpoints;
# CKPTS=results/torch for the port's own runs), on DATA's test split.
# Writes each run's test_metrics.json under EVAL_OUT/<run>/ (default
# results/torch/eval/), never into results/<run>/eval/, which holds the JAX
# package's tables.  Pauses the port's own trainers around each eval
# (with_quiet_card.sh).  Extra flags go to run_eval (e.g. --device cpu).
#
# Usage: [DATA=...] [CKPTS=...] [EVAL_OUT=...] bash scripts/torch/eval_trained.sh [flags]
set -e
HERE="$(cd "$(dirname "$0")" && pwd)"
export PYTHONPATH="$(cd "$HERE/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
DATA=${DATA:-data/dirichlet}
CKPTS=${CKPTS:-results}
EVAL_OUT=${EVAL_OUT:-results/torch/eval}

for fam_run in psignn:psignn_dirichlet dsgps:dsgps_dirichlet dss:dss_dirichlet; do
  fam=${fam_run%%:*}; run=${fam_run##*:}
  ck="$CKPTS/$run/ckpt/best_model.ckpt"
  [ -f "$ck" ] || { echo "skip $run (no ckpt)"; continue; }
  echo "== $run"
  bash "$HERE/with_quiet_card.sh" "$PYTHON" -m psignn_tpu_torch.eval.run_eval \
    --ckpt "$ck" --path_dataset "$DATA" \
    --out "$EVAL_OUT/$run" "$@"
done
