#!/bin/bash
# Round-rollover helper of the PyTorch/CUDA port: the datasets under data/
# are gitignored (3 GB), so a fresh machine starts without them.
# Generation is seeded (seed 1234) and the port's factory writes the JAX
# factory's archives, so the checkpoints stay resumable.
#
# Usage:  bash scripts/torch/resume_round.sh
# Regenerates missing datasets, then resumes every port training run under
# results/torch/ that has a running_model.ckpt (and starts from scratch the
# ones that do not), and starts the port's watchdog.  The flags are those
# of scripts/resume_round.sh: --cache_batches 1 on every run keeps its
# batches on the card (membership frozen after the first shuffle), and
# --pallas puts the Ψ-GNN run's samples in RCM node order.
set -e
cd "$(dirname "$0")/../.."
export PYTHONPATH="$(pwd)${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
mkdir -p logs/resume_torch

[ -f data/dirichlet/A_sparse_matrix.npy ] || \
  "$PYTHON" -m psignn_tpu_torch.data.generate --path_data data/dirichlet \
    --n_mesh 200 --n_samples 50 --variant dirichlet
[ -f data/mixed/A_sparse_matrix.npy ] || \
  "$PYTHON" -m psignn_tpu_torch.data.generate --path_data data/mixed \
    --n_mesh 200 --n_samples 50 --variant mixed

resume_flag() {  # $1 = results dir
  local ck="$1/ckpt/running_model.ckpt"
  [ -f "$ck" ] && echo "--resume $ck"
}

run_lr() {  # $1 = results dir, $2 = fallback
  # A resume must continue in the checkpoint's own lr regime: the trainer
  # reads lr from the CLI, not the checkpoint, and resuming the dsgps run at
  # 10x its trained lr destroys its progress (docs/dsgps_dynamics.md).
  local cfg="$1/logs/model_config.csv"
  local lr=""
  [ -f "$cfg" ] && lr=$(sed -n "s/^'lr':'\([^']*\)'.*/\1/p" "$cfg" | head -1)
  echo "${lr:-$2}"
}

# Flagship Ψ-GNN (canonical broyden config, SURVEY.md §6)
nohup "$PYTHON" -m psignn_tpu_torch.cli.main --family psignn --variant dirichlet \
  --path_dataset data/dirichlet --path_results results/torch/psignn_dirichlet \
  --solver broyden --fw_tol 1e-5 --fw_thres 500 --bw_tol 1e-8 --bw_thres 500 \
  --latent_dim 10 --n_layers 1 --lr_deq 0.01 --lr_ae 0.05 \
  --sched_step_deq 0.5 --sched_step_ae 0.5 --gradient_clip 0.1 --jac_weight 1.0 \
  --batch_size 50 --max_epochs 700 --pallas --cache_batches 1 \
  $(resume_flag results/torch/psignn_dirichlet) \
  > logs/resume_torch/psignn.log 2>&1 &
echo "psignn $!" > logs/resume_torch/pids.txt

nohup "$PYTHON" -m psignn_tpu_torch.cli.main --family dss --variant dirichlet \
  --path_dataset data/dirichlet --path_results results/torch/dss_dirichlet \
  --k 30 --alpha 1e-3 --gamma 0.9 --latent_dim 10 \
  --lr 0.01 --gradient_clip 0.01 --batch_size 50 --max_epochs 400 --cache_batches 1 \
  $(resume_flag results/torch/dss_dirichlet) \
  > logs/resume_torch/dss.log 2>&1 &
echo "dss $!" >> logs/resume_torch/pids.txt

nohup "$PYTHON" -m psignn_tpu_torch.cli.main --family dsgps --variant dirichlet \
  --path_dataset data/dirichlet --path_results results/torch/dsgps_dirichlet \
  --k 30 --gamma 0.9 --latent_dim 10 --seed 7 --spike_guard \
  --lr "$(run_lr results/torch/dsgps_dirichlet 1e-3)" --gradient_clip 0.01 \
  --batch_size 50 --max_epochs 400 --cache_batches 1 \
  $(resume_flag results/torch/dsgps_dirichlet) \
  > logs/resume_torch/dsgps.log 2>&1 &
echo "dsgps $!" >> logs/resume_torch/pids.txt

# --enc_loss_mode freeze: the fix for the detach-semantics Enc explosion on
# this data realization (docs/dsgps_dynamics.md)
nohup nice -n 8 "$PYTHON" -m psignn_tpu_torch.cli.main --family dsgps --variant mixed \
  --path_dataset data/mixed --path_results results/torch/dsgps_mixed \
  --k 30 --gamma 0.9 --latent_dim 10 --spike_guard --neumann_init_scale 0.1 \
  --enc_loss_mode freeze --seed 7 \
  --lr "$(run_lr results/torch/dsgps_mixed 1e-3)" --gradient_clip 0.01 \
  --batch_size 50 --max_epochs 400 --cache_batches 1 \
  $(resume_flag results/torch/dsgps_mixed) \
  > logs/resume_torch/dsgps_mixed.log 2>&1 &
echo "dsgps_mixed $!" >> logs/resume_torch/pids.txt

# Mixed-BC Ψ-GNN (reference: mixed/psignn 400 epochs, endpoint val Res
# 3.17e-3); the script resumes from its own running checkpoint
nohup bash scripts/torch/train_psignn_mixed.sh > logs/resume_torch/psignn_mixed.log 2>&1 &
echo "psignn_mixed $!" >> logs/resume_torch/pids.txt

nohup bash scripts/torch/train_watchdog.sh > logs/resume_torch/watchdog.log 2>&1 &
echo "watchdog $!" >> logs/resume_torch/pids.txt

echo "Launched (PIDs in logs/resume_torch/pids.txt).  Monitor with:"
echo "  tail -f results/torch/*/logs/train_metrics.csv"
echo "Stop with exact PIDs only:  kill \$(awk '{print \$2}' logs/resume_torch/pids.txt)"
