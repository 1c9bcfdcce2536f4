#!/bin/bash
# DS-GPS training, Dirichlet variant, on the PyTorch/CUDA port (reference
# dirichlet/dsgps/launch.sh: k 30, gamma 0.9, clip 0.01, batch 50, 400
# epochs — SURVEY.md §6).  The flags of scripts/train_dsgps_dirichlet.sh.
#
# lr regime (docs/dsgps_dynamics.md): a cold start at the reference's lr
# 0.01 or at 1e-3 plateaus at val Res ~5; the shipped run warm-starts the
# 1<->latent autoencoder from the trained Ψ-GNN and trains the rest at lr
# 1e-3.  A fresh OUT does the same: make_warmae_ckpt.py copies the encoder
# and decoder of results/psignn_dirichlet's checkpoint into fresh DS-GPS
# weights (the port's own draw, seed 1234) and the run resumes from that
# epoch-0 checkpoint.  For the long tail, resume from best at lr 3e-4.
#
# Usage: bash scripts/torch/train_dsgps_dirichlet.sh [DATA] [OUT] [LR] [flags]
set -e
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
DATA=${1:-data/dirichlet}
OUT=${2:-results/torch/dsgps_dirichlet}
LR=${3:-1e-3}

WARM=""
if [ ! -d "$OUT" ] && [ -f results/psignn_dirichlet/ckpt/running_model.ckpt ]; then
  "$PYTHON" "$(dirname "$0")/make_warmae_ckpt.py"
  WARM="--resume ${TMPDIR:-/tmp}/warmae_ckpt_torch/warm_init.ckpt"
fi

"$PYTHON" -m psignn_tpu_torch.cli.main \
  --family dsgps --variant dirichlet \
  --path_dataset "$DATA" --path_results "$OUT" \
  --k 30 --gamma 0.9 --latent_dim 10 \
  --lr "$LR" --gradient_clip 0.01 \
  --batch_size 50 --max_epochs 400 $WARM "${@:4}"
