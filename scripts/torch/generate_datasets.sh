#!/bin/bash
# Dataset factory of the PyTorch/CUDA port: 200 meshes x 50 samples per
# variant (reference defaults, dirichlet/dataset/generate_data.py:150-151),
# into data/dirichlet and data/mixed of the working directory.  The port's
# factory writes the same archives as scripts/generate_datasets.sh at the
# same seed; the Dirichlet set also gets DSS's A_prime/b_prime.
#
# Usage: [N_MESH=n] [N_SAMPLES=m] bash scripts/torch/generate_datasets.sh
set -e
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
"$PYTHON" -m psignn_tpu_torch.data.generate --path_data data/dirichlet \
  --n_mesh ${N_MESH:-200} --n_samples ${N_SAMPLES:-50} --variant dirichlet
"$PYTHON" -m psignn_tpu_torch.data.generate --path_data data/mixed \
  --n_mesh ${N_MESH:-200} --n_samples ${N_SAMPLES:-50} --variant mixed
