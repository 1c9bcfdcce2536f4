"""The registry of training runs and their ``train_metrics.csv`` logs: this
repository's runs and the reference's.

Port of ``psignn_tpu/eval/registry.py``, with the same run names and the
same paths below the reference's root.  ``REPO`` is the repository's root;
``REF`` is where the reference's checkout (mnastorg/PSI-GNN) goes inside
it, ``reference/``, which the JAX package reads at a fixed absolute path
instead.  A path that does not exist is a run whose log is not in the
checkout.
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF = os.path.join(REPO, "reference")

REF_CURVES = {
    "psignn": f"{REF}/dirichlet/psignn/results/constant_dataset/logs/train_metrics.csv",
    "dsgps": f"{REF}/dirichlet/dsgps/results/constant_dataset/30_ite_gamma_0_9/logs/train_metrics.csv",
    "dss": f"{REF}/dirichlet/dss/results/dss_results/logs/train_metrics.csv",
    "psignn_mixed": f"{REF}/mixed/psignn/results/best_model/logs/train_metrics.csv",
    "dsgps_mixed": f"{REF}/mixed/dsgps/results/30_ite_lamb_0_gamma_0_9/logs/train_metrics.csv",
    "dsgps_k70": f"{REF}/dirichlet/dsgps/results/constant_dataset/70_ite_gamma_1/logs/train_metrics.csv",
}

OUR_CURVES = {
    "psignn": f"{REPO}/results/psignn_dirichlet/logs/train_metrics.csv",
    "dsgps": f"{REPO}/results/dsgps_dirichlet/logs/train_metrics.csv",
    "dss": f"{REPO}/results/dss_dirichlet/logs/train_metrics.csv",
    "psignn_mixed": f"{REPO}/results/psignn_mixed/logs/train_metrics.csv",
    "dsgps_mixed": f"{REPO}/results/dsgps_mixed/logs/train_metrics.csv",
    "dsgps_k70": f"{REPO}/results/dsgps_k70_g1/logs/train_metrics.csv",
}
