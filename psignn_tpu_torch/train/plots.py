"""Training-side diagnostics plots (training_class.py:91-131).

Port of ``psignn_tpu/train/plots.py`` with its figures and file names.
matplotlib is imported when a plot is drawn (``eval.vis.load_pyplot``): the
module imports on a host without it, and a call there raises an
``ImportError`` that names matplotlib.
"""

from __future__ import annotations

import os
from typing import Dict, List

from ..eval.vis import load_pyplot


def plot_losses(hist_train: Dict[str, List[float]],
                hist_val: Dict[str, List[float]], path_logs: str) -> None:
    """2x3 log-scale train/val loss curves → track_losses.png."""
    plt, _ = load_pyplot()
    names = [("loss", "Training Loss"), ("residual_loss", "Residual Loss"),
             ("jacobian_loss", "Jacobian Loss"), ("mse_loss", "MSE Loss"),
             ("encoder_loss", "Encoder Loss"),
             ("autoencoder_loss", "Autoencoder Loss")]
    fig, axes = plt.subplots(3, 2, figsize=(10, 8), constrained_layout=True)
    for ax, (key, title) in zip(axes.ravel(), names):
        ax.plot(hist_train.get(key, []), "-b", linewidth=1, label="Train")
        ax.plot(hist_val.get(key, []), "-r", linewidth=1, label="Valid")
        ax.set_xlabel("Epoch")
        ax.set_ylabel(title)
        ax.set_yscale("log")
        ax.legend()
    fig.suptitle("Evolution of training losses through epoch")
    fig.savefig(os.path.join(path_logs, "track_losses.png"), dpi=100)
    plt.close(fig)


def plot_gradients(grad_norms: Dict[str, float], epoch: int,
                   path_logs: str) -> None:
    """Per-parameter gradient-norm bars → gradients.png."""
    if not grad_norms:
        return
    plt, _ = load_pyplot()
    names = list(grad_norms.keys())
    vals = [grad_norms[n] for n in names]
    fig = plt.figure(figsize=(15, 10))
    plt.bar(names, vals, width=0.5, linewidth=1.0)
    plt.xticks(rotation=30, ha="right")
    plt.ylabel("Gradient norm")
    plt.title(f"Gradient Norm at epoch {epoch}")
    plt.savefig(os.path.join(path_logs, "gradients.png"), bbox_inches="tight")
    plt.close(fig)
