"""Training: optimizers and schedulers, the train step, checkpoints and the
epoch-level trainer (Ψ-GNN Dirichlet, one device)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .optim import PlateauScheduler, make_optimizers
from .step import StepResult, train_step
from .trainer import TrainConfig, Trainer

__all__ = ["PlateauScheduler", "StepResult", "TrainConfig", "Trainer",
           "load_checkpoint", "make_optimizers", "save_checkpoint",
           "train_step"]
