"""Training: optimizers and schedulers, the train steps, checkpoints and the
epoch-level trainer (Ψ-GNN, DS-GPS and DSS, on one device or
data-parallel over several)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .optim import PlateauScheduler, make_adam, make_optimizers
from .step import StepResult, train_step, unrolled_train_step
from .trainer import TrainConfig, Trainer

__all__ = ["PlateauScheduler", "StepResult", "TrainConfig", "Trainer",
           "load_checkpoint", "make_adam", "make_optimizers",
           "save_checkpoint", "train_step", "unrolled_train_step"]
