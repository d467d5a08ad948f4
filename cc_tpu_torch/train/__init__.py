"""Configuration, the four nets, their forward, the losses, the train
step, and checkpoints of the train state."""
from cc_tpu_torch.train.config import TrainConfig
from cc_tpu_torch.train.state import (
    NETS, Adam, AdamState, make_models, make_optimizer,
)
from cc_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from cc_tpu_torch.train.step import (
    METRICS, build_train_step, compute_losses, forward_all, forward_eval,
)

__all__ = ["METRICS", "TrainConfig", "NETS", "Adam", "AdamState", "make_models",
           "make_optimizer", "build_train_step", "compute_losses",
           "forward_all", "forward_eval", "load_checkpoint", "save_checkpoint"]
