"""Configuration, the four nets, their forward, the losses and the train
step."""
from cc_tpu_torch.train.config import TrainConfig
from cc_tpu_torch.train.state import (
    NETS, Adam, AdamState, make_models, make_optimizer,
)
from cc_tpu_torch.train.step import (
    METRICS, build_train_step, compute_losses, forward_all, forward_eval,
)

__all__ = ["METRICS", "TrainConfig", "NETS", "Adam", "AdamState", "make_models",
           "make_optimizer", "build_train_step", "compute_losses",
           "forward_all", "forward_eval"]
