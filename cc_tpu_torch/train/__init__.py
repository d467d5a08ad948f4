"""Configuration, the four nets and their forward."""
from cc_tpu_torch.train.config import TrainConfig
from cc_tpu_torch.train.state import NETS, make_models
from cc_tpu_torch.train.step import forward_all, forward_eval

__all__ = ["TrainConfig", "NETS", "make_models", "forward_all", "forward_eval"]
