"""MNIST+SVHN Competitive-Collaboration demo, the CC objective in
miniature: the counterpart of cc_tpu/mnist, with the same names.

Alice and Bob are 10-way LeNet classifiers; the Moderator is a 1-logit
LeNet that softly assigns each sample to one of them. Epochs alternate:
  compete (even):     loss = sg(sigmoid(mod)) * CE_alice
                             + (1 - sg(sigmoid(mod))) * CE_bob
  collaborate (odd):  mod trained against pseudo-label CE_alice < CE_bob
                      + a variance regularizer, with the CE losses detached.
"""
from cc_tpu_torch.mnist.model import LeNet
from cc_tpu_torch.mnist.train import (
    MnistConfig, init_mnist_state, make_compete_step, make_collaborate_step,
    evaluate,
)

__all__ = ["LeNet", "MnistConfig", "init_mnist_state", "make_compete_step",
           "make_collaborate_step", "evaluate"]
