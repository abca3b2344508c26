"""Optimizers of the port: the ``Optimizer`` base, SGD, Momentum, Adagrad,
RMSProp, Adadelta, Adamax, ASGD, Rprop, Adam, AdamW and Lamb, and the
``lr`` schedulers."""

from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.adam import Adam, AdamW, Lamb
from paddle_tpu_torch.optimizer.optimizer import (ASGD, SGD, Adadelta,
                                                  Adagrad, Adamax, Momentum,
                                                  Optimizer, RMSProp, Rprop)

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "RMSProp", "Adadelta",
           "Adamax", "ASGD", "Rprop", "Adam", "AdamW", "Lamb", "lr"]
