"""Optimizers of the port: the ``Optimizer`` base, ``Adam`` and ``AdamW``."""

from paddle_tpu_torch.optimizer.adam import Adam, AdamW
from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["Optimizer", "Adam", "AdamW"]
