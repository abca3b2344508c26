"""The framework pieces of the port: the global RNG state
(``framework.random``)."""

from paddle_tpu_torch.framework import random

__all__ = ["random"]
