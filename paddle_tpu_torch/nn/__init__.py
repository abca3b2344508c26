"""Neural-network functions of the port (``nn.functional``)."""

from paddle_tpu_torch.nn import functional

__all__ = ["functional"]
