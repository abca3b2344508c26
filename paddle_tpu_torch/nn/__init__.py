"""Neural-network functions and layers of the port (``nn.functional``,
``nn.layers``)."""

from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.layers import (Conv2D, GroupNorm, Identity, Linear,
                                        Silu)

__all__ = ["functional", "Linear", "Conv2D", "GroupNorm", "Silu",
           "Identity"]
