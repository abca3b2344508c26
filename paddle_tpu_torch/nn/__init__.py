"""Neural-network functions and layers of the port (``nn.functional``,
``nn.layers``, ``nn.clip``)."""

from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.nn.layers import (Conv2D, GroupNorm, Identity, Linear,
                                        Silu)

__all__ = ["functional", "Linear", "Conv2D", "GroupNorm", "Silu",
           "Identity", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
