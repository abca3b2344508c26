"""Neural-network functions and layers of the port (``nn.functional``,
``nn.layers``, ``nn.transformer``, ``nn.clip``, ``nn.generation``)."""

from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)
from paddle_tpu_torch.nn.layers import (Conv2D, Dropout, Embedding,
                                        GroupNorm, Identity, LayerList,
                                        LayerNorm, Linear, Silu)
from paddle_tpu_torch.nn.transformer import (MultiHeadAttention,
                                             Transformer,
                                             TransformerDecoder,
                                             TransformerDecoderLayer,
                                             TransformerEncoder,
                                             TransformerEncoderLayer)

__all__ = ["functional", "Linear", "Embedding", "Dropout", "LayerList",
           "Conv2D", "LayerNorm", "GroupNorm", "Silu", "Identity",
           "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
